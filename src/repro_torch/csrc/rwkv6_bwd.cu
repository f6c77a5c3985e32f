// RWKV-6 recurrence backward for Hopper (training): given the forward's
// inputs r/k/v/w (B, H, T, K) fp32, u (B, H, K) fp32 and dy (B, H, T, K)
// fp32, computes dr, dk, dv, dw (B, H, T, K) and du (B, H, K) for the
// forward of csrc/rwkv6.cu
//
//     y_t = r_t . (S_{t-1} + diag(u) k_t^T v_t)
//     S_t = diag(w_t) S_{t-1} + k_t^T v_t           (S_{-1} = 0, no final-state grad)
//
// With G_t = dL/dS_t (G_{T-1} = 0, G_{t-1} = diag(w_t) G_t + r_t^T dy_t):
//
//     dr_t = S_{t-1} dy_t + u k_t (dy_t . v_t)      dk_t = G_t v_t + u r_t (dy_t . v_t)
//     dv_t = k_t G_t + dy_t sum(u k_t r_t)          dw_t = rowsum(S_{t-1} G_t)
//     du   = sum_t r_t k_t (dy_t . v_t)
//
// Replaces no TPU kernel: the reference differentiates its lax.scan
// (src/repro/models/rwkv6.py, rwkv_time_mix) through XLA; its Pallas
// kernel (src/repro/kernels/rwkv6/rwkv6.py) has no VJP.  The port runs the
// model's recurrence through csrc/rwkv6.cu, which autograd cannot
// differentiate, so training RWKV-6 on the card needs this one.
//
// What bounds it here: per token and head the per-token recurrence takes
// ~14 K^2 fp32 FLOPs (S stepped, four sums, G's update) against 9 K
// elements of traffic, about the card's fp32 ridge: 0.228 ms at (128,
// 2048, 64) on the CUDA cores' 67 TFLOP/s.  Its first kernel here walked
// every head's tokens in order and ran 4.13 ms (H100 80GB HBM3, 700 W).
// This design does the K^2 work as matrix products on the tensor cores
// and walks tokens in order only within a chunk of C = 32, at O(C K) a
// token; its bound is its bytes (0.180 ms), with its products as three
// TF32 products each at 495 TFLOP/s far below.
//
// The chunked, division-free form.  Cut T into chunks of C tokens (a
// ragged last one padded with w = 1 and r, k, v, dy = 0).  In a chunk
// t0..t1, with S0 = S_{t0-1} and G1 = G_t1: a_t = prod_{t0<=i<t} w_i,
// b_t = prod_{t<i<=t1} w_i, W = prod_chunk w, d(s, t) = prod_{s<i<t} w_i,
// M = v dy^T (C x C), P_t = S0 dy_t, Q_t = G1 v_t.  Every decay is a running
// product, never a quotient (at w = 1e-6 a product of 16 tokens underflows,
// and a ratio of two would be 0/0).
//  1. rwkv6_bwd_summaries, one block a (head, chunk): (b k)^T v and
//     (a r)^T dy, K x C by C x K products on mma.sync TF32 in 3xTF32 (hi hi
//     + hi lo + lo hi, mma_sm90.cuh's tf32_split_int: ~2^-22 an operand;
//     single-pass TF32 misses the per-element tolerance), W, and the
//     chunk's share of du, sum_t r_t k_t (v_t . dy_t).
//  2. rwkv6_bwd_scan: S0 of chunk c + 1 = W_c S0_c + (b k)^T v of chunk c,
//     forward; G1 of chunk c - 1 = W_c G1_c + (a r)^T dy of chunk c,
//     backward; one thread a float4 of a head's K x K, eight chunks' loads
//     in flight, the two directions in separate blocks of one launch, each
//     chunk's summary overwritten in place by its state.  One block a head
//     sums du's chunk shares in chunk order.
//  3. rwkv6_bwd_grads, one block of 256 threads a (head, chunk), two groups
//     of four warps.  Both: P = dy S0^T and Q = v G1^T (lo), M = v dy^T,
//     a_t, b_t and rowsum(S0 G1) (hi), the products in 3xTF32.  Then, at
//     once, hi: A[t, tau] = sum_k k_t d(t, tau) r_tau (tau > t; sum u k_t r_t
//     on the diagonal) on the CUDA cores and dv = (k b) G1 + A dy on the
//     tensor cores; lo: per column of K, two threads:
//       forward in t:  Z_{t+1} = w_t Z_t + k_t M[t, .], T3_{t+1} = w_t T3_t + k_t Q_t,
//                      dr_t = a_t P_t + Z_t[t] + u k_t M[t, t];
//       backward in t: Y_{t-1} = w_t Y_t + r_t M[., t], T2_{t-1} = w_t T2_t + r_t P_t,
//                      dk_t = b_t Q_t + Y_t[t] + u r_t M[t, t];
//     and dw_t = a_t (b_t rowsum(S0 G1) + T2_t) + b_t T3_t + T4_t, where T4_t,
//     the sum over s < t < tau of d(s, t) d(t, tau) k_s r_tau M[s, tau], is
//     sum_tau d(t, tau) r_tau Z_t[tau] for t in the chunk's first half (the
//     forward thread) and sum_s d(s, t) k_s Y_t[s] in its second (the
//     backward one): 376 pairs each, by Horner's rule.  Z, Y and the
//     column's r or k live in registers; M is stored folded (its row t
//     holds M[t, tau >= t] and M[s < t, t]), so both threads read rows.
//  No atomics anywhere, so a rerun gives the same bits.  The scratch is
//  two states a (head, chunk) (2 x 128 MiB at (128, 2048, 64)) plus W and
//  du's shares.  Inputs arrive through 16-byte cp.async when every base and
//  stride allows it, else 4-byte; tokens past T are zero-filled and their
//  w set to 1 explicitly (a zero w would zero every b_t of the chunk).
//
// What holds it back (H100 80GB HBM3, 700 W): 1.06 ms at (128, 2048, 64),
// 22% of the FFMA bound, 17% of its own (summaries 0.20, scan 0.19,
// gradients 0.67 ms; tools/rwkv6_fault_check.py splits, which also times
// the truncating split at 1.03 ms and cvt.rna's at 1.12).  The first two
// move ~2.9 TB/s.  In the gradients kernel a block pair takes ~33k cycles an SM,
// 21k of them the column threads' loops, latency-bound at ~6 cycles an
// instruction with 16 warps an SM (shared memory and registers allow two
// blocks).
#include <limits.h>

#include "mma_sm90.cuh"

namespace {

constexpr int C = 32;        // tokens a chunk
constexpr int HALF = C / 2;  // T4's split between the two column threads
constexpr int THREADS = 128;
constexpr unsigned FULL = 0xffffffffu;

// c += a b in 3xTF32: the small products first, then hi * hi.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh[0], bh[1]);
  mma_tf32(c, ah, bl[0], bl[1]);
  mma_tf32(c, ah, bh[0], bh[1]);
}

// The A fragment of m16n8k8 (rows m0.., columns k0..) of the matrix whose
// element (m, kk) is at(m, kk), split into hi and lo.
template <class F>
__device__ __forceinline__ void frag_a(F at, int m0, int k0, int lane, uint32_t (&h)[4],
                                       uint32_t (&l)[4]) {
  const int g = lane >> 2, q = lane & 3;
  tf32_split_int(at(m0 + g, k0 + q), h[0], l[0]);
  tf32_split_int(at(m0 + g + 8, k0 + q), h[1], l[1]);
  tf32_split_int(at(m0 + g, k0 + q + 4), h[2], l[2]);
  tf32_split_int(at(m0 + g + 8, k0 + q + 4), h[3], l[3]);
}
// The B fragment (rows k0.., column n0..) of the matrix whose element
// (kk, n) is at(kk, n), split into hi and lo.
template <class F>
__device__ __forceinline__ void frag_b(F at, int k0, int n0, int lane, uint32_t (&h)[2],
                                       uint32_t (&l)[2]) {
  const int g = lane >> 2, q = lane & 3;
  tf32_split_int(at(k0 + q, n0 + g), h[0], l[0]);
  tf32_split_int(at(k0 + q + 4, n0 + g), h[1], l[1]);
}

// Rows t0..t0+C-1 of a (T, K) slice (row stride st floats, unit along K)
// into a [C][LD] tile; rows at or past `live` zero-filled.
template <int K, int LD, int NTH>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long st, int live,
                                          bool vec16, int tid) {
  if (vec16) {
    constexpr int V = K / 4;
    for (int x = tid; x < C * V; x += NTH) {
      const int t = x / V, c = x % V;
      const bool ok = t < live;
      cp_async16(smem_u32(dst + t * LD + 4 * c), src + (ok ? t * st + 4 * c : 0), ok);
    }
  } else {
    for (int x = tid; x < C * K; x += NTH) {
      const int t = x / K, c = x % K;
      const bool ok = t < live;
      cp_async4(smem_u32(dst + t * LD + c), src + (ok ? t * st + c : 0), ok);
    }
  }
}

struct Strides {
  long long sb, sh, st, usb, ush, dsb, dsh, dst, gsb, gsh, gst;
};

// ----------------------------------------------------------- 1. summaries

template <int K>
struct SumShape {
  static constexpr int KP = K < 16 ? 16 : K;  // rows of the summaries' mma tiles
  static constexpr int LD = KP + 8;           // row stride: fragment loads hit 32 banks
  static constexpr int ARR = C * LD;
  // r (then a r), k (then b k), v, w, dy [C][LD]; v_t . dy_t [C].
  static constexpr int FLOATS = 5 * ARR + C;
  static constexpr int MT = KP / 16, NT = K / 8;
  static constexpr int MW = MT >= 2 ? MT / 2 : 1;         // m-tiles a warp
  static constexpr int NW = MT >= 2 ? NT : (NT + 1) / 2;  // n-tiles a warp
};

template <int K>
__global__ void __launch_bounds__(THREADS)
rwkv6_bwd_summaries(const float* __restrict__ r, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ dy, float* __restrict__ sstate,
                    float* __restrict__ gstate, float* __restrict__ wprod,
                    float* __restrict__ dupart, int h_count, int t_len, int nch, Strides s,
                    int vec16) {
  using S = SumShape<K>;
  constexpr int LD = S::LD;
  extern __shared__ __align__(16) float smem[];
  float* rs = smem;
  float* ks = rs + S::ARR;
  float* vs = ks + S::ARR;
  float* ws = vs + S::ARR;
  float* dys = ws + S::ARR;
  float* vd = dys + S::ARR;

  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int c = blockIdx.x % nch;
  const long long bh = blockIdx.x / nch;
  const int b = (int)(bh / h_count), h = (int)(bh % h_count);
  const int t0 = c * C, live = min(C, t_len - t0);
  const long long in0 = b * s.sb + h * s.sh + t0 * s.st;
  const long long dy0 = b * s.dsb + h * s.dsh + t0 * s.dst;
  load_rows<K, LD, THREADS>(rs, r + in0, s.st, live, vec16, tid);
  load_rows<K, LD, THREADS>(ks, k + in0, s.st, live, vec16, tid);
  load_rows<K, LD, THREADS>(vs, v + in0, s.st, live, vec16, tid);
  load_rows<K, LD, THREADS>(ws, w + in0, s.st, live, vec16, tid);
  load_rows<K, LD, THREADS>(dys, dy + dy0, s.dst, live, vec16, tid);
  cp_async_commit();
  if constexpr (S::KP > K) {  // the mma tiles' padding rows of (a r)^T and (b k)^T
    for (int x = tid; x < C * (S::KP - K); x += THREADS) {
      const int t = x / (S::KP - K), col = K + x % (S::KP - K);
      rs[t * LD + col] = 0.f;
      ks[t * LD + col] = 0.f;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  // Padded tokens decay by 1 (cp.async's zero-fill would zero every b_t).
  for (int x = tid; x < (C - live) * K; x += THREADS) ws[(live + x / K) * LD + x % K] = 1.f;
  // v_t . dy_t: warp wp sums tokens 8 wp..8 wp+7 over K, the same butterfly in every lane.
  for (int i = 0; i < C / 4; ++i) {
    const int t = wp * (C / 4) + i;
    float p = 0.f;
    for (int j = lane; j < K; j += 32) p = fmaf(vs[t * LD + j], dys[t * LD + j], p);
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) p += __shfl_xor_sync(FULL, p, m);
    if (lane == 0) vd[t] = p;
  }
  __syncthreads();
  const long long cidx = bh * nch + c;
  if (tid < K) {  // the chunk's share of du, tokens in order
    float a = 0.f;
    for (int t = 0; t < C; ++t) a = fmaf(rs[t * LD + tid] * ks[t * LD + tid], vd[t], a);
    dupart[cidx * K + tid] = a;
  }
  __syncthreads();
  if (tid < K) {  // k <- b k (b from the chunk's end), and W
    float bb = 1.f;
    for (int t = C - 1; t >= 0; --t) {
      ks[t * LD + tid] *= bb;
      bb *= ws[t * LD + tid];
    }
    wprod[cidx * K + tid] = bb;
  } else if (tid >= 64 && tid < 64 + K) {  // r <- a r (a from the chunk's start)
    const int col = tid - 64;
    float aa = 1.f;
    for (int t = 0; t < C; ++t) {
      rs[t * LD + col] *= aa;
      aa *= ws[t * LD + col];
    }
  }
  __syncthreads();

  // Warps 0, 1: (b k)^T v; warps 2, 3: (a r)^T dy.  Element (i, j) sums
  // over the chunk's tokens t: A(i, t) = x[t][i], B(t, j) = y[t][j].
  const float* xa = wp < 2 ? ks : rs;
  const float* yb = wp < 2 ? vs : dys;
  float* out = (wp < 2 ? sstate : gstate) + cidx * K * K;
  const int half = wp & 1;
  const int m_first = S::MT >= 2 ? half * S::MW : 0;
  const int n_first = S::MT >= 2 ? 0 : half * S::NW;
  float acc[S::MW][S::NW][4];
#pragma unroll
  for (int mi = 0; mi < S::MW; ++mi)
#pragma unroll
    for (int ni = 0; ni < S::NW; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  auto at_a = [&](int m, int kk) { return xa[kk * LD + m]; };
  auto at_b = [&](int kk, int n) { return yb[kk * LD + n]; };
#pragma unroll
  for (int kq = 0; kq < C / 8; ++kq) {
    uint32_t ah[S::MW][4], al[S::MW][4];
#pragma unroll
    for (int mi = 0; mi < S::MW; ++mi) frag_a(at_a, (m_first + mi) * 16, kq * 8, lane, ah[mi], al[mi]);
#pragma unroll
    for (int ni = 0; ni < S::NW; ++ni) {
      if (n_first + ni >= S::NT) continue;
      uint32_t bh2[2], bl2[2];
      frag_b(at_b, kq * 8, (n_first + ni) * 8, lane, bh2, bl2);
#pragma unroll
      for (int mi = 0; mi < S::MW; ++mi) mma3(acc[mi][ni], ah[mi], al[mi], bh2, bl2);
    }
  }
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mi = 0; mi < S::MW; ++mi)
#pragma unroll
    for (int ni = 0; ni < S::NW; ++ni) {
      if (n_first + ni >= S::NT) continue;
      const int j = (n_first + ni) * 8 + 2 * q;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = (m_first + mi) * 16 + g + 8 * hh;
        if (i < K)
          *reinterpret_cast<float2*>(out + i * K + j) =
              make_float2(acc[mi][ni][2 * hh], acc[mi][ni][2 * hh + 1]);
      }
    }
}

// ---------------------------------------------------------------- 2. scan

constexpr int PF = 8;  // chunks of a thread's loads in flight

template <int K>
__global__ void __launch_bounds__(THREADS)
rwkv6_bwd_scan(float* __restrict__ sstate, float* __restrict__ gstate,
               const float* __restrict__ wprod, const float* __restrict__ dupart,
               float* __restrict__ du, int nch, int tiles, long long heads) {
  constexpr int N4 = K * K / 4;
  const int tid = threadIdx.x;
  const int tile = blockIdx.x % tiles;
  const long long rest = blockIdx.x / tiles;
  const long long bh = rest % heads;
  const int dir = (int)(rest / heads);  // 0: S forward, 1: G backward
  const int e = tile * THREADS + tid;
  float* base = (dir == 0 ? sstate : gstate) + bh * nch * K * K;
  const float* wp = wprod + bh * nch * K;
  if (e < N4) {
    const int row = 4 * e / K;
    auto chunk = [&](int i) { return dir == 0 ? i : nch - 1 - i; };
    float4 buf[PF];
    float wbuf[PF];
#pragma unroll
    for (int j = 0; j < PF; ++j) {
      if (j < nch) {
        buf[j] = reinterpret_cast<const float4*>(base + (long long)chunk(j) * K * K)[e];
        wbuf[j] = wp[(long long)chunk(j) * K + row];
      }
    }
    float4 carry = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i0 = 0; i0 < nch; i0 += PF) {
#pragma unroll
      for (int j = 0; j < PF; ++j) {
        const int i = i0 + j;
        if (i < nch) {
          const float4 d = buf[j];
          const float ww = wbuf[j];
          if (i + PF < nch) {
            buf[j] = reinterpret_cast<const float4*>(base + (long long)chunk(i + PF) * K * K)[e];
            wbuf[j] = wp[(long long)chunk(i + PF) * K + row];
          }
          reinterpret_cast<float4*>(base + (long long)chunk(i) * K * K)[e] = carry;
          carry = make_float4(fmaf(ww, carry.x, d.x), fmaf(ww, carry.y, d.y),
                              fmaf(ww, carry.z, d.z), fmaf(ww, carry.w, d.w));
        }
      }
    }
  }
  if (dir == 0 && tile == 0 && tid < K) {  // du: the chunks' shares in chunk order
    float a = 0.f;
    for (int c = 0; c < nch; ++c) a += dupart[(bh * nch + c) * K + tid];
    du[bh * K + tid] = a;
  }
}

// ------------------------------------------------------------- 3. gradients

constexpr int GTHREADS = 256;  // the gradients' block: two groups of four warps

template <int K>
struct GradShape {
  static constexpr int LD = K + 4;   // tiles the tensor cores read: fragment loads hit 32 banks
  static constexpr int LDK = K;      // tiles read a column a thread or a row at a time
  static constexpr int ARR = C * LD, ARRK = C * LDK;
  static constexpr int SREG = (K > 2 * C ? K : 2 * C) * LD;  // S0, then P and Q
  static constexpr int GREG = K * LD;                        // G1
  static constexpr int LDC = C + 4;                          // M and A rows
  // r, w, a [C][LDK]; k, v (then dw's forward share), dy, b [C][LD] | S0
  // (then P, Q) | G1 | M, A [C][LDC] | dw's backward share [C][LDK] |
  // rowsum(S0 G1) and its second halves, u.
  static constexpr int FLOATS = 3 * ARRK + 4 * ARR + SREG + GREG + 2 * C * LDC + ARRK + 3 * K;
  static constexpr int NT = K / 8;
  static constexpr int G4 = K / 4;   // columns a thread of A's phase
  static constexpr int VW = G4 < 4 ? G4 : 4;
};

// x[i] = w x[i] + c m[i] for the groups of four G0 <= i / 4 < G1, m read as
// float4s.
template <int G0, int G1, int N>
__device__ __forceinline__ void update_row(float (&x)[N], const float* m, float w, float c) {
#pragma unroll
  for (int g = G0; g < G1; ++g) {
    const float4 m4 = *reinterpret_cast<const float4*>(m + 4 * g);
    x[4 * g] = fmaf(w, x[4 * g], c * m4.x);
    x[4 * g + 1] = fmaf(w, x[4 * g + 1], c * m4.y);
    x[4 * g + 2] = fmaf(w, x[4 * g + 2], c * m4.z);
    x[4 * g + 3] = fmaf(w, x[4 * g + 3], c * m4.w);
  }
}

// v = x[4 g + off] for the group g of [G0, G0 + 2) that equals tg (off is
// a constant at every call, -1..4; an index off either end is never the
// one picked, and is skipped).
template <int G0, int N>
__device__ __forceinline__ void pick(float& v, const float (&x)[N], int tg, int off) {
#pragma unroll
  for (int g = G0; g < G0 + 2; ++g) {
    const int i = 4 * g + off;
    if (i >= 0 && i < N) v = g == tg ? x[i] : v;
  }
}

// VW consecutive floats of shared memory.
template <int VW>
__device__ __forceinline__ void ld_vec(const float* p, float* out) {
  if constexpr (VW == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x, out[1] = x.y, out[2] = x.z, out[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x, out[1] = x.y;
  }
}

// Phases (the four-warp groups, lo = warps 0-3 and hi = warps 4-7):
//   loads; w of padded tokens set to 1
//   lo: P (warps 0, 1) or Q (2, 3) for an m-tile | hi: a, b; rowsum(S0 G1); M
//   stores of P, Q (over S0) and M
//   lo: the two column threads | hi: A, then dv = (k b) G1 + A dy
//   dw = the two shares
template <int K>
__global__ void __launch_bounds__(GTHREADS, 2)
rwkv6_bwd_grads(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ dy,
                const float* __restrict__ sstate, const float* __restrict__ gstate,
                float* __restrict__ dr, float* __restrict__ dk, float* __restrict__ dv,
                float* __restrict__ dw, int h_count, int t_len, int nch, Strides s,
                int vec16) {
  using S = GradShape<K>;
  constexpr int LD = S::LD, LDK = S::LDK, LDC = S::LDC;
  extern __shared__ __align__(16) float smem[];
  float* rs = smem;
  float* ws = rs + S::ARRK;
  float* as = ws + S::ARRK;
  float* ks = as + S::ARRK;
  float* vs = ks + S::ARR;
  float* dys = vs + S::ARR;
  float* bs = dys + S::ARR;
  float* s0 = bs + S::ARR;
  float* g1 = s0 + S::SREG;
  float* ms = g1 + S::GREG;
  float* am = ms + C * LDC;
  float* dwb = am + C * LDC;
  float* rsum = dwb + S::ARRK;
  float* us = rsum + 2 * K;

  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const bool hi = wp >= 4;
  const int hw = wp & 3;  // warp within its group
  const int c = blockIdx.x % nch;
  const long long bh = blockIdx.x / nch;
  const int b = (int)(bh / h_count), h = (int)(bh % h_count);
  const int t0 = c * C, live = min(C, t_len - t0);
  const long long in0 = b * s.sb + h * s.sh + t0 * s.st;
  const long long dy0 = b * s.dsb + h * s.dsh + t0 * s.dst;
  const long long go0 = b * s.gsb + h * s.gsh + t0 * s.gst;
  load_rows<K, LDK, GTHREADS>(rs, r + in0, s.st, live, vec16, tid);
  load_rows<K, LD, GTHREADS>(ks, k + in0, s.st, live, vec16, tid);
  load_rows<K, LD, GTHREADS>(vs, v + in0, s.st, live, vec16, tid);
  load_rows<K, LDK, GTHREADS>(ws, w + in0, s.st, live, vec16, tid);
  load_rows<K, LD, GTHREADS>(dys, dy + dy0, s.dst, live, vec16, tid);
  {
    const long long st0 = (bh * nch + c) * K * K;
    for (int x = tid; x < K * K / 4; x += GTHREADS) {
      const int i = x / (K / 4), c4 = x % (K / 4);
      cp_async16(smem_u32(s0 + i * LD + 4 * c4), sstate + st0 + i * K + 4 * c4, true);
      cp_async16(smem_u32(g1 + i * LD + 4 * c4), gstate + st0 + i * K + 4 * c4, true);
    }
  }
  cp_async_commit();
  if (tid < K) us[tid] = u[b * s.usb + h * s.ush + tid];
  cp_async_wait<0>();
  __syncthreads();
  for (int x = tid; x < (C - live) * K; x += GTHREADS) ws[(live + x / K) * LDK + x % K] = 1.f;
  __syncthreads();

  // lo: P = dy S0^T (warps 0, 1) or Q = v G1^T (warps 2, 3), m-tile wp & 1,
  // every n-tile.  hi: a_t, b_t of every column, rowsum(S0 G1), and M = v
  // dy^T, m-tile wp & 1, n-tiles 2 (hw >> 1), +1.
  const int m0 = (wp & 1) * 16, mn0 = (hw >> 1) * 2;
  constexpr int NACC = S::NT > 2 ? S::NT : 2;
  float acc[NACC][4];
#pragma unroll
  for (int n = 0; n < NACC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  if (!hi) {
    const float* xa = wp < 2 ? dys : vs;
    const float* xb = wp < 2 ? s0 : g1;
    auto at_x = [&](int m, int kk) { return xa[m * LD + kk]; };
    auto bt_x = [&](int kk, int n) { return xb[n * LD + kk]; };
#pragma unroll 1
    for (int kq = 0; kq < K / 8; ++kq) {
      uint32_t xh[4], xl[4];
      frag_a(at_x, m0, kq * 8, lane, xh, xl);
#pragma unroll
      for (int n = 0; n < S::NT; ++n) {
        uint32_t bh2[2], bl2[2];
        frag_b(bt_x, kq * 8, n * 8, lane, bh2, bl2);
        mma3(acc[n], xh, xl, bh2, bl2);
      }
    }
  } else {
    const int ht = tid - 128;
    if (ht < K) {
      float aa = 1.f;
#pragma unroll
      for (int t = 0; t < C; ++t) {
        as[t * LDK + ht] = aa;
        aa *= ws[t * LDK + ht];
      }
    } else if (ht >= 64 && ht < 64 + K) {
      const int col = ht - 64;
      float bb = 1.f;
#pragma unroll
      for (int t = C - 1; t >= 0; --t) {
        bs[t * LD + col] = bb;
        bb *= ws[t * LDK + col];
      }
    }
    // rowsum(S0 G1): a thread a half row (columns rotated by the row: the
    // lanes' reads hit distinct banks); the halves meet in row order.
    constexpr int HK = K / 2;
    float p = 0.f;
    const int row = ht % K, half = ht / K;
    if (ht < 2 * K) {
#pragma unroll 8
      for (int jj = 0; jj < HK; ++jj) {
        const int j = half * HK + (jj + row) % HK;
        p = fmaf(s0[row * LD + j], g1[row * LD + j], p);
      }
      if (half == 1) rsum[K + row] = p;
    }
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    if (ht < K) rsum[row] = p + rsum[K + row];
    auto at_v = [&](int m, int kk) { return vs[m * LD + kk]; };
    auto bt_dy = [&](int kk, int n) { return dys[n * LD + kk]; };
#pragma unroll 1
    for (int kq = 0; kq < K / 8; ++kq) {
      uint32_t vh[4], vl[4];
      frag_a(at_v, m0, kq * 8, lane, vh, vl);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        uint32_t bh2[2], bl2[2];
        frag_b(bt_dy, kq * 8, (mn0 + n) * 8, lane, bh2, bl2);
        mma3(acc[n], vh, vl, bh2, bl2);
      }
    }
  }
  __syncthreads();  // every read of S0 is done: P and Q take its place
  if (!hi) {
    float* pq = s0 + (wp < 2 ? 0 : C * LD);
#pragma unroll
    for (int n = 0; n < S::NT; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(pq + (m0 + g + 8 * hh) * LD + n * 8 + 2 * q) =
            make_float2(acc[n][2 * hh], acc[n][2 * hh + 1]);
  } else {
    // M folded: its upper triangle (with the diagonal) in place, and
    // transposed into the lower one, so that row t holds M[t, tau] for tau
    // >= t and M[s, t] for s < t -- a forward thread's row and a backward
    // thread's column, both read along a row.  M's own lower triangle is
    // never read.
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = m0 + g + 8 * hh, col = (mn0 + n) * 8 + 2 * q + e;
          if (col >= row) ms[row * LDC + col] = acc[n][2 * hh + e];
          if (col > row) ms[col * LDC + row] = acc[n][2 * hh + e];
        }
  }
  __syncthreads();
  const float* ps = s0;
  const float* qs = s0 + C * LD;

  if (hi) {
    // A[t, tau]: thread (t = 8 hw + g, column group q) over its K/4 columns
    // (vectors of VW at VW q + 4 VW j); the four groups meet by shuffles,
    // the same order in every lane.
    {
      constexpr int NV = S::G4 / S::VW;
      const int t = hw * 8 + g;
      float kd[S::G4];  // k_t d(t, tau), a running product
      float diag = 0.f;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int c0 = S::VW * q + 4 * S::VW * j;
        float rv[S::VW];
        ld_vec<S::VW>(ks + t * LD + c0, kd + j * S::VW);
        ld_vec<S::VW>(rs + t * LDK + c0, rv);
#pragma unroll
        for (int e = 0; e < S::VW; ++e) diag = fmaf(us[c0 + e] * kd[j * S::VW + e], rv[e], diag);
      }
      diag += __shfl_xor_sync(FULL, diag, 1);
      diag += __shfl_xor_sync(FULL, diag, 2);
      if (q == 0) {
        for (int tau = 0; tau < t; ++tau) am[t * LDC + tau] = 0.f;
        am[t * LDC + t] = diag;
      }
      for (int tau = hw * 8 + 1; tau < C; ++tau) {  // warp-uniform: broadcast reads
        const bool on = tau > t, step = tau > t + 1;
        float pp[4] = {0.f, 0.f, 0.f, 0.f};  // four chains, summed in a fixed order
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int c0 = S::VW * q + 4 * S::VW * j;
          float wv[S::VW], rv[S::VW];
          ld_vec<S::VW>(ws + (tau - 1) * LDK + c0, wv);
          ld_vec<S::VW>(rs + tau * LDK + c0, rv);
#pragma unroll
          for (int e = 0; e < S::VW; ++e) {
            const int i = j * S::VW + e;
            if (step) kd[i] *= wv[e];
            pp[i % 4] = fmaf(kd[i], rv[e], pp[i % 4]);
          }
        }
        float part = on ? (pp[0] + pp[1]) + (pp[2] + pp[3]) : 0.f;
        part += __shfl_xor_sync(FULL, part, 1);
        part += __shfl_xor_sync(FULL, part, 2);
        if (on && q == 0) am[t * LDC + tau] = part;
      }
    }
    asm volatile("bar.sync 1, 128;\n" ::: "memory");  // A is whole (warps 4-7 only)

    // dv = (k b) G1 + A dy: m-tile wp & 1, half the n-tiles by hw >> 1.
    constexpr int NW = (S::NT + 1) / 2;
    const int n_first = (hw >> 1) * NW;
#pragma unroll
    for (int n = 0; n < NW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    auto at_kb = [&](int m, int kk) { return ks[m * LD + kk] * bs[m * LD + kk]; };
    auto bt_g = [&](int kk, int n) { return g1[kk * LD + n]; };
    auto at_am = [&](int m, int kk) { return am[m * LDC + kk]; };
    auto bt_dy = [&](int kk, int n) { return dys[kk * LD + n]; };
#pragma unroll 1
    for (int kq = 0; kq < K / 8; ++kq) {
      uint32_t ah[4], al[4];
      frag_a(at_kb, m0, kq * 8, lane, ah, al);
#pragma unroll
      for (int n = 0; n < NW; ++n) {
        if (n_first + n >= S::NT) continue;
        uint32_t bh2[2], bl2[2];
        frag_b(bt_g, kq * 8, (n_first + n) * 8, lane, bh2, bl2);
        mma3(acc[n], ah, al, bh2, bl2);
      }
    }
#pragma unroll 1
    for (int kq = 0; kq < C / 8; ++kq) {
      uint32_t ah[4], al[4];
      frag_a(at_am, m0, kq * 8, lane, ah, al);
#pragma unroll
      for (int n = 0; n < NW; ++n) {
        if (n_first + n >= S::NT) continue;
        uint32_t bh2[2], bl2[2];
        frag_b(bt_dy, kq * 8, (n_first + n) * 8, lane, bh2, bl2);
        mma3(acc[n], ah, al, bh2, bl2);
      }
    }
#pragma unroll
    for (int n = 0; n < NW; ++n) {
      if (n_first + n >= S::NT) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = m0 + g + 8 * hh;
        if (t < live) {
          float* o = dv + go0 + t * s.gst + (n_first + n) * 8 + 2 * q;
          o[0] = acc[n][2 * hh];
          o[1] = acc[n][2 * hh + 1];
        }
      }
    }
  } else {
    // Two threads a column: forward in t (dr, dw's forward share into v's
    // tile) and backward in t (dk, dw's backward share).  The loops over t
    // run by groups of four t, each group unrolled, so that every test of a
    // pair's side against t is static or a uniform branch on the group (t
    // is the same in every thread): no per-pair predicate.  Z and Y are
    // updated a pair of groups of four at a time, from (or up to) the pair
    // holding t: the entries on t's near side are never read again, so
    // they may take the update too.  Z, Y and the column's r or k and w
    // live in registers; T4 is summed by Horner's rule.  (Fully unrolled
    // over t the loops ran slower: 2.0 ms a call at the eval shape against
    // 1.47 rolled, H100 80GB HBM3, 700 W.)
    const int colk = tid & 63;
    if (colk < K) {
      const float uc = us[colk];
      if (tid < 64) {
        float rr[C], wv[C], z[C];
#pragma unroll
        for (int i = 0; i < C; ++i) {
          rr[i] = rs[i * LDK + colk];
          wv[i] = ws[i * LDK + colk];
          z[i] = 0.f;
        }
        float t3 = 0.f, zt = 0.f;  // zt: Z_t[t]
#pragma unroll 1
        for (int tg = 0; tg < C / 4; ++tg) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int t = 4 * tg + j;
            const float kt = ks[t * LD + colk], wt = ws[t * LDK + colk];
            const float at = as[t * LDK + colk], bt = bs[t * LD + colk];
            const float* mrow = ms + t * LDC;
            if (t < live)
              dr[go0 + t * s.gst + colk] = fmaf(at, ps[t * LD + colk], zt) + uc * kt * mrow[t];
            float dwa = bt * t3;
            if (tg < HALF / 4) {  // T4_t = sum_{tau > t} d(t, tau) r_tau Z_t[tau], from tau = C - 1
              float hs = 0.f;
#pragma unroll
              for (int g4 = C / 4 - 1; g4 >= 0; --g4) {
                if (g4 >= HALF / 4 || g4 > tg) {  // tg < HALF / 4 here
#pragma unroll
                  for (int i = 3; i >= 0; --i) hs = fmaf(wv[4 * g4 + i], hs, rr[4 * g4 + i] * z[4 * g4 + i]);
                } else if (g4 == tg) {
#pragma unroll
                  for (int i = 3; i > j; --i) hs = fmaf(wv[4 * g4 + i], hs, rr[4 * g4 + i] * z[4 * g4 + i]);
                }
              }
              dwa += hs;
            }
            vs[t * LD + colk] = dwa;
            // Z_{t+1}[tau] = w_t Z_t[tau] + k_t M[t, tau], tau > t, from the
            // pair holding t on; zt = Z_{t+1}[t+1] selected from the pair's
            // two candidates.
            if (tg < 2) {
              update_row<0, C / 4>(z, mrow, wt, kt);
              pick<0>(zt, z, tg, j + 1);
            } else if (tg < 4) {
              update_row<2, C / 4>(z, mrow, wt, kt);
              pick<2>(zt, z, tg, j + 1);
            } else if (tg < 6) {
              update_row<4, C / 4>(z, mrow, wt, kt);
              pick<4>(zt, z, tg, j + 1);
            } else {
              update_row<6, C / 4>(z, mrow, wt, kt);
              pick<6>(zt, z, tg, j + 1);
            }
            t3 = fmaf(wt, t3, kt * qs[t * LD + colk]);
          }
        }
      } else {
        float kk[C], wv[C], y[C];
#pragma unroll
        for (int i = 0; i < C; ++i) {
          kk[i] = ks[i * LD + colk];
          wv[i] = ws[i * LDK + colk];
          y[i] = 0.f;
        }
        const float rsc = rsum[colk];
        float t2 = 0.f, yt = 0.f;  // yt: Y_t[t]
#pragma unroll 1
        for (int tg = C / 4 - 1; tg >= 0; --tg) {
#pragma unroll
          for (int j = 3; j >= 0; --j) {
            const int t = 4 * tg + j;
            const float rt = rs[t * LDK + colk], wt = ws[t * LDK + colk];
            const float at = as[t * LDK + colk], bt = bs[t * LD + colk];
            if (t < live)
              dk[go0 + t * s.gst + colk] = fmaf(bt, qs[t * LD + colk], yt) + uc * rt * ms[t * LDC + t];
            float dwbt = at * fmaf(bt, rsc, t2);
            if (tg >= HALF / 4) {  // T4_t = sum_{s < t} d(s, t) k_s Y_t[s], from s = 0
              float hs = 0.f;
#pragma unroll
              for (int g4 = 0; g4 < C / 4; ++g4) {
                if (g4 < HALF / 4 || g4 < tg) {  // tg >= HALF / 4 here
#pragma unroll
                  for (int i = 0; i < 4; ++i) hs = fmaf(wv[4 * g4 + i], hs, kk[4 * g4 + i] * y[4 * g4 + i]);
                } else if (g4 == tg) {
#pragma unroll
                  for (int i = 0; i < j; ++i) hs = fmaf(wv[4 * g4 + i], hs, kk[4 * g4 + i] * y[4 * g4 + i]);
                }
              }
              dwbt += hs;
            }
            dwb[t * LDK + colk] = dwbt;
            // Y_{t-1}[s] = w_t Y_t[s] + r_t M[s, t], s < t (folded M's row t),
            // up to the pair holding t; yt = Y_{t-1}[t-1].
            if (tg >= 6) {
              update_row<0, C / 4>(y, ms + t * LDC, wt, rt);
              pick<6>(yt, y, tg, j - 1);
            } else if (tg >= 4) {
              update_row<0, 6>(y, ms + t * LDC, wt, rt);
              pick<4>(yt, y, tg, j - 1);
            } else if (tg >= 2) {
              update_row<0, 4>(y, ms + t * LDC, wt, rt);
              pick<2>(yt, y, tg, j - 1);
            } else {
              update_row<0, 2>(y, ms + t * LDC, wt, rt);
              pick<0>(yt, y, tg, j - 1);
            }
            t2 = fmaf(wt, t2, rt * ps[t * LD + colk]);
          }
        }
      }
    }
  }
  __syncthreads();
  for (int x = tid; x < live * K; x += GTHREADS) {
    const int t = x / K, col = x % K;
    dw[go0 + t * s.gst + col] = vs[t * LD + col] + dwb[t * LDK + col];
  }
}

template <class F>
int set_smem(F* fn, size_t bytes) {
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int K>
int launch(const float* const* ins, const float* u, float* const* outs, float* du,
           float* scratch, int b, int h, int t_len, const Strides& s, int chunk, int nch,
           int tiles, long long scratch_floats, int vec16, cudaStream_t st) {
  const long long heads = (long long)b * h;
  // The wrapper's plan (ops.bwd_plan) gives the grids and sizes the
  // scratch: refuse one that disagrees with the kernels.
  if (chunk != C || nch != (t_len + C - 1) / C ||
      tiles != (K * K / 4 + THREADS - 1) / THREADS ||
      scratch_floats != heads * nch * (2LL * K * K + 2 * K))
    return (int)cudaErrorInvalidValue;
  if (heads * nch > INT_MAX || heads * tiles * 2 > INT_MAX) return (int)cudaErrorInvalidValue;
  const size_t smem1 = SumShape<K>::FLOATS * sizeof(float);
  const size_t smem3 = GradShape<K>::FLOATS * sizeof(float);
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    int e = set_smem(rwkv6_bwd_summaries<K>, smem1);
    if (e == 0) e = set_smem(rwkv6_bwd_grads<K>, smem3);
    if (e != 0) return e;
    configured = true;
  }
  float* sstate = scratch;
  float* gstate = sstate + heads * nch * K * K;
  float* wprod = gstate + heads * nch * K * K;
  float* dupart = wprod + heads * nch * K;
  rwkv6_bwd_summaries<K><<<(unsigned)(heads * nch), THREADS, smem1, st>>>(
      ins[0], ins[1], ins[2], ins[3], ins[4], sstate, gstate, wprod, dupart, h, t_len, nch, s,
      vec16);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  rwkv6_bwd_scan<K><<<(unsigned)(heads * tiles * 2), THREADS, 0, st>>>(
      sstate, gstate, wprod, dupart, du, nch, tiles, heads);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  rwkv6_bwd_grads<K><<<(unsigned)(heads * nch), GTHREADS, smem3, st>>>(
      ins[0], ins[1], ins[2], ins[3], u, ins[4], sstate, gstate, outs[0], outs[1], outs[2],
      outs[3], h, t_len, nch, s, vec16);
  return (int)cudaGetLastError();
}

}  // namespace

// r/k/v/w (B, H, T, K) fp32 sharing the element strides (sb, sh, st) and
// unit stride along K; u (B, H, K) fp32 with strides (usb, ush, 1); dy like
// r with strides (dsb, dsh, dst, 1); dr/dk/dv/dw like r sharing strides
// (gsb, gsh, gst, 1); du (B, H, K) fp32 contiguous; the plan's chunk (32),
// chunks a head (ceil(T / 32)), scan tiles a head and direction
// (ceil(K K / 512)) and scratch floats (B H chunks (2 K K + 2 K)), each
// checked, and the scratch, 16-byte aligned (ops.bwd_plan).  vec16: every
// input base and stride is a multiple of 16 bytes (16-byte copies), else
// 4-byte copies.  K in {8, 16, 32, 64}, T >= 1.  Returns
// cudaGetLastError() (or cudaErrorInvalidValue for unsupported arguments).
extern "C" int rwkv6_bwd_launch(const void* r, const void* k, const void* v, const void* w,
                                const void* u, const void* dy, void* dr, void* dk, void* dv,
                                void* dw, void* du, void* scratch, int b, int h, int t_len,
                                int kd, long long sb, long long sh, long long st,
                                long long usb, long long ush, long long dsb, long long dsh,
                                long long dst, long long gsb, long long gsh, long long gst,
                                int chunk, int nch, int tiles, long long scratch_floats,
                                int vec16, void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (b < 1 || h < 1 || t_len < 1) return (int)cudaErrorInvalidValue;
  const Strides s{sb, sh, st, usb, ush, dsb, dsh, dst, gsb, gsh, gst};
  const float* ins[5] = {(const float*)r, (const float*)k, (const float*)v, (const float*)w,
                         (const float*)dy};
  float* outs[4] = {(float*)dr, (float*)dk, (float*)dv, (float*)dw};
  const float* uf = (const float*)u;
  float *duf = (float*)du, *sc = (float*)scratch;
  switch (kd) {
    case 8:
      return launch<8>(ins, uf, outs, duf, sc, b, h, t_len, s, chunk, nch, tiles,
                       scratch_floats, vec16, cs);
    case 16:
      return launch<16>(ins, uf, outs, duf, sc, b, h, t_len, s, chunk, nch, tiles,
                        scratch_floats, vec16, cs);
    case 32:
      return launch<32>(ins, uf, outs, duf, sc, b, h, t_len, s, chunk, nch, tiles,
                        scratch_floats, vec16, cs);
    case 64:
      return launch<64>(ins, uf, outs, duf, sc, b, h, t_len, s, chunk, nch, tiles,
                        scratch_floats, vec16, cs);
    default: return (int)cudaErrorInvalidValue;
  }
}
