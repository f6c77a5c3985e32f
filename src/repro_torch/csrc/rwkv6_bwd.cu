// RWKV-6 recurrence backward for Hopper (training): given the forward's
// inputs r/k/v/w (B, H, T, K) fp32, u (B, H, K) fp32 and dy (B, H, T, K)
// fp32, computes dr, dk, dv, dw (B, H, T, K) and du (B, H, K) for the
// forward of csrc/rwkv6.cu
//
//     y_t = r_t . (S_{t-1} + diag(u) k_t^T v_t)
//     S_t = diag(w_t) S_{t-1} + k_t^T v_t           (S_{-1} = 0, no final-state grad)
//
// With G_t = dL/dS_t (G_{T-1} = 0), walking t down:
//
//     dr_t[k] = sum_v dy_t[v] S_{t-1}[k, v] + u[k] k_t[k] (dy_t . v_t)
//     dk_t[k] = sum_v G_t[k, v] v_t[v]      + u[k] r_t[k] (dy_t . v_t)
//     dv_t[v] = sum_k k_t[k] G_t[k, v]      + dy_t[v] sum_k u[k] k_t[k] r_t[k]
//     dw_t[k] = sum_v S_{t-1}[k, v] G_t[k, v]
//     du[k]   = sum_t r_t[k] k_t[k] (dy_t . v_t)
//     G_{t-1} = diag(w_t) G_t + r_t^T dy_t
//
// Replaces no TPU kernel: the reference differentiates its lax.scan
// (src/repro/models/rwkv6.py, rwkv_time_mix) through XLA; its Pallas
// kernel (src/repro/kernels/rwkv6/rwkv6.py) has no VJP.  The port runs the
// model's recurrence through csrc/rwkv6.cu, which autograd cannot
// differentiate, so training RWKV-6 on the card needs this one.
//
// What bounds it here: per token and head ~14 K^2 fp32 FLOPs of the
// function (S stepped once, 3 K^2; the sums of dr, dk, dw, dv, 8 K^2; G's
// update, 3 K^2) against 9 K elements of traffic: ~24 FLOP/byte, about the
// card's fp32 ridge (67 TFLOP/s over 3.35 TB/s = 20), so operations bound
// it on paper (0.228 ms at (128, 2048, 64)).  And, as in the forward, a
// head's tokens run in order, so a step's critical path multiplies by T.
//
// Design (a first, simple kernel: right before fast).
//  * Every term but dv is local to a row of S and G, so the forward's split
//    carries over: a cluster of K/16 blocks a head (one block for K <= 16),
//    block q owning rows 16q..16q+15.  Thread (j, cg) of a block holds
//    row j's CPT columns {VW cg + VW CG i + e} of S and of G in registers
//    (CPT 8 at K 64, so 128 threads a block).
//  * One kernel, two passes over a head's chunks of L = 8 tokens.  Pass 1
//    steps S forward through chunks 0..n-2 and stores the state at each
//    chunk's start into a scratch the wrapper allocates (B H, chunks, K, K)
//    fp32; each thread stores and later reloads only its own elements (a
//    chunk ahead, into registers).  Pass 2 walks the chunks from the last:
//    from the chunk's start it steps S forward again, keeping S_{t-1} of
//    the chunk's tokens in shared memory, then walks back through them
//    with G in registers.  S and G are rounded as the plain scan rounds S
//    (a product, a product, a sum; no fused multiply-add), so they are the
//    plain version's bit for bit and the gradients differ from it only by
//    summation order.
//  * Sums in a fixed order: a row's partial sums of dr, dk, dw and dy . v
//    over its column groups meet by a butterfly of shuffles (the same
//    order, so the same bits, in every lane); each thread leaves k_t[j]
//    G_t[j, c] in S_{t-1}'s spent slot, and after a barrier the block adds
//    its rows' dv partials in row order.  Those meet through distributed
//    shared memory, as the forward's y does: block q sums its columns'
//    partials from every block of the cluster in rank order
//    (double-buffered by chunk parity, one cluster barrier a chunk).  du
//    sums over T within the block, one thread a row.  No atomics: a rerun
//    gives the same bits.
//  * The next two chunks' r, k, w (this block's rows), v and dy (all
//    columns) are in flight while a chunk computes: a 3-stage ring of
//    4-byte cp.async (any strides; src-size 0 zero-fills past T; pass 1
//    reads k, w, v only).
//  * 54 KB of shared memory a block at K 64 (dynamic), at most 128
//    registers: four blocks an SM, so a (4 x 32)-head batch's 512 blocks
//    run in one wave.
//
// What holds it back (H100 80GB HBM3, 700 W): 4.13 ms at (128, 2048, 64),
// 5.5% of the bound.  A thread issues ~210 instructions a token (26 an
// element of its S and G: the two forward steps, four sums, G's exactly
// rounded update, the stash and the shuffles), at about a quarter of the
// SM's issue rate with 16 warps an SM: the S and G chains and a barrier
// pair and a cluster barrier every 8 tokens.  The first version (partial
// sums through shared memory, two stages, the chunk state loaded at the
// chunk's start, three blocks an SM: two waves) ran 4.58 ms.
#include <cooperative_groups.h>
#include <limits.h>

#include "mma_sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int L = 8;        // tokens a chunk
constexpr int MAX_Q = 16;   // rows of S (and columns of dv) a block owns
constexpr int STAGES = 3;   // chunks in the cp.async ring
constexpr unsigned FULL = 0xffffffffu;

template <int K>
struct Shape {
  static constexpr int Q = K < MAX_Q ? K : MAX_Q;  // rows of S a block owns
  static constexpr int NSLICE = K / Q;             // blocks a head = cluster size
  static constexpr int CPT = K == 64 ? 8 : K == 8 ? 2 : 4;  // columns a thread holds
  static constexpr int VW = CPT < 4 ? CPT : 4;     // floats a vector access
  static constexpr int NV = CPT / VW;              // vectors of a thread's columns
  static constexpr int CG = K / CPT;               // column groups: threads a row
  static constexpr int THREADS = Q * CG;
  // Shared memory, in floats: S_{t-1} of the chunk's tokens [L][Q][K] (then
  // the dv partials k_t[j] G_t[j, c] in the same slots); the rows' sums
  // over their columns of dr, dk, dw [L][3][Q]; STAGES input stages, each
  // r, k, w [L][Q] and v, dy [L][K]; the cluster's dv partials by chunk
  // parity [2][NSLICE][L][Q]; dy_t . v_t and sum_j u k r of the chunk's
  // tokens [L] each; u of the block's rows [Q].
  static constexpr int STASH = L * Q * K;
  static constexpr int PART = L * 3 * Q;
  static constexpr int STAGE = 3 * L * Q + 2 * L * K;
  static constexpr int XCH = 2 * NSLICE * L * Q;
  static constexpr int FLOATS = STASH + PART + STAGES * STAGE + XCH + 2 * L + Q;
  // Four blocks an SM at K 64 (54.1 KB each): 512 blocks of (4 x 32)-head
  // batches run in one wave.
  static constexpr int MIN_BLOCKS = 4;
  static_assert(THREADS % 32 == 0 && 32 % CG == 0 && L <= THREADS,
                "whole warps, a row's column groups in one warp, ukr a thread each");
  static_assert(STASH % 4 == 0 && PART % 4 == 0 && STAGE % 4 == 0, "vector-aligned regions");
};

// A thread's CPT columns of a row (shared or global), VW floats a vector.
template <int K>
__device__ __forceinline__ void load_cols(const float* row, int cgi,
                                          float (&out)[Shape<K>::CPT]) {
  using S = Shape<K>;
#pragma unroll
  for (int i = 0; i < S::NV; ++i) {
    const float* p = row + S::VW * cgi + S::VW * S::CG * i;
    if constexpr (S::VW == 4) {
      const float4 x = *reinterpret_cast<const float4*>(p);
      out[4 * i] = x.x, out[4 * i + 1] = x.y, out[4 * i + 2] = x.z, out[4 * i + 3] = x.w;
    } else {
      const float2 x = *reinterpret_cast<const float2*>(p);
      out[2 * i] = x.x, out[2 * i + 1] = x.y;
    }
  }
}
template <int K>
__device__ __forceinline__ void store_cols(float* row, int cgi,
                                           const float (&in)[Shape<K>::CPT]) {
  using S = Shape<K>;
#pragma unroll
  for (int i = 0; i < S::NV; ++i) {
    float* p = row + S::VW * cgi + S::VW * S::CG * i;
    if constexpr (S::VW == 4)
      *reinterpret_cast<float4*>(p) = make_float4(in[4 * i], in[4 * i + 1], in[4 * i + 2],
                                                  in[4 * i + 3]);
    else
      *reinterpret_cast<float2*>(p) = make_float2(in[2 * i], in[2 * i + 1]);
  }
}

template <int K>
__global__ void __launch_bounds__(Shape<K>::THREADS, Shape<K>::MIN_BLOCKS)
rwkv6_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, const float* __restrict__ dy,
                 float* __restrict__ dr, float* __restrict__ dk, float* __restrict__ dv,
                 float* __restrict__ dw, float* __restrict__ du, float* ckpt, int h_count,
                 int t_len, long long sb, long long sh, long long st, long long usb,
                 long long ush, long long dsb, long long dsh, long long dst, long long gsb,
                 long long gsh, long long gst) {
  using S = Shape<K>;
  constexpr int Q = S::Q, NSLICE = S::NSLICE, CPT = S::CPT, CG = S::CG;
  constexpr int THREADS = S::THREADS;
  extern __shared__ __align__(16) float smem[];
  float* stash = smem;
  float* part = stash + S::STASH;
  float* stages = part + S::PART;
  float* xch = stages + STAGES * S::STAGE;
  float* dyv_s = xch + S::XCH;
  float* ukr_s = dyv_s + L;
  float* u_s = ukr_s + L;

  const int tid = threadIdx.x;
  const int rank = blockIdx.x % NSLICE;  // the block's rank in its cluster
  const int bh = blockIdx.x / NSLICE;
  const int b = bh / h_count, h = bh % h_count;
  const int q0 = rank * Q;  // this block's rows of S, and its columns of dv
  const long long in_base = b * sb + h * sh;
  const long long dy_base = b * dsb + h * dsh;
  const long long g_base = b * gsb + h * gsh;
  const int j = tid / CG, cgi = tid % CG;  // row j's column group cgi
  const int nch = (t_len + L - 1) / L;
  // This head's chunk-start states, [chunk][K][K]; row q0 + j of each.
  float* ck = ckpt + (long long)bh * nch * K * K + (long long)(q0 + j) * K;

  // Items 0..nch-2 are pass 1 over chunks 0..nch-2; items nch-1..2 nch-2
  // are pass 2 over chunks nch-1..0.
  const int items = 2 * nch - 1;
  auto chunk_of = [&](int i) { return i < nch - 1 ? i : 2 * nch - 2 - i; };
  // Item i's inputs into stage i % STAGES; one commit group an item, empty
  // past the last.
  auto load = [&](int i) {
    if (i < items) {
      const bool fwd = i < nch - 1;  // pass 1 reads k, w, v only
      const int t0 = chunk_of(i) * L;
      float* sg = stages + (i % STAGES) * S::STAGE;
      constexpr int NQ = 3 * L * Q, N = NQ + 2 * L * K;
      for (int x = tid; x < N; x += THREADS) {
        int t, which;
        const float* src;
        if (x < NQ) {
          which = x / (L * Q);
          const int rem = x % (L * Q);
          t = rem / Q;
          src = (which == 0 ? r : which == 1 ? k : w) + in_base + q0 + rem % Q;
        } else {
          const int rem = x - NQ;
          which = 3 + rem / (L * K);
          t = rem % (L * K) / K;
          src = (which == 3 ? v + in_base : dy + dy_base) + rem % K;
        }
        if (fwd && (which == 0 || which == 4)) continue;
        const bool live = t0 + t < t_len;
        if (live) src += (long long)(t0 + t) * (which == 4 ? dst : st);
        cp_async4(smem_u32(sg + x), src, live);  // the stage's layout is x's order
      }
    }
    cp_async_commit();
  };

  if (tid < Q) u_s[tid] = u[b * usb + h * ush + q0 + tid];
  // snext: the start state of the next pass-2 chunk, loaded a chunk ahead.
  float sreg[CPT], greg[CPT], snext[CPT];
#pragma unroll
  for (int e = 0; e < CPT; ++e) sreg[e] = greg[e] = snext[e] = 0.f;
  float du_acc = 0.f;  // threads tid < Q: du of row q0 + tid

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) load(i);
  if constexpr (NSLICE > 1) cg::this_cluster().sync();  // every block runs before any remote store

  for (int i = 0; i < items; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // item i has landed; item i - 1 is done with every buffer
    load(i + STAGES - 1);
    const float* sg = stages + (i % STAGES) * S::STAGE;
    const float *rs = sg, *ks = sg + L * Q, *ws = sg + 2 * L * Q;
    const float *vs = sg + 3 * L * Q, *dys = vs + L * K;
    const int c = chunk_of(i);
    const int t0 = c * L, steps = min(L, t_len - t0);

    // S = w S + k^T v for token t, rounded as the plain scan.
    auto step_s = [&](int t) {
      float vv[CPT];
      load_cols<K>(vs + t * K, cgi, vv);
      const float kj = ks[t * Q + j], wj = ws[t * Q + j];
#pragma unroll
      for (int e = 0; e < CPT; ++e)
        sreg[e] = __fadd_rn(__fmul_rn(wj, sreg[e]), __fmul_rn(kj, vv[e]));
    };

    if (i < nch - 1) {  // pass 1: chunk c in full (c < nch - 1), then chunk c + 1's start
#pragma unroll
      for (int t = 0; t < L; ++t) step_s(t);
      if (c + 1 < nch - 1) store_cols<K>(ck + (long long)(c + 1) * K * K, cgi, sreg);
      continue;
    }

    // Pass 2, chunk c: its start state (pass 1 left chunk nch - 1's in
    // sreg; snext holds the others), then chunk c - 1's requested.
    if (c < nch - 1) {
#pragma unroll
      for (int e = 0; e < CPT; ++e) sreg[e] = snext[e];
    }
    if (c > 1) {
      load_cols<K>(ck + (long long)(c - 1) * K * K, cgi, snext);
    } else {
#pragma unroll
      for (int e = 0; e < CPT; ++e) snext[e] = 0.f;
    }
    // The block's sum_j u k r of each token (read after the barrier below).
    if (tid < L) {
      float a = 0.f;
      for (int jj = 0; jj < Q; ++jj)
        a = fmaf(u_s[jj] * ks[tid * Q + jj], rs[tid * Q + jj], a);
      ukr_s[tid] = a;
    }
    // Forward through the chunk, keeping S_{t-1} of each token.
#pragma unroll
    for (int t = 0; t < L; ++t) {
      if (t < steps) {
        store_cols<K>(stash + (t * Q + j) * K, cgi, sreg);
        step_s(t);
      }
    }
    // Back through it: G holds G_t on entry to token t, G_{t-1} after.
#pragma unroll
    for (int t = L - 1; t >= 0; --t) {
      if (t < steps) {
        float sp[CPT], dyr[CPT], vv[CPT], dvp[CPT];
        float* slot = stash + (t * Q + j) * K;
        load_cols<K>(slot, cgi, sp);
        load_cols<K>(dys + t * K, cgi, dyr);
        load_cols<K>(vs + t * K, cgi, vv);
        const float rj = rs[t * Q + j], kj = ks[t * Q + j], wj = ws[t * Q + j];
        float pr = 0.f, pk = 0.f, pw = 0.f, pd = 0.f;
#pragma unroll
        for (int e = 0; e < CPT; ++e) {
          pr = fmaf(sp[e], dyr[e], pr);
          pk = fmaf(greg[e], vv[e], pk);
          pw = fmaf(sp[e], greg[e], pw);
          pd = fmaf(dyr[e], vv[e], pd);
          dvp[e] = kj * greg[e];
        }
        // Sums over the row's column groups (neighbouring lanes), the same
        // butterfly, so the same bits, in every lane; pd is dy_t . v_t.
#pragma unroll
        for (int m = 1; m < CG; m <<= 1) {
          pr += __shfl_xor_sync(FULL, pr, m);
          pk += __shfl_xor_sync(FULL, pk, m);
          pw += __shfl_xor_sync(FULL, pw, m);
          pd += __shfl_xor_sync(FULL, pd, m);
        }
        if (cgi == 0) {
          float* pp = part + (t * 3) * Q + j;
          pp[0] = pr, pp[Q] = pk, pp[2 * Q] = pw;
          if (j == 0) dyv_s[t] = pd;
        }
        store_cols<K>(slot, cgi, dvp);  // S_{t-1} is spent: the slot takes dv's partials
#pragma unroll
        for (int e = 0; e < CPT; ++e)
          greg[e] = __fadd_rn(__fmul_rn(wj, greg[e]), __fmul_rn(rj, dyr[e]));
      }
    }
    __syncthreads();

    // dr, dk, dw of this block's rows, with their bonus terms.
    for (int o = tid; o < 3 * L * Q; o += THREADS) {
      const int t = o / (3 * Q), which = o / Q % 3, jj = o % Q;
      float a = part[o];
      if (t < steps) {
        const float dyvt = dyv_s[t];
        float* out = which == 0 ? dr : which == 1 ? dk : dw;
        if (which == 0) a += u_s[jj] * ks[t * Q + jj] * dyvt;
        else if (which == 1) a += u_s[jj] * rs[t * Q + jj] * dyvt;
        out[g_base + (long long)(t0 + t) * gst + q0 + jj] = a;
      }
    }
    if (tid < Q) {
      for (int t = steps - 1; t >= 0; --t)
        du_acc = __fadd_rn(du_acc, __fmul_rn(__fmul_rn(rs[t * Q + tid], ks[t * Q + tid]),
                                             dyv_s[t]));
    }
    // dv: this block's rows in order, plus its share of the bonus term.
    for (int o = tid; o < L * K; o += THREADS) {
      const int t = o / K, cc = o % K;
      float a = 0.f;
#pragma unroll
      for (int jj = 0; jj < Q; ++jj) a += stash[(t * Q + jj) * K + cc];
      a = fmaf(dys[t * K + cc], ukr_s[t], a);
      if constexpr (NSLICE == 1) {
        if (t < steps) dv[g_base + (long long)(t0 + t) * gst + cc] = a;
      } else {
        float* to = cg::this_cluster().map_shared_rank(
            xch + (((c & 1) * NSLICE + rank) * L + t) * Q + cc % Q, cc / Q);
        *to = a;
      }
    }
    if constexpr (NSLICE > 1) {
      cg::this_cluster().sync();  // every block's partials of chunk c have landed
      for (int o = tid; o < L * Q; o += THREADS) {
        const int t = o / Q, cl = o % Q;
        float a = 0.f;
#pragma unroll
        for (int src = 0; src < NSLICE; ++src)
          a += xch[(((c & 1) * NSLICE + src) * L + t) * Q + cl];
        if (t < steps) dv[g_base + (long long)(t0 + t) * gst + q0 + cl] = a;
      }
    }
  }
  cp_async_wait<0>();
  if (tid < Q) du[(long long)bh * K + q0 + tid] = du_acc;
}

template <int K>
int launch(const float* const* ins, const float* u, float* const* outs, float* du,
           float* ckpt, int b, int h, int t_len, const long long* s, cudaStream_t st) {
  using S = Shape<K>;
  const long long blocks = (long long)b * h * S::NSLICE;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const size_t smem = S::FLOATS * sizeof(float);
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(rwkv6_bwd_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(S::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S::NSLICE;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, rwkv6_bwd_kernel<K>, ins[0], ins[1], ins[2], ins[3], u,
                                 ins[4], outs[0], outs[1], outs[2], outs[3], du, ckpt, h,
                                 t_len, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8],
                                 s[9], s[10]);
}

}  // namespace

// r/k/v/w (B, H, T, K) fp32 sharing the element strides (sb, sh, st) and
// unit stride along K; u (B, H, K) fp32 with strides (usb, ush, 1); dy like
// r with strides (dsb, dsh, dst, 1); dr/dk/dv/dw like r sharing strides
// (gsb, gsh, gst, 1); du (B, H, K) fp32 contiguous; ckpt a scratch of B H
// ceil(T / 8) K K floats.  K in {8, 16, 32, 64}, T >= 1.  Returns
// cudaGetLastError() (or cudaErrorInvalidValue for unsupported arguments).
extern "C" int rwkv6_bwd_launch(const void* r, const void* k, const void* v, const void* w,
                                const void* u, const void* dy, void* dr, void* dk, void* dv,
                                void* dw, void* du, void* ckpt, int b, int h, int t_len,
                                int kd, long long sb, long long sh, long long st,
                                long long usb, long long ush, long long dsb, long long dsh,
                                long long dst, long long gsb, long long gsh, long long gst,
                                void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (b < 1 || h < 1 || t_len < 1) return (int)cudaErrorInvalidValue;
  const long long s[11] = {sb, sh, st, usb, ush, dsb, dsh, dst, gsb, gsh, gst};
  const float* ins[5] = {(const float*)r, (const float*)k, (const float*)v, (const float*)w,
                         (const float*)dy};
  float* outs[4] = {(float*)dr, (float*)dk, (float*)dv, (float*)dw};
  const float* uf = (const float*)u;
  float *duf = (float*)du, *ck = (float*)ckpt;
  int rc;
  switch (kd) {
    case 8: rc = launch<8>(ins, uf, outs, duf, ck, b, h, t_len, s, cs); break;
    case 16: rc = launch<16>(ins, uf, outs, duf, ck, b, h, t_len, s, cs); break;
    case 32: rc = launch<32>(ins, uf, outs, duf, ck, b, h, t_len, s, cs); break;
    case 64: rc = launch<64>(ins, uf, outs, duf, ck, b, h, t_len, s, cs); break;
    default: rc = (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
