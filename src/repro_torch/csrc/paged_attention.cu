// Paged-attention decode for Hopper: one new query token per row attends
// that row's KV prefix through its block-table row.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/paged_attention.py
// (paged_attention, body _kernel), which packs R rows into one MXU score tile
// and double-buffers page DMAs.
//
// What bounds it here: the bytes of the live K/V pages.  A decode step does
// 4*Hq*hd FLOPs per cached token against 2*Hkv*hd*elem bytes of K/V (~8
// FLOP/byte in bf16 at G = 4), far below the card's ~295 FLOP/byte ridge, so
// only the page reads matter.  The card streams them at full rate only when
// every SM has enough bytes in flight, and only when the work per byte
// (instructions, shared-memory wavefronts, shuffles) stays below what an SM
// issues in the time its share of the bytes arrives.
//
// Design (split-KV, "flash-decoding"):
//  * Grid (B*Hkv, n_splits).  Split s of row b covers pages [s*pps,
//    (s+1)*pps) of its table row; a block whose split starts past the row's
//    live pages (ceil(len / bs), capped at the table's width) exits at once.
//    The host picks (n_splits, pps) from shapes alone (ops.plan_splits), so
//    long rows spread over every SM with no host sync.  The block holds the
//    G = Hq/Hkv query heads of its KV head: each K/V element is read once
//    for all G heads.  A -1 table entry is clamped to block 0 and hidden by
//    the length mask.
//  * Loads: the split's table entries go to shared memory once; then K and
//    V rows (hd*elem contiguous bytes each) arrive by 16-byte cp.async.cg in
//    a ring of 2 stages of TS tokens (64, 32 KB at bf16 and hd 128; 32 where
//    a row passes 256 bytes or G = 16), with int8 pages' fp32 scales in the
//    same stages: the next stage is in flight while the block computes on
//    one.  Each thread copies fixed 16-byte units of fixed rows of every
//    stage, so a stage costs it a few table lookups and cp.async
//    instructions.  Rows whose bytes are not 16-byte multiples (or an
//    unaligned pool) take a byte-copy path.
//  * q K: a warp takes every fourth token of a stage (TS/4), 8 lanes a group
//    of TS/16 of them, each lane DPL/2 chunks of 8 dims; q (fp32,
//    scale*log2(e) folded in, so the softmax is exp2f) sits in registers
//    where G*DPL*4 <= 64 floats (the path's G = 4 at hd 128), else in
//    shared memory, and each q chunk serves all the group's tokens.  Three
//    xor-shuffles finish each dot.
//  * Softmax and P V: every warp keeps its own online (m, l) per head and
//    its own acc[G][DPL], lane owning dims [lane*DPL, (lane+1)*DPL) of every
//    token: the warp's TS/4 probabilities per head go through shared
//    memory and each lane adds p * V over its dims.  int8 K is dequantized
//    by scaling the dot product, int8 V by scaling p.  The only block
//    barrier is the ring's one per stage.
//  * End of a split: the warps' states merge once through shared memory.
//    With one split the block normalizes and writes q's dtype directly (one
//    launch).  Otherwise it writes its fp32 partial (m, l, unnormalized acc)
//    to a workspace the wrapper allocates, and paged_combine_kernel, one
//    block per (row, KV head, query head), takes the log-sum-exp
//    combination of the splits the row's length reaches, in split order
//    (deterministic, no atomics).  A length-0 row reads no pages and writes
//    zeros.  ops.plan_splits gives the splits from shapes alone: enough
//    blocks to fill the SMs, not so many that a second wave or the combine
//    costs more than the spread.
//  * No tensor cores: at one query a row the CUDA cores' dot products stay
//    far below the time of the bytes.
#include <math.h>

#include "common.cuh"
#include "mma_sm90.cuh"

namespace {

constexpr int NT = 128;  // threads a block
constexpr int NW = NT / 32;
constexpr int STAGES = 2;
constexpr int MAX_SMEM = 227 * 1024;
constexpr int MAX_SPLITS = 1024;  // splits a row the combine takes

// N (2, 4 or 8) consecutive elements of a shared-memory row, aligned to
// N elements, widened to fp32.
template <int N>
__device__ __forceinline__ void load_n(const float* p, float* f) {
  if (N >= 4) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + i);
      f[i] = a.x, f[i + 1] = a.y, f[i + 2] = a.z, f[i + 3] = a.w;
    }
  } else {
    const float2 a = *reinterpret_cast<const float2*>(p);
    f[0] = a.x, f[1] = a.y;
  }
}
__device__ __forceinline__ void bf16x2(uint32_t w, float* f) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}
template <int N>
__device__ __forceinline__ void load_n(const __nv_bfloat16* p, float* f) {
  if (N == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    bf16x2(u.x, f), bf16x2(u.y, f + 2), bf16x2(u.z, f + 4), bf16x2(u.w, f + 6);
  } else if (N == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    bf16x2(u.x, f), bf16x2(u.y, f + 2);
  } else {
    bf16x2(*reinterpret_cast<const uint32_t*>(p), f);
  }
}
__device__ __forceinline__ void int8x4(uint32_t w, float* f) {
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = static_cast<float>(static_cast<int8_t>(w >> (8 * i)));
}
template <int N>
__device__ __forceinline__ void load_n(const int8_t* p, float* f) {
  if (N == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    int8x4(u.x, f), int8x4(u.y, f + 4);
  } else if (N == 4) {
    int8x4(*reinterpret_cast<const uint32_t*>(p), f);
  } else {
    const uint32_t w = *reinterpret_cast<const uint16_t*>(p);
    f[0] = static_cast<float>(static_cast<int8_t>(w));
    f[1] = static_cast<float>(static_cast<int8_t>(w >> 8));
  }
}

struct Params {
  const void* q;
  const void* kp;
  const void* vp;
  const float* ks;
  const float* vs;
  const int* bt;
  const int* lens;
  void* out;
  float* ws_acc;  // (B*Hkv, n_splits, G, hd) fp32 partial sums (n_splits > 1)
  float* ws_ml;   // (B*Hkv, n_splits, G, 2) fp32 running max (log2) and sum
  int hkv, hd, bs, bs_shift, max_blocks, pps, n_splits, vec, q_bf16;
  float qscale;  // scale * log2(e)
};

__device__ __forceinline__ float load_q(const Params& p, size_t i) {
  return p.q_bf16 ? to_f(static_cast<const __nv_bfloat16*>(p.q)[i])
                  : static_cast<const float*>(p.q)[i];
}
__device__ __forceinline__ void store_out(const Params& p, size_t i, float v) {
  if (p.q_bf16)
    static_cast<__nv_bfloat16*>(p.out)[i] = from_f<__nv_bfloat16>(v);
  else
    static_cast<float*>(p.out)[i] = v;
}

// Tokens a ring stage holds: 64 (16 a warp, 4 a lane group) where a row
// is at most 256 bytes and G <= 8, else 32 (registers and shared memory).
__host__ __device__ constexpr int stage_tokens(int hdp, int elem, int g) {
  return hdp * elem <= 256 && g <= 8 ? 64 : 32;
}
// Shared-memory layout, in bytes: the split's table entries, q (fp32, G x
// HDP), the warps' probabilities (TS tokens x G), then the ring (reused for
// the warps' merge after the last stage).
__host__ __device__ inline int table_bytes(int pps) { return (pps * 4 + 15) / 16 * 16; }
__host__ __device__ inline int q_bytes(int g, int hdp) { return g * hdp * 4; }
__host__ __device__ inline int p_bytes(int g, int ts) { return ts * g * 4; }
__host__ __device__ inline int stage_bytes(int hdp, int elem, bool quant, int ts) {
  return 2 * ts * hdp * elem + (quant ? 2 * ts * 4 : 0);
}
__host__ __device__ inline int merge_bytes(int g, int hdp) { return NW * g * (hdp + 2) * 4; }
inline int smem_total(int g, int hdp, int elem, bool quant, int pps) {
  const int ts = stage_tokens(hdp, elem, g);
  const int ring = STAGES * stage_bytes(hdp, elem, quant, ts);
  const int merge = merge_bytes(g, hdp);
  return table_bytes(pps) + q_bytes(g, hdp) + p_bytes(g, ts) + (ring > merge ? ring : merge);
}

// DPL: head dims a lane owns in P V (HDP = 32 * DPL >= hd, zero-filled past
// hd); in q K a token's 8 lanes own DPL / 2 chunks of 8 dims each.
template <typename TKV, int G, int DPL>
__global__ void __launch_bounds__(NT) paged_split_kernel(const Params p) {
  constexpr bool QUANT = sizeof(TKV) == 1;
  constexpr int HDP = 32 * DPL;
  constexpr int TS = stage_tokens(HDP, sizeof(TKV), G);
  constexpr int TW = TS / NW;                        // tokens a warp takes a stage
  constexpr int TI = TW / 4;                         // tokens a lane group takes
  constexpr int CPL = DPL / 2;                       // q K chunks a lane
  constexpr bool QREG = G * CPL * 8 <= 64;           // q in registers
  constexpr int UPR = HDP * (int)sizeof(TKV) / 16;  // 16-byte units a shared row
  constexpr int JS = NT / UPR;                       // rows a thread's units step by
  constexpr int NK = TS / JS;                        // K (and V) units a thread a stage
  constexpr int SBYTES = 2 * TS * HDP * (int)sizeof(TKV) + (QUANT ? 2 * TS * 4 : 0);
  extern __shared__ __align__(16) unsigned char smem[];
  const int bh = blockIdx.x, split = blockIdx.y;
  const int b = bh / p.hkv, h = bh - b * p.hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool direct = p.n_splits == 1;
  const size_t obase = (size_t)bh * G * p.hd;
  // Live tokens: the row's length, capped at the table's width.
  const int len = min(max(p.lens[b], 0), p.max_blocks * p.bs);
  const int n_pages = (len + p.bs - 1) / p.bs;
  const int p0 = split * p.pps;
  if (p0 >= n_pages) {  // the split reaches no token
    if (direct)
      for (int i = tid; i < G * p.hd; i += NT) store_out(p, obase + i, 0.f);
    return;
  }
  const int p1 = min(p0 + p.pps, n_pages);
  const int tok0 = p0 * p.bs;
  const int ntok = min(len, p1 * p.bs) - tok0;  // >= 1

  int* tbl = reinterpret_cast<int*>(smem);
  float* qs = reinterpret_cast<float*>(smem + table_bytes(p.pps));
  float* pw = qs + G * HDP + warp * TW * G;  // this warp's TW x G probabilities
  unsigned char* ring = smem + table_bytes(p.pps) + q_bytes(G, HDP) + p_bytes(G, TS);
  for (int i = tid; i < p1 - p0; i += NT)
    tbl[i] = max(p.bt[(size_t)b * p.max_blocks + p0 + i], 0);
  for (int i = tid; i < G * HDP; i += NT) {
    const int g = i / HDP, d = i - g * HDP;
    qs[i] = d < p.hd ? load_q(p, obase + g * p.hd + d) * p.qscale : 0.f;
  }

  // Copy stage t (tokens [t*TS, (t+1)*TS) of the split) into its ring slot;
  // dims past hd are zero-filled (q is zero there), tokens past the split
  // are not copied (their scores are masked and P V stops before them).
  // Thread tid copies unit tid % UPR of rows tid / UPR + k * JS, of K and V.
  const size_t row_bytes = (size_t)p.hd * sizeof(TKV);
  const uint32_t ring_u = smem_u32(ring);
  const int jt = tid / UPR, wu = tid - jt * UPR;
  auto row_of = [&](int a) {  // pool row of token a (live) of this (row, KV head)
    const int pg = p.bs_shift >= 0 ? a >> p.bs_shift : a / p.bs;
    return ((size_t)tbl[pg - p0] * p.bs + (a - pg * p.bs)) * p.hkv + h;
  };
  auto issue = [&](int t) {
    const uint32_t st = ring_u + (t % STAGES) * SBYTES;
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      const int j = jt + k * JS;
      if (t * TS + j >= ntok) break;  // rows step by JS: the rest are past too
      const size_t row = row_of(tok0 + t * TS + j);
      const uint32_t dk = st + (j * UPR + wu) * 16, dv = dk + TS * UPR * 16;
      const unsigned char* sk = static_cast<const unsigned char*>(p.kp) + row * row_bytes;
      const unsigned char* sv = static_cast<const unsigned char*>(p.vp) + row * row_bytes;
      if (p.vec) {
        const bool full = (size_t)wu * 16 < row_bytes;
        cp_async16(dk, full ? sk + wu * 16 : sk, full);
        cp_async16(dv, full ? sv + wu * 16 : sv, full);
      } else {  // rows that are not 16-byte multiples, or an unaligned pool
        unsigned char* d = ring + (dk - ring_u);
        for (int c = 0; c < 16; ++c) {
          const bool in = (size_t)wu * 16 + c < row_bytes;
          d[c] = in ? sk[wu * 16 + c] : 0;
          d[c + TS * UPR * 16] = in ? sv[wu * 16 + c] : 0;
        }
      }
    }
    if (QUANT && tid < 2 * TS) {
      const int kv = tid >= TS, j = tid - kv * TS;
      if (t * TS + j < ntok)
        cp_async4(st + 2 * TS * UPR * 16 + tid * 4, (kv ? p.vs : p.ks) + row_of(tok0 + t * TS + j),
                  true);
    }
  };

  const int nst = (ntok + TS - 1) / TS;
  __syncthreads();  // the table and q
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < nst) issue(t);
    cp_async_commit();
  }
  const int tg = lane >> 3, qd = lane & 7;  // q K: tokens tg + 4 i, lane qd
  float qr[QREG ? G : 1][QREG ? CPL : 1][8];
  if (QREG) {
#pragma unroll
    for (int g = 0; g < (QREG ? G : 1); ++g)
#pragma unroll
      for (int ci = 0; ci < (QREG ? CPL : 1); ++ci)
        load_n<8>(qs + g * HDP + (qd + 8 * ci) * 8, qr[g][ci]);
  }
  float m[G], l[G], acc[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[g][e] = 0.f;
  }
  for (int t = 0; t < nst; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage t landed for all; stage t - 1's slot is free
    if (t + STAGES - 1 < nst) issue(t + STAGES - 1);
    cp_async_commit();
    const unsigned char* st = ring + (t % STAGES) * SBYTES;
    const TKV* kt = reinterpret_cast<const TKV*>(st);
    const TKV* vt = kt + TS * HDP;
    const float* kst = reinterpret_cast<const float*>(st + 2 * TS * HDP * sizeof(TKV));
    const float* vst = kst + TS;
    // The warp's u-th token of the stage, interleaved over the warps so that
    // a stage's live tokens spread over all four.
    const auto tok = [&](int u) { return warp + NW * u; };
    const int live = min(TS, ntok - t * TS);  // live tokens of the stage
    if (tok(0) >= live) continue;
    // Lane group tg takes the warp's tokens tg + 4 i, i < TI.
    float s[TI][G], ksc[TI], vsc[TI];
#pragma unroll
    for (int i = 0; i < TI; ++i) {
      ksc[i] = QUANT ? kst[tok(tg + 4 * i)] : 1.f;
      vsc[i] = QUANT ? vst[tok(tg + 4 * i)] : 1.f;
#pragma unroll
      for (int g = 0; g < G; ++g) s[i][g] = 0.f;
    }
#pragma unroll
    for (int ci = 0; ci < CPL; ++ci) {
      const int c = (qd + 8 * ci) * 8;
      float kf[TI][8];
#pragma unroll
      for (int i = 0; i < TI; ++i) load_n<8>(kt + tok(tg + 4 * i) * HDP + c, kf[i]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float qv[8];
        if (QREG) {
#pragma unroll
          for (int e = 0; e < 8; ++e) qv[e] = qr[QREG ? g : 0][QREG ? ci : 0][e];
        } else {
          load_n<8>(qs + g * HDP + c, qv);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e)
#pragma unroll
          for (int i = 0; i < TI; ++i) s[i][g] = fmaf(qv[e], kf[i][e], s[i][g]);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < TI; ++i) {
#pragma unroll
        for (int off = 1; off < 8; off <<= 1)
          s[i][g] += __shfl_xor_sync(0xffffffffu, s[i][g], off);
        s[i][g] = tok(tg + 4 * i) < live ? s[i][g] * ksc[i] : -INFINITY;
        mx = fmaxf(mx, s[i][g]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      if (mx > m[g]) {  // warp-uniform: every lane holds the same m and mx
        const float c = exp2f(m[g] - mx);
        l[g] *= c;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[g][e] *= c;
        m[g] = mx;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < TI; ++i) {
        const float pr = tok(tg + 4 * i) < live ? exp2f(s[i][g] - m[g]) : 0.f;
        l[g] += pr;
        if (qd == 0) pw[(tg + 4 * i) * G + g] = pr * vsc[i];
      }
    __syncwarp();
    // P V: lane owns dims [lane * DPL, (lane + 1) * DPL) of every token.
    for (int u = 0; u < TW && tok(u) < live; ++u) {
      float vf[DPL], pv[G];
      load_n<DPL>(vt + tok(u) * HDP + lane * DPL, vf);
      if (G % 4 == 0) {
#pragma unroll
        for (int g = 0; g < G; g += 4) load_n<4>(pw + u * G + g, pv + g);
      } else {
#pragma unroll
        for (int g = 0; g < G; ++g) pv[g] = pw[u * G + g];
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[g][e] = fmaf(pv[g], vf[e], acc[g][e]);
    }
    __syncwarp();
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the merge

  // l: sum over the warp's 4 lane groups (a group's 8 lanes hold the same).
#pragma unroll
  for (int g = 0; g < G; ++g) {
    l[g] += __shfl_xor_sync(0xffffffffu, l[g], 8);
    l[g] += __shfl_xor_sync(0xffffffffu, l[g], 16);
  }
  float* mw = reinterpret_cast<float*>(ring);  // [NW][G] max, [NW][G] sum, [NW][G][HDP] acc
  float* lw = mw + NW * G;
  float* aw = lw + NW * G;
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      mw[warp * G + g] = m[g];
      lw[warp * G + g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < DPL; ++e) aw[(warp * G + g) * HDP + lane * DPL + e] = acc[g][e];
  __syncthreads();
  const size_t part = (size_t)bh * p.n_splits + split;
  for (int i = tid; i < G * p.hd; i += NT) {
    const int g = i / p.hd, d = i - g * p.hd;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, mw[w * G + g]);
    float ls = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float mv = mw[w * G + g];
      const float c = mv == -INFINITY ? 0.f : exp2f(mv - mx);
      ls = fmaf(c, lw[w * G + g], ls);
      a = fmaf(c, aw[(w * G + g) * HDP + d], a);
    }
    if (direct) {
      store_out(p, obase + i, a / ls);
    } else {
      p.ws_acc[part * G * p.hd + i] = a;
      if (d == 0) {
        p.ws_ml[(part * G + g) * 2] = mx;
        p.ws_ml[(part * G + g) * 2 + 1] = ls;
      }
    }
  }
}

// One block per (row, KV head, query head): out = sum_s w_s acc_s / sum_s
// w_s l_s with w_s = exp2(m_s - max_s m_s), over the splits the row's
// length reaches; each thread sums its dims in split order and the block's
// reductions run in a fixed order (deterministic, no atomics).  A row that
// reaches no split (length 0) writes zeros.
__global__ void __launch_bounds__(NT) paged_combine_kernel(const Params p, int g_n) {
  __shared__ float w[MAX_SPLITS];
  __shared__ float red[NW];
  const int bh = blockIdx.x, g = blockIdx.y, b = bh / p.hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(max(p.lens[b], 0), p.max_blocks * p.bs);
  const int n_pages = (len + p.bs - 1) / p.bs;
  const int n_live = min((n_pages + p.pps - 1) / p.pps, p.n_splits);
  const float* ml = p.ws_ml + ((size_t)bh * p.n_splits * g_n + g) * 2;  // split s at s*g_n*2
  float mx = -INFINITY;
  for (int s = tid; s < n_live; s += NT) mx = fmaxf(mx, ml[(size_t)s * g_n * 2]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
  __syncthreads();
  float ls = 0.f;
  for (int s = tid; s < n_live; s += NT) {
    const float mv = ml[(size_t)s * g_n * 2];
    w[s] = mv == -INFINITY ? 0.f : exp2f(mv - mx);
    ls = fmaf(w[s], ml[(size_t)s * g_n * 2 + 1], ls);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ls += __shfl_xor_sync(0xffffffffu, ls, off);
  if (lane == 0) red[warp] = ls;
  __syncthreads();
  ls = (red[0] + red[1]) + (red[2] + red[3]);
  const float* acc = p.ws_acc + ((size_t)bh * p.n_splits * g_n + g) * p.hd;
  const size_t stride = (size_t)g_n * p.hd;  // between splits
  for (int d = tid; d < p.hd; d += NT) {
    float a = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_live; ++s) a = fmaf(w[s], acc[s * stride + d], a);
    store_out(p, ((size_t)bh * g_n + g) * p.hd + d, n_live ? a / ls : 0.f);
  }
}

template <typename TKV, int G, int DPL>
int launch(const Params& p, int b, int smem, cudaStream_t st) {
  auto kern = paged_split_kernel<TKV, G, DPL>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(b * p.hkv, p.n_splits), NT, smem, st>>>(p);
  return 0;
}

template <typename TKV, int G>
int dispatch_dpl(int dpl, const Params& p, int b, int smem, cudaStream_t st) {
  switch (dpl) {
    case 2: return launch<TKV, G, 2>(p, b, smem, st);
    case 4: return launch<TKV, G, 4>(p, b, smem, st);
    case 8: return launch<TKV, G, 8>(p, b, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TKV>
int dispatch_g(int g, int dpl, const Params& p, int b, int smem, cudaStream_t st) {
  switch (g) {
    case 1: return dispatch_dpl<TKV, 1>(dpl, p, b, smem, st);
    case 2: return dispatch_dpl<TKV, 2>(dpl, p, b, smem, st);
    case 4: return dispatch_dpl<TKV, 4>(dpl, p, b, smem, st);
    case 8: return dispatch_dpl<TKV, 8>(dpl, p, b, smem, st);
    case 16: return dispatch_dpl<TKV, 16>(dpl, p, b, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool split_plan_ok(int b, int hkv, int g, int hd, int bs, int max_blocks, int n_splits, int pps,
                   int q_dtype) {
  return b > 0 && hkv > 0 && g > 0 && g <= 16 && hd > 0 && hd <= 256 && bs > 0 &&
         max_blocks > 0 && n_splits > 0 && n_splits <= MAX_SPLITS && pps > 0 &&
         (long long)n_splits * pps >= max_blocks && (q_dtype == kF32 || q_dtype == kBF16);
}

}  // namespace

// The combine alone, on partials a split launch left in ws_acc / ws_ml
// (combine == 0 there): out (B, Hkv*G, hd) in q's dtype.
extern "C" int paged_combine_launch(const float* ws_acc, const float* ws_ml, const int* lens,
                                    void* out, int b, int hkv, int g, int hd, int bs,
                                    int max_blocks, int n_splits, int pps, int q_dtype,
                                    void* stream) {
  if (!split_plan_ok(b, hkv, g, hd, bs, max_blocks, n_splits, pps, q_dtype) || !ws_acc ||
      !ws_ml)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.ws_acc = const_cast<float*>(ws_acc);
  p.ws_ml = const_cast<float*>(ws_ml);
  p.lens = lens;
  p.out = out;
  p.hkv = hkv, p.hd = hd, p.bs = bs, p.max_blocks = max_blocks, p.pps = pps;
  p.n_splits = n_splits, p.q_bf16 = q_dtype == kBF16;
  paged_combine_kernel<<<dim3(b * hkv, g), NT, 0, static_cast<cudaStream_t>(stream)>>>(p, g);
  return (int)cudaGetLastError();
}

// q (B, Hkv*G, hd); k/v pools (N, bs, Hkv, hd); scales (N, bs, Hkv) fp32 for
// int8 pools, else null; block_tables (B, max_blocks) int32 (-1 = none);
// lengths (B,) int32 = cache_len + 1.  Split plan: n_splits splits of pps
// pages (n_splits * pps >= max_blocks); with n_splits > 1, ws_acc
// (B*Hkv*n_splits*G*hd fp32) and ws_ml (B*Hkv*n_splits*G*2 fp32) take the
// partials, and combine != 0 also launches the combine into out.  q/out
// dtype: 0 fp32, 1 bf16; pool dtype: the same as q, or 2 (int8).  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for what it cannot launch.
extern "C" int paged_attention_launch(const void* q, const void* kp, const void* vp,
                                      const float* ks, const float* vs, const int* bt,
                                      const int* lens, void* out, float* ws_acc, float* ws_ml,
                                      int b, int hkv, int g, int hd, int bs, int max_blocks,
                                      int n_splits, int pps, int combine, float scale,
                                      int q_dtype, int kv_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int elem = kv_dtype == kF32 ? 4 : kv_dtype == kBF16 ? 2 : 1;
  const bool quant = kv_dtype == kI8;
  const int dpl = hd <= 64 ? 2 : hd <= 128 ? 4 : 8;  // HDP = 64, 128, 256
  if (!split_plan_ok(b, hkv, g, hd, bs, max_blocks, n_splits, pps, q_dtype) ||
      (n_splits > 1 && (!ws_acc || !ws_ml)) || (quant && (!ks || !vs)) ||
      (!quant && kv_dtype != q_dtype))
    return (int)cudaErrorInvalidValue;
  const int smem = smem_total(g, 32 * dpl, elem, quant, pps);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  int bs_shift = 0;
  while ((1 << bs_shift) < bs) ++bs_shift;
  if ((1 << bs_shift) != bs) bs_shift = -1;
  Params p{q, kp, vp, ks, vs, bt, lens, out, ws_acc, ws_ml, hkv, hd, bs, bs_shift, max_blocks,
           pps, n_splits, 0, q_dtype == kBF16, scale * 1.4426950408889634f};
  p.vec = ((size_t)hd * elem) % 16 == 0 && reinterpret_cast<uintptr_t>(kp) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(vp) % 16 == 0;
  int rc;
  if (kv_dtype == kF32)
    rc = dispatch_g<float>(g, dpl, p, b, smem, st);
  else if (kv_dtype == kBF16)
    rc = dispatch_g<__nv_bfloat16>(g, dpl, p, b, smem, st);
  else if (kv_dtype == kI8)
    rc = dispatch_g<int8_t>(g, dpl, p, b, smem, st);
  else
    rc = (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  if (n_splits > 1 && combine) paged_combine_kernel<<<dim3(b * hkv, g), NT, 0, st>>>(p, g);
  return (int)cudaGetLastError();
}
