// RWKV-6 time-mix recurrence for Hopper:
//
//     y_t = r_t . (S_{t-1} + diag(u) k_t^T v_t)
//     S_t = diag(w_t) S_{t-1} + k_t^T v_t            (S: K x V, fp32, S_0 = 0)
//
// for r/k/v/w (B, H, T, K) read through strides (unit stride along K), u
// (B, H, K) fp32 (broadcast strides allowed); y (B, H, T, K) in r's dtype,
// written through its own strides, and optionally the final state
// S_T (B, H, K, K) fp32.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6/rwkv6.py (rwkv6_chunked,
// body _kernel): one grid row per batch*head walking 16-token chunks in
// order with the (K, V) state in VMEM scratch.  The TPU kernel rewrites a
// chunk as matrix products for its matrix unit: with logcum = cumsum of
// log w over the chunk, y gets r * exp(logecum) @ S plus an L x L matrix
// A[t, s] = sum_k r_t k_s exp(min(logecum_t - logcum_s, 0)) times v, and S
// the chunk's whole decay plus the decayed k^T v -- every exponent a
// difference over s <= t, the rebase that keeps w -> 0 from overflowing.
// It starts from a zero state and returns y only; this kernel also writes
// the final state, so a prefill runs through it.
//
// What bounds it here.  fp32 on the CUDA cores (TF32 tensor cores are below
// the reference's precision), so the chunked form's products buy nothing:
// per token and head both forms take ~4 K^2 FLOPs (~16 kFLOP at K = 64)
// against 5 K elements of traffic, ~13 FLOP/byte, under the card's fp32
// ridge (67 TFLOP/s over 3.35 TB/s = 20): bytes bound it on paper (0.100
// ms at (128, 2048, 64)), with the FMAs close behind (0.063 ms at peak).
// And a head's tokens run in order, so what a step costs on its critical
// path multiplies by T.
//
// Design.
//  * Per token, in registers: S = w S + k^T v, rounded exactly as the plain
//    scan rounds it (a product, a product, a sum; no fused multiply-add),
//    so the state is the scan's bit for bit and y differs from it only by
//    summation order.  (The chunked form's exp/log algebra sat ~2e-6 of
//    max |y| from the scan; a 4-layer bf16 model amplified that past its
//    eval-logit gate.)  No exponent anywhere: w = 1e-6 needs no rebase.
//  * The rows of S are independent: S[j, :] evolves by w[j] alone, and
//    y_t = sum_j r_t[j] (S[j, :] + u[j] k_t[j] v_t).  So a head's work
//    splits over K quarters: a cluster of K/16 blocks (cudaLaunchKernelEx
//    with the cluster attribute; one block for K <= 16) in which block q
//    owns rows 16q..16q+15 of S, loads only its 16 columns of r, k, w, u,
//    and updates its rows with no exchange on the recurrence.  Its share
//    of y is a partial sum over its rows for all V columns.
//  * Each thread holds S[8 rows][its column] (two row groups a column at
//    K = 64); the groups' partial ys meet by a shuffle reduce-scatter at
//    the end of a chunk, and the blocks' partials through distributed
//    shared memory: block q owns y's columns 16q..16q+15, every block
//    stores its partials for them into q's shared memory (map_shared_rank),
//    double-buffered by chunk parity, under one split cluster barrier a
//    chunk (arrive after the stores, wait a chunk later, before q sums its
//    four slots in a fixed order and writes y), never on the state's path.
//  * Chunk c + 2 is in flight while chunk c computes: a 3-stage ring of
//    16-byte cp.async (the model's permuted views and contiguous inputs),
//    or 4-byte cp.async for other strides or bases (the wrapper picks from
//    strides and pointers; the entry point checks).  Tokens past T are not
//    stepped.  One __syncthreads a chunk (the stage has landed); bf16
//    inputs take one more, after the chunk's r, k, w are widened to fp32
//    once (each token's row is read by all K column threads).
//  * The bonus r_t . (u * k_t) depends on the token only: each warp sums a
//    chunk's 16 once and hands them out by shuffle.
//  * Registers held to <= 96 (MIN_BLOCKS): five blocks an SM let 154
//    clusters of four run at once, so a (4 x 32)-head batch's 512 blocks
//    take one wave (at 111 registers only 124 clusters fit: two waves).
//
// What holds it back (H100 80GB HBM3, 700 W): a block steps its 16 tokens
// a chunk through ~43 instructions a token a thread (seven shared loads, a
// shuffle, ~33 FP ops of which the exact update is three a row), ~4.2 us a
// chunk at the eval shape with ~4 blocks an SM, ~1.3 instructions a cycle
// an SM: latency of the shared loads and issue, not bytes.  Tried and
// dropped: the chunked form with the pairwise rebase (cluster-shared A
// over K quarters; 0.61 ms, and ~2e-6 off the scan), its one-barrier
// pipelined variant, rows by bulk copy (one warp issuing 64 copies a
// chunk), 64 threads of 16 rows (two waves), two columns a thread, two
// FMA chains for the cross term, 16-byte remote stores of the partials.
#include <cooperative_groups.h>
#include <limits.h>

#include "common.cuh"
#include "mma_sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int L = 16;         // tokens a chunk: a stage of the copy ring
constexpr int MAX_Q = 16;     // rows of S (and columns of y) a block owns
constexpr int STAGES = 3;     // chunks in the cp.async ring
constexpr int MIN_BLOCKS = 5;  // blocks an SM (see the header)
constexpr unsigned FULL = 0xffffffffu;

template <int K>
struct Shape {
  static constexpr int Q = K < MAX_Q ? K : MAX_Q;  // rows of S a block owns
  static constexpr int NSLICE = K / Q;             // blocks a head = cluster size
  static constexpr int THREADS = K >= 32 ? 128 : 4 * K;
  static constexpr int JG = THREADS / K;  // row groups a column of S is split over
  static constexpr int JPT = Q / JG;      // rows of S a thread holds
  static constexpr int TPT = L / JG;      // tokens of y a thread owns after the reduce
};

template <typename T, int K>
struct Smem {
  using S = Shape<K>;
  struct Stage {
    T r[L][S::Q], k[L][S::Q], w[L][S::Q], v[L][K];
  };
  alignas(16) Stage stage[STAGES];
  // bf16 inputs: the chunk's r, k, w widened once (fp32 reads the stage).
  static constexpr bool WIDEN = sizeof(T) != sizeof(float);
  alignas(16) float wide[WIDEN ? 3 : 1][L][S::Q];
  // Partial y for this block's columns from each block of the cluster, by
  // chunk parity.
  alignas(16) float part[2][S::NSLICE][L][S::Q];
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// N (2, 4 or 8) consecutive floats of a shared row, aligned to N floats.
template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&out)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      out[i] = x.x, out[i + 1] = x.y, out[i + 2] = x.z, out[i + 3] = x.w;
    }
  } else {
    static_assert(N == 2, "rows of 2, 4 or 8");
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x, out[1] = x.y;
  }
}

// One step of a reduce-scatter over the lanes of a column's row groups:
// lane bit M of jg picks which half of `in`'s N tokens the lane keeps (the
// odd or even ones), adding its partner's partials for them.  `out` may be
// `in`.
template <int N, int M>
__device__ __forceinline__ void halve(const float (&in)[L], float (&out)[L], int jg) {
  const bool hi = (jg & M) != 0;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float keep = hi ? in[2 * i + 1] : in[2 * i];
    const float send = hi ? in[2 * i] : in[2 * i + 1];
    out[i] = keep + __shfl_xor_sync(FULL, send, M);
  }
}

template <typename T, int K, int VEC>
__global__ void __launch_bounds__(Shape<K>::THREADS, MIN_BLOCKS)
rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ w, const float* __restrict__ u, T* __restrict__ y,
             float* __restrict__ state, int h_count, int t_len, long long sb, long long sh,
             long long st, long long usb, long long ush, long long ysb, long long ysh,
             long long yst) {
  using S = Shape<K>;
  constexpr int Q = S::Q, NSLICE = S::NSLICE, THREADS = S::THREADS;
  constexpr int JG = S::JG, JPT = S::JPT, TPT = S::TPT;
  using Sm = Smem<T, K>;
  __shared__ Sm sm;

  const int tid = threadIdx.x, lane = tid & 31;
  const int rank = blockIdx.x % NSLICE;  // the block's rank in its cluster
  const int bh = blockIdx.x / NSLICE;
  const int b = bh / h_count, h = bh % h_count;
  const int q0 = rank * Q;  // this block's rows of S, and its columns of y
  const long long in_base = b * sb + h * sh;
  const long long y_base = b * ysb + h * ysh;
  // Thread (vcol, jg) holds S[q0 + jl0 .. q0 + jl0 + JPT - 1][vcol].
  const int vcol = tid / JG, jg = tid % JG, jl0 = jg * JPT;

  // The bonus r_t . (u * k_t) over this block's rows depends on the token
  // only: each warp sums a chunk's 16 once, lane 2t + hh over half hh of
  // the rows (bt below), and hands token t's to every lane by a shuffle.
  constexpr int HQ = Q / 2;
  const int bt = lane >> 1, bh0 = (lane & 1) * HQ;
  float sreg[JPT], uhalf[HQ];
#pragma unroll
  for (int jj = 0; jj < JPT; ++jj) sreg[jj] = 0.f;
#pragma unroll
  for (int jj = 0; jj < HQ; ++jj) uhalf[jj] = u[b * usb + h * ush + q0 + bh0 + jj];

  // Chunk c's r, k, w (this block's Q columns) and v (all K columns) into
  // stage c % STAGES; one commit group a chunk, empty past the end.
  auto load_chunk = [&](int c) {
    const int t0 = c * L;
    if (t0 < t_len) {
      typename Sm::Stage& sg = sm.stage[c % STAGES];
      constexpr int EPP = VEC / (int)sizeof(T);  // elements a copy
      constexpr int QP = Q / EPP, VP = K / EPP;  // copies a row
      constexpr int NQ = 3 * L * QP, N = NQ + L * VP;
      for (int i = tid; i < N; i += THREADS) {
        int t, e;
        const T* src;
        T* dst;
        if (i < NQ) {
          const int which = i / (L * QP), rem = i % (L * QP);
          t = rem / QP, e = (rem % QP) * EPP;
          src = (which == 0 ? r : which == 1 ? k : w) + in_base + q0 + e;
          dst = (which == 0 ? &sg.r[t][e] : which == 1 ? &sg.k[t][e] : &sg.w[t][e]);
        } else {
          const int rem = i - NQ;
          t = rem / VP, e = (rem % VP) * EPP;
          src = v + in_base + e;
          dst = &sg.v[t][e];
        }
        const bool live = t0 + t < t_len;
        if (live) src += (long long)(t0 + t) * st;  // past T: zero-fill, read nothing
        if constexpr (VEC == 16) cp_async16(smem_u32(dst), src, live);
        else cp_async4(smem_u32(dst), src, live);
      }
    }
    cp_async_commit();
  };

  const int nchunks = (t_len + L - 1) / L;
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) load_chunk(c);
  if constexpr (NSLICE > 1) {
    cluster_arrive();  // every block of the cluster runs before any remote store
    cluster_wait();
  }

  // The owner's sum of chunk cc's partials, in rank order, into y.
  auto reduce_store = [&](int cc) {
    for (int o = tid; o < L * Q; o += THREADS) {
      const int t = o / Q, vl = o % Q;
      float acc = 0.f;
#pragma unroll
      for (int src = 0; src < NSLICE; ++src) acc += sm.part[cc & 1][src][t][vl];
      if (cc * L + t < t_len)
        y[y_base + (long long)(cc * L + t) * yst + q0 + vl] = from_f<T>(acc);
    }
  };

  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk c has landed; chunk c - 1 is done with its buffers
    load_chunk(c + STAGES - 1);
    const typename Sm::Stage& sg = sm.stage[c % STAGES];
    const int t0 = c * L;
    const int steps = min(L, t_len - t0);
    if constexpr (Sm::WIDEN) {
      for (int i = tid; i < 3 * L * Q; i += THREADS) {
        const int which = i / (L * Q), t = i % (L * Q) / Q, j = i % Q;
        sm.wide[which][t][j] =
            to_f(which == 0 ? sg.r[t][j] : which == 1 ? sg.k[t][j] : sg.w[t][j]);
      }
      __syncthreads();
    }
    // Row t of r (0), k (1) or w (2) from column j, in fp32.
    auto row = [&](int which, int t, int j) -> const float* {
      if constexpr (Sm::WIDEN) return &sm.wide[which][t][j];
      else return which == 0 ? &sg.r[t][j] : which == 1 ? &sg.k[t][j] : &sg.w[t][j];
    };

    float bonus;
    {
      float rv[HQ], kv[HQ];
      load_row<HQ>(row(0, bt, bh0), rv);
      load_row<HQ>(row(1, bt, bh0), kv);
      bonus = 0.f;
#pragma unroll
      for (int jj = 0; jj < HQ; ++jj) bonus = fmaf(rv[jj], uhalf[jj] * kv[jj], bonus);
      bonus += __shfl_xor_sync(FULL, bonus, 1);
    }

    // Step the tokens: y_t's partial over this thread's rows from S_{t-1}
    // (the first row group adds the bonus), then S_t = w S_{t-1} + k v
    // rounded as the plain scan.
    float yacc[L];
#pragma unroll
    for (int t = 0; t < L; ++t) {
      yacc[t] = 0.f;
      if (t < steps) {
        float rv[JPT], kv[JPT], wv[JPT];
        load_row<JPT>(row(0, t, jl0), rv);
        load_row<JPT>(row(1, t, jl0), kv);
        load_row<JPT>(row(2, t, jl0), wv);
        const float vt = to_f(sg.v[t][vcol]);
        const float bonus_t = __shfl_sync(FULL, bonus, 2 * t);
        float cross = 0.f;
#pragma unroll
        for (int jj = 0; jj < JPT; ++jj) cross = fmaf(rv[jj], sreg[jj], cross);
        yacc[t] = fmaf(jg == 0 ? bonus_t : 0.f, vt, cross);
#pragma unroll
        for (int jj = 0; jj < JPT; ++jj)
          sreg[jj] = __fadd_rn(__fmul_rn(wv[jj], sreg[jj]), __fmul_rn(kv[jj], vt));
      }
    }

    // Reduce-scatter the JG row groups' partials (lanes jg of a column are
    // neighbours): the thread keeps tokens t = JG i + jg.
    static_assert(JG == 2 || JG == 4, "two or four row groups");
    float cur[L];
    halve<L, 1>(yacc, cur, jg);
    if constexpr (JG == 4) halve<L / 2, 2>(cur, cur, jg);

    // Out: a block that holds all of S writes y itself; in a cluster the
    // partials go to the block that owns the column, and y of chunk c - 1
    // is summed now that every block has stored its share.
    if constexpr (NSLICE == 1) {
#pragma unroll
      for (int i = 0; i < TPT; ++i) {
        const int t = JG * i + jg;
        if (t < steps) y[y_base + (long long)(t0 + t) * yst + vcol] = from_f<T>(cur[i]);
      }
    } else {
      if (c > 0) {
        cluster_wait();
        reduce_store(c - 1);
      }
      const int owner = vcol / Q;
      float* dst = cg::this_cluster().map_shared_rank(&sm.part[c & 1][rank][0][0], owner);
#pragma unroll
      for (int i = 0; i < TPT; ++i) dst[(JG * i + jg) * Q + vcol % Q] = cur[i];
      cluster_arrive();
    }
  }
  if constexpr (NSLICE > 1) {
    cluster_wait();
    reduce_store(nchunks - 1);
  }
  cp_async_wait<0>();
  if (state != nullptr) {
    float* sp = state + ((long long)bh * K + q0 + jl0) * K + vcol;
#pragma unroll
    for (int jj = 0; jj < JPT; ++jj) sp[(long long)jj * K] = sreg[jj];
  }
}

template <typename T, int K, int VEC>
int launch(const void* r, const void* k, const void* v, const void* w, const float* u,
           void* y, float* state, int b, int h, int t_len, const long long* s,
           cudaStream_t st) {
  using S = Shape<K>;
  const long long blocks = (long long)b * h * S::NSLICE;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(S::THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S::NSLICE;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, rwkv6_kernel<T, K, VEC>, (const T*)r, (const T*)k,
                                 (const T*)v, (const T*)w, u, (T*)y, state, h, t_len, s[0],
                                 s[1], s[2], s[3], s[4], s[5], s[6], s[7]);
}

template <typename T, int VEC>
int dispatch_k(const void* r, const void* k, const void* v, const void* w, const float* u,
               void* y, float* state, int b, int h, int t_len, int kd, const long long* s,
               cudaStream_t st) {
  switch (kd) {
    case 8: return launch<T, 8, VEC>(r, k, v, w, u, y, state, b, h, t_len, s, st);
    case 16: return launch<T, 16, VEC>(r, k, v, w, u, y, state, b, h, t_len, s, st);
    case 32: return launch<T, 32, VEC>(r, k, v, w, u, y, state, b, h, t_len, s, st);
    case 64: return launch<T, 64, VEC>(r, k, v, w, u, y, state, b, h, t_len, s, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_vec(const void* const* ins, const float* u, void* y, float* state, int b, int h,
                 int t_len, int kd, const long long* s, int vec, cudaStream_t st) {
  // Every row a copy starts at: the bases and the byte strides of the
  // (b, h, t) dimensions longer than 1.
  long long bits = 0;
  for (int i = 0; i < 4; ++i) bits |= (long long)(uintptr_t)ins[i];
  const int dims[3] = {b, h, t_len};
  for (int i = 0; i < 3; ++i)
    if (dims[i] > 1) bits |= s[i] * (long long)sizeof(T);
  if (vec == 16 && (bits & 15) == 0)
    return dispatch_k<T, 16>(ins[0], ins[1], ins[2], ins[3], u, y, state, b, h, t_len, kd, s,
                             st);
  if (vec == 4 && (bits & 3) == 0)
    return dispatch_k<T, 4>(ins[0], ins[1], ins[2], ins[3], u, y, state, b, h, t_len, kd, s,
                            st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// r/k/v/w (B, H, T, K) of one dtype (0 fp32, 1 bf16) sharing the element
// strides (sb, sh, st) and unit stride along K; u (B, H, K) fp32 with
// strides (usb, ush, 1); y like r with strides (ysb, ysh, yst, 1); state
// (B, H, K, K) fp32 contiguous, or null.  K in {8, 16, 32, 64}, T >= 1.
// vec: bytes a cp.async copies, 16 or 4; the bases, and the byte strides
// of the dimensions longer than 1, must be multiples of it.  Returns cudaGetLastError() (or
// cudaErrorInvalidValue for unsupported arguments).
extern "C" int rwkv6_launch(const void* r, const void* k, const void* v, const void* w,
                            const void* u, void* y, void* state, int b, int h, int t_len,
                            int kd, long long sb, long long sh, long long st, long long usb,
                            long long ush, long long ysb, long long ysh, long long yst,
                            int dtype, int vec, void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (b < 1 || h < 1 || t_len < 1) return (int)cudaErrorInvalidValue;
  const long long s[8] = {sb, sh, st, usb, ush, ysb, ysh, yst};
  const void* ins[4] = {r, k, v, w};
  int rc;
  if (dtype == kF32)
    rc = dispatch_vec<float>(ins, (const float*)u, y, (float*)state, b, h, t_len, kd, s, vec,
                             cs);
  else if (dtype == kBF16)
    rc = dispatch_vec<__nv_bfloat16>(ins, (const float*)u, y, (float*)state, b, h, t_len, kd,
                                     s, vec, cs);
  else
    rc = (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
