// Nested low-rank matmul for Hopper:  y = (x @ u) @ v + (x @ u2) @ v2.
//
// Replaces the TPU kernel src/repro/kernels/nested_lowrank/nested_lowrank.py
// (nested_lowrank_matmul, body _kernel), which keeps x, u and u2 resident in
// VMEM and streams v/v2 tiles.
//
// What bounds it here: at decode (M = live rows, 1..64) every factor byte is
// read once for a handful of rows, so the kernel is bound by the bytes of
// the factors: at ratio 0.2 a Mistral-7B-width MLP factor pair is ~94 MB of
// bf16, ~349 MB per layer per step, against 3.35 TB/s.  At prefill-chunk row
// counts (M = 512) it turns compute-bound.
//
// Design:
//  * The TPU design's resident factors cannot carry over: bf16 u alone is
//    20.9 MB at rank 2548, far beyond a block's 227 KB of shared memory.  So
//    both factors are STREAMED through shared-memory tiles.
//  * Two phases over the concatenation identity y = (x @ [u|u2]) @ [v;v2]
//    (exact), reading the four factors in place — ranks r < k1 come from
//    u/v, the rest from u2/v2 — so no per-call copy or concatenation:
//      phase 1  t = x @ [u|u2]   -> fp32 split-K partials, summed and
//               rounded to the factor dtype (as the TPU kernel's
//               t_ref[...].astype(v.dtype)), t kept at rank width (M, k);
//      phase 2  y = t @ [v;v2]   -> fp32 split-K partials, summed, cast.
//  * Split-K spreads the long reduction of a skinny product over enough
//    blocks (~2 per SM) to keep the memory system busy; the partials are
//    reduced by a separate pass, in a fixed order (deterministic: no
//    atomics).
//  * fp32 FMA on CUDA cores, fp32 accumulation.  Tensor cores (wgmma), TMA
//    and a fused single pass are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;  // depth of one shared-memory tile; the wrapper's
                         // split-K chunk is a multiple of it.

// One split-K slice of C(M, N) = A(M, Kd) @ B(Kd, N) into fp32 partials.
// B is two row-major matrices b0/b1 joined at ``split``: along columns
// (SPLIT_COLS: b0 = (Kd, split), b1 = (Kd, N - split)) or along rows
// (b0 = (split, N), b1 = (Kd - split, N)).
template <typename TA, typename TB, int BM, int BN, int TM, int TN, bool SPLIT_COLS>
__global__ void __launch_bounds__(kThreads)
gemm_partial(const TA* __restrict__ a, int lda, const TB* __restrict__ b0,
             const TB* __restrict__ b1, int split, float* __restrict__ part,
             int M, int Kd, int N, int k_chunk) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "tile/thread mismatch");
  __shared__ float As[kBK][BM];
  __shared__ float Bs[kBK][BN];
  constexpr int TX = BN / TN;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * k_chunk;
  const int kend = min(Kd, kbeg + k_chunk);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    for (int i = tid; i < BM * kBK; i += kThreads) {
      const int mm = i / kBK, kk = i % kBK;
      const int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < kend) ? to_f(a[(size_t)gm * lda + gk]) : 0.f;
    }
    for (int i = tid; i < kBK * BN; i += kThreads) {
      const int kk = i / BN, nn = i % BN;
      const int gk = k0 + kk, gn = n0 + nn;
      float val = 0.f;
      if (gk < kend && gn < N) {
        if (SPLIT_COLS) {
          val = gn < split ? to_f(b0[(size_t)gk * split + gn])
                           : to_f(b1[(size_t)gk * (N - split) + (gn - split)]);
        } else {
          val = gk < split ? to_f(b0[(size_t)gk * N + gn])
                           : to_f(b1[(size_t)(gk - split) * N + gn]);
        }
      }
      Bs[kk][nn] = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float ra[TM], rb[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) ra[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) rb[j] = Bs[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = part + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * TX;
      if (gn < N) out[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

// out[i] = cast(sum over the S split-K slices of part[s, i]), fixed order.
template <typename TO>
__global__ void reduce_partials(const float* __restrict__ part, TO* __restrict__ out,
                                int splits, size_t count) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += part[(size_t)z * count + i];
    out[i] = from_f<TO>(s);
  }
}

template <bool SPLIT_COLS, typename TA, typename TB>
void launch_gemm(const TA* a, int lda, const TB* b0, const TB* b1, int split,
                 float* part, int M, int Kd, int N, int splits, int k_chunk,
                 cudaStream_t stream) {
  // Skinny (decode-shaped) rows get a short, wide tile; the wrapper's split
  // heuristic mirrors this choice (SKINNY_ROWS / tile sizes in ops.py).
  if (M <= 16) {
    constexpr int BM = 16, BN = 128;
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
    gemm_partial<TA, TB, BM, BN, 2, 4, SPLIT_COLS><<<grid, kThreads, 0, stream>>>(
        a, lda, b0, b1, split, part, M, Kd, N, k_chunk);
  } else {
    constexpr int BM = 64, BN = 64;
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
    gemm_partial<TA, TB, BM, BN, 4, 4, SPLIT_COLS><<<grid, kThreads, 0, stream>>>(
        a, lda, b0, b1, split, part, M, Kd, N, k_chunk);
  }
}

template <typename TO>
void launch_reduce(const float* part, TO* out, int splits, size_t count,
                   cudaStream_t stream) {
  size_t blocks = (count + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  if (blocks == 0) return;
  reduce_partials<TO><<<(unsigned)blocks, 256, 0, stream>>>(part, out, splits, count);
}

template <typename T>
void run(const T* x, const T* u, const T* v, const T* u2, const T* v2, T* y,
         float* part1, T* t, float* part2, int M, int K, int k1, int k2, int N,
         int s1, int c1, int s2, int c2, cudaStream_t stream) {
  const int k = k1 + k2;
  launch_gemm<true>(x, K, u, u2, k1, part1, M, K, k, s1, c1, stream);
  launch_reduce<T>(part1, t, s1, (size_t)M * k, stream);
  launch_gemm<false>(t, k, v, v2, k1, part2, M, k, N, s2, c2, stream);
  launch_reduce<T>(part2, y, s2, (size_t)M * N, stream);
}

}  // namespace

// x (M, K), u (K, k1), v (k1, N), u2 (K, k2), v2 (k2, N), y (M, N), all of
// one dtype (0 fp32, 1 bf16), row-major and contiguous.  Scratch: part1
// fp32 (s1, M, k1+k2), t (M, k1+k2) in the factor dtype, part2 fp32
// (s2, M, N).  c1/c2 are the split-K chunk depths (multiples of 16) with
// s1 = ceil(K / c1), s2 = ceil((k1+k2) / c2).  Returns cudaGetLastError().
extern "C" int nested_lowrank_launch(const void* x, const void* u, const void* v,
                                     const void* u2, const void* v2, void* y,
                                     float* part1, void* t, float* part2, int M,
                                     int K, int k1, int k2, int N, int s1, int c1,
                                     int s2, int c2, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    run<float>((const float*)x, (const float*)u, (const float*)v, (const float*)u2,
               (const float*)v2, (float*)y, part1, (float*)t, part2, M, K, k1, k2,
               N, s1, c1, s2, c2, st);
  } else if (dtype == kBF16) {
    using bf = __nv_bfloat16;
    run<bf>((const bf*)x, (const bf*)u, (const bf*)v, (const bf*)u2, (const bf*)v2,
            (bf*)y, part1, (bf*)t, part2, M, K, k1, k2, N, s1, c1, s2, c2, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
