// Calibration Gram for Hopper: G = X^T X in fp32 over the flattened rows of
// one activation tap, plus the fused per-channel sum |x|.
//
// Replaces the TPU kernel src/repro/kernels/gram/gram.py (gram_accumulate,
// body _kernel), which tiles the (n, n) output on a 2-D grid and walks the
// rows on a third, sequential grid axis, carrying the sum in the output tile.
//
// What bounds it here: operations.  One tap of R rows does R*n*(n+1) FLOPs
// for the upper triangle against R*n*elem + 4*n*n bytes; at n = 14336 and
// R = 2048 that is ~480 FLOP per byte, above the card's ~295 FLOP/byte
// ridge for bf16 (and far above fp32's ~20).
//
// Design:
//  * One block per output tile (bi, bj) with bi <= bj; the block loops over
//    ALL rows itself.  This replaces the TPU's sequential row axis: there
//    is no reduction across blocks, no atomics, and the sum order is fixed.
//    It writes the tile and its transpose, so the lower triangle costs no
//    FLOPs.
//  * 128 x 128 tile, 256 threads, an 8 x 8 register tile each (rows
//    ty + 16 i, columns tx + 16 j: conflict-free shared-memory reads).  Row
//    chunks of 32 are staged in shared memory as fp32.
//  * bf16 taps are read directly and converted in registers.  A product of
//    two bf16 values is exact in fp32, so fp32 FMA matches the reference's
//    Precision.HIGHEST up to the order of the sums.  For the same reason a
//    later fast version may use bf16 tensor cores (mma/wgmma with fp32
//    accumulation) for bf16 taps at no cost in accuracy.
//  * The diagonal-tile blocks also sum |x| for their columns from the staged
//    chunk, so sum |x| costs no second pass over X.
//  * Ragged edges (rows not a multiple of 32, n not a multiple of 128) are
//    zero-filled on load and masked on store.  The kernel allocates nothing.
//  * Tensor cores, a cp.async/TMA pipeline and 16-byte loads are later work.
#include "common.cuh"

namespace {

constexpr int TILE = 128;   // output tile edge
constexpr int CHUNK = 32;   // rows staged per step
constexpr int THREADS = 256;
constexpr int PER = 8;      // register tile edge per thread (16 x 16 threads)

template <typename T>
__global__ void __launch_bounds__(THREADS)
gram_kernel(const T* __restrict__ x, float* __restrict__ g, float* __restrict__ asum,
            int rows, int n, int ntiles) {
  __shared__ float xi[CHUNK][TILE];
  __shared__ float xj[CHUNK][TILE];

  // Map the linear block index onto the upper triangle (bi <= bj), row by row.
  int t = blockIdx.x, bi = 0;
  while (t >= ntiles - bi) {
    t -= ntiles - bi;
    ++bi;
  }
  const int bj = bi + t;
  const bool diag = bi == bj;
  const int c0i = bi * TILE, c0j = bj * TILE;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float acc[PER][PER];
#pragma unroll
  for (int a = 0; a < PER; ++a)
#pragma unroll
    for (int b = 0; b < PER; ++b) acc[a][b] = 0.f;
  float colsum = 0.f;  // diagonal blocks: sum |x| of column c0i + tid (tid < TILE)

  for (int r0 = 0; r0 < rows; r0 += CHUNK) {
    for (int idx = tid; idx < CHUNK * TILE; idx += THREADS) {
      const int r = idx / TILE, c = idx % TILE;
      const bool rok = r0 + r < rows;
      const size_t base = (size_t)(r0 + r) * n;
      xi[r][c] = (rok && c0i + c < n) ? to_f(x[base + c0i + c]) : 0.f;
      xj[r][c] = diag ? xi[r][c] : ((rok && c0j + c < n) ? to_f(x[base + c0j + c]) : 0.f);
    }
    __syncthreads();
    if (diag && tid < TILE) {
#pragma unroll 8
      for (int r = 0; r < CHUNK; ++r) colsum += fabsf(xi[r][tid]);
    }
#pragma unroll 4
    for (int r = 0; r < CHUNK; ++r) {
      float a[PER], b[PER];
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        a[k] = xi[r][ty + 16 * k];
        b[k] = xj[r][tx + 16 * k];
      }
#pragma unroll
      for (int p = 0; p < PER; ++p)
#pragma unroll
        for (int q = 0; q < PER; ++q) acc[p][q] = fmaf(a[p], b[q], acc[p][q]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int i = c0i + ty + 16 * p;
    if (i >= n) continue;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int j = c0j + tx + 16 * q;
      if (j >= n) continue;
      g[(size_t)i * n + j] = acc[p][q];
      if (!diag) g[(size_t)j * n + i] = acc[p][q];
    }
  }
  if (diag && tid < TILE && c0i + tid < n) asum[c0i + tid] = colsum;
}

}  // namespace

// x (rows, n) contiguous, dtype 0 fp32 / 1 bf16; g (n, n) fp32 and asum (n,)
// fp32 are written in full.  Returns cudaGetLastError().
extern "C" int gram_launch(const void* x, float* g, float* asum, int rows, int n,
                           int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ntiles = (n + TILE - 1) / TILE;
  const int blocks = ntiles * (ntiles + 1) / 2;
  if (dtype == kF32)
    gram_kernel<float><<<blocks, THREADS, 0, st>>>((const float*)x, g, asum, rows, n, ntiles);
  else if (dtype == kBF16)
    gram_kernel<__nv_bfloat16><<<blocks, THREADS, 0, st>>>((const __nv_bfloat16*)x, g, asum,
                                                          rows, n, ntiles);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
