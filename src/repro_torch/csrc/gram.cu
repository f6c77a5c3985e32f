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
// Both kernels share the work split:
//  * One block per 128 x 128 output tile (bi, bj) with bi <= bj; the block
//    loops over ALL rows itself.  This replaces the TPU's sequential row
//    axis: there is no reduction across blocks, no atomics, and the sum
//    order of every element is fixed, so a run repeats bit for bit.  A
//    block writes its tile and the mirror, so the lower triangle costs no
//    FLOPs.
//  * The diagonal-tile blocks also sum |x| for their columns, in row order,
//    from the staged chunk, so sum |x| costs no second pass over X.
//  * The kernels allocate nothing; ragged rows are zero-filled on load and
//    columns past n are never stored.
//
// gram_mma (bf16 taps, n % 8 == 0, x 16-byte aligned): the tensor cores.
// A product of two bf16 values is exact in fp32, so bf16 mma with fp32
// accumulation matches the reference's Precision.HIGHEST up to the order
// (and the rounding) of the sums.
//  * 8 warps, each a 64 x 32 sub-tile of the 128 x 128 tile: 4 x 4
//    m16n8k16 tiles, 64 fp32 accumulators a thread.
//  * Two-level sums: the tensor cores' fp32 adds may truncate, and on a
//    diagonal entry (a sum of squares) those errors all point one way: over
//    4100 rows in one accumulator, 1.4e-5 of the entry (measured on the
//    H100).  So the mma accumulators hold the partial sum of 1024 rows
//    (FLUSH chunks), which one round-to-nearest add moves into a running
//    sum in shared memory (64 KB a block, each thread its own column).
//    Measured on the H100 against partials of 256 and 512 rows, 1024 was
//    the fastest and the closest to the plain fp32 matmul at every width;
//    the running sum in registers (128 accumulators a thread, one block an
//    SM) ran 1.46x slower at n = 14336.
//  * Chunks of 32 rows of column slab i and column slab j arrive by 16-byte
//    cp.async.cg (src-size 0 zero-fills rows past R and columns past n) in
//    a 3-stage ring with one barrier a stage; with the running sums, 112 KB
//    of shared memory, two blocks an SM.  A row of a slab is 256 bytes
//    whose 16-byte chunks are XOR-swizzled (chunk ^ (row & 7)), so the
//    ldmatrix reads below are free of bank conflicts.  A diagonal tile
//    stages one slab.
//  * Shared memory holds X's chunk as [row k][column c].  A = X_i^T (m =
//    column i, k = row) and B = X_j (k = row, n = column j) both come by
//    ldmatrix.trans from that layout.
//  * Epilogue through shared memory (the ring's and the sums' space): the
//    tile is laid out row-major and stored as coalesced rows of G; an
//    off-diagonal block then lays out its transpose from the same
//    registers and stores the mirror rows.  A diagonal block copies its upper half onto its lower
//    half before the store: G must be exactly symmetric (the fp64 eigen-
//    and singular-value solvers downstream assume it), and an mma tile's
//    (i, j) and (j, i) are not guaranteed to be bit-equal (on the H100
//    they came out equal).
//
// gram_kernel (fp32 taps, and bf16 at odd widths or offsets): CUDA cores.
// Tensor cores on fp32 inputs would compute in TF32, below the reference's
// precision.  256 threads, an 8 x 8 register tile each (rows ty + 16 i,
// columns tx + 16 j: conflict-free shared-memory reads); row chunks of 32
// staged in shared memory as fp32; fp32 FMA (bit-identical to the plain
// fp32 matmul in every case measured on the H100).
//
// The batched form (a token-choice MoE layer's per-expert Grams, which the
// reference computes with one einsum over the zero-padded (E, C, n)
// capacity buffer): E taps of the same shape in one launch, the expert a
// second grid index (blockIdx.y) that offsets x, G and sum |x|.  The
// single form is E = 1.
#include "common.cuh"
#include "mma_sm90.cuh"

namespace {

constexpr int TILE = 128;   // output tile edge
constexpr int CHUNK = 32;   // rows staged per step
constexpr int THREADS = 256;
constexpr int PER = 8;      // register tile edge per thread (16 x 16 threads)

// Element offsets of expert blockIdx.y's rows, Gram and sum |x| in a batch
// of (rows, n) taps.
struct ExpertOffsets {
  size_t x, g, a;
};
__device__ __forceinline__ ExpertOffsets expert_offsets(int rows, int n) {
  const size_t e = blockIdx.y;
  return {e * rows * n, e * n * n, e * n};
}

// Map the linear block index onto the upper triangle (bi <= bj), row by row.
__device__ __forceinline__ void tile_of(int ntiles, int& bi, int& bj) {
  int t = blockIdx.x;
  bi = 0;
  while (t >= ntiles - bi) {
    t -= ntiles - bi;
    ++bi;
  }
  bj = bi + t;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gram_kernel(const T* __restrict__ x, float* __restrict__ g, float* __restrict__ asum,
            int rows, int n, int ntiles) {
  __shared__ float xi[CHUNK][TILE];
  __shared__ float xj[CHUNK][TILE];
  const ExpertOffsets eo = expert_offsets(rows, n);
  x += eo.x, g += eo.g, asum += eo.a;

  int bi, bj;
  tile_of(ntiles, bi, bj);
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

using bf16 = __nv_bfloat16;
constexpr int STAGES = 3;                 // ring stages of gram_mma
constexpr int FLUSH = 32;                 // chunks (1024 rows) a partial sum spans
constexpr int ROWB = TILE * 2;            // bytes of one staged row of a slab
constexpr int SLAB = CHUNK * ROWB;        // one column slab of one chunk
constexpr int STAGE = 2 * SLAB;           // slabs i and j
constexpr int SUMS = STAGES * STAGE;      // byte offset of the running sums
constexpr int NACC = 64;                  // accumulators a thread
constexpr int TP = TILE + 8;              // fp32 row stride: row-major epilogue pass
constexpr int TPT = TILE + 4;             // and transposed pass (conflict-free stores)
constexpr int MMA_SMEM = SUMS + NACC * THREADS * 4;  // 112 KB: two blocks an SM
static_assert(TILE * TP * 4 <= MMA_SMEM, "the epilogue tile reuses the ring and the sums");

// Rows of the 128 x 128 fp32 tile in shared memory (row stride ld) to G
// rows row0.., columns col0.., as 16-byte stores: a warp writes 512
// contiguous bytes of one row.
__device__ __forceinline__ void store_rows(const float* tile, int ld, float* __restrict__ g,
                                           int n, int row0, int col0) {
  for (int idx = threadIdx.x; idx < TILE * TILE / 4; idx += THREADS) {
    const int r = idx / (TILE / 4), c = 4 * (idx % (TILE / 4));
    if (row0 + r < n && col0 + c < n)
      *reinterpret_cast<float4*>(g + (size_t)(row0 + r) * n + col0 + c) =
          *reinterpret_cast<const float4*>(tile + r * ld + c);
  }
}

// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16), lane = 4 * gid + tig:
//   A regs {(gid, 2tig..+1), (gid+8, 2tig..), (gid, 2tig+8..), (gid+8, 2tig+8..)}
//   B regs {(k 2tig..+1, n gid), (k 2tig+8..+9, n gid)}
//   C      {(gid, 2tig), (gid, 2tig+1), (gid+8, 2tig), (gid+8, 2tig+1)}
// Here m = column i, n = column j, k = row: G(i, j) = sum_k x(k, i) x(k, j).
__global__ void __launch_bounds__(THREADS, 2)
gram_mma(const bf16* __restrict__ x, float* __restrict__ g, float* __restrict__ asum,
         int rows, int n, int ntiles) {
  extern __shared__ __align__(128) unsigned char smem_g[];
  const uint32_t ring = smem_u32(smem_g);
  float* tile = reinterpret_cast<float*>(smem_g);  // the epilogue's, after the ring
  // The running sums, one column of NACC per thread (conflict-free).
  float* sums = reinterpret_cast<float*>(smem_g + SUMS) + threadIdx.x;
  const ExpertOffsets eo = expert_offsets(rows, n);
  x += eo.x, g += eo.g, asum += eo.a;

  int bi, bj;
  tile_of(ntiles, bi, bj);
  const bool diag = bi == bj;
  const int c0i = bi * TILE, c0j = bj * TILE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;  // sub-tile: columns i wm*64.., j wn*32..

  // Loads: this thread copies 16-byte chunk lc of slab rows lr and lr + 16
  // (the same swizzle, lr & 7, for both and in every stage).
  const int lr = tid >> 4, lc = tid & 15;
  const uint32_t ldst = ring + lr * ROWB + ((lc ^ (lr & 7)) << 4);
  const bool li = c0i + 8 * lc < n, lj = c0j + 8 * lc < n;
  const bf16* xi = x + (li ? c0i + 8 * lc : 0);
  const bf16* xj = x + (lj ? c0j + 8 * lc : 0);
  const int nch = (rows + CHUNK - 1) / CHUNK;
  auto load = [&](int ch) {
    const uint32_t dst = ldst + (ch % STAGES) * STAGE;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int r = ch * CHUNK + lr + 16 * q;
      const size_t off = r < rows ? (size_t)r * n : 0;
      cp_async16(dst + q * 16 * ROWB, xi + off, r < rows && li);
      if (!diag) cp_async16(dst + SLAB + q * 16 * ROWB, xj + off, r < rows && lj);
    }
  };

  // ldmatrix.trans addresses (byte offsets in a slab, k16 step 0):
  //   A (m16 tile mi): rows k (lane & 7) + 8 (lane >> 4), chunk
  //     wm * 8 + 2 mi + ((lane >> 3) & 1): registers a0..a3;
  //   B (n8 tiles 2p, 2p+1): rows k (lane & 7) + 8 ((lane >> 3) & 1), chunk
  //     wn * 4 + 2 p + (lane >> 4): b0, b1 of tile 2p, then of tile 2p+1.
  const int xr = lane & 7;
  uint32_t a_off[4], b_off[2];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
    a_off[mi] = (xr + 8 * (lane >> 4)) * ROWB +
                (((wm * 8 + 2 * mi + ((lane >> 3) & 1)) ^ xr) << 4);
#pragma unroll
  for (int p = 0; p < 2; ++p)
    b_off[p] = (xr + 8 * ((lane >> 3) & 1)) * ROWB + (((wn * 4 + 2 * p + (lane >> 4)) ^ xr) << 4);

  // acc: the mma partial sum of the current FLUSH chunks; sums: the
  // running sum of the partials, in shared memory.
  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mi][nj][e] = 0.f;
        sums[(16 * mi + 4 * nj + e) * THREADS] = 0.f;
      }
  float colsum = 0.f;  // diagonal blocks: sum |x| of column c0i + tid (tid < TILE)

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nch) load(s);
    cp_async_commit();
  }
  for (int ch = 0; ch < nch; ++ch) {
    // Chunk ch has landed for every thread, and every warp is done with
    // chunk ch - 1, whose slot the next load refills.
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (ch + STAGES - 1 < nch) load(ch + STAGES - 1);
    cp_async_commit();
    const uint32_t si = ring + (ch % STAGES) * STAGE, sj = diag ? si : si + SLAB;
    if (diag && tid < TILE) {
      const unsigned char* slab = smem_g + (ch % STAGES) * STAGE + (tid & 7) * 2;
#pragma unroll 8
      for (int r = 0; r < CHUNK; ++r)
        colsum += fabsf(__bfloat162float(*reinterpret_cast<const bf16*>(
            slab + r * ROWB + (((tid >> 3) ^ (r & 7)) << 4))));
    }
#pragma unroll
    for (int kk = 0; kk < CHUNK / 16; ++kk) {
      uint32_t bfr[2][4];
#pragma unroll
      for (int p = 0; p < 2; ++p) ldsm_x4_trans(sj + kk * 16 * ROWB + b_off[p], bfr[p]);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        uint32_t af[4];
        ldsm_x4_trans(si + kk * 16 * ROWB + a_off[mi], af);
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
          mma_bf16(acc[mi][nj], af, bfr[nj >> 1][2 * (nj & 1)], bfr[nj >> 1][2 * (nj & 1) + 1]);
      }
    }
    if ((ch + 1) % FLUSH == 0 || ch == nch - 1) {
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& s = sums[(16 * mi + 4 * nj + e) * THREADS];
            s += acc[mi][nj][e];
            acc[mi][nj][e] = ch == nch - 1 ? s : 0.f;  // the total, after the last chunk
          }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring, which the tile reuses

  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 64 + 16 * mi + gid + 8 * h, c = wn * 32 + 8 * nj + 2 * tig;
        *reinterpret_cast<float2*>(tile + r * TP + c) =
            make_float2(acc[mi][nj][2 * h], acc[mi][nj][2 * h + 1]);
      }
  __syncthreads();
  if (diag) {
    // The lower half mirrors the upper half (reads and writes are disjoint).
    for (int idx = tid; idx < TILE * TILE; idx += THREADS) {
      const int r = idx / TILE, c = idx % TILE;
      if (r > c) tile[r * TP + c] = tile[c * TP + r];
    }
    __syncthreads();
    if (tid < TILE && c0i + tid < n) asum[c0i + tid] = colsum;
  }
  store_rows(tile, TP, g, n, c0i, c0j);
  if (diag) return;
  __syncthreads();  // the row stores have read the tile
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wm * 64 + 16 * mi + gid + 8 * (e >> 1);
        const int c = wn * 32 + 8 * nj + 2 * tig + (e & 1);
        tile[c * TPT + r] = acc[mi][nj][e];
      }
  __syncthreads();
  store_rows(tile, TPT, g, n, c0j, c0i);
}

int launch_mma(const void* x, float* g, float* asum, int rows, int n, int ntiles, int blocks,
               int batch, cudaStream_t st) {
  static bool configured = false;  // one attribute call
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(gram_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         MMA_SMEM);
    if (e == cudaSuccess)  // all of the SM's shared memory: two blocks fit
      e = cudaFuncSetAttribute(gram_mma, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  gram_mma<<<dim3(blocks, batch), THREADS, MMA_SMEM, st>>>((const bf16*)x, g, asum, rows, n,
                                                           ntiles);
  return 0;
}

}  // namespace

// x (batch, rows, n) contiguous (the single form: batch 1), dtype 0 fp32 /
// 1 bf16; kernel 0 the FMA kernel, 1 the mma kernel (bf16 only, n % 8 ==
// 0, x 16-byte aligned); g (batch, n, n) fp32 and asum (batch, n) fp32 are
// written in full.  Returns cudaGetLastError(), or cudaErrorInvalidValue
// for what the named kernel does not take.
extern "C" int gram_launch(const void* x, float* g, float* asum, int rows, int n, int batch,
                           int dtype, int kernel, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ntiles = (n + TILE - 1) / TILE;
  const int blocks = ntiles * (ntiles + 1) / 2;
  if (batch < 1 || batch > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks, batch);
  if (kernel == 1) {
    if (dtype != kBF16 || n % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    const int rc = launch_mma(x, g, asum, rows, n, ntiles, blocks, batch, st);
    if (rc != 0) return rc;
  } else if (kernel != 0) {
    return (int)cudaErrorInvalidValue;
  } else if (dtype == kF32) {
    gram_kernel<float><<<grid, THREADS, 0, st>>>((const float*)x, g, asum, rows, n, ntiles);
  } else if (dtype == kBF16) {
    gram_kernel<bf16><<<grid, THREADS, 0, st>>>((const bf16*)x, g, asum, rows, n, ntiles);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
