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
// Three kernels, by the rows' dtype, width and alignment (ops.route):
// gram_mma, gram_tf32x3 and gram_kernel (FMA).  They share the work split:
//  * One block per 128 x 128 output tile (bi, bj) with bi <= bj.  In
//    gram_mma and gram_kernel the block loops over ALL rows itself: there
//    is no reduction across blocks.  gram_tf32x3 splits the rows across
//    blocks and its reduce kernel adds the partial tiles in split order
//    (below).  This replaces the TPU's sequential row axis; there are no
//    atomics, and the sum order of every element is fixed, so a run
//    repeats bit for bit.  A block writes its tile and the mirror, so the
//    lower triangle costs no FLOPs.
//  * The diagonal-tile blocks also sum |x| for their columns (of their
//    split's rows), in row order, from the staged chunk, so sum |x| costs
//    no second pass over X.
//  * The kernels allocate nothing (gram_tf32x3's partials go to a scratch
//    the wrapper allocates); ragged rows are zero-filled on load and
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
// gram_tf32x3 (fp32 taps, n % 4 == 0, x 16-byte aligned): the tensor
// cores at fp32's precision, with the rows split across blocks.
//  * One TF32 product keeps 11 bits of each operand: a single-pass TF32
//    Gram is 10-180x the plain fp32 matmul's per-element error against an
//    fp64 Gram (1.5e-5 to 6.8e-5 of sqrt(G_ii G_jj) at the gram phase's
//    fp32 shapes on the H100).  So each staged value is split in registers
//    into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna), and
//    mma.sync.m16n8k8.tf32 sums lo_i hi_j, then hi_i lo_j, then hi_i hi_j
//    (3xTF32: each product exact in fp32; lo_i lo_j, below 2^-22 of a
//    product, is dropped): 0.19-1.8x the plain's error there.  Splitting
//    once at staging into hi and lo slabs instead ran slower (one block an
//    SM for the two slabs).
//  * Short tensor-core sums: the tensor cores' adds truncate (see
//    gram_mma), so the three products of 8 rows go into a fresh
//    accumulator, which one round-to-nearest add moves into the running
//    fp32 sum in registers.  An accumulator of 8 rows costs no register
//    beyond its 4; a longer one would need a second set of 64.
//  * Rows split across blocks: the grid is (upper tiles x splits, batch),
//    and split s of a tile takes rows [s R / S, (s + 1) R / S).  The
//    wrapper plans S (ops.plan_splits) to spread the work evenly over the
//    card's SMs.  With S = 1 the block writes G itself; with more it writes
//    its partial tile (a diagonal tile also its partial sum |x|) to a
//    scratch the wrapper allocates, and gram_tf32x3_reduce adds the
//    partials in split order.  No atomics: a run repeats bit for bit.
//  * Warps as gram_mma's (8 of 64 x 32; m16n8k8's C fragment is
//    m16n8k16's).  Chunks of 32 rows of slabs i and j arrive by 16-byte
//    cp.async.cg in a 3-stage ring (zero-filled past the split's rows and
//    past n).  A slab row is 128 floats padded to 136, so the fragment
//    reads (row tig, column gid) hit 32 different banks.  104 KB of shared
//    memory: two blocks an SM.
//  * Epilogue through shared memory at row stride 129 (conflict-free by
//    row and by column): the rows of G, then the mirror rows; a diagonal
//    tile writes its upper half and mirrors it onto the lower one, so G
//    equals G^T exactly.
//
// gram_kernel (fp32 taps the tf32x3 kernel does not take: a width not a
// multiple of 4 or an unaligned start; bf16 at odd widths or offsets):
// CUDA cores.  256 threads, an 8 x 8 register tile each (rows ty + 16 i,
// columns tx + 16 j: conflict-free shared-memory reads); row chunks of 32
// staged in shared memory as fp32; fp32 FMA.  Two-level sums, as in
// gram_mma: the FMAs sum a span of 1024 rows (FLUSH chunks) into a
// partial tile in registers, which one add moves into the running sum,
// kept in the block's own tile of G (each thread reads back only what it
// wrote; the mirror is written at the end).  One accumulator over all rows
// lost too much on long taps: on 24000 bf16 rows the error reached 1.5e-5
// and 1.8e-5 of max |G| at n 768 and 3072 (H100).  A running tile in
// registers cost one block an SM (1.4-2.4x slower), and the flush as a
// branch inside the chunk loop 1.2-1.3x; the span loop around the chunk
// loop runs as fast as one accumulator did.
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
constexpr int FLUSH = 32;   // chunks (1024 rows) a partial sum spans (gram_kernel, gram_mma)

// Element offsets of expert blockIdx.y's rows, Gram and sum |x| in a batch
// of (rows, n) taps.
struct ExpertOffsets {
  size_t x, g, a;
};
__device__ __forceinline__ ExpertOffsets expert_offsets(int rows, int n) {
  const size_t e = blockIdx.y;
  return {e * rows * n, e * n * n, e * n};
}

// Map tile index t onto the upper triangle (bi <= bj), row by row.
__device__ __forceinline__ void tile_at(int t, int ntiles, int& bi, int& bj) {
  bi = 0;
  while (t >= ntiles - bi) {
    t -= ntiles - bi;
    ++bi;
  }
  bj = bi + t;
}
__device__ __forceinline__ void tile_of(int ntiles, int& bi, int& bj) {
  tile_at(blockIdx.x, ntiles, bi, bj);
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

  // acc: the FMA partial sum of the current FLUSH chunks; the running sum
  // of the partials is G(i, j) itself, from the first flush on.
  float acc[PER][PER];
#pragma unroll
  for (int a = 0; a < PER; ++a)
#pragma unroll
    for (int b = 0; b < PER; ++b) acc[a][b] = 0.f;
  float colsum = 0.f;  // diagonal blocks: sum |x| of column c0i + tid (tid < TILE)
  // This thread's row p of G (columns c0j + tx + 16 q), or null past n.
  auto g_row = [&](int p) -> float* {
    const int i = c0i + ty + 16 * p;
    return i < n ? g + (size_t)i * n + c0j + tx : nullptr;
  };
  const int qn = min(PER, (n - c0j - tx + 15) / 16);  // q < qn: column in range

  // Rows in spans of FLUSH chunks; each span's partial is moved into G
  // after it, but the last span's (the epilogue adds it).
  for (int f0 = 0; f0 < rows; f0 += FLUSH * CHUNK) {
    if (f0 > 0) {
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        float* gr = g_row(p);
#pragma unroll
        for (int q = 0; q < PER; ++q) {
          if (gr != nullptr && q < qn)
            gr[16 * q] = f0 == FLUSH * CHUNK ? acc[p][q] : gr[16 * q] + acc[p][q];
          acc[p][q] = 0.f;
        }
      }
    }
    const int f1 = min(rows, f0 + FLUSH * CHUNK);
    for (int r0 = f0; r0 < f1; r0 += CHUNK) {
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
  }

  const bool flushed = rows > FLUSH * CHUNK;  // G holds the running sum
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int i = c0i + ty + 16 * p;
    if (i >= n) continue;
    float* gr = g_row(p);
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int j = c0j + tx + 16 * q;
      if (j >= n) continue;
      const float sum = flushed ? gr[16 * q] + acc[p][q] : acc[p][q];
      gr[16 * q] = sum;
      if (!diag) g[(size_t)j * n + i] = sum;
    }
  }
  if (diag && tid < TILE && c0i + tid < n) asum[c0i + tid] = colsum;
}

using bf16 = __nv_bfloat16;
constexpr int STAGES = 3;                 // ring stages of gram_mma
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

constexpr int XLD = TILE + 8;             // fp32 slab row stride of gram_tf32x3
constexpr int XSLAB = CHUNK * XLD * 4;    // bytes of one slab of one chunk
constexpr int XSTAGE = 2 * XSLAB;         // slabs i and j
constexpr int ELD = TILE + 1;             // row stride of the epilogue's tile
constexpr int X3_SMEM = STAGES * XSTAGE;  // 102 KB: two blocks an SM
constexpr int RQ = 32;                    // tile rows a reduce block sums
static_assert(TILE * ELD * 4 <= X3_SMEM, "the epilogue tile reuses the ring");

// Rows r0 .. r0 + nr - 1 of tile (c0i, c0j) of G, laid out in shared memory
// at row stride ELD (row r at tile + r * ELD), to G: first its rows (c0i +
// r0 + r, c0j + c), then its mirror (c0j + c, c0i + r0 + r), each pass a
// warp on 32 neighbouring elements of one row of G.  A diagonal tile
// writes its upper half (c >= r0 + r) and mirrors it onto the lower.
__device__ __forceinline__ void store_tile(const float* tile, int nr, int r0, bool diag,
                                           float* __restrict__ g, int n, int c0i, int c0j) {
  for (int idx = threadIdx.x; idx < nr * TILE; idx += THREADS) {
    const int r = idx / TILE, c = idx % TILE, i = c0i + r0 + r, j = c0j + c;
    if (i < n && j < n && (!diag || c >= r0 + r)) g[(size_t)i * n + j] = tile[r * ELD + c];
  }
  for (int idx = threadIdx.x; idx < nr * TILE; idx += THREADS) {
    const int c = idx / nr, r = idx % nr, i = c0i + r0 + r, j = c0j + c;
    if (i < n && j < n && (!diag || c > r0 + r)) g[(size_t)j * n + i] = tile[r * ELD + c];
  }
}

// part: (batch, splits, upper tiles, TILE, TILE) partial tiles; apart:
// (batch, splits, ntiles, TILE) partial sums |x| of the diagonal tiles.
// Both are read only by gram_tf32x3_reduce, and only when splits > 1.
__global__ void __launch_bounds__(THREADS, 2)
gram_tf32x3(const float* __restrict__ x, float* __restrict__ g, float* __restrict__ asum,
            float* __restrict__ part, float* __restrict__ apart, int rows, int n, int ntiles,
            int splits) {
  extern __shared__ __align__(128) unsigned char smem_x[];
  const uint32_t ring = smem_u32(smem_x);
  float* tile = reinterpret_cast<float*>(smem_x);  // the epilogue's, after the ring
  const ExpertOffsets eo = expert_offsets(rows, n);
  x += eo.x, g += eo.g, asum += eo.a;

  const int upper = gridDim.x / splits, t = blockIdx.x / splits, s = blockIdx.x % splits;
  int bi, bj;
  tile_at(t, ntiles, bi, bj);
  const bool diag = bi == bj;
  const int c0i = bi * TILE, c0j = bj * TILE;
  const int r0 = (int)((long long)s * rows / splits);
  const int r1 = (int)((long long)(s + 1) * rows / splits);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;  // sub-tile: columns i wm*64.., j wn*32..
  const int gid = lane >> 2, tig = lane & 3;

  // Loads: this thread copies 16-byte chunk lc of slab rows lr + 8 q.
  const int lr = tid >> 5, lc = tid & 31;
  const uint32_t ldst = ring + (lr * XLD + 4 * lc) * 4;
  const bool li = c0i + 4 * lc < n, lj = c0j + 4 * lc < n;
  const float* xi = x + (li ? c0i + 4 * lc : 0);
  const float* xj = x + (lj ? c0j + 4 * lc : 0);
  const int nch = (r1 - r0 + CHUNK - 1) / CHUNK;
  auto load = [&](int ch) {
    const uint32_t dst = ldst + (ch % STAGES) * XSTAGE;
#pragma unroll
    for (int q = 0; q < CHUNK / 8; ++q) {
      const int r = r0 + ch * CHUNK + lr + 8 * q;
      const size_t off = r < r1 ? (size_t)r * n : 0;
      cp_async16(dst + q * 8 * XLD * 4, xi + off, r < r1 && li);
      if (!diag) cp_async16(dst + XSLAB + q * 8 * XLD * 4, xj + off, r < r1 && lj);
    }
  };

  // Fragment offsets (floats) in a slab at k8 step 0: A(m, k) = x(row k,
  // column c0i + m), B(k, n) = x(row k, column c0j + n).
  const int a_off = tig * XLD + wm * 64 + gid, b_off = tig * XLD + wn * 32 + gid;
  float sum[4][4][4];  // the running fp32 sums
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[mi][nj][e] = 0.f;
  float colsum = 0.f;  // diagonal blocks: sum |x| of column c0i + tid (tid < TILE)

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nch) load(st);
    cp_async_commit();
  }
  for (int ch = 0; ch < nch; ++ch) {
    // Chunk ch has landed for every thread, and every warp is done with
    // chunk ch - 1, whose slot the next load refills.
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (ch + STAGES - 1 < nch) load(ch + STAGES - 1);
    cp_async_commit();
    const float* si = reinterpret_cast<const float*>(smem_x + (ch % STAGES) * XSTAGE);
    const float* sj = diag ? si : si + XSLAB / 4;
    if (diag && tid < TILE) {
#pragma unroll 8
      for (int r = 0; r < CHUNK; ++r) colsum += fabsf(si[r * XLD + tid]);
    }
#pragma unroll
    for (int kk = 0; kk < CHUNK / 8; ++kk) {
      const float* ak = si + a_off + kk * 8 * XLD;
      const float* bk = sj + b_off + kk * 8 * XLD;
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int h = 0; h < 2; ++h) tf32_split(bk[h * 4 * XLD + 8 * nj], bh[nj][h], bl[nj][h]);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          tf32_split(ak[(e >> 1) * 4 * XLD + (e & 1) * 8 + 16 * mi], ah[e], al[e]);
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(acc, al, bh[nj][0], bh[nj][1]);
          mma_tf32(acc, ah, bl[nj][0], bl[nj][1]);
          mma_tf32(acc, ah, bh[nj][0], bh[nj][1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) sum[mi][nj][e] += acc[e];
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring, which the tile reuses

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tile[(wm * 64 + 16 * mi + gid + 8 * (e >> 1)) * ELD + wn * 32 + 8 * nj + 2 * tig +
             (e & 1)] = sum[mi][nj][e];
  __syncthreads();
  if (splits == 1) {
    store_tile(tile, TILE, 0, diag, g, n, c0i, c0j);
    if (diag && tid < TILE && c0i + tid < n) asum[c0i + tid] = colsum;
    return;
  }
  const size_t e = blockIdx.y;
  float* p = part + ((e * splits + s) * upper + t) * TILE * TILE;
  for (int idx = tid; idx < TILE * TILE; idx += THREADS)
    p[idx] = tile[(idx / TILE) * ELD + idx % TILE];
  if (diag && tid < TILE) apart[((e * splits + s) * ntiles + bi) * TILE + tid] = colsum;
}

// The partials of gram_tf32x3 summed in split order: a block a (upper
// tile, RQ-row quarter), each thread 16 entries, the quarter's G rows and
// mirror through shared memory; a diagonal tile's first quarter also sums
// |x| of the tile's columns.
__global__ void __launch_bounds__(THREADS)
gram_tf32x3_reduce(const float* __restrict__ part, const float* __restrict__ apart,
                   float* __restrict__ g, float* __restrict__ asum, int n, int ntiles,
                   int splits) {
  __shared__ float tile[RQ * ELD];
  const int quarters = TILE / RQ;
  const int upper = gridDim.x / quarters, t = blockIdx.x / quarters, q = blockIdx.x % quarters;
  const size_t e = blockIdx.y;
  g += e * n * n, asum += e * n;
  int bi, bj;
  tile_at(t, ntiles, bi, bj);
  const bool diag = bi == bj;
  const int c0i = bi * TILE, c0j = bj * TILE;
  const size_t step = (size_t)upper * TILE * TILE / 4;  // one split to the next, float4s
  const float4* p = reinterpret_cast<const float4*>(part + ((e * splits) * upper + t) * TILE *
                                                    TILE + q * RQ * TILE);
#pragma unroll
  for (int k = 0; k < RQ * TILE / 4 / THREADS; ++k) {
    const int idx = threadIdx.x + THREADS * k, r = idx / (TILE / 4), c = 4 * (idx % (TILE / 4));
    float4 v = p[idx];
    for (int sp = 1; sp < splits; ++sp) {
      const float4 w = p[sp * step + idx];
      v.x += w.x, v.y += w.y, v.z += w.z, v.w += w.w;
    }
    float* dst = tile + r * ELD + c;
    dst[0] = v.x, dst[1] = v.y, dst[2] = v.z, dst[3] = v.w;
  }
  if (diag && q == 0 && threadIdx.x < TILE && c0i + threadIdx.x < n) {
    float a = 0.f;
    for (int sp = 0; sp < splits; ++sp)
      a += apart[((e * splits + sp) * ntiles + bi) * TILE + threadIdx.x];
    asum[c0i + threadIdx.x] = a;
  }
  __syncthreads();
  store_tile(tile, RQ, q * RQ, diag, g, n, c0i, c0j);
}

int launch_tf32x3(const float* x, float* g, float* asum, float* part, float* apart, int rows,
                  int n, int ntiles, int blocks, int batch, int splits, cudaStream_t st) {
  static bool configured = false;  // one attribute call
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(gram_tf32x3,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, X3_SMEM);
    if (e == cudaSuccess)  // all of the SM's shared memory: two blocks fit
      e = cudaFuncSetAttribute(gram_tf32x3, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  gram_tf32x3<<<dim3(blocks * splits, batch), THREADS, X3_SMEM, st>>>(x, g, asum, part, apart,
                                                                      rows, n, ntiles, splits);
  if (splits > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    gram_tf32x3_reduce<<<dim3(blocks * (TILE / RQ), batch), THREADS, 0, st>>>(
        part, apart, g, asum, n, ntiles, splits);
  }
  return 0;
}

}  // namespace

// x (batch, rows, n) contiguous (the single form: batch 1), dtype 0 fp32 /
// 1 bf16; kernel 0 the FMA kernel, 1 the mma kernel (bf16 only, n % 8 ==
// 0, x 16-byte aligned), 2 the tf32x3 kernel (fp32 only, n % 4 == 0, x
// 16-byte aligned) over ``splits`` row splits, with part and apart its
// scratch when splits > 1 (see gram_tf32x3); g (batch, n, n) fp32 and asum
// (batch, n) fp32 are written in full.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for what the named kernel does not take.
extern "C" int gram_launch(const void* x, float* g, float* asum, float* part, float* apart,
                           int rows, int n, int batch, int dtype, int kernel, int splits,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ntiles = (n + TILE - 1) / TILE;
  const int blocks = ntiles * (ntiles + 1) / 2;
  if (batch < 1 || batch > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks, batch);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (kernel == 2) {
    if (dtype != kF32 || n % 4 != 0 || !aligned || splits < 1 ||
        (long long)blocks * splits > 0x7fffffffLL || (splits > 1 && (!part || !apart)))
      return (int)cudaErrorInvalidValue;
    const int rc = launch_tf32x3((const float*)x, g, asum, part, apart, rows, n, ntiles,
                                 blocks, batch, splits, st);
    if (rc != 0) return rc;
  } else if (kernel == 1) {
    if (dtype != kBF16 || n % 8 != 0 || !aligned) return (int)cudaErrorInvalidValue;
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
