// Nested low-rank matmul for Hopper:  y = (x @ u) @ v + (x @ u2) @ v2.
//
// Replaces the TPU kernel src/repro/kernels/nested_lowrank/nested_lowrank.py
// (nested_lowrank_matmul, body _kernel), which keeps x, u and u2 resident in
// VMEM and streams v/v2 tiles.  Its semantics are kept: t = x @ [u|u2] summed
// in fp32 over all of K and rounded to the factor dtype once
// (t_ref[...].astype(v.dtype)); y = t @ [v;v2] summed in fp32 and rounded
// once.  The concatenation identity is exact, and the four factors are read
// in place: no per-call copy or concatenation.
//
// What bounds it here: at decode (M = live rows, 1..16) every factor byte
// is read once for a handful of rows, so the kernel is bound by the bytes of
// the factors.  At ratio 0.2 a Mistral-7B-width gate projection's four
// bf16 factors are 94.2 MB: 28.1 us at 3.35 TB/s.  At M = 8 each factor
// element takes 8 FMAs, which fp32 FMA on the CUDA cores can issue in
// about half that time (at M = 16 in about all of it); measured, the
// stream kernel below reaches about half the byte rate at M = 8, held by
// instruction issue and latency, not by bytes (PERF.md).  At
// prefill-chunk row counts the product turns compute-bound: at M = 512 the
// gate projection is 48.1 GFLOP (48.6 us at the bf16 tensor-core peak)
// against 28.1 us of bytes, so rows 17..1024 run on the tensor cores.
//
// The TPU design's resident factors cannot carry over (bf16 u alone is
// 20.9 MB at rank 2548, a block has 227 KB of shared memory), so both
// factors are streamed.  Two phases, each a split-K pass into fp32
// partials and a fixed-order reduction (reduce_partials; deterministic, no
// atomics):  phase 1 t = x @ [u|u2] -> t (M, k1+k2) in the factor dtype;
// phase 2 y = t @ [v;v2].  Split-K spreads each skinny product over ~2
// blocks per SM.  Three kernels, chosen by the wrapper (ops.plan) and
// checked here:
//
// stream_partial: bf16, M <= 16, N % 8 == 0, v and v2 16-byte aligned (u
//   and u2 at any address and any rank).  Built to keep bytes in flight:
//  * Each factor gets its own column tiles (phase 1: u's, then u2's) or
//    K-ranges (phase 2: v's splits, then v2's), so no tile straddles the
//    u/u2 seam and no element load branches on it.
//  * A tile is BN = 256 columns; factor rows stream through a 4-stage ring
//    of BK = 32-row stages by 16-byte cp.async.cg, one barrier a stage.
//  * Any rank, any base address: u's rows (ld = k1, often odd) start at
//    any 2-byte address, so a row cannot be copied with aligned 16-byte
//    loads as it stands.  Each row's span [row*ld + n0, + BN) is covered by
//    the 16-byte-aligned chunks that hold it, copied into a shared row of
//    BN + 8 elements; the row's shift (address / 2 mod 8, the same for every
//    stage because BK * ld and the tile origins are multiples of 8) says
//    where column 0 lies, and column j is read at shift + j (an odd shift
//    reads two 4-byte words and joins their halves).  Only chunks holding
//    an element of the span are copied; the cp.async src-size form
//    zero-fills past the span's end instead of reading it, and rows past
//    the block's K-range are zero-filled.  A chunk's bytes before the span
//    lie in the same allocation, which the allocator aligns to far more
//    than 16 bytes.  Phase 2's rows (ld = N, N % 8 == 0, v/v2 aligned)
//    have shift 0, and the template flag SHIFT compiles it out.
//  * The block's slice of the left operand (x, or t in phase 2) is put in
//    shared memory once, widened to fp32 as [k][MT], so a thread reads all
//    MT rows of one k with MT/4 broadcast 16-byte loads.
//  * MT in {8, 16} row tiles; a thread holds MT x C fp32 sums for C
//    columns in C/2 pairs strided by 64 (conflict-free 4-byte reads); the
//    8 warps split a stage's rows, and their sums are added in a fixed
//    order through shared memory at the end.  MT 8 (C 8) runs 2 blocks an
//    SM at <= 128 registers; MT 16 (C 4) 1 block, since 128 registers
//    spill there.  No tensor cores (fp32 FMA), which is what now limits
//    it: mma.sync is the next step.
//
// mma_partial: bf16, 17 <= M <= 1024, K % 8 == 0, N % 8 == 0, x, v and v2
//   16-byte aligned (u and u2 at any address and any rank).  The tensor
//   cores, fed the stream kernel's way:
//  * (128 rows, 128 columns) block tiles, 8 warps as 2 x 4 of (64, 32);
//    mma.sync m16n8k16 bf16 with fp32 sums in registers, A fragments by
//    ldmatrix, B fragments by ldmatrix.trans from the row-major (k, n)
//    tile.  Rows past M load as zeros and are never stored; a warp skips
//    its m16 tiles that lie wholly past M.
//  * A 4-stage ring of BK = 32-deep stages by 16-byte cp.async.cg: the
//    left operand's (128, 32) tile (64-byte rows, chunk ^ (row/2 mod 4))
//    and the factor's (32, 128) tile (256-byte rows, chunk ^ (row mod 8)),
//    both swizzles free of bank conflicts for ldmatrix.  One barrier a
//    stage: the ring runs one stage ahead of the compute it feeds.
//  * Phase 1's B is u/u2 (ld = k1 or k2, odd ranks the common case), whose
//    rows ldmatrix cannot read in place (it needs 16-byte-aligned rows).
//    Of the two ways out -- re-pack each landed stage into an aligned tile,
//    or build B fragments from 2-byte loads -- this takes the re-pack: the
//    rows arrive by the stream kernel's per-row-shift copy into BN + 8
//    element rows, and one stage ahead of its use every warp moves 4 rows
//    into an aligned, swizzled tile (two of them, alternating) with 4-byte
//    loads, joining the halves of two words where the shift is odd.  That
//    is one shared read and write per factor element, against the >= 17 x
//    2 FLOP each element feeds, while B fragments from 2-byte loads would
//    take ~4 loads and packs per mma in the inner loop.  Phase 2's B (v,
//    v2: ld = N, aligned) needs no re-pack (SHIFT false).
//  * Phase 2's A is t, the wrapper's scratch, laid out (M, tld) with u's
//    columns at 0 and u2's at k1p = k1 rounded up to 8 (tld = k1p + k2
//    rounded up to 8), so that both K-ranges start 16-byte aligned; loads
//    stop at each range's end (src-size), so the padding is never read.
//  * The grid enumerates row tiles fastest, so the blocks that share a
//    factor tile run together and read it once from memory, then from L2.
//
// gemm_partial (the tile kernel): every other call (fp32, or bf16 layouts
//   the two bf16 kernels do not take: N % 8, unaligned v/v2, K % 8 above
//   16 rows).  A (16, 128) or (64, 64) fp32-FMA
//   tile, synchronous 16-deep loads, one element at a time.
//
// The batched form (the reference's vmap over a token-choice MoE layer's
// experts): x (E, M, K), u (E, K, k1), v (E, k1, N), u2 (E, K, k2), v2 (E,
// k2, N) and y (E, M, N), all E products in one launch of each phase.  The
// expert is a grid index (blockIdx.y; the tile kernel folds it into
// blockIdx.z beside the split-K slice) that offsets every operand by its
// per-expert stride; split-K partials are laid out [slice][expert][row]
// [column], so one reduction over E * M columns serves every expert, and t
// (E, M, k) keeps each expert's rounding point.  The single form is E = 1.
#include <algorithm>
#include <climits>

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
             int M, int Kd, int N, int k_chunk, int E, int splits) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "tile/thread mismatch");
  __shared__ float As[kBK][BM];
  __shared__ float Bs[kBK][BN];
  constexpr int TX = BN / TN;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int e = blockIdx.z / splits, zs = blockIdx.z % splits;  // expert, slice
  a += (size_t)e * M * lda;
  b0 += (size_t)e * (SPLIT_COLS ? (size_t)Kd * split : (size_t)split * N);
  b1 += (size_t)e * (SPLIT_COLS ? (size_t)Kd * (N - split) : (size_t)(Kd - split) * N);
  const int kbeg = zs * k_chunk;
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

  float* out = part + ((size_t)zs * E + e) * M * N;
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
                 float* part, int M, int Kd, int N, int splits, int k_chunk, int E,
                 cudaStream_t stream) {
  // Skinny (decode-shaped) rows get a short, wide tile; the wrapper's split
  // heuristic mirrors this choice (SKINNY_ROWS / tile sizes in ops.py).
  if (M <= 16) {
    constexpr int BM = 16, BN = 128;
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits * E);
    gemm_partial<TA, TB, BM, BN, 2, 4, SPLIT_COLS><<<grid, kThreads, 0, stream>>>(
        a, lda, b0, b1, split, part, M, Kd, N, k_chunk, E, splits);
  } else {
    constexpr int BM = 64, BN = 64;
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits * E);
    gemm_partial<TA, TB, BM, BN, 4, 4, SPLIT_COLS><<<grid, kThreads, 0, stream>>>(
        a, lda, b0, b1, split, part, M, Kd, N, k_chunk, E, splits);
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
         int s1, int c1, int s2, int c2, int E, cudaStream_t stream) {
  const int k = k1 + k2;
  launch_gemm<true>(x, K, u, u2, k1, part1, M, K, k, s1, c1, E, stream);
  launch_reduce<T>(part1, t, s1, (size_t)E * M * k, stream);
  launch_gemm<false>(t, k, v, v2, k1, part2, M, k, N, s2, c2, E, stream);
  launch_reduce<T>(part2, y, s2, (size_t)E * M * N, stream);
}

// ---- the stream kernel (bf16, M <= 16) ----

using bf16 = __nv_bfloat16;

constexpr int kBN = 256;             // columns of a tile
constexpr int kSK = 32;              // factor rows a ring stage holds
constexpr int kStages = 4;
constexpr int kRow = kBN + 8;        // shared row, elements (16-byte multiple)
constexpr int kMaxChunk = 512;       // deepest split-K chunk (x slice in smem)
constexpr int kRingBytes = kStages * kSK * kRow * 2;
constexpr int kMaxSmem = kRingBytes + kMaxChunk * 16 * 4;

// One factor of a phase: b (kd, nc) row-major, multiplied by columns
// [a_col, a_col + kd) of the left operand, its partial sums written to
// columns [out_col, out_col + nc) of slices [z0, z0 + splits).
struct Seg {
  const bf16* b;
  int kd, nc, a_col, out_col;
  int tiles;   // ceil(nc / kBN)
  int splits;  // ceil(kd / chunk)
  int z0;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, of which the first `bytes` are read and the
// rest zero-filled (0 reads nothing).  src is 16-byte aligned.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
// Expert blockIdx.y's (kd, nc) factor in a batch of them, row-major.
__device__ __forceinline__ const bf16* expert_factor(const bf16* b, int kd, int nc) {
  return b + (size_t)blockIdx.y * kd * nc;
}

// One (segment, column tile, split-K slice) per block; grid x over s0's
// tiles x splits, then s1's, grid y over the batch's experts.  Partials:
// part[z][expert][m][out_col + col], row stride out_ld, for m < M.
template <int MT, int C, bool SHIFT>
__global__ void __launch_bounds__(kThreads, MT == 8 ? 2 : 1)
stream_partial(const bf16* __restrict__ a, int lda, Seg s0, Seg s1,
               float* __restrict__ part, int M, int out_ld, int chunk) {
  constexpr int WN = 32 * C;                 // columns a warp covers
  constexpr int WARPS_N = kBN / WN;
  constexpr int WARPS_K = kThreads / 32 / WARPS_N;
  constexpr int RPW = kSK / WARPS_K;         // rows of a stage a warp takes
  constexpr int CH = SHIFT ? kRow / 8 : kBN / 8;  // chunks copied a row
  constexpr int COPIES = (kSK * CH + kThreads - 1) / kThreads;
  static_assert(WARPS_N * WN == kBN && WARPS_K * RPW == kSK && MT % 4 == 0, "tiling");
  static_assert(WARPS_K * MT * kBN * 4 <= kRingBytes, "the reduction reuses the ring");

  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem + kRingBytes);  // [chunk][MT]
  const uint32_t ring = smem_u32(smem);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int blk = blockIdx.x;
  const bool second = blk >= s0.tiles * s0.splits;
  if (second) blk -= s0.tiles * s0.splits;
  const int tiles = second ? s1.tiles : s0.tiles;
  const int tile = blk % tiles, split = blk / tiles;
  const bf16* __restrict__ b = second ? s1.b : s0.b;
  const int kd = second ? s1.kd : s0.kd, nc = second ? s1.nc : s0.nc;
  b = expert_factor(b, kd, nc);
  a += (size_t)blockIdx.y * M * lda;
  const int a_col = second ? s1.a_col : s0.a_col;
  const int out_col = second ? s1.out_col : s0.out_col;
  const int z = (second ? s1.z0 : s0.z0) + split;
  const int n0 = tile * kBN, ncols = min(kBN, nc - n0);
  const int kbeg = split * chunk, krows = min(chunk, kd - kbeg);
  const int nst = (krows + kSK - 1) / kSK;  // ring stages of this block

  // Element offset (mod 8) of the block's first row's column n0; row r of
  // any stage starts at shift (sh0 + r * nc) & 7, since kSK * nc, kbeg and
  // n0 are multiples of 8.
  const unsigned sh0 = SHIFT ? (unsigned)(reinterpret_cast<uintptr_t>(b) >> 1)
                                   + (unsigned)kbeg * nc + n0 : 0u;
  const bf16* b_al = b - (sh0 & 7);  // 16-byte aligned, in b's allocation

  // This thread's copies: chunk i = tid + p * kThreads is row i / CH,
  // chunk i % CH of every stage.  coff: element offset from b_al of the
  // chunk at stage 0; cbytes: bytes of it inside the span (0: skip).
  int coff[COPIES], cbytes[COPIES];
#pragma unroll
  for (int p = 0; p < COPIES; ++p) {
    const int i = tid + p * kThreads, r = i / CH, j = i % CH;
    const int sh = SHIFT ? (int)((sh0 + (unsigned)r * nc) & 7u) : 0;
    const int live = min(8, sh + ncols - 8 * j);  // span elements in chunk j
    coff[p] = (kbeg + r) * nc + n0 + 8 * j + (int)(sh0 & 7) - sh;
    cbytes[p] = (i < kSK * CH && 8 * j + 8 > sh && live > 0) ? 2 * live : 0;
  }
  auto load_stage = [&](int st) {
    if (st < nst) {
      const uint32_t base = ring + (uint32_t)((st % kStages) * kSK * kRow * 2);
      const size_t step = (size_t)st * kSK * nc;
#pragma unroll
      for (int p = 0; p < COPIES; ++p) {
        const int i = tid + p * kThreads;
        if (COPIES * kThreads == kSK * CH || i < kSK * CH) {
          const int r = i / CH, j = i % CH;
          const bool ok = st * kSK + r < krows && cbytes[p] > 0;
          cp_async16(base + (uint32_t)((r * kRow + 8 * j) * 2),
                     ok ? b_al + coff[p] + step : b_al, ok ? cbytes[p] : 0);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) load_stage(st);

  // The left operand's slice, widened, zero past the K-range and past M.
  const int xrows = nst * kSK;
  for (int i = tid; i < xrows * MT; i += kThreads) {
    const int m = i / xrows, kk = i % xrows;
    float val = 0.f;
    if (m < M && kk < krows) val = __bfloat162float(a[(size_t)m * lda + a_col + kbeg + kk]);
    xs[kk * MT + m] = val;
  }

  const int wn = warp % WARPS_N, wk = warp / WARPS_N;
  const int wcol = wn * WN / 2 + lane;  // word of this thread's first pair
  float acc[MT][C];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[m][c] = 0.f;

  for (int st = 0; st < nst; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    load_stage(st + kStages - 1);
    const uint32_t* rows = reinterpret_cast<const uint32_t*>(
        smem + (st % kStages) * kSK * kRow * 2);
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = wk * RPW + i;
      float xv[MT];
      const float4* xr = reinterpret_cast<const float4*>(xs + (st * kSK + r) * MT);
#pragma unroll
      for (int q = 0; q < MT / 4; ++q) {
        const float4 f = xr[q];
        xv[4 * q] = f.x, xv[4 * q + 1] = f.y, xv[4 * q + 2] = f.z, xv[4 * q + 3] = f.w;
      }
      const int sh = SHIFT ? (int)((sh0 + (unsigned)r * nc) & 7u) : 0;
      const uint32_t* w = rows + r * (kRow / 2) + (sh >> 1) + wcol;
      float bv[C];
      if (SHIFT && (sh & 1)) {
#pragma unroll
        for (int p = 0; p < C / 2; ++p) {
          const uint32_t joined = __byte_perm(w[32 * p], w[32 * p + 1], 0x5432);
          bv[2 * p] = bf_lo(joined), bv[2 * p + 1] = bf_hi(joined);
        }
      } else {
#pragma unroll
        for (int p = 0; p < C / 2; ++p) {
          const uint32_t word = w[32 * p];
          bv[2 * p] = bf_lo(word), bv[2 * p + 1] = bf_hi(word);
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[m][c] = fmaf(xv[m], bv[c], acc[m][c]);
    }
  }

  // The warps' sums over their rows, added in a fixed order.
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [WARPS_K][MT][kBN]
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int p = 0; p < C / 2; ++p)
      *reinterpret_cast<float2*>(red + (wk * MT + m) * kBN + 2 * (wcol + 32 * p)) =
          make_float2(acc[m][2 * p], acc[m][2 * p + 1]);
  __syncthreads();
  float* out = part + ((size_t)z * gridDim.y + blockIdx.y) * M * out_ld + out_col + n0;
  for (int i = tid; i < M * kBN; i += kThreads) {
    const int m = i / kBN, c = i % kBN;
    if (c >= ncols) continue;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < WARPS_K; ++q) s += red[(q * MT + m) * kBN + c];
    out[(size_t)m * out_ld + c] = s;
  }
}

template <int MT, int C, bool SHIFT>
int launch_stream(const bf16* a, int lda, const Seg& s0, const Seg& s1, float* part,
                  int M, int out_ld, int chunk, int E, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(stream_partial<MT, C, SHIFT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int blocks = s0.tiles * s0.splits + s1.tiles * s1.splits;
  if (blocks == 0) return 0;
  const size_t smem = kRingBytes + (size_t)chunk * MT * 4;
  stream_partial<MT, C, SHIFT><<<dim3(blocks, E), kThreads, smem, stream>>>(a, lda, s0, s1, part,
                                                                          M, out_ld, chunk);
  return (int)cudaGetLastError();
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// The stream kernel's phases.  Refuses (cudaErrorInvalidValue) what it
// cannot do: M outside 1..16, N % 8 != 0, v or v2 not 16-byte aligned, a
// chunk that is not a positive multiple of kSK up to kMaxChunk, or splits
// that do not cover each depth with that chunk, or factors whose element
// offsets pass 2^31.
int run_stream(const bf16* x, const bf16* u, const bf16* v, const bf16* u2, const bf16* v2,
               bf16* y, float* part1, bf16* t, float* part2, int M, int K, int k1, int k2,
               int N, int s1, int c1, int s2, int c2, int E, cudaStream_t stream) {
  auto chunk_ok = [](int c) { return c > 0 && c % kSK == 0 && c <= kMaxChunk; };
  const int sv = cdiv(k1, c2), sv2 = cdiv(k2, c2);
  if (M < 1 || M > 16 || N % 8 || reinterpret_cast<uintptr_t>(v) % 16 ||
      reinterpret_cast<uintptr_t>(v2) % 16 || !chunk_ok(c1) || !chunk_ok(c2) ||
      s1 != cdiv(K, c1) || s2 != sv + sv2 ||
      (long long)(K + kSK) * std::max(k1, k2) >= INT_MAX ||
      (long long)(std::max(k1, k2) + kSK) * N >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int k = k1 + k2;
  const Seg pu{u, K, k1, 0, 0, cdiv(k1, kBN), s1, 0};
  const Seg pu2{u2, K, k2, 0, k1, cdiv(k2, kBN), s1, 0};
  int e = M <= 8 ? launch_stream<8, 8, true>(x, K, pu, pu2, part1, M, k, c1, E, stream)
                 : launch_stream<16, 4, true>(x, K, pu, pu2, part1, M, k, c1, E, stream);
  if (e) return e;
  launch_reduce<bf16>(part1, t, s1, (size_t)E * M * k, stream);
  const Seg pv{v, k1, N, 0, 0, cdiv(N, kBN), sv, 0};
  const Seg pv2{v2, k2, N, k1, 0, cdiv(N, kBN), sv2, sv};
  e = M <= 8 ? launch_stream<8, 8, false>(t, k, pv, pv2, part2, M, N, c2, E, stream)
             : launch_stream<16, 4, false>(t, k, pv, pv2, part2, M, N, c2, E, stream);
  if (e) return e;
  launch_reduce<bf16>(part2, y, s2, (size_t)E * M * N, stream);
  return 0;
}


// ---- the mma kernel (bf16, 17 <= M <= 1024) ----

constexpr int kMM = 128;                  // rows of a block tile
constexpr int kMN = 128;                  // columns of a block tile
constexpr int kMK = 32;                   // depth of a ring stage
constexpr int kMStages = 4;
constexpr int kARow = kMK * 2;            // bytes of an A tile row (4 chunks)
constexpr int kATile = kMM * kARow;
constexpr int kBRow = kMN * 2;            // bytes of an aligned B tile row (16 chunks)
constexpr int kBTile = kMK * kBRow;
constexpr int kRawRow = (kMN + 8) * 2;    // bytes of a shifted B row (17 chunks)
constexpr int kRawTile = kMK * kRawRow;
template <bool SHIFT>
constexpr int mma_smem_bytes() {
  return kMStages * kATile + (SHIFT ? kMStages * kRawTile + 2 * kBTile : kMStages * kBTile);
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One (segment, column tile, row tile, split-K slice) per block; grid x,
// row tiles fastest, over s0's tiles x splits, then s1's, grid y over the
// batch's experts.  Partials: part[z][expert][m][out_col + col], row stride
// out_ld, for m < M.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16), lane = 4 * gid + tig:
//   C {(gid, 2tig), (gid, 2tig+1), (gid+8, 2tig), (gid+8, 2tig+1)}.
// ldmatrix.x4: lanes 8i..8i+7 address the rows of matrix i, which lands in
// register i (.trans: transposed).  A: matrices (rows 0-7, k 0-7), (rows
// 8-15, k 0-7), (rows 0-7, k 8-15), (rows 8-15, k 8-15); B (.trans):
// (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15), the
// B registers of two n8 tiles.
template <bool SHIFT>
__global__ void __launch_bounds__(kThreads, 2)
mma_partial(const bf16* __restrict__ a, int lda, Seg s0, Seg s1, float* __restrict__ part,
            int M, int out_ld, int chunk, int mtiles) {
  constexpr int CH = SHIFT ? kRawRow / 16 : kBRow / 16;  // chunks copied a factor row
  constexpr int BCOPIES = (kMK * CH + kThreads - 1) / kThreads;
  constexpr int ACH = kARow / 16;                        // chunks of an A row
  constexpr int ACOPIES = kMM * ACH / kThreads;
  constexpr int BSLOT = SHIFT ? kRawTile : kBTile;
  static_assert(ACOPIES * kThreads == kMM * ACH && kMK % 16 == 0, "tiling");
  static_assert(kMK == 4 * (kThreads / 32), "the re-pack gives each warp 4 rows");

  extern __shared__ __align__(128) unsigned char smem_mma[];
  const uint32_t aring = smem_u32(smem_mma);
  const uint32_t bring = aring + kMStages * kATile;
  const uint32_t bpack = bring + kMStages * kRawTile;  // SHIFT: two aligned tiles

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int blk = blockIdx.x;
  const bool second = blk >= mtiles * s0.tiles * s0.splits;
  if (second) blk -= mtiles * s0.tiles * s0.splits;
  const int mt = blk % mtiles;
  blk /= mtiles;
  const int tiles = second ? s1.tiles : s0.tiles;
  const int tile = blk % tiles, split = blk / tiles;
  const int kd = second ? s1.kd : s0.kd, nc = second ? s1.nc : s0.nc;
  const bf16* const __restrict__ b = expert_factor(second ? s1.b : s0.b, kd, nc);
  a += (size_t)blockIdx.y * M * lda;
  const int a_col = second ? s1.a_col : s0.a_col;
  const int out_col = second ? s1.out_col : s0.out_col;
  const int z = (second ? s1.z0 : s0.z0) + split;
  const int m0 = mt * kMM, n0 = tile * kMN, ncols = min(kMN, nc - n0);
  const int kbeg = split * chunk, krows = min(chunk, kd - kbeg);
  const int nst = (krows + kMK - 1) / kMK;  // ring stages of this block

  // Factor rows, as the stream kernel copies them (SHIFT) or straight into
  // the swizzled tile.  Row r of any stage starts at element shift (sh0 +
  // r * nc) & 7, since kMK * nc, kbeg and n0 are multiples of 8.
  const unsigned sh0 = SHIFT ? (unsigned)(reinterpret_cast<uintptr_t>(b) >> 1)
                                   + (unsigned)kbeg * nc + n0 : 0u;
  const bf16* b_al = b - (sh0 & 7);  // 16-byte aligned, in b's allocation
  int boff[BCOPIES], bbytes[BCOPIES];
#pragma unroll
  for (int p = 0; p < BCOPIES; ++p) {
    const int i = tid + p * kThreads, r = i / CH, j = i % CH;
    const int sh = SHIFT ? (int)((sh0 + (unsigned)r * nc) & 7u) : 0;
    const int live = min(8, sh + ncols - 8 * j);  // span elements in chunk j
    boff[p] = (kbeg + r) * nc + n0 + 8 * j + (int)(sh0 & 7) - sh;
    bbytes[p] = (i < kMK * CH && live > 0) ? 2 * live : 0;
  }
  // The left operand: rows m0.., columns a_col + kbeg.. of this K-range.
  const bf16* arow[ACOPIES];
  uint32_t adst[ACOPIES];
#pragma unroll
  for (int p = 0; p < ACOPIES; ++p) {
    const int i = tid + p * kThreads, r = i / ACH, c = i % ACH;
    arow[p] = m0 + r < M ? a + (size_t)(m0 + r) * lda + a_col + kbeg + 8 * c : nullptr;
    adst[p] = (uint32_t)(r * kARow + ((c ^ ((r >> 1) & 3)) << 4));
  }
  auto load_stage = [&](int st) {
    if (st < nst) {
      const int slot = st % kMStages;
#pragma unroll
      for (int p = 0; p < ACOPIES; ++p) {
        const int live = min(8, krows - st * kMK - 8 * ((tid + p * kThreads) % ACH));
        const bool ok = arow[p] != nullptr && live > 0;
        cp_async16(aring + slot * kATile + adst[p], ok ? arow[p] + st * kMK : a,
                   ok ? 2 * live : 0);
      }
      const size_t step = (size_t)st * kMK * nc;
#pragma unroll
      for (int p = 0; p < BCOPIES; ++p) {
        const int i = tid + p * kThreads;
        if (BCOPIES * kThreads == kMK * CH || i < kMK * CH) {
          const int r = i / CH, j = i % CH;
          const bool ok = st * kMK + r < krows && bbytes[p] > 0;
          const uint32_t dst = SHIFT ? (uint32_t)(r * kRawRow + 16 * j)
                                     : (uint32_t)(r * kBRow + ((j ^ (r & 7)) << 4));
          cp_async16(bring + slot * BSLOT + dst, ok ? b_al + boff[p] + step : b_al,
                     ok ? bbytes[p] : 0);
        }
      }
    }
    cp_async_commit();
  };
  // SHIFT: stage st's shifted rows -> aligned tile st & 1.  Warp w moves
  // rows 4w..4w+3, a lane words lane and lane + 32 of each (conflict-free
  // 4-byte reads; the swizzle keeps a row's half within its 32 banks).
  auto repack = [&](int st) {
    if (!SHIFT || st >= nst) return;
    const unsigned char* raw = smem_mma + kMStages * kATile + (st % kMStages) * kRawTile;
    unsigned char* dst = smem_mma + kMStages * kATile + kMStages * kRawTile + (st & 1) * kBTile;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = warp * 4 + q;
      const int sh = (int)((sh0 + (unsigned)r * nc) & 7u);
      const uint32_t* w = reinterpret_cast<const uint32_t*>(raw + r * kRawRow) + (sh >> 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int wl = 32 * h + lane;  // word of columns 2 wl, 2 wl + 1
        uint32_t word = w[wl];
        if (sh & 1) word = __byte_perm(word, w[wl + 1], 0x5432);
        *reinterpret_cast<uint32_t*>(dst + r * kBRow + (((wl >> 2) ^ (r & 7)) << 4) +
                                     ((wl & 3) << 2)) = word;
      }
    }
  };

  // ldmatrix addresses of this lane: A rows wm*64 + 16 i + (lane & 15),
  // chunk 2 kk + (lane >> 4); B rows 16 kk + (lane & 7) + 8 ((lane >> 3) &
  // 1), chunk wn*4 + 2 dn + (lane >> 4).  Swizzles by (row/2 mod 4) and (row
  // mod 8), which depend on the lane only.
  const int wm = warp / 4, wn = warp % 4;
  uint32_t a_off[kMK / 16], b_off[2];
#pragma unroll
  for (int kk = 0; kk < kMK / 16; ++kk)
    a_off[kk] = (uint32_t)((wm * 64 + (lane & 15)) * kARow +
                           (((2 * kk + (lane >> 4)) ^ ((lane >> 1) & 3)) << 4));
#pragma unroll
  for (int dn = 0; dn < 2; ++dn)
    b_off[dn] = (uint32_t)(((lane & 7) + (((lane >> 3) & 1) << 3)) * kBRow +
                           (((wn * 4 + 2 * dn + (lane >> 4)) ^ (lane & 7)) << 4));
  const int mlive = M - m0 - wm * 64;  // rows of this warp's 64 that exist

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

#pragma unroll
  for (int st = 0; st < kMStages - 1; ++st) load_stage(st);
  cp_async_wait<kMStages - 2>();  // stage 0 has landed (this thread's copies)
  __syncthreads();
  repack(0);
  for (int st = 0; st < nst; ++st) {
    // Stage st + 1 has landed for every thread; every warp is done with
    // stage st - 1, whose ring slot the next load refills.
    cp_async_wait<kMStages - 3>();
    __syncthreads();
    load_stage(st + kMStages - 1);
    repack(st + 1);
    const uint32_t as = aring + (st % kMStages) * kATile;
    const uint32_t bs = SHIFT ? bpack + (st & 1) * kBTile : bring + (st % kMStages) * kBTile;
#pragma unroll
    for (int kk = 0; kk < kMK / 16; ++kk) {
      uint32_t bf[2][4];  // n8 tiles 2 dn, 2 dn + 1 x both k halves
#pragma unroll
      for (int dn = 0; dn < 2; ++dn) ldsm_x4_trans(bs + kk * 16 * kBRow + b_off[dn], bf[dn]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (16 * i < mlive) {
          uint32_t af[4];
          ldsm_x4(as + a_off[kk] + i * 16 * kARow, af);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_bf16(acc[i][j], af, bf[j >> 1][2 * (j & 1)], bf[j >> 1][2 * (j & 1) + 1]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const int gid = lane >> 2, tig = lane & 3;
  float* out = part + ((size_t)z * gridDim.y + blockIdx.y) * M * out_ld + out_col + n0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wm * 64 + 16 * i + gid + 8 * h;
      if (m0 + row >= M) continue;
      float* orow = out + (size_t)(m0 + row) * out_ld;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = wn * 32 + 8 * j + 2 * tig;
        if (col + 1 < ncols)
          *reinterpret_cast<float2*>(orow + col) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        else if (col < ncols)
          orow[col] = acc[i][j][2 * h];
      }
    }
}

template <bool SHIFT>
int launch_mma(const bf16* a, int lda, const Seg& s0, const Seg& s1, float* part, int M,
               int out_ld, int chunk, int E, cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<SHIFT>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(mma_partial<SHIFT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int mtiles = cdiv(M, kMM);
  const int blocks = mtiles * (s0.tiles * s0.splits + s1.tiles * s1.splits);
  if (blocks == 0) return 0;
  mma_partial<SHIFT><<<dim3(blocks, E), kThreads, smem, stream>>>(a, lda, s0, s1, part, M,
                                                                   out_ld, chunk, mtiles);
  return (int)cudaGetLastError();
}

int round8(int n) { return (n + 7) / 8 * 8; }

// The mma kernel's phases; t is (M, round8(k1) + round8(k2)), u2's columns
// from round8(k1) on.  Refuses (cudaErrorInvalidValue) what it cannot do:
// M outside 17..1024, K % 8 != 0, N % 8 != 0, x, t, v or v2 not 16-byte
// aligned, a chunk that is not a positive multiple of kMK, splits that do
// not cover each depth with that chunk, or factors whose element offsets
// pass 2^31.
int run_mma(const bf16* x, const bf16* u, const bf16* v, const bf16* u2, const bf16* v2,
            bf16* y, float* part1, bf16* t, float* part2, int M, int K, int k1, int k2, int N,
            int s1, int c1, int s2, int c2, int E, cudaStream_t stream) {
  auto chunk_ok = [](int c) { return c > 0 && c % kMK == 0; };
  auto al = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (!chunk_ok(c1) || !chunk_ok(c2)) return (int)cudaErrorInvalidValue;
  const int sv = cdiv(k1, c2), sv2 = cdiv(k2, c2);
  if (M < 17 || M > 1024 || K % 8 || N % 8 || !al(x) || !al(t) || !al(v) || !al(v2) ||
      s1 != cdiv(K, c1) || s2 != sv + sv2 ||
      (long long)(K + kMK) * std::max(k1, k2) >= INT_MAX ||
      (long long)(std::max(k1, k2) + kMK) * N >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int k1p = round8(k1), tld = k1p + round8(k2);
  const Seg pu{u, K, k1, 0, 0, cdiv(k1, kMN), s1, 0};
  const Seg pu2{u2, K, k2, 0, k1p, cdiv(k2, kMN), s1, 0};
  int e = launch_mma<true>(x, K, pu, pu2, part1, M, tld, c1, E, stream);
  if (e) return e;
  launch_reduce<bf16>(part1, t, s1, (size_t)E * M * tld, stream);
  const Seg pv{v, k1, N, 0, 0, cdiv(N, kMN), sv, 0};
  const Seg pv2{v2, k2, N, k1p, 0, cdiv(N, kMN), sv2, sv};
  e = launch_mma<false>(t, tld, pv, pv2, part2, M, N, c2, E, stream);
  if (e) return e;
  launch_reduce<bf16>(part2, y, s2, (size_t)E * M * N, stream);
  return 0;
}

}  // namespace

// x (E, M, K), u (E, K, k1), v (E, k1, N), u2 (E, K, k2), v2 (E, k2, N),
// y (E, M, N) for E = batch >= 1 (the single form: E = 1), all of one
// dtype (0 fp32, 1 bf16), row-major and contiguous.  Scratch: part1 fp32
// (s1, E, M, k1+k2), t (E, M, k1+k2) in the factor dtype, part2 fp32
// (s2, E, M, N).  kernel 0 (tile): c1/c2 are the split-K chunk depths
// (multiples of 16), s1 = ceil(K / c1), s2 = ceil((k1+k2) / c2).  kernel 1
// (stream, bf16 only): chunks are multiples of 32 up to 512, s1 = ceil(K /
// c1), s2 = ceil(k1 / c2) + ceil(k2 / c2).  kernel 2 (mma, bf16 only):
// chunks are multiples of 32, splits as the stream kernel's, and t and
// part1 have round8(k1) + round8(k2) columns (u2's from round8(k1)).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a launch the
// chosen kernel cannot do.
extern "C" int nested_lowrank_launch(const void* x, const void* u, const void* v,
                                     const void* u2, const void* v2, void* y,
                                     float* part1, void* t, float* part2, int M,
                                     int K, int k1, int k2, int N, int s1, int c1,
                                     int s2, int c2, int batch, int dtype, int kernel,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch < 1 || batch > 65535) return (int)cudaErrorInvalidValue;
  if (kernel == 1 || kernel == 2) {
    if (dtype != kBF16) return (int)cudaErrorInvalidValue;
    const int e = (kernel == 1 ? run_stream : run_mma)(
        (const bf16*)x, (const bf16*)u, (const bf16*)v, (const bf16*)u2, (const bf16*)v2,
        (bf16*)y, part1, (bf16*)t, part2, M, K, k1, k2, N, s1, c1, s2, c2, batch, st);
    return e ? e : (int)cudaGetLastError();
  }
  if (kernel != 0 || (long long)std::max(s1, s2) * batch > 65535)  // grid z: slices x experts
    return (int)cudaErrorInvalidValue;
  if (dtype == kF32) {
    run<float>((const float*)x, (const float*)u, (const float*)v, (const float*)u2,
               (const float*)v2, (float*)y, part1, (float*)t, part2, M, K, k1, k2,
               N, s1, c1, s2, c2, batch, st);
  } else if (dtype == kBF16) {
    run<bf16>((const bf16*)x, (const bf16*)u, (const bf16*)v, (const bf16*)u2,
              (const bf16*)v2, (bf16*)y, part1, (bf16*)t, part2, M, K, k1, k2, N, s1, c1,
              s2, c2, batch, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
