// Causal GQA flash-attention backward for Hopper (training): given q (B, S,
// Hq, hd), k/v (B, S, Hkv, hd), the forward's out (B, S, Hq, hd) and its
// row log-sum-exp lse (B, Hq, S) fp32, and dout like out, computes dq (like
// q) and dk, dv (like k), query head h reading KV head h / G as in the
// forward (csrc/flash_attention.cu).
//
// Replaces no TPU kernel: the reference differentiates its jnp attention
// through XLA (no Pallas kernel of the JAX package has a VJP).  The port
// routes every causal train forward through its flash kernel, whose output
// autograd cannot differentiate, so training on the card needs this one.
//
// The FA2 backward:
//   D  = rowsum(dO * O)                       (flash_bwd_dsum_kernel)
//   P  = exp(S * scale - lse), S = Q K^T, zero above the diagonal
//   dV = P^T dO,  dS = P * (dO V^T - D),  dK = dS^T Q * scale
//                                            (flash_bwd_dkdv_*)
//   dQ = dS K * scale                         (flash_bwd_dq_*)
// dK and dV sum over the G query heads of each KV head.  P is rebuilt from
// lse in both the dK/dV and the dQ kernel (S is computed twice).
//
// Three launches, no atomics: every output element is written by one
// thread of one block, in a fixed order, so two runs give the same bits.
//
// What bounds it here: operations.  The backward does about 2.5 times the
// forward's causal FLOPs (3.5 with S computed twice) against the same
// bytes, far above the card's ridge.  So bf16 at hd <= 128 (every head dim
// of the port's configs) runs on the tensor cores; fp32, and bf16 above hd
// 128, on CUDA cores.  The wrapper's bwd_plan() picks; the launcher
// dispatches on (dtype, padded hd) alone and never falls back.
//
// bf16, hd <= 128 (flash_bwd_dkdv_mma, flash_bwd_dq_mma): mma.sync.m16n8k16
// (bf16 in, fp32 accumulate), in the forward's idiom.
//  * 4 warps, 16 rows each: 64-row tiles.  Tiles arrive by cp.async.cg
//    16-byte copies (src-size 0 zero-fills past S and past hd; hd is padded
//    to HDP in {64, 128} in shared memory only), rows HDP * 2 bytes with
//    their 16-byte chunks swizzled (chunk ^ (row & 7)), and are read by
//    ldmatrix (.trans where the tile's rows are the product's k).  Streamed
//    tiles go through a two-stage ring: the next step's copies are in
//    flight while the warps compute this one, two __syncthreads a step.
//    About 100 KB of shared memory and at most 255 registers a thread, so
//    two blocks an SM.
//  * A warp computes its products in chunks of 32 (queries for dK/dV, keys
//    for dQ): S and dP of a chunk are 16 fp32 each a thread, beside 128
//    accumulator registers at hd 128.
//  * P and dS are rounded to bf16 where they enter a product, as in FA2,
//    straight from the fp32 C fragments into A fragments (no shared-memory
//    round trip); the plain version does not round them.
//  * dK/dV: one block per (batch, KV head, 64-key tile), longest causal
//    rows first; a warp holds 16 keys.  K and V stay in shared memory for
//    the block's life; the block walks the 64-row query tiles from its own
//    diagonal to S, and in each the G query heads of its group, so K and V
//    are read once for all G heads.  Each step streams that tile's Q, dO,
//    lse and D.  Per chunk, transposed so that keys are the rows:
//      S^T = K Q^T, dP^T = V dO^T (K, V as A by ldmatrix; Q, dO as B),
//      P^T = exp2(S^T scale log2e - lse log2e), masked on the diagonal tile
//      and past S; dS^T = P^T (dP^T - D);
//      dV += P^T dO, dK += dS^T Q (dO, Q as B by ldmatrix.trans).
//    dK and dV stay in fp32 registers until the one store (dK times scale).
//  * dQ: rows packed as in the forward (row = position * G + head), so each
//    K/V tile serves all G heads; one block per (batch, KV head, 64 rows),
//    any G, longest causal rows first.  Q's and dO's A fragments stay in
//    registers; K/V tiles stream up to the block's last position.  Per
//    chunk: S = Q K^T, dP = dO V^T, P from lse, dS = P (dP - D), dQ += dS K
//    (K as B by ldmatrix.trans).  dQ is stored once, times scale.
//  * What holds it back: the phases of a chunk run one after another
//    within a warp, each warp re-reads the streamed tile from shared memory
//    for every product, and mma.sync reaches only part of the bf16 peak.
//    Left for later: wgmma, TMA, warp specialisation, one fused pass.
//
// fp32, and bf16 above hd 128 (flash_bwd_dkdv_kernel, flash_bwd_dq_kernel):
// CUDA cores (fp32 FMA).  Tensor cores would compute fp32 in TF32.
//  * dK/dV: one block per (batch, KV head, 32-key tile).  It keeps its K and
//    V tile in shared memory and its dK, dV rows in registers, and walks the
//    32-row query tiles at or after its keys, and in each the G heads of its
//    group.
//  * dQ: one block per (batch, query head, 32-row query tile), its Q, dO
//    rows in shared memory and its dQ rows in registers; it walks the key
//    tiles up to the diagonal.
//  * 256 threads as 32 rows x 8 lanes; a lane holds dims lane + 8 j.  Tiles
//    are widened to fp32 in shared memory with a row stride of hd + 1.
#include <math.h>

#include "common.cuh"
#include "mma_sm90.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BT = 32;  // query rows and keys a tile
constexpr int PLD = BT + 1;  // row stride of the P and dS tiles

size_t smem_bytes(int hd, int tiles_of_p) {
  return sizeof(float) * ((size_t)4 * BT * (hd + 1) + (size_t)tiles_of_p * BT * PLD);
}

// rows x hd tile of x at positions p0.. (head h of hx heads) -> shared fp32
// with row stride hd + 1; rows past S load as zeros.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ x, int b, int p0,
                                          int h, int hx, int s_len, int hd) {
  for (int idx = threadIdx.x; idx < BT * hd; idx += THREADS) {
    const int r = idx / hd, d = idx % hd, pos = p0 + r;
    dst[r * (hd + 1) + d] =
        pos < s_len ? to_f(x[(((size_t)b * s_len + pos) * hx + h) * hd + d]) : 0.f;
  }
}

// For query row `row` (position q0 + row) and keys k0 + lane8 + 8 j: P from
// lse and dS = P * (dP - D), written to ps (if not null) and dss.
__device__ __forceinline__ void p_and_ds(const float* qs, const float* dos, const float* ks,
                                         const float* vs, float* ps, float* dss,
                                         const float* lse_s, const float* d_s, int row,
                                         int lane8, int q0, int k0, int s_len, int hd,
                                         float scale) {
  const int ld = hd + 1;
  float sc[BT / 8], dp[BT / 8];
#pragma unroll
  for (int j = 0; j < BT / 8; ++j) sc[j] = dp[j] = 0.f;
  for (int d = 0; d < hd; ++d) {
    const float qv = qs[row * ld + d], ov = dos[row * ld + d];
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
      sc[j] = fmaf(qv, ks[(lane8 + 8 * j) * ld + d], sc[j]);
      dp[j] = fmaf(ov, vs[(lane8 + 8 * j) * ld + d], dp[j]);
    }
  }
  const int qpos = q0 + row;
#pragma unroll
  for (int j = 0; j < BT / 8; ++j) {
    const int key = k0 + lane8 + 8 * j;
    const float p = (qpos < s_len && key <= qpos) ? expf(sc[j] * scale - lse_s[row]) : 0.f;
    if (ps != nullptr) ps[row * PLD + lane8 + 8 * j] = p;
    dss[row * PLD + lane8 + 8 * j] = p * (dp[j] - d_s[row]);
  }
}

// lse and D of rows q0.. of query head h into shared memory (0 past S).
__device__ __forceinline__ void load_rows(float* lse_s, float* d_s, const float* lse,
                                          const float* dsum, int b, int h, int hq, int q0,
                                          int s_len) {
  if (threadIdx.x < BT) {
    const int pos = q0 + threadIdx.x;
    const size_t i = ((size_t)b * hq + h) * s_len + pos;
    lse_s[threadIdx.x] = pos < s_len ? lse[i] : 0.f;
    d_s[threadIdx.x] = pos < s_len ? dsum[i] : 0.f;
  }
}

// D[b, h, s] = sum_d dO * O, one warp a row (rows in (b, s, h) order).
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dsum_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                      float* __restrict__ dsum, long long rows, int s_len, int hq, int hd) {
  const long long row = (long long)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* o = out + row * hd;
  const T* g = dout + row * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc = fmaf(to_f(g[d]), to_f(o[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long long h = row % hq, bs = row / hq, s = bs % s_len, b = bs / s_len;
    dsum[(b * hq + h) * s_len + s] = acc;
  }
}

template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ dsum,
                      T* __restrict__ dk, T* __restrict__ dv, int s_len, int hkv, int g,
                      int hd, float scale) {
  extern __shared__ float smem[];
  __shared__ float lse_s[BT], d_s[BT];
  const int ld = hd + 1;
  float* ks = smem;
  float* vs = ks + BT * ld;
  float* qs = vs + BT * ld;
  float* dos = qs + BT * ld;
  float* ps = dos + BT * ld;
  float* dss = ps + BT * PLD;

  const int tid = threadIdx.x, lane8 = tid & 7, row = tid >> 3;
  const int bh = blockIdx.y, b = bh / hkv, kvh = bh % hkv, hq = hkv * g;
  const int k0 = blockIdx.x * BT, nj = hd / 8;
  load_tile(ks, k, b, k0, kvh, hkv, s_len, hd);
  load_tile(vs, v, b, k0, kvh, hkv, s_len, hd);

  float dk_acc[NJ], dv_acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  // Query tiles start on the key tile's own boundary: the first one holds
  // the diagonal, earlier ones see none of these keys.
  for (int q0 = k0; q0 < s_len; q0 += BT) {
    for (int gi = 0; gi < g; ++gi) {
      const int h = kvh * g + gi;
      __syncthreads();  // the previous step's reads of qs, dos, ps, dss are done
      load_tile(qs, q, b, q0, h, hq, s_len, hd);
      load_tile(dos, dout, b, q0, h, hq, s_len, hd);
      load_rows(lse_s, d_s, lse, dsum, b, h, hq, q0, s_len);
      __syncthreads();
      p_and_ds(qs, dos, ks, vs, ps, dss, lse_s, d_s, row, lane8, q0, k0, s_len, hd, scale);
      __syncthreads();
      // This thread's key row `row`, dims lane8 + 8 j.
      for (int r = 0; r < BT; ++r) {
        const float p = ps[r * PLD + row], ds = dss[r * PLD + row];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (j < nj) {
            dv_acc[j] = fmaf(p, dos[r * ld + lane8 + 8 * j], dv_acc[j]);
            dk_acc[j] = fmaf(ds, qs[r * ld + lane8 + 8 * j], dk_acc[j]);
          }
        }
      }
    }
  }
  const int key = k0 + row;
  if (key >= s_len) return;
  const size_t off = (((size_t)b * s_len + key) * hkv + kvh) * hd + lane8;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (j < nj) {
      dk[off + 8 * j] = from_f<T>(dk_acc[j] * scale);
      dv[off + 8 * j] = from_f<T>(dv_acc[j]);
    }
  }
}

template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ dsum, T* __restrict__ dq, int s_len, int hkv,
                    int g, int hd, float scale) {
  extern __shared__ float smem[];
  __shared__ float lse_s[BT], d_s[BT];
  const int ld = hd + 1;
  float* qs = smem;
  float* dos = qs + BT * ld;
  float* ks = dos + BT * ld;
  float* vs = ks + BT * ld;
  float* dss = vs + BT * ld;

  const int tid = threadIdx.x, lane8 = tid & 7, row = tid >> 3;
  const int hq = hkv * g, bh = blockIdx.y, b = bh / hq, h = bh % hq, kvh = h / g;
  const int q0 = blockIdx.x * BT, nj = hd / 8;
  load_tile(qs, q, b, q0, h, hq, s_len, hd);
  load_tile(dos, dout, b, q0, h, hq, s_len, hd);
  load_rows(lse_s, d_s, lse, dsum, b, h, hq, q0, s_len);

  float dq_acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) dq_acc[j] = 0.f;
  const int last_key = min(s_len - 1, q0 + BT - 1);
  for (int k0 = 0; k0 <= last_key; k0 += BT) {
    __syncthreads();  // Q, dO staged; the previous tile's reads of ks, dss done
    load_tile(ks, k, b, k0, kvh, hkv, s_len, hd);
    load_tile(vs, v, b, k0, kvh, hkv, s_len, hd);
    __syncthreads();
    p_and_ds(qs, dos, ks, vs, nullptr, dss, lse_s, d_s, row, lane8, q0, k0, s_len, hd,
             scale);
    __syncwarp();  // row `row` of dS is written and read by the same 8 lanes
    for (int c = 0; c < BT; ++c) {
      const float ds = dss[row * PLD + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (j < nj) dq_acc[j] = fmaf(ds, ks[c * ld + lane8 + 8 * j], dq_acc[j]);
    }
  }
  const int pos = q0 + row;
  if (pos >= s_len) return;
  T* dst = dq + (((size_t)b * s_len + pos) * hq + h) * hd + lane8;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    if (j < nj) dst[8 * j] = from_f<T>(dq_acc[j] * scale);
}

// D into dsum, one warp a row of (B, S, Hq).
template <typename T>
int launch_dsum(const void* out, const void* dout, float* dsum, int b, int s_len, int hq, int hd,
                cudaStream_t st) {
  const long long rows = (long long)b * s_len * hq;
  const int warps = THREADS / 32;
  flash_bwd_dsum_kernel<T><<<(unsigned)((rows + warps - 1) / warps), THREADS, 0, st>>>(
      (const T*)out, (const T*)dout, dsum, rows, s_len, hq, hd);
  return (int)cudaGetLastError();
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const float* lse, float* dsum, void* dq, void* dk, void* dv, int b, int s_len,
           int hkv, int g, int hd, float scale, cudaStream_t st) {
  const int hq = hkv * g;
  if (b * hq > 65535) return (int)cudaErrorInvalidValue;
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes(8 * NJ, 2));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, NJ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(8 * NJ, 1));
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  int rc = launch_dsum<T>(out, dout, dsum, b, s_len, hq, hd, st);
  if (rc != 0) return rc;
  const int tiles = (s_len + BT - 1) / BT;
  flash_bwd_dkdv_kernel<T, NJ><<<dim3(tiles, b * hkv), THREADS, smem_bytes(hd, 2), st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dsum, (T*)dk, (T*)dv, s_len,
      hkv, g, hd, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_kernel<T, NJ><<<dim3(tiles, b * hq), THREADS, smem_bytes(hd, 1), st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dsum, (T*)dq, s_len, hkv,
      g, hd, scale);
  return 0;
}

// ---------------------------------------------------------------------------
// bf16 at hd <= 128: tensor cores (mma.sync m16n8k16, ldmatrix, cp.async).

typedef __nv_bfloat16 bf16;

constexpr int MMA_WARPS = 4;  // 16 rows each
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int TR = 16 * MMA_WARPS;  // rows of every tile: keys (dK/dV), rows (dQ), streamed
constexpr int CHUNK = 32;  // queries (dK/dV) or keys (dQ) a warp's products take at a time
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr uint32_t tile_bytes(int hdp) { return (uint32_t)TR * hdp * 2; }
// dK/dV: a stage is a Q tile, a dO tile, then TR lse and TR D floats.
__host__ __device__ constexpr uint32_t dkdv_stage_bytes(int hdp) {
  return 2 * tile_bytes(hdp) + 2 * TR * 4;
}
// dK/dV: K, V, two stages.  dQ: Q, dO, two stages of a K and a V tile.
constexpr size_t dkdv_smem_bytes(int hdp) {
  return 2 * tile_bytes(hdp) + 2 * dkdv_stage_bytes(hdp);
}
constexpr size_t dq_smem_bytes(int hdp) { return 6 * (size_t)tile_bytes(hdp); }

// A (TR, HDP) tile at shared address dst, swizzled: row r from base + r *
// stride (elements); rows from `live` on and dims from hd on are zeros.
// base must be a valid address (row 0 lies before S).
template <int HDP>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* base, size_t stride, int live,
                                          int hd) {
  constexpr int CH = HDP / 8, RSTEP = MMA_THREADS / CH;
  static_assert(TR % RSTEP == 0 && RSTEP % 8 == 0, "passes keep the swizzle");
  const int lr = threadIdx.x / CH, lc = threadIdx.x % CH;
  const bool lc_live = lc * 8 < hd;
#pragma unroll
  for (int i = 0; i < TR / RSTEP; ++i) {
    const int r = lr + RSTEP * i;
    const bool ok = lc_live && r < live;
    cp_async16(dst + swz<CH>(r, lc), ok ? base + r * stride + lc * 8 : base, ok);
  }
}

// Per-lane ldmatrix offsets into a swizzled (rows, HDP) tile for the 4
// values of (k-step % 4); steps 4 apart are 8 chunks (128 bytes) further.
//   a: A fragment of rows row0 + (lane & 15) (row0 a multiple of 16);
//   b: B fragments of two n-tiles (rows 16 jn + (lane & 7) + 8 (lane >> 4)),
//      both k halves: regs {b0, b1} of n-tile 2 jn, then of 2 jn + 1;
//   t: B fragments by .trans, the tile's rows the product's k (16 kk +
//      (lane & 7) + 8 ((lane >> 3) & 1)): regs as b, for n-tiles 2 dn, 2 dn + 1.
struct LdsmOffsets {
  uint32_t a[4], b[4], t[4];
  template <int ROW>
  __device__ __forceinline__ void init(int lane, int row0) {
    const int x = lane & 7;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a[j] = (row0 + (lane & 15)) * ROW + (((2 * j + (lane >> 4)) ^ x) << 4);
      b[j] = (x + ((lane >> 4) << 3)) * ROW + (((2 * j + ((lane >> 3) & 1)) ^ x) << 4);
      t[j] = (x + (((lane >> 3) & 1) << 3)) * ROW + (((2 * j + (lane >> 4)) ^ x) << 4);
    }
  }
};

// The A fragment of k-step kk (n-tiles 2 kk, 2 kk + 1) of a C-fragment
// block, rounded to bf16.
__device__ __forceinline__ void c_to_a(const float (&c)[CHUNK / 8][4], int kk, uint32_t (&a)[4]) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

template <int HDP>
__global__ void __launch_bounds__(MMA_THREADS, 2)
flash_bwd_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ dsum,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int s_len, int hkv, int g,
                   int hd, int n_bh, float scale, float scale_log2) {
  constexpr int ROW = HDP * 2, KS = HDP / 16, DT = HDP / 8, NT = CHUNK / 8;
  constexpr uint32_t TILE = tile_bytes(HDP), STAGE = dkdv_stage_bytes(HDP);
  extern __shared__ __align__(128) unsigned char smem_bwd[];
  const uint32_t ks = smem_u32(smem_bwd), vs = ks + TILE, ring = vs + TILE;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, gid = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.x % n_bh, kt = blockIdx.x / n_bh;  // kt ascending: longest first
  const int b = bh / hkv, kvh = bh % hkv, hq = hkv * g, k0 = kt * TR;
  const size_t q_stride = (size_t)hq * hd, kv_stride = (size_t)hkv * hd;
  const size_t kv_off = (((size_t)b * s_len + k0) * hkv + kvh) * hd;
  load_tile<HDP>(ks, k + kv_off, kv_stride, s_len - k0, hd);
  load_tile<HDP>(vs, v + kv_off, kv_stride, s_len - k0, hd);

  // Step i: query tile kt + i / G (64 rows), head kvh * G + i % G.
  const int n_steps = ((s_len + TR - 1) / TR - kt) * g;
  auto load_step = [&](int i) {
    const int q0 = (kt + i / g) * TR, h = kvh * g + i % g;
    const uint32_t st = ring + (i & 1) * STAGE;
    const size_t off = (((size_t)b * s_len + q0) * hq + h) * hd;
    load_tile<HDP>(st, q + off, q_stride, s_len - q0, hd);
    load_tile<HDP>(st + TILE, dout + off, q_stride, s_len - q0, hd);
    // lse (threads 0..63) and D (64..127) of the tile's rows.
    const int r = tid % TR;
    const float* src = (tid < TR ? lse : dsum) + ((size_t)b * hq + h) * s_len + q0;
    const bool ok = q0 + r < s_len;
    cp_async4(st + 2 * TILE + tid * 4, ok ? src + r : src, ok);
  };
  load_step(0);
  cp_async_commit();

  LdsmOffsets off;
  off.init<ROW>(lane, 16 * warp);
  const int key_first = k0 + 16 * warp;
  const bool warp_live = key_first < s_len;
  const int key[2] = {key_first + gid, key_first + gid + 8};
  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[d][e] = dv_acc[d][e] = 0.f;

  for (int i = 0; i < n_steps; ++i) {
    if (i + 1 < n_steps) load_step(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // step i (and K, V) landed for every thread
    const int q0 = (kt + i / g) * TR;
    const uint32_t qt = ring + (i & 1) * STAGE, ot = qt + TILE;
    const float* lse_s =
        reinterpret_cast<const float*>(smem_bwd + 2 * TILE + (i & 1) * STAGE + 2 * TILE);
    const float* d_s = lse_s + TR;
#pragma unroll
    for (int c = 0; c < TR / CHUNK; ++c) {
      const int qc = q0 + c * CHUNK;
      // Chunks past S or wholly above this warp's keys add nothing.
      if (!warp_live || qc >= s_len || key_first > qc + CHUNK - 1) continue;
      const bool masked = key_first + 15 > qc || qc + CHUNK > s_len;

      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 queries.
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint32_t ko = (kk >> 2) * 128;
        uint32_t ka[4], va[4];
        ldsm_x4(ks + ko + off.a[kk & 3], ka);
        ldsm_x4(vs + ko + off.a[kk & 3], va);
#pragma unroll
        for (int jn = 0; jn < NT / 2; ++jn) {
          const uint32_t ro = (c * CHUNK + 16 * jn) * ROW + ko + off.b[kk & 3];
          uint32_t bq[4], bo[4];
          ldsm_x4(qt + ro, bq);
          mma_bf16(s[2 * jn], ka, bq[0], bq[1]);
          mma_bf16(s[2 * jn + 1], ka, bq[2], bq[3]);
          ldsm_x4(ot + ro, bo);
          mma_bf16(dp[2 * jn], va, bo[0], bo[1]);
          mma_bf16(dp[2 * jn + 1], va, bo[2], bo[3]);
        }
      }

      // P^T from each query's lse (zero above the diagonal and past S) into
      // s, dS^T = P^T (dP^T - D) into dp.
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = c * CHUNK + 8 * j + 2 * tig;  // query row in the tile
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
        const float2 d2 = *reinterpret_cast<const float2*>(d_s + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float nl = -((e & 1) ? l2.y : l2.x) * LOG2E, dd = (e & 1) ? d2.y : d2.x;
          float p = exp2f(fmaf(s[j][e], scale_log2, nl));
          const int qpos = q0 + col + (e & 1);
          if (masked && (key[e >> 1] > qpos || qpos >= s_len)) p = 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dd);
        }
      }

      // dV += P^T dO, dK += dS^T Q: the tiles' rows are the products' k.
#pragma unroll
      for (int kk = 0; kk < CHUNK / 16; ++kk) {
        uint32_t pa[4], da[4];
        c_to_a(s, kk, pa);
        c_to_a(dp, kk, da);
#pragma unroll
        for (int dn = 0; dn < DT / 2; ++dn) {
          const uint32_t ro = (c * CHUNK + 16 * kk) * ROW + (dn >> 2) * 128 + off.t[dn & 3];
          uint32_t bo[4], bq[4];
          ldsm_x4_trans(ot + ro, bo);
          mma_bf16(dv_acc[2 * dn], pa, bo[0], bo[1]);
          mma_bf16(dv_acc[2 * dn + 1], pa, bo[2], bo[3]);
          ldsm_x4_trans(qt + ro, bq);
          mma_bf16(dk_acc[2 * dn], da, bq[0], bq[1]);
          mma_bf16(dk_acc[2 * dn + 1], da, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= s_len) continue;
    const size_t row = (((size_t)b * s_len + key[h]) * hkv + kvh) * hd + 2 * tig;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      if (8 * d < hd) {
        *reinterpret_cast<uint32_t*>(dk + row + 8 * d) =
            pack_bf16(dk_acc[d][2 * h] * scale, dk_acc[d][2 * h + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + row + 8 * d) =
            pack_bf16(dv_acc[d][2 * h], dv_acc[d][2 * h + 1]);
      }
  }
}

template <int HDP>
__global__ void __launch_bounds__(MMA_THREADS, 2)
flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ dsum,
                 bf16* __restrict__ dq, int s_len, int hkv, int g, int hd, int n_bh, int n_rb,
                 float scale, float scale_log2) {
  constexpr int CH = HDP / 8, ROW = HDP * 2, KS = HDP / 16, DT = HDP / 8, NT = CHUNK / 8;
  constexpr uint32_t TILE = tile_bytes(HDP);
  extern __shared__ __align__(128) unsigned char smem_bwd[];
  const uint32_t qs = smem_u32(smem_bwd), os = qs + TILE, ring = os + TILE;  // stage: K, V

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, gid = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.x % n_bh, rb = n_rb - 1 - blockIdx.x / n_bh;  // longest first
  const int b = bh / hkv, kvh = bh % hkv, hq = hkv * g;
  const int n_rows = s_len * g, row0 = rb * TR;  // row = position * G + head in group

  for (int i = tid; i < TR * CH; i += MMA_THREADS) {
    const int r = i / CH, c = i % CH, grow = row0 + r, pos = grow / g;
    const bool ok = grow < n_rows && c * 8 < hd;
    const size_t src = ok ? (((size_t)b * s_len + pos) * hq + kvh * g + grow - pos * g) * hd + c * 8
                          : 0;
    cp_async16(qs + swz<CH>(r, c), q + src, ok);
    cp_async16(os + swz<CH>(r, c), dout + src, ok);
  }
  const int last_pos = (min(row0 + TR, n_rows) - 1) / g;
  const int n_tiles = last_pos / TR + 1;
  const size_t kv_stride = (size_t)hkv * hd;
  auto load_kv = [&](int t) {
    const int k0 = t * TR;
    const uint32_t st = ring + (t & 1) * 2 * TILE;
    const size_t off = (((size_t)b * s_len + k0) * hkv + kvh) * hd;
    load_tile<HDP>(st, k + off, kv_stride, s_len - k0, hd);
    load_tile<HDP>(st + TILE, v + off, kv_stride, s_len - k0, hd);
  };
  load_kv(0);
  cp_async_commit();

  // This thread's rows gid and gid + 8 of the warp's 16: position (the
  // last key each may see), lse * log2(e) and D.  Rows past S * G are never
  // stored; they see keys up to S - 1.
  const int wrow = row0 + 16 * warp;
  const bool warp_live = wrow < n_rows;
  const int warp_first = wrow / g, warp_last = (min(wrow + 15, n_rows - 1)) / g;
  int lim[2];
  float lse2[2], dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int grow = wrow + gid + 8 * h;
    const bool live = grow < n_rows;
    lim[h] = live ? grow / g : s_len - 1;
    const size_t li = ((size_t)b * hq + kvh * g + grow - lim[h] * g) * s_len + lim[h];
    lse2[h] = live ? lse[li] * LOG2E : 0.f;
    dd[h] = live ? dsum[li] : 0.f;
  }
  LdsmOffsets off;
  off.init<ROW>(lane, 16 * warp);
  uint32_t qf[KS][4], of[KS][4];
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    ldsm_x4(qs + (kk >> 2) * 128 + off.a[kk & 3], qf[kk]);
    ldsm_x4(os + (kk >> 2) * 128 + off.a[kk & 3], of[kk]);
  }
  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_kv(t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile t landed for every thread
    const uint32_t kt = ring + (t & 1) * 2 * TILE, vt = kt + TILE;
#pragma unroll
    for (int c = 0; c < TR / CHUNK; ++c) {
      const int kc = t * TR + c * CHUNK;
      if (!warp_live || kc > warp_last) continue;  // wholly above the warp's rows
      const bool masked = kc + CHUNK - 1 > warp_first;

      // S = Q K^T and dP = dO V^T: 16 rows x 32 keys.
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int jn = 0; jn < NT / 2; ++jn) {
          const uint32_t ro = (c * CHUNK + 16 * jn) * ROW + (kk >> 2) * 128 + off.b[kk & 3];
          uint32_t bk[4], bv[4];
          ldsm_x4(kt + ro, bk);
          mma_bf16(s[2 * jn], qf[kk], bk[0], bk[1]);
          mma_bf16(s[2 * jn + 1], qf[kk], bk[2], bk[3]);
          ldsm_x4(vt + ro, bv);
          mma_bf16(dp[2 * jn], of[kk], bv[0], bv[1]);
          mma_bf16(dp[2 * jn + 1], of[kk], bv[2], bv[3]);
        }

      // P from the row's lse, zero past its diagonal; dS = P (dP - D).
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(s[j][e], scale_log2, -lse2[e >> 1]));
          if (masked && kc + 8 * j + 2 * tig + (e & 1) > lim[e >> 1]) p = 0.f;
          dp[j][e] = p * (dp[j][e] - dd[e >> 1]);
        }

      // dQ += dS K: K's rows are the product's k.
#pragma unroll
      for (int kk = 0; kk < CHUNK / 16; ++kk) {
        uint32_t da[4];
        c_to_a(dp, kk, da);
#pragma unroll
        for (int dn = 0; dn < DT / 2; ++dn) {
          uint32_t bk[4];
          ldsm_x4_trans(kt + (c * CHUNK + 16 * kk) * ROW + (dn >> 2) * 128 + off.t[dn & 3], bk);
          mma_bf16(acc[2 * dn], da, bk[0], bk[1]);
          mma_bf16(acc[2 * dn + 1], da, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

  if (!warp_live) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int grow = wrow + gid + 8 * h;
    if (grow >= n_rows) continue;
    const int pos = grow / g;
    bf16* row = dq + (((size_t)b * s_len + pos) * hq + kvh * g + grow - pos * g) * hd + 2 * tig;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      if (8 * d < hd)
        *reinterpret_cast<uint32_t*>(row + 8 * d) =
            pack_bf16(acc[d][2 * h] * scale, acc[d][2 * h + 1] * scale);
  }
}

template <int HDP>
int launch_mma(const void* q, const void* k, const void* v, const void* out, const void* dout,
               const float* lse, float* dsum, void* dq, void* dk, void* dv, int b, int s_len,
               int hkv, int g, int hd, float scale, cudaStream_t st) {
  const long long n_bh = (long long)b * hkv, n_kt = (s_len + TR - 1) / TR;
  const long long n_rows = (long long)s_len * g, n_rb = (n_rows + TR - 1) / TR;
  if (n_rows + TR > 0x7fffffffLL || n_bh * n_rb > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_mma<HDP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)dkdv_smem_bytes(HDP));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_bwd_dq_mma<HDP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dq_smem_bytes(HDP));
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  int rc = launch_dsum<bf16>(out, dout, dsum, b, s_len, hkv * g, hd, st);
  if (rc != 0) return rc;
  const float scale_log2 = scale * LOG2E;  // exp(x) = exp2(x log2(e))
  flash_bwd_dkdv_mma<HDP><<<(unsigned)(n_bh * n_kt), MMA_THREADS, dkdv_smem_bytes(HDP), st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse, dsum, (bf16*)dk,
      (bf16*)dv, s_len, hkv, g, hd, (int)n_bh, scale, scale_log2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_mma<HDP><<<(unsigned)(n_bh * n_rb), MMA_THREADS, dq_smem_bytes(HDP), st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse, dsum, (bf16*)dq,
      s_len, hkv, g, hd, (int)n_bh, (int)n_rb, scale, scale_log2);
  return 0;
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, const void* out, const void* dout,
              const float* lse, float* dsum, void* dq, void* dk, void* dv, int b, int s_len,
              int hkv, int g, int hd, float scale, int hdp, cudaStream_t st) {
  if (hdp == 32) return launch<T, 4>(q, k, v, out, dout, lse, dsum, dq, dk, dv, b, s_len, hkv, g, hd, scale, st);
  if (hdp == 64) return launch<T, 8>(q, k, v, out, dout, lse, dsum, dq, dk, dv, b, s_len, hkv, g, hd, scale, st);
  if (hdp == 128) return launch<T, 16>(q, k, v, out, dout, lse, dsum, dq, dk, dv, b, s_len, hkv, g, hd, scale, st);
  if (hdp == 256) return launch<T, 32>(q, k, v, out, dout, lse, dsum, dq, dk, dv, b, s_len, hkv, g, hd, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, out, dout, dq (B, S, Hkv*G, hd); k, v, dk, dv (B, S, Hkv, hd); lse and
// dsum (B, Hkv*G, S) fp32 (dsum is scratch this call fills); all
// contiguous, one dtype (0 fp32, 1 bf16); hd a multiple of 8 up to hdp, the
// padded head dim the wrapper's bwd_plan() chose: bf16 at 64 or 128 runs
// the tensor-core kernels (q, k, v, dout 16-byte aligned), bf16 at 256 and
// fp32 at 32, 64, 128 or 256 the CUDA-core ones.  Three kernels on
// `stream`, in order.  Returns cudaGetLastError(), or cudaErrorInvalidValue
// for what no instantiation can launch.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* out, const void* dout, const void* lse,
                                          void* dsum, void* dq, void* dk, void* dv, int b,
                                          int s_len, int hkv, int g, int hd, float scale,
                                          int dtype, int hdp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd < 8 || hd > hdp || hd % 8 != 0 || g < 1 || hkv < 1 || s_len < 1 || b < 1)
    return (int)cudaErrorInvalidValue;
  int rc = (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  float* ds = static_cast<float*>(dsum);
  if (dtype == kF32)
    rc = launch_hd<float>(q, k, v, out, dout, l, ds, dq, dk, dv, b, s_len, hkv, g, hd, scale,
                          hdp, st);
  else if (dtype == kBF16 && hdp == 64)
    rc = launch_mma<64>(q, k, v, out, dout, l, ds, dq, dk, dv, b, s_len, hkv, g, hd, scale, st);
  else if (dtype == kBF16 && hdp == 128)
    rc = launch_mma<128>(q, k, v, out, dout, l, ds, dq, dk, dv, b, s_len, hkv, g, hd, scale, st);
  else if (dtype == kBF16 && hdp == 256)
    rc = launch<bf16, 32>(q, k, v, out, dout, l, ds, dq, dk, dv, b, s_len, hkv, g, hd, scale,
                          st);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
