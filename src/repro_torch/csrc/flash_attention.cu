// Causal GQA flash attention for Hopper (train / prefill / evaluation
// forwards): q (B, S, Hq, hd), k/v (B, S, Hkv, hd) -> out (B, S, Hq, hd),
// query head h reading KV head h / G (the reference's (b, s, hkv, g, hd)
// reshape order).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// (flash_attention, body _kernel): the FA2 schedule over (B*Hkv, q-blocks,
// kv-blocks) with the kv axis sequential, the accumulators in VMEM scratch,
// and blocks above the diagonal skipped.
//
// What bounds it here: operations.  Causal attention does 2*B*Hq*hd*S*(S+1)
// FLOPs against (2*B*S*Hq*hd + 2*B*S*Hkv*hd) * elem bytes; at S = 2048 and
// hd = 128 that is ~1000 FLOP per byte, far above the card's ridge (~295
// in bf16).  So the bf16 kernel runs on the tensor cores.
//
// Semantics of the TPU kernel, kept by both kernels below: scores in fp32,
// scaled, masked keys set to -1e30; the online softmax with a running max m
// and sum l in fp32; l sums the unrounded fp32 p while P is rounded to v's
// dtype before P V; out = acc / max(l, 1e-30) in the output dtype.  A block
// holds the G query heads of one KV head for consecutive positions (row r
// = position-in-block * G + head-in-group), so each K/V tile is read once
// for all G heads, and walks the KV tiles only up to the diagonal.  Ragged
// S is masked in the kernels: keys and rows past S load as zeros and are
// never stored.  The wrapper pads nothing.  Given an lse pointer (a train
// forward: the backward in flash_attention_bwd.cu rebuilds P from it), both
// kernels also store each row's log-sum-exp of its scaled, masked scores,
// m * scale + log(l), from the running max and sum they already keep; a
// null pointer leaves them as they were.
//
// bf16 (flash_mma_kernel): the FA2 schedule on mma.sync tensor cores.
//  * 8 warps, 16 query rows each: BM = 128 rows a block; BN = 64 keys a KV
//    tile (32 at a padded head dim of 256, to bound registers).  One block
//    an SM (~210 registers a thread at hd 128, no spills).  One 1-D grid of
//    (q-block, b * Hkv), q-blocks in reverse order so that the longest
//    causal rows start first.  Measured against 4 warps at 2 blocks an SM,
//    32 rows a warp (which spills with Q in registers) and 128-key tiles,
//    this shape was as fast or faster.
//  * hd is padded to HDP in {64, 128, 256} in shared memory only: the dims
//    past hd load as zeros, add nothing to Q K^T, and their P V columns are
//    never stored.
//  * Q, K and V arrive by cp.async.cg 16-byte copies (src-size 0 zero-fills
//    past S and past hd).  K/V tiles go through a four-stage ring in two
//    halves of two tiles: one half loads while the warps compute the other,
//    with one __syncthreads every two tiles, so that between barriers the
//    warps drift apart and one warp's softmax overlaps another's mma (a
//    barrier every tile, with a two- or three-stage ring, was slower).  Rows
//    are HDP * 2 bytes with their 16-byte chunks XOR-swizzled
//    (chunk ^ (row & 7)), so the ldmatrix reads below are free of bank
//    conflicts.
//  * S = Q K^T with mma.sync.m16n8k16 (bf16 in, fp32 accumulate): Q's A
//    fragments are loaded once with ldmatrix and stay in registers for all
//    tiles; K's B fragments come by ldmatrix from the (key, hd) tile.
//  * The softmax runs on the fp32 C fragments: a thread holds two rows
//    (gid and gid + 8 of its warp's 16), whose max reduces over the 4 lanes
//    of a quad with __shfl_xor_sync.  The scale is folded into exp2f:
//    p = exp2(s * scale * log2(e) - m * scale * log2(e)), one FFMA, the
//    same p as exp(s * scale - m * scale) up to rounding.  l stays per
//    thread until the end.
//  * O += P V with the same instruction: P's C fragments are packed into
//    bf16 A fragments in registers (the FA2 register reuse, no shared-memory
//    round trip); V's B fragments come by ldmatrix.trans from the row-major
//    (key, hd) tile.
//  * A warp skips the tiles wholly above its own rows' diagonal and masks
//    only tiles that cross it.
//  * What holds it back: within a warp the phases run one after another
//    (Q K^T, softmax, P V), and with 8 warps an SM, in near lock step, the
//    tensor cores idle through much of each softmax; mma.sync itself
//    reaches only part of the card's bf16 peak.  Left for later: wgmma with
//    shared-memory descriptors, TMA loads behind mbarriers, a producer warp
//    (warp specialisation) so that one warp group's softmax overlaps
//    another's mma, a persistent grid.
//
// fp32 (flash_kernel): CUDA cores.  Tensor cores would compute fp32 inputs
// in TF32, below the fp32 reference's precision, and no model path of the
// port runs attention in fp32.  128 threads as 16 row groups x 8 lanes,
// R = 64 rows (32 above hd 128), KV tiles of 32 keys, Q/K/V widened to
// fp32 in shared memory with a row stride of hd + 1, P through shared
// memory within the warp.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int BK = 32;  // keys per KV tile
constexpr float NEG_INF = -1e30f;

template <typename T, int RT, int NJ>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, float* __restrict__ lse, int s_len, int hkv, int g, int hd,
             int bq, float scale) {
  constexpr int R = 16 * RT;  // rows per block
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* qs = smem;              // R x ld
  float* ks = qs + R * ld;       // BK x ld
  float* vs = ks + BK * ld;      // BK x ld
  float* ps = vs + BK * ld;      // R x (BK + 1)

  const int tid = threadIdx.x, lane8 = tid & 7, rg = tid >> 3;
  const int bh = blockIdx.y, b = bh / hkv, kvh = bh % hkv;
  const int hq = hkv * g;
  const int q0 = blockIdx.x * bq;
  const int rows = bq * g;  // live rows of this block (<= R)

  for (int idx = tid; idx < R * hd; idx += THREADS) {
    const int r = idx / hd, d = idx % hd;
    const int pos = q0 + r / g;
    float val = 0.f;
    if (r < rows && pos < s_len)
      val = to_f(q[(((size_t)b * s_len + pos) * hq + kvh * g + r % g) * hd + d]);
    qs[r * ld + d] = val;
  }

  float m[RT], l[RT], acc[RT][NJ];
  int qpos[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
    qpos[i] = q0 + (rg + 16 * i) / g;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }
  const int nj = hd / 8;

  const int last_key = min(s_len - 1, q0 + bq - 1);
  for (int k0 = 0; k0 <= last_key; k0 += BK) {
    __syncthreads();  // previous tile's K/V reads are done (and Q is staged)
    for (int idx = tid; idx < BK * hd; idx += THREADS) {
      const int c = idx / hd, d = idx % hd;
      const int key = k0 + c;
      float kv = 0.f, vv = 0.f;
      if (key < s_len) {
        const size_t off = (((size_t)b * s_len + key) * hkv + kvh) * hd + d;
        kv = to_f(k[off]);
        vv = to_f(v[off]);
      }
      ks[c * ld + d] = kv;
      vs[c * ld + d] = vv;
    }
    __syncthreads();

    // Scores for rows rg + 16 i, keys kg + 8 j (kg = lane8).
    float sc[RT][BK / 8];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[RT], kk[BK / 8];
#pragma unroll
      for (int i = 0; i < RT; ++i) qv[i] = qs[(rg + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) kk[j] = ks[(lane8 + 8 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) sc[i][j] = fmaf(qv[i], kk[j], sc[i][j]);
    }

    float corr[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const int key = k0 + lane8 + 8 * j;
        float s = sc[i][j] * scale;
        if (key > qpos[i] || key >= s_len) s = NEG_INF;
        sc[i][j] = s;
        mx = fmaxf(mx, s);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float p = expf(sc[i][j] - m_new);
        sum += p;
        // P in v's dtype for P V (the TPU kernel's p.astype(v.dtype)); l
        // sums the unrounded fp32 p, as there.
        ps[(rg + 16 * i) * (BK + 1) + lane8 + 8 * j] = to_f(from_f<T>(p));
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + sum;
      m[i] = m_new;
    }
    __syncwarp();  // P rows are written and read by the same 8-lane group

    // acc[rows rg + 16 i][dims lane8 + 8 j] = acc * corr + P V.
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr[i];
    for (int c = 0; c < BK; ++c) {
      float pv[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) pv[i] = ps[(rg + 16 * i) * (BK + 1) + c];
      const float* vrow = vs + c * ld + lane8;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j < nj) {
          const float vv = vrow[8 * j];
#pragma unroll
          for (int i = 0; i < RT; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
    __syncwarp();  // P reads done before the next tile overwrites P
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = rg + 16 * i;
    if (r >= rows || qpos[i] >= s_len) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    // m is in scaled units here: the row's log-sum-exp is m + log(l).
    if (lse != nullptr && lane8 == 0)
      lse[((size_t)b * hq + kvh * g + r % g) * s_len + qpos[i]] = m[i] + logf(l[i]);
    T* orow = out + (((size_t)b * s_len + qpos[i]) * hq + kvh * g + r % g) * hd + lane8;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (j < nj) orow[8 * j] = from_f<T>(acc[i][j] * inv);
  }
}

size_t smem_bytes(int rt, int hd) {
  const size_t ld = hd + 1, r = 16 * rt;
  return sizeof(float) * (r * ld + 2 * BK * ld + r * (BK + 1));
}

template <typename T, int RT, int NJ>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int b,
           int s_len, int hkv, int g, int hd, float scale, cudaStream_t st) {
  constexpr int R = 16 * RT;
  if (g > R || b * hkv > 65535) return (int)cudaErrorInvalidValue;
  const int bq = R / g;
  const size_t smem = smem_bytes(RT, hd);
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_kernel<T, RT, NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes(RT, 8 * NJ));
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((s_len + bq - 1) / bq, b * hkv);
  flash_kernel<T, RT, NJ><<<grid, THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, s_len, hkv, g, hd, bq, scale);
  return 0;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, ldmatrix, cp.async).

typedef __nv_bfloat16 bf16;

constexpr int MMA_WARPS = 8;  // 16 query rows each
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int BM = 16 * MMA_WARPS;  // query rows a block
constexpr int SYNC_TILES = 2;  // KV tiles between block barriers
constexpr int STAGES = 2 * SYNC_TILES;  // K/V tiles in the shared-memory ring

// Keys a KV tile for a padded head dim: 32 at 256 bounds the registers.
constexpr int mma_bn(int hdp) { return hdp > 128 ? 32 : 64; }

constexpr size_t mma_smem_bytes(int hdp) {  // Q + the ring of K, V tiles
  return sizeof(bf16) * (size_t)hdp * (BM + STAGES * 2 * mma_bn(hdp));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c of row r in a tile of CH chunks a row, the
// chunk index XOR-swizzled by the row's low three bits.
template <int CH>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * CH + (c ^ (r & 7))) * 16u;
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

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

// Two floats rounded to bf16 (round-to-nearest-even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16), lane = 4 * gid + tig:
//   A regs {(gid, 2tig..+1), (gid+8, 2tig..), (gid, 2tig+8..), (gid+8, 2tig+8..)}
//   B regs {(k 2tig..+1, n gid), (k 2tig+8..+9, n gid)}
//   C      {(gid, 2tig), (gid, 2tig+1), (gid+8, 2tig), (gid+8, 2tig+1)}
// ldmatrix.x4: lanes 8i..8i+7 address the rows of matrix i, which lands in
// register i as (row lane / 4, cols 2 (lane % 4)..+1) (.trans: transposed).
template <int HDP, int BN>
__global__ void __launch_bounds__(MMA_THREADS, 1)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, float* __restrict__ lse,
                 int s_len, int hkv, int g, int hd, int bq, int n_bh, int n_qblocks,
                 float scale_log2) {
  constexpr int CH = HDP / 8;   // 16-byte chunks a row
  constexpr int ROW = CH * 16;  // bytes a row
  constexpr int KS = HDP / 16;  // k-steps of Q K^T
  constexpr int NT = BN / 8;    // score n-tiles (8 keys each)
  constexpr int DT = HDP / 8;   // output n-tiles (8 dims each)
  constexpr int RSTEP = MMA_THREADS / CH;  // tile rows one pass of cp.async covers
  static_assert(BN % RSTEP == 0 && RSTEP % 8 == 0, "cp.async passes keep the swizzle");
  constexpr uint32_t TILE = BN * ROW;  // one K or V tile
  extern __shared__ __align__(128) unsigned char smem_tc[];  // not smem: one name, one type
  const uint32_t qs = smem_addr(smem_tc);
  const uint32_t kvs = qs + BM * ROW;  // stage s: K at +2s TILE, V after it

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x % n_bh, qb = n_qblocks - 1 - blockIdx.x / n_bh;
  const int b = bh / hkv, kvh = bh % hkv, hq = hkv * g;
  const int q0 = qb * bq, rows = bq * g;  // live rows of this block (<= BM)

  for (int i = tid; i < BM * CH; i += MMA_THREADS) {
    const int r = i / CH, c = i % CH, pos = q0 + r / g;
    const bool ok = r < rows && pos < s_len && c * 8 < hd;
    const bf16* src = ok ? q + (((size_t)b * s_len + pos) * hq + kvh * g + r % g) * hd + c * 8 : q;
    cp_async16(qs + swz<CH>(r, c), src, ok);
  }
  const int n_tiles = min(s_len - 1, q0 + bq - 1) / BN + 1;
  // A thread copies chunk lc of tile rows lr + RSTEP i: the chunk and the
  // swizzle (row & 7) are the same in every pass and every tile.
  const int lr = tid / CH, lc = tid % CH;
  const size_t key_stride = (size_t)hkv * hd;
  const size_t kv_base = ((size_t)b * s_len * hkv + kvh) * hd;
  const bf16* kp = k + kv_base + lr * key_stride + lc * 8;
  const bf16* vp = v + kv_base + lr * key_stride + lc * 8;
  const uint32_t ldst = kvs + swz<CH>(lr, lc);
  const bool lc_live = lc * 8 < hd;
  auto load_kv = [&](int tile, int stage) {
    const int k0 = tile * BN;
#pragma unroll
    for (int i = 0; i < BN / RSTEP; ++i) {
      const bool ok = lc_live && k0 + lr + RSTEP * i < s_len;
      const size_t off = ok ? (size_t)(k0 + RSTEP * i) * key_stride : 0;
      const uint32_t dst = ldst + stage * 2 * TILE + i * RSTEP * ROW;
      cp_async16(dst, ok ? kp + off : k, ok);
      cp_async16(dst + TILE, ok ? vp + off : v, ok);
    }
  };
  // Tiles come in groups of SYNC_TILES, one commit group each: group i
  // (tiles i SYNC_TILES ...) fills half i % 2 of the ring.  Q rides with
  // group 0.
  auto load_group = [&](int first) {
#pragma unroll
    for (int i = 0; i < SYNC_TILES; ++i)
      if (first + i < n_tiles) load_kv(first + i, (first + i) % STAGES);
    cp_async_commit();
  };
  load_group(0);

  // ldmatrix addresses: row part per lane, swizzled chunk part for the 4
  // values of (step % 4); steps 4 apart are 8 chunks (128 bytes) further.
  //   K (B of Q K^T): rows key 16 jn + (lane & 7) + 8 (lane >> 4), chunk
  //     2 kk + ((lane >> 3) & 1);
  //   V (B of P V, .trans): rows key 16 kk + (lane & 7) + 8 ((lane >> 3) & 1),
  //     chunk 2 dn + (lane >> 4).
  const int x = lane & 7;
  uint32_t k_off[4], v_off[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    k_off[j] = (x + ((lane >> 4) << 3)) * ROW + (((2 * j + ((lane >> 3) & 1)) ^ x) << 4);
    v_off[j] = (x + (((lane >> 3) & 1) << 3)) * ROW + (((2 * j + (lane >> 4)) ^ x) << 4);
  }

  // This thread's rows: gid and gid + 8 of the warp's 16, and the last key
  // each may see.  The warp's first and last live positions bound the tiles
  // it computes and the ones it masks.
  const int gid = lane >> 2, tig = lane & 3;
  const int lim[2] = {min(q0 + (warp * 16 + gid) / g, s_len - 1),
                      min(q0 + (warp * 16 + gid + 8) / g, s_len - 1)};
  const int warp_first = q0 + warp * 16 / g;
  const bool warp_live = warp * 16 < rows && warp_first < s_len;
  const int warp_last = min(q0 + min(warp * 16 + 15, rows - 1) / g, s_len - 1);

  uint32_t qf[KS][4];
  float o[DT][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int d = 0; d < DT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;

  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldsm_x4(qs + swz<CH>(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)), qf[kk]);

  for (int t = 0; t < n_tiles; ++t) {
    // At the start of each group: its tiles have landed for every thread,
    // and every warp is done with the previous group, whose half of the
    // ring the next group refills.  In between, warps drift freely.
    if (t % SYNC_TILES == 0) {
      if (t > 0) {
        cp_async_wait<0>();
        __syncthreads();
      }
      load_group(t + SYNC_TILES);
    }
    const int k0 = t * BN;
    if (warp_live && k0 <= warp_last) {
      const uint32_t kt = kvs + (t % STAGES) * 2 * TILE, vt = kt + TILE;

      // S = Q K^T.
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int jn = 0; jn < NT / 2; ++jn) {
          uint32_t bk[4];  // n-tiles 2jn, 2jn+1 x both k halves
          ldsm_x4(kt + jn * 16 * ROW + (kk >> 2) * 128 + k_off[kk & 3], bk);
          mma_bf16(s[2 * jn], qf[kk], bk[0], bk[1]);
          mma_bf16(s[2 * jn + 1], qf[kk], bk[2], bk[3]);
        }

      // Mask past each row's diagonal (only in tiles that cross it), row
      // max over the quad (m is kept in raw score units), p = exp2(s * sl -
      // m * sl) as one FFMA and exp2f, and the rescale of l and O.
      const bool crosses = k0 + BN - 1 > warp_first;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (crosses && k0 + 8 * j + 2 * tig + (e & 1) > lim[e / 2]) s[j][e] = NEG_INF;
          mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1)
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], off));
        const float corr = exp2f((m[h] - mx[h]) * scale_log2);
        const float neg_ms = -mx[h] * scale_log2;
        m[h] = mx[h];
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          s[j][2 * h] = exp2f(fmaf(s[j][2 * h], scale_log2, neg_ms));
          s[j][2 * h + 1] = exp2f(fmaf(s[j][2 * h + 1], scale_log2, neg_ms));
          sum += s[j][2 * h] + s[j][2 * h + 1];
        }
        // Per-thread partial sums of the unrounded p; the quad adds them up
        // at the end (every lane of a quad applies the same corr).
        l[h] = l[h] * corr + sum;
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          o[d][2 * h] *= corr;
          o[d][2 * h + 1] *= corr;
        }
      }

      // O += P V: P rounded to bf16 straight from the C fragments.
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dn = 0; dn < DT / 2; ++dn) {
          uint32_t bv[4];  // both k halves x d-tiles 2dn, 2dn+1
          ldsm_x4_trans(vt + kk * 16 * ROW + (dn >> 2) * 128 + v_off[dn & 3], bv);
          mma_bf16(o[2 * dn], pa, bv[0], bv[1]);
          mma_bf16(o[2 * dn + 1], pa, bv[2], bv[3]);
        }
      }
    }
  }

  if (!warp_live) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) l[h] += __shfl_xor_sync(0xffffffffu, l[h], off);
    const int r = warp * 16 + gid + 8 * h, pos = q0 + r / g;
    if (r >= rows || pos >= s_len) continue;
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
    // m is in raw score units: the row's log-sum-exp is m * scale + log(l),
    // scale = scale_log2 * ln(2).
    if (lse != nullptr && tig == 0)
      lse[((size_t)b * hq + kvh * g + r % g) * s_len + pos] =
          m[h] * (scale_log2 * 0.6931471805599453f) + logf(l[h]);
    bf16* orow = out + (((size_t)b * s_len + pos) * hq + kvh * g + r % g) * hd + 2 * tig;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      if (8 * d < hd)
        *reinterpret_cast<uint32_t*>(orow + 8 * d) =
            pack_bf16(o[d][2 * h] * inv, o[d][2 * h + 1] * inv);
  }
}

template <int HDP>
int launch_mma(const void* q, const void* k, const void* v, void* out, float* lse, int b,
               int s_len, int hkv, int g, int hd, float scale, cudaStream_t st) {
  constexpr int BN = mma_bn(HDP);
  if (g > BM) return (int)cudaErrorInvalidValue;
  const int bq = BM / g, n_bh = b * hkv, n_qblocks = (s_len + bq - 1) / bq;
  if ((long long)n_bh * n_qblocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = mma_smem_bytes(HDP);
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_mma_kernel<HDP, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const float scale_log2 = scale * 1.4426950408889634f;  // exp(x) = exp2(x log2(e))
  flash_mma_kernel<HDP, BN><<<n_bh * n_qblocks, MMA_THREADS, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, lse, s_len, hkv, g, hd,
      bq, n_bh, n_qblocks, scale_log2);
  return 0;
}

}  // namespace

// q (B, S, Hkv*G, hd), k/v (B, S, Hkv, hd), out like q; all contiguous, one
// dtype (0 fp32, 1 bf16), bf16 pointers 16-byte aligned; hd a multiple of 8,
// padded to hdp, the head dim of the instantiation to run, as the wrapper's
// plan() chose it.  lse: null, or (B, Hkv*G, S) fp32 that receives each
// row's log-sum-exp of its scaled, masked scores (the backward's input);
// null changes nothing else.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for what no instantiation can launch.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int b, int s_len, int hkv, int g, int hd, float scale,
                                      int dtype, int hdp, void* lse_ptr, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_ptr);
  if (hd < 8 || hd > hdp || hd % 8 != 0 || g < 1) return (int)cudaErrorInvalidValue;
  int rc = (int)cudaErrorInvalidValue;
  if (dtype == kF32) {
    if (hdp == 32) rc = launch<float, 4, 4>(q, k, v, out, lse, b, s_len, hkv, g, hd, scale, st);
    else if (hdp == 64) rc = launch<float, 4, 8>(q, k, v, out, lse, b, s_len, hkv, g, hd, scale, st);
    else if (hdp == 128) rc = launch<float, 4, 16>(q, k, v, out, lse, b, s_len, hkv, g, hd, scale, st);
    else if (hdp == 256) rc = launch<float, 2, 32>(q, k, v, out, lse, b, s_len, hkv, g, hd, scale, st);
  } else if (dtype == kBF16) {
    if (hdp == 64) rc = launch_mma<64>(q, k, v, out, lse, b, s_len, hkv, g, hd, scale, st);
    else if (hdp == 128) rc = launch_mma<128>(q, k, v, out, lse, b, s_len, hkv, g, hd, scale, st);
    else if (hdp == 256) rc = launch_mma<256>(q, k, v, out, lse, b, s_len, hkv, g, hd, scale, st);
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
