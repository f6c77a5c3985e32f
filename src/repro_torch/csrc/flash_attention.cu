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
// hd = 128 that is ~1000 FLOP per byte, well above the card's ridge.  This
// first kernel runs them on CUDA cores in fp32 (products of bf16 values are
// exact in fp32), so it sits far from the bf16 tensor-core bound.
//
// Design:
//  * One block per (q-block, b * Hkv + kv head).  The block's R rows are the
//    G query heads of that KV head for R / G consecutive positions (row
//    r = position-in-block * G + head-in-group), so each K/V tile is read
//    once for all G heads: the TPU kernel's GQA grouping.
//  * The block walks KV tiles of 32 keys in order, only up to the diagonal
//    (the TPU kernel's causal skip), keeping fp32 online-softmax state: the
//    running max m and sum l per row in registers, the output accumulator
//    acc (R x hd) spread over the threads' registers.  Scores are scaled,
//    causally masked to -1e30 (so a masked key adds exp(-1e30 - m) = 0 to
//    l), and P is rounded to v's dtype before P V, as the TPU kernel does.
//  * Thread layout: 128 threads as 16 row groups x 8 lanes.  A row group
//    owns rows rg + 16 i; for the scores its 8 lanes own keys kg + 8 j, for
//    P V dims dg + 8 j.  Row max / sum reduce over those 8 lanes with warp
//    shuffles; P passes through shared memory within the warp.  Q, K and V
//    tiles sit in shared memory as fp32 with a row stride of hd + 1, so the
//    strided reads are free of bank conflicts.
//  * Ragged S is masked in the kernel: K/V rows past S load as zeros and
//    are masked out of the scores, query rows past S are never stored.  The
//    wrapper pads nothing.
//  * hd may be any multiple of 8 up to 256: the dims per lane are a
//    template bound (hd / 8 <= NJ), with R = 64 rows (32 for hd > 128, to
//    bound registers).
//  * Tensor cores (mma.sync / wgmma), TMA loads and a warp-specialised
//    pipeline are later work.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int BK = 32;  // keys per KV tile
constexpr float NEG_INF = -1e30f;

template <typename T, int RT, int NJ>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int s_len, int hkv, int g, int hd, int bq, float scale) {
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
int launch(const void* q, const void* k, const void* v, void* out, int b, int s_len,
           int hkv, int g, int hd, float scale, cudaStream_t st) {
  constexpr int R = 16 * RT;
  if (g > R) return (int)cudaErrorInvalidValue;
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
      (const T*)q, (const T*)k, (const T*)v, (T*)out, s_len, hkv, g, hd, bq, scale);
  return 0;
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* out, int b, int s_len,
                int hkv, int g, int hd, float scale, cudaStream_t st) {
  if (hd <= 32) return launch<T, 4, 4>(q, k, v, out, b, s_len, hkv, g, hd, scale, st);
  if (hd <= 64) return launch<T, 4, 8>(q, k, v, out, b, s_len, hkv, g, hd, scale, st);
  if (hd <= 128) return launch<T, 4, 16>(q, k, v, out, b, s_len, hkv, g, hd, scale, st);
  return launch<T, 2, 32>(q, k, v, out, b, s_len, hkv, g, hd, scale, st);
}

}  // namespace

// q (B, S, Hkv*G, hd), k/v (B, S, Hkv, hd), out like q; all contiguous, one
// dtype (0 fp32, 1 bf16); hd a multiple of 8 in [8, 256].  Returns
// cudaGetLastError() (or cudaErrorInvalidValue for unsupported arguments).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int b, int s_len, int hkv, int g, int hd, float scale,
                                      int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd < 8 || hd > 256 || hd % 8 != 0 || g < 1) return (int)cudaErrorInvalidValue;
  int rc;
  if (dtype == kF32)
    rc = dispatch_hd<float>(q, k, v, out, b, s_len, hkv, g, hd, scale, st);
  else if (dtype == kBF16)
    rc = dispatch_hd<__nv_bfloat16>(q, k, v, out, b, s_len, hkv, g, hd, scale, st);
  else
    rc = (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
