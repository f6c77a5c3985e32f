// Paged-attention decode for Hopper: one new query token per row attends
// that row's KV prefix through its block-table row.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/paged_attention.py
// (paged_attention, body _kernel), which packs R rows into one MXU score tile
// and double-buffers page DMAs.
//
// What bounds it here: the bytes of the live K/V pages.  A decode step does
// 4*Hq*hd FLOPs per cached token against 2*Hkv*hd*elem bytes of K/V, far
// below the card's ~295 FLOP/byte ridge, so only the page reads matter.
//
// Design:
//  * One block per (row, KV head); the block holds the G = Hq/Hkv query
//    heads of that KV head, so each K/V page element is read once for all G
//    heads (the GQA saving).  The TPU's R-row packing existed to fill an
//    8-sublane tile and is not carried over.
//  * The block walks ONLY the row's live pages, ceil(len / bs), through its
//    block-table row; a -1 entry is clamped to block 0 and hidden by the
//    length mask, as the TPU kernel does.  A length-0 row reads no pages and
//    writes zeros (acc / max(l, 1e-30)).
//  * fp32 online softmax: per page, warps compute the G x bs scores (each
//    lane strides over hd, warp-shuffle reduction), one thread per head
//    updates the running max/sum, then thread d accumulates output feature
//    d for all G heads.  int8 pages are dequantized with their per-(token,
//    head) fp32 scales on load.
//  * Flash-decoding splits of long rows across blocks, cp.async/TMA page
//    loads and vectorized loads are later work.
#include <math.h>

#include "common.cuh"

namespace {

template <typename TQ, typename TKV, bool QUANT, int G>
__global__ void paged_attention_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ kp, const TKV* __restrict__ vp,
    const float* __restrict__ ks, const float* __restrict__ vs,
    const int* __restrict__ bt, const int* __restrict__ lens, TQ* __restrict__ out,
    int hkv, int hd, int bs, int max_blocks, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;            // G * hd   queries (fp32)
  float* sc = qs + G * hd;     // G * bs   scores, then probabilities
  float* mstat = sc + G * bs;  // G        running max
  float* lstat = mstat + G;    // G        running sum
  float* corr = lstat + G;     // G        this page's rescale

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const int hq = hkv * G;
  const int len = lens[b];

  for (int i = tid; i < G * hd; i += nthreads) {
    const int g = i / hd, d = i % hd;
    qs[i] = to_f(q[((size_t)b * hq + h * G + g) * hd + d]);
  }
  if (tid < G) {
    mstat[tid] = -INFINITY;
    lstat[tid] = 0.f;
  }
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;
  __syncthreads();

  const int n_pages = (len + bs - 1) / bs;
  for (int p = 0; p < n_pages; ++p) {
    const int blk = max(bt[(size_t)b * max_blocks + min(p, max_blocks - 1)], 0);
    const int valid = min(bs, len - p * bs);

    for (int j = warp; j < valid; j += nwarps) {
      const size_t row = ((size_t)blk * bs + j) * hkv + h;
      const TKV* krow = kp + row * hd;
      const float kscale = QUANT ? ks[row] : 1.f;
      float part[G];
#pragma unroll
      for (int g = 0; g < G; ++g) part[g] = 0.f;
      for (int d = lane; d < hd; d += 32) {
        const float kv = to_f(krow[d]) * kscale;
#pragma unroll
        for (int g = 0; g < G; ++g) part[g] = fmaf(qs[g * hd + d], kv, part[g]);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = part[g];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) sc[g * bs + j] = s * scale;
      }
    }
    __syncthreads();

    if (tid < G) {
      const int g = tid;
      float mx = mstat[g];
      for (int j = 0; j < valid; ++j) mx = fmaxf(mx, sc[g * bs + j]);
      const float c = expf(mstat[g] - mx);  // exp(-inf) = 0 on the first page
      float sum = 0.f;
      for (int j = 0; j < valid; ++j) {
        const float e = expf(sc[g * bs + j] - mx);
        sc[g * bs + j] = e;
        sum += e;
      }
      lstat[g] = lstat[g] * c + sum;
      mstat[g] = mx;
      corr[g] = c;
    }
    __syncthreads();

    if (tid < hd) {
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] *= corr[g];
      for (int j = 0; j < valid; ++j) {
        const size_t row = ((size_t)blk * bs + j) * hkv + h;
        const float vv = to_f(vp[row * hd + tid]) * (QUANT ? vs[row] : 1.f);
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g] = fmaf(sc[g * bs + j], vv, acc[g]);
      }
    }
    __syncthreads();
  }

  if (tid < hd) {
#pragma unroll
    for (int g = 0; g < G; ++g)
      out[((size_t)b * hq + h * G + g) * hd + tid] =
          from_f<TQ>(acc[g] / fmaxf(lstat[g], 1e-30f));
  }
}

template <typename TQ, typename TKV, bool QUANT, int G>
void launch(const void* q, const void* kp, const void* vp, const float* ks,
            const float* vs, const int* bt, const int* lens, void* out, int b,
            int hkv, int hd, int bs, int max_blocks, float scale, cudaStream_t st) {
  const int threads = ((hd + 31) / 32) * 32;
  const size_t smem = sizeof(float) * ((size_t)G * hd + (size_t)G * bs + 3 * G);
  paged_attention_kernel<TQ, TKV, QUANT, G><<<dim3(b, hkv), threads, smem, st>>>(
      (const TQ*)q, (const TKV*)kp, (const TKV*)vp, ks, vs, bt, lens, (TQ*)out,
      hkv, hd, bs, max_blocks, scale);
}

template <typename TQ, typename TKV, bool QUANT>
int dispatch_g(int g, const void* q, const void* kp, const void* vp, const float* ks,
               const float* vs, const int* bt, const int* lens, void* out, int b,
               int hkv, int hd, int bs, int max_blocks, float scale, cudaStream_t st) {
#define PA_CASE(GV)                                                                 \
  case GV:                                                                          \
    launch<TQ, TKV, QUANT, GV>(q, kp, vp, ks, vs, bt, lens, out, b, hkv, hd, bs,    \
                               max_blocks, scale, st);                              \
    return 0;
  switch (g) {
    PA_CASE(1)
    PA_CASE(2)
    PA_CASE(4)
    PA_CASE(8)
    PA_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PA_CASE
}

}  // namespace

// q (B, Hkv*G, hd); k/v pools (N, bs, Hkv, hd); scales (N, bs, Hkv) fp32 for
// int8 pools, else null; block_tables (B, max_blocks) int32 (-1 = none);
// lengths (B,) int32 = cache_len + 1.  q/out dtype: 0 fp32, 1 bf16; pool
// dtype: the same as q, or 2 (int8).  Returns cudaGetLastError().
extern "C" int paged_attention_launch(const void* q, const void* kp, const void* vp,
                                      const float* ks, const float* vs, const int* bt,
                                      const int* lens, void* out, int b, int hkv, int g,
                                      int hd, int bs, int max_blocks, float scale,
                                      int q_dtype, int kv_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  using bf = __nv_bfloat16;
  if (q_dtype == kF32 && kv_dtype == kF32)
    rc = dispatch_g<float, float, false>(g, q, kp, vp, ks, vs, bt, lens, out, b, hkv,
                                         hd, bs, max_blocks, scale, st);
  else if (q_dtype == kBF16 && kv_dtype == kBF16)
    rc = dispatch_g<bf, bf, false>(g, q, kp, vp, ks, vs, bt, lens, out, b, hkv, hd,
                                   bs, max_blocks, scale, st);
  else if (q_dtype == kF32 && kv_dtype == kI8)
    rc = dispatch_g<float, int8_t, true>(g, q, kp, vp, ks, vs, bt, lens, out, b, hkv,
                                         hd, bs, max_blocks, scale, st);
  else if (q_dtype == kBF16 && kv_dtype == kI8)
    rc = dispatch_g<bf, int8_t, true>(g, q, kp, vp, ks, vs, bt, lens, out, b, hkv, hd,
                                      bs, max_blocks, scale, st);
  else
    rc = (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
