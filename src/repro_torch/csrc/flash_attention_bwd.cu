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
// The FA2 backward, in fp32 whatever the input dtype:
//   D  = rowsum(dO * O)                       (flash_bwd_dsum_kernel)
//   P  = exp(S * scale - lse), S = Q K^T, zero above the diagonal
//   dV = P^T dO,  dS = P * (dO V^T - D),  dK = dS^T Q * scale
//                                            (flash_bwd_dkdv_kernel)
//   dQ = dS K * scale                         (flash_bwd_dq_kernel)
// dK and dV sum over the G query heads of each KV head.  P is rebuilt from
// lse in both the dK/dV and the dQ kernel (S is computed twice).
//
// Three launches, no atomics: every output element is written by one
// thread of one block, so two runs give the same bits.
//  * dK/dV: one block per (batch, KV head, 32-key tile).  It keeps its K and
//    V tile in shared memory and its dK, dV rows in registers, and walks the
//    32-row query tiles at or after its keys, and in each the G heads of its
//    group.
//  * dQ: one block per (batch, query head, 32-row query tile), its Q, dO
//    rows in shared memory and its dQ rows in registers; it walks the key
//    tiles up to the diagonal.
//  * 256 threads as 32 rows x 8 lanes; a lane holds dims lane + 8 j.  Tiles
//    are widened to fp32 in shared memory with a row stride of hd + 1.
//
// What bounds it here: operations.  The backward does about 2.5 times the
// forward's causal FLOPs against the same bytes, far above the card's ridge.
// This first version runs on CUDA cores (fp32 FMA) and recomputes S in both
// kernels; tensor cores (mma.sync / wgmma), TMA and a fused dQ pass are
// left for a later redesign.
#include <math.h>

#include "common.cuh"

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
  const long long rows = (long long)b * s_len * hq;
  const int warps = THREADS / 32;
  flash_bwd_dsum_kernel<T><<<(unsigned)((rows + warps - 1) / warps), THREADS, 0, st>>>(
      (const T*)out, (const T*)dout, dsum, rows, s_len, hq, hd);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int tiles = (s_len + BT - 1) / BT;
  flash_bwd_dkdv_kernel<T, NJ><<<dim3(tiles, b * hkv), THREADS, smem_bytes(hd, 2), st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dsum, (T*)dk, (T*)dv, s_len,
      hkv, g, hd, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_kernel<T, NJ><<<dim3(tiles, b * hq), THREADS, smem_bytes(hd, 1), st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dsum, (T*)dq, s_len, hkv,
      g, hd, scale);
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
// contiguous, one dtype (0 fp32, 1 bf16); hd a multiple of 8 up to hdp in
// {32, 64, 128, 256}.  Three kernels on `stream`, in order.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for what no instantiation
// can launch.
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
  else if (dtype == kBF16)
    rc = launch_hd<__nv_bfloat16>(q, k, v, out, dout, l, ds, dq, dk, dv, b, s_len, hkv, g, hd,
                                  scale, hdp, st);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
