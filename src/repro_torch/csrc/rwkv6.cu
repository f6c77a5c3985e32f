// RWKV-6 time-mix recurrence for Hopper, in chunks of L = 16 tokens:
//
//     y_t = r_t . (S_{t-1} + diag(u) k_t^T v_t)
//     S_t = diag(w_t) S_{t-1} + k_t^T v_t            (S: K x V, fp32, S_0 = 0)
//
// for r/k/v/w (B, H, T, K) read through strides (unit stride along K), u
// (B, H, K) fp32 (broadcast strides allowed); y (B, H, T, K) in r's dtype,
// written through its own strides, and optionally the final state
// S_T (B, H, K, K) fp32.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6/rwkv6.py (rwkv6_chunked,
// body _kernel): one grid row per batch*head walking the chunks in order
// with the (K, V) state in VMEM scratch; inside a chunk, with
// logcum = inclusive cumsum of log(max(w, 1e-38)) and logecum = logcum - logw,
//     cross:  y_t += (r_t * exp(logecum_t)) @ S
//     intra:  y_t += sum_{s<t} A[t, s] v_s,
//             A[t, s] = sum_k r_t k_s exp(min(logecum_t - logcum_s, 0))
//     bonus:  y_t += (r_t . (u * k_t)) v_t
//     state:  S <- exp(logcum_{L-1}) * S + sum_s (k_s * exp(logcum_{L-1} - logcum_s))^T v_s
// Every exponent is a difference over s <= t, hence <= 0: the chunk-local
// rebase that keeps strong decay (w -> 0) from overflowing.  The TPU kernel
// starts from a zero state and returns y only; this one also writes the
// final state, so a prefill runs through it.
//
// What bounds it here: bytes.  Per token it does ~4 K V + 2 L (K + V) FLOPs
// (~21 kFLOP at K = V = 64) against 5 K element reads and writes, ~16
// FLOP/byte in fp32: below the card's fp32 ridge (67 TFLOP/s over 3.35 TB/s
// = 20) and far below the tensor-core ridge.
//
// Design (simple and correct first; tensor cores and TMA are later work):
//  * The columns of S are independent: y_t[v] and S[:, v] need only column
//    v.  One block per (b * H + h, V-slice of 16 columns), so a single
//    prefill row (B = 1, H = 32) still gives 128 blocks.  Each block keeps
//    its K x 16 slice of S in shared memory and walks the chunks in order.
//  * Each block loads the chunk's r, k, w (L x K, widened to fp32) and its
//    v columns, computes the cumsums, the L x L matrix A (with the bonus on
//    its diagonal) and the decayed r and k again in every V-slice: cheap
//    next to the state's traffic.  Shared rows are padded to K + 1 floats,
//    so the strided reads are free of bank conflicts.
//  * A ragged T is masked in the kernel: positions past T load r = k = v = 0
//    and w = 1 (log w = 0, the identity decay the TPU wrapper pads with), so
//    they change neither y nor S; their y is not stored.
//  * Full-precision expf/logf, fp32 throughout, so the kernel holds the
//    sequential fp32 scan to rounding.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int L = 16;         // tokens per chunk (the TPU kernel's default)
constexpr int MAX_VS = 16;    // state columns per block
constexpr int THREADS = 128;

template <typename T, int K>
__global__ void __launch_bounds__(THREADS)
rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ w, const float* __restrict__ u, T* __restrict__ y,
             float* __restrict__ state, int h_count, int t_len, long long sb, long long sh,
             long long st, long long usb, long long ush, long long ysb, long long ysh,
             long long yst) {
  constexpr int VS = K < MAX_VS ? K : MAX_VS;  // columns of this block
  constexpr int NSLICE = K / VS;
  constexpr int KP = K + 1;  // padded row stride
  const int slice = blockIdx.x % NSLICE;
  const int bh = blockIdx.x / NSLICE;
  const int b = bh / h_count, h = bh % h_count;
  const int v0 = slice * VS;
  const long long in_base = b * sb + h * sh;
  const T* rp = r + in_base;
  const T* kp = k + in_base;
  const T* vp = v + in_base + v0;
  const T* wp = w + in_base;
  T* yp = y + b * ysb + h * ysh + v0;

  __shared__ float s_r[L][KP];   // r, then r * exp(logecum)
  __shared__ float s_k[L][KP];   // k, then k * exp(logcum_{L-1} - logcum)
  __shared__ float s_lc[L][KP];  // log w, then its inclusive cumsum
  __shared__ float s_le[L][KP];  // exclusive cumsum
  __shared__ float s_v[L][VS];
  __shared__ float s_S[K][VS];
  __shared__ float s_A[L][L + 1];
  __shared__ float s_u[K];
  __shared__ float s_dec[K];     // exp(logcum_{L-1}): the chunk's whole decay

  const int tid = threadIdx.x;
  for (int i = tid; i < K * VS; i += THREADS) s_S[i / VS][i % VS] = 0.f;
  for (int i = tid; i < K; i += THREADS) s_u[i] = u[b * usb + h * ush + i];

  for (int t0 = 0; t0 < t_len; t0 += L) {
    __syncthreads();  // the previous chunk is done with shared memory
    for (int i = tid; i < L * K; i += THREADS) {
      const int t = i / K, c = i % K, tt = t0 + t;
      float rv = 0.f, kv = 0.f, lw = 0.f;
      if (tt < t_len) {
        const long long off = tt * st + c;
        rv = to_f(rp[off]);
        kv = to_f(kp[off]);
        lw = logf(fmaxf(to_f(wp[off]), 1e-38f));
      }
      s_r[t][c] = rv;
      s_k[t][c] = kv;
      s_lc[t][c] = lw;
    }
    for (int i = tid; i < L * VS; i += THREADS) {
      const int t = i / VS, c = i % VS, tt = t0 + t;
      s_v[t][c] = tt < t_len ? to_f(vp[tt * st + c]) : 0.f;
    }
    __syncthreads();
    for (int c = tid; c < K; c += THREADS) {
      float acc = 0.f;
      for (int t = 0; t < L; ++t) {
        const float lw = s_lc[t][c];
        acc += lw;
        s_lc[t][c] = acc;
        s_le[t][c] = acc - lw;
      }
    }
    __syncthreads();
    // A[t, s] for s < t, and the bonus r_t . (u * k_t) on the diagonal.
    for (int p = tid; p < L * L; p += THREADS) {
      const int t = p / L, s = p % L;
      float a = 0.f;
      if (s < t) {
#pragma unroll 8
        for (int c = 0; c < K; ++c)
          a += s_r[t][c] * s_k[s][c] * expf(fminf(s_le[t][c] - s_lc[s][c], 0.f));
      } else if (s == t) {
#pragma unroll 8
        for (int c = 0; c < K; ++c) a += s_r[t][c] * s_u[c] * s_k[t][c];
      }
      s_A[t][s] = a;
    }
    __syncthreads();
    for (int i = tid; i < L * K; i += THREADS) {
      const int t = i / K, c = i % K;
      s_r[t][c] *= expf(s_le[t][c]);
      s_k[t][c] *= expf(s_lc[L - 1][c] - s_lc[t][c]);
    }
    for (int c = tid; c < K; c += THREADS) s_dec[c] = expf(s_lc[L - 1][c]);
    __syncthreads();
    for (int i = tid; i < L * VS; i += THREADS) {
      const int t = i / VS, c = i % VS;
      float acc = 0.f;
#pragma unroll 8
      for (int j = 0; j < K; ++j) acc += s_r[t][j] * s_S[j][c];
      for (int s = 0; s <= t; ++s) acc += s_A[t][s] * s_v[s][c];
      if (t0 + t < t_len) yp[(t0 + t) * yst + c] = from_f<T>(acc);
    }
    __syncthreads();
    for (int i = tid; i < K * VS; i += THREADS) {
      const int j = i / VS, c = i % VS;
      float acc = s_dec[j] * s_S[j][c];
#pragma unroll
      for (int s = 0; s < L; ++s) acc += s_k[s][j] * s_v[s][c];
      s_S[j][c] = acc;
    }
  }
  if (state != nullptr) {
    float* sp = state + (long long)bh * K * K + v0;
    for (int i = tid; i < K * VS; i += THREADS) {
      const int j = i / VS, c = i % VS;
      sp[j * K + c] = s_S[j][c];  // each thread wrote this entry itself
    }
  }
}

template <typename T, int K>
int launch(const void* r, const void* k, const void* v, const void* w, const float* u,
           void* y, float* state, int b, int h, int t_len, const long long* s,
           cudaStream_t st) {
  constexpr int VS = K < MAX_VS ? K : MAX_VS;
  const long long blocks = (long long)b * h * (K / VS);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  rwkv6_kernel<T, K><<<(unsigned)blocks, THREADS, 0, st>>>(
      (const T*)r, (const T*)k, (const T*)v, (const T*)w, u, (T*)y, state, h, t_len,
      s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7]);
  return 0;
}

template <typename T>
int dispatch_k(const void* r, const void* k, const void* v, const void* w, const float* u,
               void* y, float* state, int b, int h, int t_len, int kd, const long long* s,
               cudaStream_t st) {
  switch (kd) {
    case 8: return launch<T, 8>(r, k, v, w, u, y, state, b, h, t_len, s, st);
    case 16: return launch<T, 16>(r, k, v, w, u, y, state, b, h, t_len, s, st);
    case 32: return launch<T, 32>(r, k, v, w, u, y, state, b, h, t_len, s, st);
    case 64: return launch<T, 64>(r, k, v, w, u, y, state, b, h, t_len, s, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// r/k/v/w (B, H, T, K) of one dtype (0 fp32, 1 bf16) sharing the element
// strides (sb, sh, st) and unit stride along K; u (B, H, K) fp32 with
// strides (usb, ush, 1); y like r with strides (ysb, ysh, yst, 1); state
// (B, H, K, K) fp32 contiguous, or null.  K in {8, 16, 32, 64}, T >= 1.
// Returns cudaGetLastError() (or cudaErrorInvalidValue for unsupported
// arguments).
extern "C" int rwkv6_launch(const void* r, const void* k, const void* v, const void* w,
                            const void* u, void* y, void* state, int b, int h, int t_len,
                            int kd, long long sb, long long sh, long long st, long long usb,
                            long long ush, long long ysb, long long ysh, long long yst,
                            int dtype, void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (b < 1 || h < 1 || t_len < 1) return (int)cudaErrorInvalidValue;
  const long long s[8] = {sb, sh, st, usb, ush, ysb, ysh, yst};
  int rc;
  if (dtype == kF32)
    rc = dispatch_k<float>(r, k, v, w, (const float*)u, y, (float*)state, b, h, t_len, kd, s,
                           cs);
  else if (dtype == kBF16)
    rc = dispatch_k<__nv_bfloat16>(r, k, v, w, (const float*)u, y, (float*)state, b, h,
                                   t_len, kd, s, cs);
  else
    rc = (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
