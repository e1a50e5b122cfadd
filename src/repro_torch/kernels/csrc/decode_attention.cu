// Single-token decode attention for Hopper (sm_90a), plain C interface for
// ctypes: one kernel over a native cache and one over an int8 cache.
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention
//   (_decode_kernel/_online_update) and ::decode_attention_int8
//   (_decode_int8_kernel), the decode attention of the dense serving path.
//
// What bounds it on this card: bytes.  One query row meets the whole live
// cache, so every K/V byte read is used for 2 multiply-adds: at B=8, 32 heads,
// D=128 and ~576 live rows the bf16 cache is ~75 MB (~22 us at 3.35 TB/s),
// the int8 cache ~20 MB (~6 us), against well under a GFLOP of work.
//
// What this design does about it: one block per (batch, head), so B=8 gives
// 256 blocks over 132 SMs (80 at recurrentgemma-2b's 10 heads).  Head dims 16,
// 32, 128 and 256; at 256 each lane holds 8 values of a row.  The block's lanes form groups of min(32, D) lanes,
// one cache row per group at a time (each lane holds D/32 contiguous values,
// so a group reads a row in one coalesced sweep), four rows in flight per
// group.  Groups split only the rows below valid_len[b] (and above the window),
// as `live` does in the TPU kernel, so a ragged batch reads no dead rows.  Each
// group keeps its own (m, l, acc) in registers; the partial results are merged
// once in shared memory.  The int8 variant loads the int8 rows and their f32
// row scale and dequantizes in registers: the cache is never widened in
// memory, so it moves ~4x fewer bytes than a bf16 cache.  A row with no live
// key (valid_len 0) gives 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int UNROLL = 4;         // cache rows in flight per group
constexpr float NEG = -1e30f;     // the TPU kernel's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// N contiguous elements loaded as one aligned vector.
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float (&out)[N]) {
  const Vec<T, N> x = *reinterpret_cast<const Vec<T, N>*>(p);
#pragma unroll
  for (int e = 0; e < N; ++e) out[e] = to_f32(x.v[e]);
}

// QT: query/output type; KT: cache type (QT, or int8_t with row scales).
template <typename QT, typename KT, int D, bool INT8>
__global__ void __launch_bounds__(NTHREADS)
decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
              const float* __restrict__ k_scale, const KT* __restrict__ v,
              const float* __restrict__ v_scale, const int* __restrict__ valid_len,
              QT* __restrict__ o, int Skv, int H, int Hkv, int window, float scale) {
  constexpr int LPR = D < 32 ? D : 32;    // lanes per group (one cache row)
  constexpr int EPL = D / LPR;            // values per lane
  constexpr int NG = NTHREADS / LPR;      // groups per block
  static_assert(D % LPR == 0 && EPL <= 8, "unsupported head dim");

  __shared__ float m_s[NG], l_s[NG];
  __shared__ float acc_s[NG * D];

  const int tid = threadIdx.x;
  const int g = tid / LPR, gl = tid % LPR;
  const int lane = tid & 31;
  const unsigned gmask =
      LPR == 32 ? 0xffffffffu : (((1u << (LPR % 32)) - 1u) << (lane / LPR * LPR));
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (H / Hkv);
  const int64_t kv_row = (int64_t)Hkv * D;

  int valid = valid_len[b];
  valid = valid < 0 ? 0 : (valid > Skv ? Skv : valid);
  // live rows: k_pos < valid and, with a window, k_pos > valid - 1 - window
  const int lo = window > 0 ? max(0, valid - window) : 0;

  float qv[EPL];
  load_f32<QT, EPL>(q + ((int64_t)b * H + h) * D + gl * EPL, qv);
#pragma unroll
  for (int e = 0; e < EPL; ++e) qv[e] *= scale;

  const KT* kb = k + (int64_t)b * Skv * kv_row + (int64_t)hk * D + gl * EPL;
  const KT* vb = v + (int64_t)b * Skv * kv_row + (int64_t)hk * D + gl * EPL;
  const int64_t sc_base = (int64_t)b * Skv * Hkv + hk;   // scales (B, Skv, Hkv, 1)

  float m = NEG, l = 0.f, acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;

  for (int base = lo + g * UNROLL; base < valid; base += NG * UNROLL) {
    float s[UNROLL];
    float vv[UNROLL][EPL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = base + u;
      float kk[EPL];
      if (r < valid) {
        load_f32<KT, EPL>(kb + (int64_t)r * kv_row, kk);
        load_f32<KT, EPL>(vb + (int64_t)r * kv_row, vv[u]);
        if (INT8) {
          const float ks = k_scale[sc_base + (int64_t)r * Hkv];
          const float vs = v_scale[sc_base + (int64_t)r * Hkv];
#pragma unroll
          for (int e = 0; e < EPL; ++e) { kk[e] *= ks; vv[u][e] *= vs; }
        }
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) { kk[e] = 0.f; vv[u][e] = 0.f; }
      }
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) part = fmaf(qv[e], kk[e], part);
      s[u] = part;
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) s[u] += __shfl_xor_sync(gmask, s[u], off);

    float m_new = m;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (base + u >= valid) s[u] = NEG;
      m_new = fmaxf(m_new, s[u]);
    }
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] *= corr;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const float p = base + u < valid ? expf(s[u] - m_new) : 0.f;
      l += p;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[e] = fmaf(p, vv[u][e], acc[e]);
    }
    m = m_new;
  }

  // merge the groups' partial softmax states
  if (gl == 0) { m_s[g] = m; l_s[g] = l; }
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc_s[g * D + gl * EPL + e] = acc[e];
  __syncthreads();
  for (int d = tid; d < D; d += NTHREADS) {
    float M = NEG;
    for (int j = 0; j < NG; ++j) M = fmaxf(M, m_s[j]);
    float L = 0.f, A = 0.f;
    for (int j = 0; j < NG; ++j) {
      const float w = expf(m_s[j] - M);
      L = fmaf(l_s[j], w, L);
      A = fmaf(acc_s[j * D + d], w, A);
    }
    o[((int64_t)b * H + h) * D + d] = from_f32<QT>(A / fmaxf(L, 1e-30f));
  }
}

template <typename QT, typename KT, int D, bool INT8>
cudaError_t launch(const void* q, const void* k, const float* ks, const void* v,
                   const float* vs, const int* valid, void* o, int B, int Skv,
                   int H, int Hkv, int window, cudaStream_t stream) {
  dim3 grid(H, B);
  decode_kernel<QT, KT, D, INT8><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k), ks,
      static_cast<const KT*>(v), vs, valid, static_cast<QT*>(o), Skv, H, Hkv,
      window, (float)(1.0 / sqrt((double)D)));  // as the f32 of 1/math.sqrt(D)
  return cudaGetLastError();
}

template <typename QT, typename KT, bool INT8>
cudaError_t dispatch_d(const void* q, const void* k, const float* ks, const void* v,
                       const float* vs, const int* valid, void* o, int B, int Skv,
                       int H, int Hkv, int D, int window, cudaStream_t s) {
  switch (D) {
    case 16: return launch<QT, KT, 16, INT8>(q, k, ks, v, vs, valid, o, B, Skv, H, Hkv, window, s);
    case 32: return launch<QT, KT, 32, INT8>(q, k, ks, v, vs, valid, o, B, Skv, H, Hkv, window, s);
    case 128: return launch<QT, KT, 128, INT8>(q, k, ks, v, vs, valid, o, B, Skv, H, Hkv, window, s);
    case 256: return launch<QT, KT, 256, INT8>(q, k, ks, v, vs, valid, o, B, Skv, H, Hkv, window, s);
    default: return cudaErrorInvalidValue;
  }
}

bool bad_shape(int B, int Skv, int H, int Hkv) {
  return B <= 0 || Skv <= 0 || Hkv <= 0 || H % Hkv != 0;
}

}  // namespace

// dtype (of q, o and a native cache): 0 = float32, 1 = bfloat16.
// window <= 0: no window.  Returns the cudaError_t of the launch.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const int* valid, void* o, int B, int Skv,
                                      int H, int Hkv, int D, int window, int dtype,
                                      void* stream) {
  if (bad_shape(B, Skv, H, Hkv)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float, float, false>(q, k, nullptr, v, nullptr, valid, o, B,
                                                Skv, H, Hkv, D, window, s);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16, __nv_bfloat16, false>(
        q, k, nullptr, v, nullptr, valid, o, B, Skv, H, Hkv, D, window, s);
  return (int)cudaErrorInvalidValue;
}

// k/v int8 (B, Skv, Hkv, D); k_scale/v_scale f32 (B, Skv, Hkv, 1).
extern "C" int repro_decode_attention_int8(const void* q, const void* k,
                                           const float* k_scale, const void* v,
                                           const float* v_scale, const int* valid,
                                           void* o, int B, int Skv, int H, int Hkv,
                                           int D, int window, int dtype, void* stream) {
  if (bad_shape(B, Skv, H, Hkv)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float, int8_t, true>(q, k, k_scale, v, v_scale, valid, o, B,
                                                Skv, H, Hkv, D, window, s);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16, int8_t, true>(q, k, k_scale, v, v_scale,
                                                        valid, o, B, Skv, H, Hkv, D,
                                                        window, s);
  return (int)cudaErrorInvalidValue;
}
