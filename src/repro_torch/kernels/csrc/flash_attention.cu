// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_fwd
//   (the Pallas TPU kernel _attn_kernel/_attn_body), the prefill attention of
//   the dense serving path and the attention forward of f32/bf16 training;
//   and src/repro/kernels/flash_attention.py::flash_attention_int8_fwd
//   (_attn_int8_kernel), the attention forward of int8-fused training.
//
// What bounds it on this card: operations.  Prefill at B=8, S=512, H=32,
// D=128, causal needs about 17 GFLOP for about 0.5 GB moved, so the bf16
// tensor cores (989 TFLOP/s) and not the 3.35 TB/s memory set the bound.
//
// What this design does about it: this first version is the simple, correct
// one.  It keeps every intermediate on chip -- one block per (batch, head,
// 64-row query tile), K/V tiles of 32 rows staged in shared memory as f32, the
// running (m, l, acc) in f32 registers/shared memory -- so device memory sees
// each Q, K, V byte about once per query tile and never the S x S scores.  It
// skips whole K/V tiles that the causal or window mask removes, as the TPU
// kernel does, which halves the causal work.  The products run on the f32
// FMA units, not the tensor cores: moving them to wgmma is a later change.
//
// Layouts follow the JAX package: q/o (B, Sq, H, D), k/v (B, Skv, Hkv, D),
// contiguous; the kv head of query head h is h / (H / Hkv).  Ragged edges are
// masked by bounds checks, not padded copies.  A row with no live key gives 0
// (acc / max(l, 1e-30)).
//
// The int8 kernel takes K/V as int8 plus (B, Skv, Hkv, 1) f32 row scales: a
// K/V tile and its scales are loaded together and dequantized on chip, so
// float K/V never exist in device memory and the K/V bytes read are a
// quarter of bf16's.  Rows past Skv dequantize to 0 (the TPU kernel's
// zero-scale padding rows): a clamped row index and a zero scale, not a pad.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 32;          // key rows per K/V tile
constexpr int NTHREADS = 256;   // 8 warps
constexpr float NEG = -1e30f;   // the TPU kernel's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1)        // Q tile, pre-scaled
       + BK * (D + 1)        // K tile
       + BK * D              // V tile
       + BQ * (BK + 1)       // scores, then probabilities
       + 3 * BQ;             // m, l, corr per query row
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int Sq, int Skv, int H, int Hkv, int causal, int window,
                 float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int DC = D / 16;            // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                     // [BQ][D+1]
  float* Ks = Qs + BQ * (D + 1);        // [BK][D+1]
  float* Vs = Ks + BK * (D + 1);        // [BK][D]
  float* Ps = Vs + BK * D;              // [BQ][BK+1]
  float* m_s = Ps + BQ * (BK + 1);      // [BQ]
  float* l_s = m_s + BQ;                // [BQ]
  float* c_s = l_s + BQ;                // [BQ]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;      // 16 x 16 thread grid
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int64_t q_row = (int64_t)H * D, kv_row = (int64_t)Hkv * D;
  const T* qb = q + (int64_t)b * Sq * q_row + (int64_t)h * D;
  const T* kb = k + (int64_t)b * Skv * kv_row + (int64_t)hk * D;
  const T* vb = v + (int64_t)b * Skv * kv_row + (int64_t)hk * D;

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int r = i / D, d = i % D;
    const int qi = q0 + r;
    Qs[r * (D + 1) + d] = qi < Sq ? to_f32(qb[(int64_t)qi * q_row + d]) * scale : 0.f;
  }
  for (int r = tid; r < BQ; r += NTHREADS) { m_s[r] = NEG; l_s[r] = 0.f; }

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;

  const int q_last = q0 + BQ - 1;
  const int n_kt = (Skv + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK, k_last = k0 + BK - 1;
    // whole-tile skip (flash_attention.py:90-99); uniform over the block
    if (causal && k0 > q_last) break;
    if (window > 0 && k_last <= q0 - window) continue;

    __syncthreads();   // previous tile's Ks/Vs/Ps are no longer read
    for (int i = tid; i < BK * D; i += NTHREADS) {
      const int r = i / D, d = i % D;
      const int ki = k0 + r;
      const bool in = ki < Skv;
      Ks[r * (D + 1) + d] = in ? to_f32(kb[(int64_t)ki * kv_row + d]) : 0.f;
      Vs[r * D + d] = in ? to_f32(vb[(int64_t)ki * kv_row + d]) : 0.f;
    }
    __syncthreads();

    // S = Q K^T: rows ty*4+i, cols tx and tx+16
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) { s[i][0] = 0.f; s[i][1] = 0.f; }
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float k0v = Ks[tx * (D + 1) + d];
      const float k1v = Ks[(tx + 16) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = Qs[(ty * 4 + i) * (D + 1) + d];
        s[i][0] = fmaf(qv, k0v, s[i][0]);
        s[i][1] = fmaf(qv, k1v, s[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      Ps[(ty * 4 + i) * (BK + 1) + tx] = s[i][0];
      Ps[(ty * 4 + i) * (BK + 1) + tx + 16] = s[i][1];
    }
    __syncthreads();

    // online softmax: warp w owns rows w*8 .. w*8+7, lane = key column
    for (int rr = 0; rr < BQ / 8; ++rr) {
      const int r = warp * (BQ / 8) + rr;
      const int qi = q0 + r, ki = k0 + lane;
      bool live = ki < Skv;
      if (causal) live = live && ki <= qi;
      if (window > 0) live = live && ki > qi - window;
      const float sv = live ? Ps[r * (BK + 1) + lane] : NEG;
      float mx = sv;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p = live ? expf(sv - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      Ps[r * (BK + 1) + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V: rows ty*4+i, cols tx + 16*j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const float corr = c_s[r];
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= corr;
      for (int kk = 0; kk < BK; ++kk) {
        const float p = Ps[r * (BK + 1) + kk];
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(p, Vs[kk * D + tx + 16 * j], acc[i][j]);
      }
    }
  }
  __syncthreads();

  T* ob = o + (int64_t)b * Sq * q_row + (int64_t)h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int qi = q0 + r;
    if (qi >= Sq) continue;
    const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DC; ++j)
      ob[(int64_t)qi * q_row + tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
  }
}

// flash_fwd_kernel over int8 K/V with (B, Skv, Hkv, 1) f32 row scales: the
// same sweep, with each K/V element dequantized (int8 -> f32, times its row
// scale, as the TPU kernel does) as the tile enters shared memory.  It is a
// copy rather than a template argument of flash_fwd_kernel: templating the
// tile load made nvcc spill more in the float kernel and slowed it by ~40% at
// the serving shape on the H100.  Its tile load differs: unpredicated loads
// from a clamped row, with the pad rows zeroed by their scale, ran the int8
// sweep ~3x faster on the H100 than the float kernel's predicated loads.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_int8_kernel(const T* __restrict__ q, const int8_t* __restrict__ k,
                      const float* __restrict__ ks, const int8_t* __restrict__ v,
                      const float* __restrict__ vs, T* __restrict__ o,
                      int Sq, int Skv, int H, int Hkv, int causal, int window,
                      float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int DC = D / 16;            // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                     // [BQ][D+1]
  float* Ks = Qs + BQ * (D + 1);        // [BK][D+1]
  float* Vs = Ks + BK * (D + 1);        // [BK][D]
  float* Ps = Vs + BK * D;              // [BQ][BK+1]
  float* m_s = Ps + BQ * (BK + 1);      // [BQ]
  float* l_s = m_s + BQ;                // [BQ]
  float* c_s = l_s + BQ;                // [BQ]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;      // 16 x 16 thread grid
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int64_t q_row = (int64_t)H * D, kv_row = (int64_t)Hkv * D;
  const T* qb = q + (int64_t)b * Sq * q_row + (int64_t)h * D;
  const int8_t* kb = k + (int64_t)b * Skv * kv_row + (int64_t)hk * D;
  const int8_t* vb = v + (int64_t)b * Skv * kv_row + (int64_t)hk * D;
  // row scales of this (batch, kv head): row ki at [ki * Hkv]
  const float* ksb = ks + (int64_t)b * Skv * Hkv + hk;
  const float* vsb = vs + (int64_t)b * Skv * Hkv + hk;

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int r = i / D, d = i % D;
    const int qi = q0 + r;
    Qs[r * (D + 1) + d] = qi < Sq ? to_f32(qb[(int64_t)qi * q_row + d]) * scale : 0.f;
  }
  for (int r = tid; r < BQ; r += NTHREADS) { m_s[r] = NEG; l_s[r] = 0.f; }

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;

  const int q_last = q0 + BQ - 1;
  const int n_kt = (Skv + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK, k_last = k0 + BK - 1;
    // whole-tile skip (flash_attention.py:90-99); uniform over the block
    if (causal && k0 > q_last) break;
    if (window > 0 && k_last <= q0 - window) continue;

    __syncthreads();   // previous tile's Ks/Vs/Ps are no longer read
    for (int i = tid; i < BK * D; i += NTHREADS) {
      const int r = i / D, d = i % D;
      const int ki = k0 + r;
      // rows past Skv are the TPU kernel's zero-scale pad rows: they load
      // the last row's bytes (unpredicated loads) and scale them by 0
      const bool in = ki < Skv;
      const float sk = in ? ksb[(int64_t)ki * Hkv] : 0.f;
      const float sv = in ? vsb[(int64_t)ki * Hkv] : 0.f;
      Ks[r * (D + 1) + d] = (float)kb[(int64_t)min(ki, Skv - 1) * kv_row + d] * sk;
      Vs[r * D + d] = (float)vb[(int64_t)min(ki, Skv - 1) * kv_row + d] * sv;
    }
    __syncthreads();

    // S = Q K^T: rows ty*4+i, cols tx and tx+16
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) { s[i][0] = 0.f; s[i][1] = 0.f; }
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float k0v = Ks[tx * (D + 1) + d];
      const float k1v = Ks[(tx + 16) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = Qs[(ty * 4 + i) * (D + 1) + d];
        s[i][0] = fmaf(qv, k0v, s[i][0]);
        s[i][1] = fmaf(qv, k1v, s[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      Ps[(ty * 4 + i) * (BK + 1) + tx] = s[i][0];
      Ps[(ty * 4 + i) * (BK + 1) + tx + 16] = s[i][1];
    }
    __syncthreads();

    // online softmax: warp w owns rows w*8 .. w*8+7, lane = key column
    for (int rr = 0; rr < BQ / 8; ++rr) {
      const int r = warp * (BQ / 8) + rr;
      const int qi = q0 + r, ki = k0 + lane;
      bool live = ki < Skv;
      if (causal) live = live && ki <= qi;
      if (window > 0) live = live && ki > qi - window;
      const float sv = live ? Ps[r * (BK + 1) + lane] : NEG;
      float mx = sv;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p = live ? expf(sv - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      Ps[r * (BK + 1) + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V: rows ty*4+i, cols tx + 16*j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const float corr = c_s[r];
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= corr;
      for (int kk = 0; kk < BK; ++kk) {
        const float p = Ps[r * (BK + 1) + kk];
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(p, Vs[kk * D + tx + 16 * j], acc[i][j]);
      }
    }
  }
  __syncthreads();

  T* ob = o + (int64_t)b * Sq * q_row + (int64_t)h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int qi = q0 + r;
    if (qi >= Sq) continue;
    const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DC; ++j)
      ob[(int64_t)qi * q_row + tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int Sq, int Skv, int H, int Hkv, int causal, int window,
                   cudaStream_t stream) {
  const int smem = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Skv, H, Hkv, causal, window,
      (float)(1.0 / sqrt((double)D)));  // as the f32 of 1/math.sqrt(D)
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, int B,
                       int Sq, int Skv, int H, int Hkv, int D, int causal,
                       int window, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, Sq, Skv, H, Hkv, causal, window, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Skv, H, Hkv, causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int D>
cudaError_t launch_int8(const void* q, const void* k, const void* ks, const void* v,
                        const void* vs, void* o, int B, int Sq, int Skv, int H, int Hkv,
                        int causal, int window, cudaStream_t stream) {
  const int smem = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_int8_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_int8_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(k), static_cast<const float*>(ks),
      static_cast<const int8_t*>(v), static_cast<const float*>(vs), static_cast<T*>(o),
      Sq, Skv, H, Hkv, causal, window, (float)(1.0 / sqrt((double)D)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d_int8(const void* q, const void* k, const void* ks, const void* v,
                            const void* vs, void* o, int B, int Sq, int Skv, int H,
                            int Hkv, int D, int causal, int window, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch_int8<T, 16>(q, k, ks, v, vs, o, B, Sq, Skv, H, Hkv, causal, window, stream);
    case 128:
      return launch_int8<T, 128>(q, k, ks, v, vs, o, B, Sq, Skv, H, Hkv, causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0: no window.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int repro_flash_attention_fwd(const void* q, const void* k, const void* v,
                                         void* o, int B, int Sq, int Skv, int H,
                                         int Hkv, int D, int causal, int window,
                                         int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(q, k, v, o, B, Sq, Skv, H, Hkv, D, causal, window, s);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, Hkv, D, causal,
                                          window, s);
  return (int)cudaErrorInvalidValue;
}

// The int8 variant: k, v int8 (B, Skv, Hkv, D); k_scale, v_scale float32
// (B, Skv, Hkv, 1); dtype is q's and o's.
extern "C" int repro_flash_attention_int8_fwd(const void* q, const void* k,
                                              const void* k_scale, const void* v,
                                              const void* v_scale, void* o, int B,
                                              int Sq, int Skv, int H, int Hkv, int D,
                                              int causal, int window, int dtype,
                                              void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d_int8<float>(q, k, k_scale, v, v_scale, o, B, Sq, Skv, H, Hkv, D,
                                       causal, window, s);
  if (dtype == 1)
    return (int)dispatch_d_int8<__nv_bfloat16>(q, k, k_scale, v, v_scale, o, B, Sq, Skv, H,
                                               Hkv, D, causal, window, s);
  return (int)cudaErrorInvalidValue;
}
