// RWKV-6 WKV scan for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/rwkv6_scan.py::rwkv6_scan (the Pallas TPU
//   kernel _wkv6_kernel/_wkv6_body), the time-mixing recurrence of the RWKV-6
//   prefill and of f32/bf16 training:
//     out_t = r_t @ (S_{t-1} + diag(u) k_t v_t^T)
//     S_t   = diag(w_t) S_{t-1} + k_t v_t^T,   S_0 = 0,
//   per (batch, head), with a (D, D) float32 state S; returns every out_t and
//   the final state.  And src/repro/kernels/rwkv6_scan.py::rwkv6_scan_int8
//   (_wkv6_int8_kernel), the same recurrence in int8-fused training: r/k/v
//   arrive as int8 with (B, S, H, 1) f32 row scales and are dequantized
//   (int8 -> f32, times the row scale, as the TPU kernel does) as a chunk
//   enters shared memory; the decay w stays float.  One kernel template
//   serves both: only the chunk load differs (FloatRKV / Int8RKV).
//
// What bounds it on this card: float32 operations.  Each step of each (b, h)
// needs 5 D^2 of them (D^2 multiply-adds for r_t @ S, D^2 products k v^T and
// D^2 multiply-adds for the update): at B=8, S=512, H=64, D=64 that is
// 5.4 GFLOP, 0.080 ms at 67 TFLOP/s, against ~176 MB moved (0.053 ms at
// 3.35 TB/s).
//
// What this design does about it: a token-serial sweep, not the TPU kernel's
// chunked form.  The TPU kernel chunks the sequence (32 steps) so that the
// work becomes (32, D) x (D, D) products on its matrix unit; it takes the
// decays as log(max(w, 1e-30)) and keeps every exponent <= 0 so that the
// chunked form cannot overflow.  On Hopper's FMA units the chunked form has
// no fewer operations (the same work on S per step, plus a 32 x 32 x D/2
// intra-chunk term and its exps); it pays off only once its products run on the tensor
// cores (wgmma), which is later work.  The serial sweep multiplies by the
// decays themselves (floored at 1e-30, as the TPU kernel's log floor), so it
// cannot overflow either: it never divides by a decay.  It computes the same
// function as the TPU kernel, and step for step what the plain version
// (kernels/ref.py::rwkv6_scan_ref) computes.
//
// One block per (batch, head) of 2 D threads.  Thread (e, p) owns column e of
// S and its rows p*D/2 .. p*D/2+D/2-1 (p = 0, 1) in registers, so S never
// leaves the SM and the update needs no synchronisation; out_t[e] is the sum
// of the two partial dot products, added across two adjacent lanes by a
// shuffle, plus v_t[e] * sum_d r_t[d] u[d] k_t[d].  The sequence is walked in chunks of 32
// steps: a chunk of r, k, w, v is loaded into shared memory with coalesced
// reads of the (B, S, H, D) layout in place (no transposed copy), r/k/w padded
// so each thread's float4 reads are free of bank conflicts.  A ragged S ends
// the last chunk early, which is what the TPU kernels' padding (lw = 0,
// r = k = v = 0; zero row scales in the int8 kernel) does to the state.
// In int8-fused training (B 60, S 256, H 64, D 64) the int8 load reads a
// quarter of bf16's r/k/v bytes, but the bound is the same 2.0e10 f32
// operations (0.30 ms at 67 TFLOP/s).  At full width there are only 512 blocks
// of 128 threads for 132 SMs, all resident at once (80 registers a thread,
// 35 KB of shared memory a block), 3 or 4 a SM: the time is set by the 512
// serial steps of a block, not by the card's width.  Two threads a column
// ran 1.7x faster on the H100 than four (chip_smoke.py: 0.335 against 0.555
// ms at full width): fewer shuffles and shared-memory reads per
// multiply-add, and one wave of blocks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 32;          // time steps staged in shared memory at once

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr int NP = 2;              // threads per column of the state

// How r/k/v reach float32 as a chunk enters shared memory: element g of the
// (B, S, H, D) layout, whose row (b, t, h) has row scale index sr.  The
// loads take the read-only path (__ldg): through plain struct members the
// float kernel ran slower at the serving shape on the H100 than with its
// pointers as const __restrict__ kernel arguments; through __ldg, as fast
// (scripts/wkv6_ab.py).
template <typename T>
struct FloatRKV {                  // r/k/v in T (the float kernel)
  const T* __restrict__ r; const T* __restrict__ k; const T* __restrict__ v;
  __device__ __forceinline__ float r_at(int64_t g, int64_t) const {
    return to_f32(__ldg(r + g));
  }
  __device__ __forceinline__ float k_at(int64_t g, int64_t) const {
    return to_f32(__ldg(k + g));
  }
  __device__ __forceinline__ float v_at(int64_t g, int64_t) const {
    return to_f32(__ldg(v + g));
  }
};

struct Int8RKV {                   // int8 r/k/v + (B, S, H, 1) f32 row scales
  const int8_t* __restrict__ r; const int8_t* __restrict__ k; const int8_t* __restrict__ v;
  const float* __restrict__ rs; const float* __restrict__ ks; const float* __restrict__ vs;
  __device__ __forceinline__ float r_at(int64_t g, int64_t sr) const {
    return (float)__ldg(r + g) * __ldg(rs + sr);
  }
  __device__ __forceinline__ float k_at(int64_t g, int64_t sr) const {
    return (float)__ldg(k + g) * __ldg(ks + sr);
  }
  __device__ __forceinline__ float v_at(int64_t g, int64_t sr) const {
    return (float)__ldg(v + g) * __ldg(vs + sr);
  }
};

// In: how r/k/v are read (FloatRKV<T> or Int8RKV).  TW: dtype of w.
// TO: dtype of out.  D: head dim.
template <typename In, typename TW, typename TO, int D>
__global__ void __launch_bounds__(D * NP)
wkv6_kernel(In in, const TW* __restrict__ w, const float* __restrict__ u,
            TO* __restrict__ out, float* __restrict__ state, int S, int H) {
  constexpr int NT = D * NP;          // threads
  constexpr int RPT = D / NP;         // state rows per thread
  constexpr int PS = RPT + 4;         // padded stride of one thread's rows
  constexpr int ROW = NP * PS;        // padded r/k/w row
  static_assert(RPT % 4 == 0 && NT % 32 == 0, "unsupported head dim");
  __shared__ __align__(16) float r_s[CHUNK][ROW];
  __shared__ __align__(16) float k_s[CHUNK][ROW];
  __shared__ __align__(16) float w_s[CHUNK][ROW];
  __shared__ float v_s[CHUNK][D];
  __shared__ float bonus_s[CHUNK];

  const int tid = threadIdx.x;
  const int e = tid / NP, p = tid % NP;
  const int lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.y;
  const int64_t row = (int64_t)H * D;
  const int64_t base = (int64_t)b * S * row + (int64_t)h * D;
  const int64_t sbase = (int64_t)b * S * H + h;     // row scale of (b, t = 0, h)
  const float* uh = u + (int64_t)h * D;

  float st[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) st[i] = 0.f;

  for (int t0 = 0; t0 < S; t0 += CHUNK) {
    const int n = min(CHUNK, S - t0);
    __syncthreads();                  // the previous chunk is no longer read
#pragma unroll 4
    for (int i = tid; i < n * D; i += NT) {
      const int t = i / D, d = i % D;
      const int64_t g = base + (int64_t)(t0 + t) * row + d;
      const int64_t sr = sbase + (int64_t)(t0 + t) * H;
      const int pd = (d / RPT) * PS + d % RPT;
      r_s[t][pd] = in.r_at(g, sr);
      k_s[t][pd] = in.k_at(g, sr);
      w_s[t][pd] = fmaxf(to_f32(w[g]), 1e-30f);
      v_s[t][d] = in.v_at(g, sr);
    }
    __syncthreads();
    // the bonus term's scalar per step: sum_d r_t[d] u[d] k_t[d]
    for (int t = warp; t < n; t += NT / 32) {
      float sum = 0.f;
      for (int d = lane; d < D; d += 32) {
        const int pd = (d / RPT) * PS + d % RPT;
        sum = fmaf(r_s[t][pd] * uh[d], k_s[t][pd], sum);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) bonus_s[t] = sum;
    }
    __syncthreads();

    for (int t = 0; t < n; ++t) {
      const float4* rt = reinterpret_cast<const float4*>(&r_s[t][p * PS]);
      const float4* kt = reinterpret_cast<const float4*>(&k_s[t][p * PS]);
      const float4* wt = reinterpret_cast<const float4*>(&w_s[t][p * PS]);
      const float ve = v_s[t][e];
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < RPT / 4; ++j) {
        const float4 rr = rt[j], kk = kt[j], ww = wt[j];
        acc = fmaf(rr.x, st[4 * j + 0], acc);
        acc = fmaf(rr.y, st[4 * j + 1], acc);
        acc = fmaf(rr.z, st[4 * j + 2], acc);
        acc = fmaf(rr.w, st[4 * j + 3], acc);
        st[4 * j + 0] = fmaf(ww.x, st[4 * j + 0], kk.x * ve);
        st[4 * j + 1] = fmaf(ww.y, st[4 * j + 1], kk.y * ve);
        st[4 * j + 2] = fmaf(ww.z, st[4 * j + 2], kk.z * ve);
        st[4 * j + 3] = fmaf(ww.w, st[4 * j + 3], kk.w * ve);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);   // the other half of column e
      if (p == 0)
        out[base + (int64_t)(t0 + t) * row + e] = from_f32<TO>(fmaf(ve, bonus_s[t], acc));
    }
  }

  float* sb = state + ((int64_t)b * H + h) * D * D;
#pragma unroll
  for (int i = 0; i < RPT; ++i) sb[(int64_t)(p * RPT + i) * D + e] = st[i];
}

template <typename In, typename TW, typename TO>
cudaError_t launch(const In& in, const void* w, const float* u, void* out, float* state,
                   int B, int S, int H, int D, cudaStream_t stream) {
  dim3 grid(H, B);
  const TW* wp = static_cast<const TW*>(w);
  TO* op = static_cast<TO*>(out);
  switch (D) {
    case 16:
      wkv6_kernel<In, TW, TO, 16><<<grid, 16 * NP, 0, stream>>>(in, wp, u, op, state, S, H);
      break;
    case 64:
      wkv6_kernel<In, TW, TO, 64><<<grid, 64 * NP, 0, stream>>>(in, wp, u, op, state, S, H);
      break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// dtype codes: 0 = float32, 1 = bfloat16
template <typename In, typename TO>
cudaError_t dispatch_w(const In& in, const void* w, int w_dtype, const float* u, void* out,
                       float* state, int B, int S, int H, int D, cudaStream_t stream) {
  if (w_dtype == 0) return launch<In, float, TO>(in, w, u, out, state, B, S, H, D, stream);
  if (w_dtype == 1)
    return launch<In, __nv_bfloat16, TO>(in, w, u, out, state, B, S, H, D, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// r/k/v (B, S, H, D) and out of dtype, w (B, S, H, D) of w_dtype (0 =
// float32, 1 = bfloat16), u (H, D) f32; state (B, H, D, D) f32.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int repro_rwkv6_scan(const void* r, const void* k, const void* v, const void* w,
                                const float* u, void* out, float* state, int B, int S,
                                int H, int D, int dtype, int w_dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const FloatRKV<float> in{static_cast<const float*>(r), static_cast<const float*>(k),
                             static_cast<const float*>(v)};
    return (int)dispatch_w<FloatRKV<float>, float>(in, w, w_dtype, u, out, state, B, S, H,
                                                   D, s);
  }
  if (dtype == 1) {
    using BF = __nv_bfloat16;
    const FloatRKV<BF> in{static_cast<const BF*>(r), static_cast<const BF*>(k),
                          static_cast<const BF*>(v)};
    return (int)dispatch_w<FloatRKV<BF>, BF>(in, w, w_dtype, u, out, state, B, S, H, D, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The int8 entry (replaces _wkv6_int8_kernel): r/k/v (B, S, H, D) int8 with
// (B, S, H, 1) f32 row scales, w (B, S, H, D) of w_dtype, u (H, D) f32; out
// (B, S, H, D) of out_dtype, state (B, H, D, D) f32.
extern "C" int repro_rwkv6_scan_int8(const void* r, const float* r_scale, const void* k,
                                     const float* k_scale, const void* v,
                                     const float* v_scale, const void* w, const float* u,
                                     void* out, float* state, int B, int S, int H, int D,
                                     int out_dtype, int w_dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Int8RKV in{static_cast<const int8_t*>(r), static_cast<const int8_t*>(k),
                   static_cast<const int8_t*>(v), r_scale, k_scale, v_scale};
  if (out_dtype == 0)
    return (int)dispatch_w<Int8RKV, float>(in, w, w_dtype, u, out, state, B, S, H, D, s);
  if (out_dtype == 1)
    return (int)dispatch_w<Int8RKV, __nv_bfloat16>(in, w, w_dtype, u, out, state, B, S, H,
                                                   D, s);
  return (int)cudaErrorInvalidValue;
}
