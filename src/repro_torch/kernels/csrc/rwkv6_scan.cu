// RWKV-6 WKV scan for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/rwkv6_scan.py::rwkv6_scan (the Pallas TPU
//   kernel _wkv6_kernel/_wkv6_body), the time-mixing recurrence of the RWKV-6
//   prefill on the recurrent serving path:
//     out_t = r_t @ (S_{t-1} + diag(u) k_t v_t^T)
//     S_t   = diag(w_t) S_{t-1} + k_t v_t^T,   S_0 = 0,
//   per (batch, head), with a (D, D) float32 state S; returns every out_t and
//   the final state.
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
// the last chunk early, which is what the TPU kernel's padding (lw = 0,
// r = k = v = 0) does to the state.  At full width there are only 512 blocks
// of 128 threads for 132 SMs, all resident at once (86 registers a thread,
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

// T: dtype of r/k/v/w and out.  D: head dim.
template <typename T, int D>
__global__ void __launch_bounds__(D * NP)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ w, const float* __restrict__ u, T* __restrict__ out,
            float* __restrict__ state, int S, int H) {
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
      const int pd = (d / RPT) * PS + d % RPT;
      r_s[t][pd] = to_f32(r[g]);
      k_s[t][pd] = to_f32(k[g]);
      w_s[t][pd] = fmaxf(to_f32(w[g]), 1e-30f);
      v_s[t][d] = to_f32(v[g]);
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
        out[base + (int64_t)(t0 + t) * row + e] = from_f32<T>(fmaf(ve, bonus_s[t], acc));
    }
  }

  float* sb = state + ((int64_t)b * H + h) * D * D;
#pragma unroll
  for (int i = 0; i < RPT; ++i) sb[(int64_t)(p * RPT + i) * D + e] = st[i];
}

template <typename T, int D>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const float* u, void* out, float* state, int B, int S, int H,
                   cudaStream_t stream) {
  dim3 grid(H, B);
  wkv6_kernel<T, D><<<grid, D * NP, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), u, static_cast<T*>(out), state, S, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* r, const void* k, const void* v, const void* w,
                       const float* u, void* out, float* state, int B, int S, int H,
                       int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(r, k, v, w, u, out, state, B, S, H, stream);
    case 64: return launch<T, 64>(r, k, v, w, u, out, state, B, S, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// r/k/v/w (B, S, H, D) of dtype (0 = float32, 1 = bfloat16), u (H, D) f32;
// out (B, S, H, D) of the same dtype, state (B, H, D, D) f32.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int repro_rwkv6_scan(const void* r, const void* k, const void* v, const void* w,
                                const float* u, void* out, float* state, int B, int S,
                                int H, int D, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_d<float>(r, k, v, w, u, out, state, B, S, H, D, s);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(r, k, v, w, u, out, state, B, S, H, D, s);
  return (int)cudaErrorInvalidValue;
}
