// Per-row symmetric int8 quantizer for Hopper (sm_90a), plain C interface
// for ctypes.
//
// Replaces: src/repro/kernels/quantize.py::_quantize_rows (the Pallas TPU
//   kernel _quant_kernel), the row quantizer of int8-fused training: K and V
//   of every attention layer pass through it before the int8 flash kernel.
//
// For x (R, N) and noise (R, N), or one constant noise value for every
// element (the training path's 0.5, round half up), it writes
//   scale[r] = max(absmax_r * f32(1/127), 1e-12)                f32 (R, 1)
//   q[r, j]  = clip(floor(x[r, j] / scale[r] + noise[r, j]), -127, 127)  int8
// bit for bit as the JAX kernel computes it: XLA folds the kernel's
// "absmax / 127.0" into a multiply by the float32 reciprocal of 127, while
// x / scale stays a true IEEE division (never a multiply by 1/scale); then
// floorf.  The build passes no --use_fast_math, so '/' is correctly rounded.
//
// What bounds it on this card: bytes.  It reads x (and noise, when given)
// and writes q and the scales, a handful of operations per element.
//
// What this design does about it: one warp per row, lanes on neighbouring
// elements (coalesced), a warp-shuffle absmax, then a second pass over the
// same row, which the first pass left in L1/L2.  Rows are independent, so a
// ragged R is a bounds check on the row index, not a padded copy.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int ROWS_PER_BLOCK = NTHREADS / 32;   // one warp per row

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
quantize_rows_kernel(const T* __restrict__ x, const float* __restrict__ noise,
                     float noise_const, int8_t* __restrict__ q,
                     float* __restrict__ scale, int R, int N) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= R) return;                         // the whole warp leaves together
  const T* xr = x + (int64_t)row * N;

  float amax = 0.f;
  for (int j = lane; j < N; j += 32) amax = fmaxf(amax, fabsf(to_f32(xr[j])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float s = fmaxf(amax * (1.0f / 127.0f), 1e-12f);
  if (lane == 0) scale[row] = s;

  const float* nr = noise ? noise + (int64_t)row * N : nullptr;
  int8_t* qr = q + (int64_t)row * N;
  for (int j = lane; j < N; j += 32) {
    const float y = to_f32(xr[j]) / s;
    const float r = floorf(y + (nr ? nr[j] : noise_const));
    qr[j] = (int8_t)fminf(fmaxf(r, -127.f), 127.f);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* noise, float noise_const, void* q,
                   void* scale, int R, int N, cudaStream_t stream) {
  const int blocks = (R + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  quantize_rows_kernel<T><<<blocks, NTHREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(noise), noise_const,
      static_cast<int8_t*>(q), static_cast<float*>(scale), R, N);
  return cudaGetLastError();
}

}  // namespace

// x: (R, N) contiguous, dtype 0 = float32, 1 = bfloat16.  noise: (R, N)
// float32 contiguous, or NULL to add noise_const to every element.  q: (R, N)
// int8, scale: (R,) float32.  Returns the cudaError_t of the launch.
extern "C" int repro_quantize_rows(const void* x, const void* noise, float noise_const,
                                   void* q, void* scale, int R, int N, int dtype,
                                   void* stream) {
  if (R <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, noise, noise_const, q, scale, R, N, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, noise, noise_const, q, scale, R, N, s);
  return (int)cudaErrorInvalidValue;
}
