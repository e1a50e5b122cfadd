// Per-row symmetric int8 quantizer for Hopper (sm_90a), plain C interface
// for ctypes.
//
// Replaces: src/repro/kernels/quantize.py::_quantize_rows (the Pallas TPU
//   kernel _quant_kernel), the row quantizer of int8-fused training: K and V
//   of every attention layer, r, k and v of every WKV-6 layer and the gated
//   input of every RG-LRU layer pass through it before their int8 kernels.
//
// For x (R, N) and noise (R, N), or one constant noise value for every
// element (the training path's 0.5, round half up), it writes
//   scale[r] = max(absmax_r * f32(1/127), 1e-12)                f32 (R, 1)
//   q[r, j]  = clip(floor(x[r, j] / scale[r] + noise[r, j]), -127, 127)  int8
// bit for bit as the JAX kernel computes it: XLA folds the kernel's
// "absmax / 127.0" into a multiply by the float32 reciprocal of 127, while
// x / scale stays a true IEEE division (never a multiply by 1/scale); then
// floorf.  The build passes no --use_fast_math, so '/' is correctly rounded.
// A row reciprocal with one or two FMA corrections (Markstein's form) would
// be a few per cent faster, but it rounds as the division does only while
// the remainder x - scale * y stays in the normal range (x far below the
// row's absmax breaks that), so '/' stays.
//
// What bounds it on this card: bytes.  It reads x (and noise, when given)
// once and writes q and the scales, a handful of operations per element:
// at rwkv6-7b's r/k/v, 983,040 rows of 64 bf16, that is 193 MB, 0.058 ms at
// 3.35 TB/s.
//
// What this design does about it: x moves in 16-byte pieces, one load per
// piece, and each piece stays in the registers of the thread that loaded it
// from the absmax to the quantize step, so x is read once.  The host picks
// one of three routes by the row's shape (kernels/quantize.py::quantize_plan
// names it; the entry refuses a route the shape does not allow):
//   narrow  rows of at most NARROW_MAX_BYTES, a multiple of 16 bytes, on a
//           16-byte-aligned base (64, 128 and 256 bf16): a row spreads over
//           a group of 2^k lanes, one 16-byte piece a lane (8 bf16 or 4 f32),
//           several rows to a warp (rows of 64 bf16: 8 lanes a row, 4 rows a
//           warp); the absmax is a __shfl_xor_sync reduction inside the
//           group; each warp issues the loads of NARROW_GROUPS such row
//           groups before it quantizes the first (1 KB a warp in flight,
//           ~56 KB an SM at the 36 registers of rows of bf16), as
//           streaming loads (x is read once); q goes out packed, 8 bytes a
//           lane (bf16) or 4 (f32); the group's first lane writes the
//           scale;
//   wide    longer rows of 16-byte multiples on an aligned base, up to
//           WIDE_THREADS * WIDE_PIECES pieces (rows of 2560 f32: 640
//           pieces): a block a row, each thread holding up to WIDE_PIECES
//           pieces in registers, the absmax crossing warps through shared
//           memory;
//   scalar  every other shape (a width that is not a multiple of 16 bytes,
//           an unaligned base, a longer row): a warp a row, one element a
//           lane a load, x read twice (the second pass from L1/L2).
// A random-noise tensor is read as 16-byte loads beside x on the two vector
// routes.  Rows are independent, so a ragged R is a bounds check on the row
// index, not a padded copy.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

// route codes (kernels/quantize.py::QUANT_ROUTES) and the limits they hold
constexpr int ROUTE_NARROW = 0;
constexpr int ROUTE_WIDE = 1;
constexpr int ROUTE_SCALAR = 2;
constexpr int NARROW_MAX_BYTES = 512;   // a row on the narrow route: at most a warp of pieces
constexpr int NARROW_THREADS = 128;
constexpr int NARROW_GROUPS = 2;        // row groups a warp loads before it quantizes one
constexpr int WIDE_THREADS = 128;
constexpr int WIDE_PIECES = 8;          // 16-byte pieces a thread holds on the wide route
constexpr int SCALAR_THREADS = 256;     // a warp a row

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// 16 bytes of x as floats: 4 f32, or 8 bf16 widened (exactly)
template <typename T> struct Piece;
template <> struct Piece<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& r, float (&v)[4]) {
    v[0] = __uint_as_float(r.x); v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z); v[3] = __uint_as_float(r.w);
  }
};
template <> struct Piece<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& r, float (&v)[8]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {        // element 2k in the low half, 2k + 1 in the high
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ float row_scale(float amax) {
  return fmaxf(amax * (1.0f / 127.0f), 1e-12f);
}

__device__ __forceinline__ uint32_t quant1(float v, float s, float noise) {
  const float r = floorf(v / s + noise);
  return (uint32_t)((int)fminf(fmaxf(r, -127.f), 127.f) & 0xff);
}

// the V values of one piece quantized and packed, a byte each, in order
template <int V>
__device__ __forceinline__ void quant_piece(const float (&v)[V], const float (&nz)[V], float s,
                                            uint32_t (&out)[V / 4]) {
#pragma unroll
  for (int w = 0; w < V / 4; ++w) {
    out[w] = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) out[w] |= quant1(v[4 * w + k], s, nz[4 * w + k]) << (8 * k);
  }
}

template <int V>
__device__ __forceinline__ void store_q(int8_t* dst, const uint32_t (&out)[V / 4]) {
  if constexpr (V == 8) *reinterpret_cast<uint2*>(dst) = make_uint2(out[0], out[1]);
  else *reinterpret_cast<uint32_t*>(dst) = out[0];
}

// V noise values of one piece: 16-byte loads of the tensor, or the constant
template <int V, bool NOISE>
__device__ __forceinline__ void load_noise(const float* __restrict__ src, float c, bool live,
                                           float (&nz)[V]) {
#pragma unroll
  for (int k = 0; k < V / 4; ++k) {
    float4 n4 = make_float4(c, c, c, c);
    if (NOISE && live) n4 = __ldg(reinterpret_cast<const float4*>(src) + k);
    nz[4 * k] = n4.x; nz[4 * k + 1] = n4.y; nz[4 * k + 2] = n4.z; nz[4 * k + 3] = n4.w;
  }
}

template <typename T, bool NOISE>
__global__ void __launch_bounds__(NARROW_THREADS)
quantize_rows_narrow_kernel(const T* __restrict__ x, const float* __restrict__ noise,
                            float noise_const, int8_t* __restrict__ q,
                            float* __restrict__ scale, int R, int N, int log_g) {
  constexpr int V = Piece<T>::N;
  const int lane = threadIdx.x & 31;
  const int j = lane & ((1 << log_g) - 1);        // the lane's piece of its row
  const int rows_warp = 32 >> log_g;
  const bool holds = j < N / V;                   // a group of 2^k lanes, N / V of them hold
  const int64_t warp = (int64_t)blockIdx.x * (NARROW_THREADS / 32) + (threadIdx.x >> 5);
  const int64_t row0 = warp * rows_warp * NARROW_GROUPS + (lane >> log_g);

  // every group's loads first: x, and the noise beside it
  uint4 raw[NARROW_GROUPS];
  float nz[NARROW_GROUPS][V];
#pragma unroll
  for (int u = 0; u < NARROW_GROUPS; ++u) {
    const int64_t row = row0 + (int64_t)u * rows_warp;
    const bool live = holds && row < R;
    const int64_t off = row * N + (int64_t)j * V;
    raw[u] = live ? __ldcs(reinterpret_cast<const uint4*>(x + off)) : make_uint4(0, 0, 0, 0);
    load_noise<V, NOISE>(noise + (NOISE && live ? off : 0), noise_const, live, nz[u]);
  }
#pragma unroll
  for (int u = 0; u < NARROW_GROUPS; ++u) {
    const int64_t row = row0 + (int64_t)u * rows_warp;
    const bool live = holds && row < R;
    float v[V];
    Piece<T>::unpack(raw[u], v);
    float amax = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) amax = fmaxf(amax, fabsf(v[k]));
    for (int off = (1 << log_g) >> 1; off > 0; off >>= 1)   // within the group
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float s = row_scale(amax);
    if (live) {
      if (j == 0) scale[row] = s;
      uint32_t out[V / 4];
      quant_piece<V>(v, nz[u], s, out);
      store_q<V>(q + row * N + (int64_t)j * V, out);
    }
  }
}

template <typename T, bool NOISE>
__global__ void __launch_bounds__(WIDE_THREADS)
quantize_rows_wide_kernel(const T* __restrict__ x, const float* __restrict__ noise,
                          float noise_const, int8_t* __restrict__ q,
                          float* __restrict__ scale, int N) {
  constexpr int V = Piece<T>::N;
  __shared__ float warp_max[WIDE_THREADS / 32];
  const int64_t row = blockIdx.x;
  const int pieces = N / V;
  const T* xr = x + row * N;

  uint4 raw[WIDE_PIECES];
  float amax = 0.f;
#pragma unroll
  for (int k = 0; k < WIDE_PIECES; ++k) {
    const int i = threadIdx.x + k * WIDE_THREADS;
    raw[k] = i < pieces ? __ldcs(reinterpret_cast<const uint4*>(xr) + i)
                        : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int k = 0; k < WIDE_PIECES; ++k) {
    float v[V];
    Piece<T>::unpack(raw[k], v);
#pragma unroll
    for (int e = 0; e < V; ++e) amax = fmaxf(amax, fabsf(v[e]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < WIDE_THREADS / 32; ++w) amax = fmaxf(amax, warp_max[w]);
  const float s = row_scale(amax);
  if (threadIdx.x == 0) scale[row] = s;

#pragma unroll
  for (int k = 0; k < WIDE_PIECES; ++k) {
    const int i = threadIdx.x + k * WIDE_THREADS;
    if (i < pieces) {
      float v[V], nz[V];
      Piece<T>::unpack(raw[k], v);
      load_noise<V, NOISE>(noise + (NOISE ? row * N + (int64_t)i * V : 0), noise_const, true, nz);
      uint32_t out[V / 4];
      quant_piece<V>(v, nz, s, out);
      store_q<V>(q + row * N + (int64_t)i * V, out);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(SCALAR_THREADS)
quantize_rows_scalar_kernel(const T* __restrict__ x, const float* __restrict__ noise,
                            float noise_const, int8_t* __restrict__ q,
                            float* __restrict__ scale, int R, int N) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * (SCALAR_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= R) return;                         // the whole warp leaves together
  const T* xr = x + row * N;

  float amax = 0.f;
  for (int j = lane; j < N; j += 32) amax = fmaxf(amax, fabsf(to_f32(xr[j])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float s = row_scale(amax);
  if (lane == 0) scale[row] = s;

  const float* nr = noise ? noise + row * N : nullptr;
  int8_t* qr = q + row * N;
  for (int j = lane; j < N; j += 32)
    qr[j] = (int8_t)quant1(to_f32(xr[j]), s, nr ? nr[j] : noise_const);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
cudaError_t launch(const void* xv, const void* nv, float noise_const, void* qv, void* sv,
                   int R, int N, int route, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const float* noise = static_cast<const float*>(nv);
  int8_t* q = static_cast<int8_t*>(qv);
  float* scale = static_cast<float*>(sv);
  const int64_t row_bytes = (int64_t)N * sizeof(T);
  const int pieces = (int)(row_bytes / 16);
  const bool vector = row_bytes % 16 == 0 && aligned16(x) && (!noise || aligned16(noise));
  if (route == ROUTE_NARROW) {
    if (!vector || row_bytes > NARROW_MAX_BYTES) return cudaErrorInvalidValue;
    int log_g = 0;
    while ((1 << log_g) < pieces) ++log_g;
    const int64_t rows_block =
        (int64_t)(NARROW_THREADS / 32) * (32 >> log_g) * NARROW_GROUPS;
    const unsigned blocks = (unsigned)((R + rows_block - 1) / rows_block);
    if (noise)
      quantize_rows_narrow_kernel<T, true><<<blocks, NARROW_THREADS, 0, stream>>>(
          x, noise, noise_const, q, scale, R, N, log_g);
    else
      quantize_rows_narrow_kernel<T, false><<<blocks, NARROW_THREADS, 0, stream>>>(
          x, noise, noise_const, q, scale, R, N, log_g);
  } else if (route == ROUTE_WIDE) {
    if (!vector || row_bytes <= NARROW_MAX_BYTES || pieces > WIDE_THREADS * WIDE_PIECES)
      return cudaErrorInvalidValue;
    if (noise)
      quantize_rows_wide_kernel<T, true><<<R, WIDE_THREADS, 0, stream>>>(
          x, noise, noise_const, q, scale, N);
    else
      quantize_rows_wide_kernel<T, false><<<R, WIDE_THREADS, 0, stream>>>(
          x, noise, noise_const, q, scale, N);
  } else if (route == ROUTE_SCALAR) {
    const int rows_block = SCALAR_THREADS / 32;
    quantize_rows_scalar_kernel<T><<<(R + rows_block - 1) / rows_block, SCALAR_THREADS, 0,
                                     stream>>>(x, noise, noise_const, q, scale, R, N);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// x: (R, N) contiguous, dtype 0 = float32, 1 = bfloat16.  noise: (R, N)
// float32 contiguous, or NULL to add noise_const to every element.  q: (R, N)
// int8, scale: (R,) float32.  route: ROUTE_NARROW, ROUTE_WIDE or
// ROUTE_SCALAR; a vector route the shape or the bases do not allow is
// refused.  Returns the cudaError_t of the launch.
extern "C" int repro_quantize_rows(const void* x, const void* noise, float noise_const,
                                   void* q, void* scale, int R, int N, int dtype, int route,
                                   void* stream) {
  if (R <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, noise, noise_const, q, scale, R, N, route, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, noise, noise_const, q, scale, R, N, route, s);
  return (int)cudaErrorInvalidValue;
}
