// RG-LRU scan for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/rglru_scan.py::rglru_scan (the Pallas TPU
//   kernel _rglru_kernel/_rglru_body), the diagonal recurrence of the
//   RecurrentGemma recurrent blocks' prefill on the recurrent serving path:
//     h_t = a_t * h_{t-1} + x_t,   h_0 = 0,
//   per (batch, channel), with a float32 carry; returns every h_t.  And
//   src/repro/kernels/rglru_scan.py::rglru_scan_int8 (_rglru_int8_kernel),
//   the same recurrence in int8-fused training: x arrives as int8 with one
//   f32 scale per (batch, step) row, dequantized as it is loaded.
//
// What bounds it on this card: bytes.  Each element is read twice (a, x) and
// written once for one multiply and one add: at B=8, S=512, W=2560 in f32
// that is 126 MB, 0.038 ms at 3.35 TB/s, against 21 MFLOP.  The int8 entry
// reads x as one byte an element: at int8-fused training's B=60, S=128,
// W=2560 that is 177 MB (a and y in f32, x int8), 0.053 ms.
//
// What this design does about it: one thread per (batch, channel), walking
// the sequence in order with the carry in a register, as the TPU kernel walks
// its sequence chunks with the carry in VMEM.  Neighbouring threads hold
// neighbouring channels, so every load and store of a warp is one coalesced
// 128-byte line of the (B, S, W) layout.  The recurrence is serial only in h:
// each thread loads UNROLL steps of a and x before it uses them, so many
// loads are in flight per thread (B*W = 20,480 threads at full width, 160
// blocks of 128 for 132 SMs, is not enough by itself to cover the memory
// latency).  A chunked parallel scan over S is later work.  h is updated
// with a rounded multiply then a rounded add (no fused multiply-add), the
// operations of the plain version (kernels/ref.py::rglru_scan_ref), so the
// two agree bit for bit on the card; the int8 entry dequantizes with a
// rounded multiply, float(q) * scale, as dequantize_int8_ref does, and stays
// bit-equal too.  The row scale of (b, t) is one value for every channel: a
// warp reads it as one broadcast load per step.  Ragged S and W are bounds
// checks: the TPU kernels' padding (a = 1, x = 0, zero scales) leaves real
// rows as they are.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 128;
constexpr int UNROLL = 8;          // time steps loaded ahead of their use

// How x_t reaches float32: element g of the (B, S, W) layout, in row sr of
// the (B, S) steps.
struct FloatX {
  const float* __restrict__ x;
  __device__ __forceinline__ float at(int64_t g, int64_t) const { return x[g]; }
};

struct Int8X {                     // int8 x + (B, S, 1) f32 row scales
  const int8_t* __restrict__ x;
  const float* __restrict__ scale;
  __device__ __forceinline__ float at(int64_t g, int64_t sr) const {
    return __fmul_rn((float)x[g], scale[sr]);
  }
};

template <typename In>
__global__ void __launch_bounds__(NTHREADS)
rglru_kernel(const float* __restrict__ a, In in, float* __restrict__ y, int S, int W) {
  const int c = blockIdx.x * NTHREADS + threadIdx.x;
  if (c >= W) return;
  const int64_t base = (int64_t)blockIdx.y * S * W + c;
  const int64_t sbase = (int64_t)blockIdx.y * S;       // row scale of (b, t = 0)
  float h = 0.f;
  int t = 0;
  for (; t + UNROLL <= S; t += UNROLL) {
    float av[UNROLL], xv[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      av[j] = a[base + (int64_t)(t + j) * W];
      xv[j] = in.at(base + (int64_t)(t + j) * W, sbase + t + j);
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      h = __fadd_rn(__fmul_rn(av[j], h), xv[j]);
      y[base + (int64_t)(t + j) * W] = h;
    }
  }
  for (; t < S; ++t) {
    h = __fadd_rn(__fmul_rn(a[base + (int64_t)t * W], h), in.at(base + (int64_t)t * W, sbase + t));
    y[base + (int64_t)t * W] = h;
  }
}

template <typename In>
cudaError_t launch(const void* a, const In& in, void* y, int B, int S, int W, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return cudaErrorInvalidValue;
  dim3 grid((W + NTHREADS - 1) / NTHREADS, B);
  rglru_kernel<In><<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), in, static_cast<float*>(y), S, W);
  return cudaGetLastError();
}

}  // namespace

// a, x, y (B, S, W) float32: the recurrent block hands the scan its f32
// gates.  Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_rglru_scan(const void* a, const void* x, void* y, int B, int S, int W,
                                void* stream) {
  return (int)launch(a, FloatX{static_cast<const float*>(x)}, y, B, S, W, stream);
}

// The int8 entry: a, y (B, S, W) float32, x (B, S, W) int8 with (B, S, 1)
// float32 row scales.
extern "C" int repro_rglru_scan_int8(const void* a, const void* x, const float* x_scale,
                                     void* y, int B, int S, int W, void* stream) {
  return (int)launch(a, Int8X{static_cast<const int8_t*>(x), x_scale}, y, B, S, W, stream);
}
