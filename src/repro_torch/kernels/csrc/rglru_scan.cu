// RG-LRU scan for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/rglru_scan.py::rglru_scan (the Pallas TPU
//   kernel _rglru_kernel/_rglru_body), the diagonal recurrence of the
//   RecurrentGemma recurrent blocks' prefill on the recurrent serving path:
//     h_t = a_t * h_{t-1} + x_t,   h_0 = 0,
//   per (batch, channel), with a float32 carry; returns every h_t.  And
//   src/repro/kernels/rglru_scan.py::rglru_scan_int8 (_rglru_int8_kernel),
//   the same recurrence in int8-fused training: x arrives as int8 with one
//   f32 scale per (batch, step) row, dequantized as it is used.
//
// What bounds it on this card: bytes.  Each element is read twice (a, x) and
// written once for one multiply and one add: at B=8, S=512, W=2560 in f32
// that is 126 MB, 0.038 ms at 3.35 TB/s, against 21 MFLOP.  The int8 entry
// reads x as one byte an element: at int8-fused training's B=60, S=128,
// W=2560 that is 177 MB (a and y in f32, x int8), 0.053 ms.
//
// Why the chain stays serial: h is updated with a rounded multiply then a
// rounded add (no fused multiply-add), in step order, the operations of the
// plain version (kernels/ref.py::rglru_scan_ref), so the two agree bit for
// bit on the card; a scan over S in chunks (products of the decays combined
// across chunks) would round differently.  The chain costs a multiply and an
// add a step, ~8 cycles, which the bytes of a step outlast many times over,
// so what the design has to do is keep enough bytes arriving.
//
// What this design does about it: a block is one warp that owns 32
// channels of one batch row, one 128-byte line of a (and of x) a step, lane
// = channel (RS: 8 x 80 = 640 blocks, ~5 an SM).  Tiles of STEPS steps x 32
// channels of a and x go into a ring of STAGES tiles in shared memory by
// cp.async, 16-byte pieces; the warp issues tile t + STAGES - 1 before it
// walks tile t out of shared memory, one float a step with no bank conflict,
// so STAGES - 1 tiles (24 KB) are in flight while it walks.  Each y_t goes
// out from the register that holds h, a coalesced 128-byte line a step.  The
// int8 entry stages its 32 bytes a step of x and the step's row scale (one
// value for every channel) beside the tile, and dequantizes with a rounded
// multiply, float(q) * scale, as dequantize_int8_ref does, so it stays
// bit-equal too.  A W that is not a multiple of a 16-byte piece's channels,
// or an unaligned base, stages 4-byte pieces (f32) or plain loads (int8)
// instead.  Ragged S and W are bounds checks: the TPU kernels' padding (a = 1,
// x = 0, zero scales) leaves real rows as they are.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr int CHANNELS = 32;       // a block: one warp, lane = channel
constexpr int STEPS = 32;          // steps a tile
constexpr int STAGES = 4;          // tiles in the ring: STAGES - 1 in flight while one is walked

template <typename XT>
struct Ring {
  float a[STAGES][STEPS][CHANNELS];
  XT x[STAGES][STEPS][CHANNELS];
  float scale[STAGES][std::is_same<XT, int8_t>::value ? STEPS : 1];
};

// Tile `tile` of a and x (and the row scales) into its stage, steps [t0,
// t0 + n) of the block's 32 channels [c0, c0 + 32); pieces past S or W are
// not read.  VEC: 16-byte pieces (a row of the tile is 8 pieces of f32, 2 of
// int8); otherwise one channel a lane.
template <typename XT, bool VEC>
__device__ __forceinline__ void load_tile(Ring<XT>& ring, int tile, const float* __restrict__ a,
                                          const XT* __restrict__ x,
                                          const float* __restrict__ xs, int64_t row0, int c0,
                                          int S, int W) {
  constexpr bool Q8 = std::is_same<XT, int8_t>::value;
  const int lane = threadIdx.x;
  const int st = tile % STAGES, t0 = tile * STEPS, n = min(STEPS, S - t0);
  if constexpr (VEC) {
    constexpr int A_PIECES = CHANNELS * 4 / 16, X_PIECES = CHANNELS * (int)sizeof(XT) / 16;
    static_assert(STEPS * X_PIECES % 32 == 0, "the warp's pieces cover a tile evenly");
#pragma unroll
    for (int i = 0; i < STEPS * A_PIECES / 32; ++i) {
      const int p = lane + 32 * i, r = p / A_PIECES, c = (p % A_PIECES) * 4;
      const bool in = r < n && c0 + c < W;
      tcore::cp_async16(tcore::smem_u32(&ring.a[st][r][c]),
                        in ? a + (row0 + t0 + r) * W + c0 + c : a, in);
    }
#pragma unroll
    for (int i = 0; i < STEPS * X_PIECES / 32; ++i) {
      const int p = lane + 32 * i, r = p / X_PIECES;
      const int c = (p % X_PIECES) * (16 / (int)sizeof(XT));
      const bool in = r < n && c0 + c < W;
      tcore::cp_async16(tcore::smem_u32(&ring.x[st][r][c]),
                        in ? x + (row0 + t0 + r) * W + c0 + c : x, in);
    }
  } else {
    const bool live = c0 + lane < W;
#pragma unroll 4
    for (int r = 0; r < STEPS; ++r) {
      const bool in = live && r < n;
      const int64_t g = (row0 + t0 + r) * W + c0 + lane;
      tcore::cp_async4z(tcore::smem_u32(&ring.a[st][r][lane]), in ? a + g : a, in);
      if constexpr (Q8) ring.x[st][r][lane] = in ? x[g] : (int8_t)0;
      else tcore::cp_async4z(tcore::smem_u32(&ring.x[st][r][lane]), in ? x + g : x, in);
    }
  }
  if constexpr (Q8) {                    // STEPS row scales, a lane each
    const bool in = lane < n;
    if (lane < STEPS)
      tcore::cp_async4z(tcore::smem_u32(&ring.scale[st][lane]), in ? xs + row0 + t0 + lane : xs,
                        in);
  }
}

template <typename XT, bool VEC>
__global__ void __launch_bounds__(CHANNELS)
rglru_ring_kernel(const float* __restrict__ a, const XT* __restrict__ x,
                  const float* __restrict__ xs, float* __restrict__ y, int S, int W) {
  constexpr bool Q8 = std::is_same<XT, int8_t>::value;
  static_assert(STEPS <= 32 && CHANNELS == 32, "a lane loads at most one row scale a tile");
  __shared__ __align__(16) Ring<XT> ring;
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * CHANNELS;
  const int64_t row0 = (int64_t)blockIdx.y * S;        // the (b, t = 0) row
  const int tiles = (S + STEPS - 1) / STEPS;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < tiles) load_tile<XT, VEC>(ring, i, a, x, xs, row0, c0, S, W);
    tcore::cp_async_commit();
  }
  const bool live = c0 + lane < W;
  float* yc = y + row0 * W + c0 + lane;
  float h = 0.f;
  for (int tile = 0; tile < tiles; ++tile) {
    __syncwarp();                        // tile - 1's stage is walked: refill it
    if (tile + STAGES - 1 < tiles)
      load_tile<XT, VEC>(ring, tile + STAGES - 1, a, x, xs, row0, c0, S, W);
    tcore::cp_async_commit();
    tcore::cp_async_wait<STAGES - 1>();  // this lane's pieces of tile `tile` have landed
    __syncwarp();                        // and every lane's
    const int st = tile % STAGES, t0 = tile * STEPS, n = min(STEPS, S - t0);
    auto step = [&](int j) {
      float xv;
      if constexpr (Q8) xv = __fmul_rn((float)ring.x[st][j][lane], ring.scale[st][j]);
      else xv = ring.x[st][j][lane];
      h = __fadd_rn(__fmul_rn(ring.a[st][j][lane], h), xv);
      yc[(int64_t)(t0 + j) * W] = h;
    };
    if (!live) continue;
    if (n == STEPS) {
#pragma unroll
      for (int j = 0; j < STEPS; ++j) step(j);
    } else {
      for (int j = 0; j < n; ++j) step(j);
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename XT>
cudaError_t launch(const void* a, const void* x, const float* xs, void* y, int B, int S, int W,
                   void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return cudaErrorInvalidValue;
  // 16-byte pieces need every row of a and x to start on a 16-byte boundary
  const bool vec = W % (16 / (int)sizeof(XT)) == 0 && W % 4 == 0 && aligned16(a) &&
                   aligned16(x);
  const dim3 grid((W + CHANNELS - 1) / CHANNELS, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const XT* xt = static_cast<const XT*>(x);
  float* yf = static_cast<float*>(y);
  if (vec) rglru_ring_kernel<XT, true><<<grid, CHANNELS, 0, s>>>(af, xt, xs, yf, S, W);
  else rglru_ring_kernel<XT, false><<<grid, CHANNELS, 0, s>>>(af, xt, xs, yf, S, W);
  return cudaGetLastError();
}

}  // namespace

// a, x, y (B, S, W) float32: the recurrent block hands the scan its f32
// gates.  Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_rglru_scan(const void* a, const void* x, void* y, int B, int S, int W,
                                void* stream) {
  return (int)launch<float>(a, x, nullptr, y, B, S, W, stream);
}

// The int8 entry: a, y (B, S, W) float32, x (B, S, W) int8 with (B, S, 1)
// float32 row scales.
extern "C" int repro_rglru_scan_int8(const void* a, const void* x, const float* x_scale,
                                     void* y, int B, int S, int W, void* stream) {
  return (int)launch<int8_t>(a, x, x_scale, y, B, S, W, stream);
}
