// Fused MoE expert GEMM and MoE combine for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces: src/repro/kernels/fused_moe.py::fused_moe_gemm (_fused_moe_kernel)
//   and ::fused_moe_combine (_combine_kernel), the expert FFN of every MoE
//   layer on the single-device path (models/moe.py::moe_mlp).
//
// fused_moe_gemm computes, for every capacity slot s of expert e = s / C,
//   y[s] = (silu(x[t_s] wg[e]) * (x[t_s] wu[e])) wo[e] * gate[s]
// in float32 from the model-dtype operands, cast once; an empty slot
// (slot_tok == T) gives exactly 0.
//
// What bounds it on this card.  At prefill (T = 4096 tokens, k = 8, 128
// experts of d 2048 x f 768, C = 384) it does ~309 GFLOP for the live slots
// against ~1.4 GB of weights and rows: operations, and since the kernel
// multiplies in float32 FMAs (the reference's numerics; bf16 tensor cores
// would round h), the 67 TFLOP/s float32 rate, not the 989 bf16 one.  At
// decode (T = 8, C = 8) at most 64 of the 128 experts hold a token, and each
// live expert's 9.4 MB of weights meet one or two rows: bytes, ~0.6 GB a layer.
//
// What this design does about it.  Two phases, each a grid of (output-column
// tile, slot tile, expert) blocks:
//   1. gate/up: the block loads its slot indices, reads those rows of x
//      straight from device memory by index as each K stage enters shared
//      memory (the TPU kernel's one-hot gather; no gathered copy goes to HBM,
//      the sentinel reads as a zero row), multiplies them into a 64-column
//      tile of wg and of wu together (float32 FMAs), and writes
//      h = silu(g) * u for its tile to a float32 scratch (E*C, f) in device
//      memory;
//   2. down: the same tile loop over h and wo, then the gate, one cast, and
//      the (E*C, d) output.
// Many slots per expert (prefill) take 64-slot tiles with 16-deep stages (4 x
// 4 outputs of each matrix per thread: ~4 FMAs per shared-memory load); few
// (decode, C <= 16) take 16-slot tiles with 64-deep stages, so each stage of
// a block moves 4x the weight bytes and keeps more loads in flight.
// h leaves the chip (the TPU kernel keeps it in VMEM): 151 MB written and read
// at prefill (~0.09 ms at 3.35 TB/s), 3 MB at decode.  In exchange both
// phases split f and d over blocks, so decode's few live experts spread over
// all SMs, and any f that is a multiple of 16 works (dbrx's 10,752 would not
// fit a 64-slot h tile in shared memory).  A tile whose slots are all empty
// writes zeros (phase 2) and returns WITHOUT reading its expert's weights, so
// decode reads only the live experts'.  Slots fill each expert from its first
// slot on, so live rows sit at the front of an expert's tiles: warps whose
// rows all lie past the tile's last live slot skip the FMAs (at decode ~1 of
// a tile's 16 rows is live), and empty rows before it compute on a zero row;
// every empty row is written as 0.
//
// fused_moe_combine computes out[t] = sum of y[s] over the slots s with
// slot_tok[s] == t, accumulated in float32 and cast once.  It is bound by
// bytes: the live slot rows are read once (~134 MB at prefill, ~0.04 ms).  A
// first pass inverts slot_tok into per-token slot lists (an atomic counter
// per token only picks a list position); the summing pass sorts each token's
// <= MAX_K slots in ascending order and adds them one by one, so the sum has
// one fixed order: the plain version (kernels/ref.py::fused_moe_combine_ref)
// adds in the same order and the two agree bit for bit.  A token with more
// than MAX_K slots gets a NaN row rather than a silently partial sum.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BN = 64;         // output columns per tile
constexpr int NTHREADS = 256;  // 16 row groups x 16 column groups of 4
constexpr int MAX_K = 32;      // slots per token the combine takes
constexpr int CT = 256;        // combine threads per block

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<uint32_t*>(&a);
  t.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = t;
}

// One (BM slots x BN columns) output tile, reduced over K in BK-deep stages
// staged through shared memory as float32.  Thread (ty, tx) of the 16 x 16
// grid owns rows ty*TM .. +TM-1 and columns tx*4 .. +3.  Two shapes:
// BM = 64, BK = 16 for many slots per expert (prefill), BM = 16, BK = 64 for
// few (decode), where each stage moves 4x more weight bytes per block.
template <int BM, int BK>
struct Tile {
  static constexpr int TM = BM / 16;
  static constexpr int AP = BM + 4;                   // padded row of the A^T tile
  static constexpr int A_VECS = BM * BK / 4;          // 4-element loads per A stage
  static constexpr int NA = (A_VECS + NTHREADS - 1) / NTHREADS;
  static constexpr int NB = BK * BN / 4 / NTHREADS;   // per thread per B stage
  static_assert(BM % 16 == 0 && BK % 16 == 0, "tile shape");

  // A stage: rows of a row-major matrix at element offsets row_off[r]
  // (-1: a zero row), columns k0 .. k0+BK-1.
  template <typename T>
  __device__ static void load_a(const T* src, const int64_t* row_off, int k0,
                                float (&v)[NA][4]) {
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int q = threadIdx.x + i * NTHREADS;
      const int64_t off = q < A_VECS ? row_off[q / (BK / 4)] : -1;
      if (off >= 0) {
        load4(src + off + k0 + (q % (BK / 4)) * 4, v[i]);
      } else {
        v[i][0] = v[i][1] = v[i][2] = v[i][3] = 0.f;
      }
    }
  }
  __device__ static void store_a(float (*As)[AP], const float (&v)[NA][4]) {
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int q = threadIdx.x + i * NTHREADS;
      if (q >= A_VECS) break;
      const int r = q / (BK / 4), c = (q % (BK / 4)) * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) As[c + j][r] = v[i][j];
    }
  }
  // B stage: rows k0 .. k0+BK-1, columns n0 .. n0+BN-1 of a row-major
  // (K, ncols) matrix; columns >= ncols read 0.
  template <typename T>
  __device__ static void load_b(const T* w, int k0, int n0, int ncols, float (&v)[NB][4]) {
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int q = threadIdx.x + i * NTHREADS;
      const int r = q / (BN / 4), c = n0 + (q % (BN / 4)) * 4;
      if (c < ncols) {
        load4(w + (int64_t)(k0 + r) * ncols + c, v[i]);
      } else {
        v[i][0] = v[i][1] = v[i][2] = v[i][3] = 0.f;
      }
    }
  }
  __device__ static void store_b(float (*Bs)[BN], const float (&v)[NB][4]) {
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int q = threadIdx.x + i * NTHREADS;
      *reinterpret_cast<float4*>(&Bs[q / (BN / 4)][(q % (BN / 4)) * 4]) =
          make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
    }
  }
  // acc[i][j] += A[ty*TM+i][k] * B[k][tx*4+j] over one stage; a thread
  // whose rows are all at or past `n_rows` (empty slots: zero rows) skips it,
  // so at decode only the warps of live rows multiply.
  __device__ static void mma(const float (*As)[AP], const float (*Bs)[BN], int n_rows,
                             float (&acc)[TM][4]) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
    if (ty * TM >= n_rows) return;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[k][ty * TM + i];
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
};

// Phase 1: h[s, n] = silu(x[t_s] . wg[e][:, n]) * (x[t_s] . wu[e][:, n]).
template <typename T, int BM, int BK>
__global__ void __launch_bounds__(NTHREADS)
moe_gate_up_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                   const T* __restrict__ wu, const int* __restrict__ slot_tok,
                   float* __restrict__ h, int n_tok, int d, int f, int C) {
  using Tl = Tile<BM, BK>;
  __shared__ __align__(16) float As[BK][Tl::AP];
  __shared__ __align__(16) float Gs[BK][BN];
  __shared__ __align__(16) float Us[BK][BN];
  __shared__ int64_t row_off[BM];
  __shared__ int n_live;                  // 1 + the last live row of the tile

  const int e = blockIdx.z, c0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int rows = min(BM, C - c0);
  const int64_t s0 = (int64_t)e * C + c0;
  const int tid = threadIdx.x;
  if (tid == 0) n_live = 0;
  __syncthreads();
  if (tid < BM) {
    const int t = tid < rows ? slot_tok[s0 + tid] : n_tok;
    const bool live = t >= 0 && t < n_tok;
    row_off[tid] = live ? (int64_t)t * d : -1;   // the sentinel reads a zero row
    if (live) atomicMax(&n_live, tid + 1);
  }
  __syncthreads();
  const int n_rows = n_live;
  // an all-empty tile reads no weights; phase 2 never reads its h rows
  if (n_rows == 0) return;

  const T* wge = wg + (int64_t)e * d * f;
  const T* wue = wu + (int64_t)e * d * f;
  float g[Tl::TM][4] = {}, u[Tl::TM][4] = {};
  float av[Tl::NA][4], gv[Tl::NB][4], uv[Tl::NB][4];
  Tl::load_a(x, row_off, 0, av);
  Tl::load_b(wge, 0, n0, f, gv);
  Tl::load_b(wue, 0, n0, f, uv);
  for (int k0 = 0; k0 < d; k0 += BK) {
    Tl::store_a(As, av);
    Tl::store_b(Gs, gv);
    Tl::store_b(Us, uv);
    __syncthreads();
    if (k0 + BK < d) {            // the next stage's loads fly during this one's FMAs
      Tl::load_a(x, row_off, k0 + BK, av);
      Tl::load_b(wge, k0 + BK, n0, f, gv);
      Tl::load_b(wue, k0 + BK, n0, f, uv);
    }
    Tl::mma(As, Gs, n_rows, g);
    Tl::mma(As, Us, n_rows, u);
    __syncthreads();
  }

  const int ty = tid >> 4, col = n0 + (tid & 15) * 4;
  if (col >= f) return;
#pragma unroll
  for (int i = 0; i < Tl::TM; ++i) {
    const int r = ty * Tl::TM + i;
    if (r >= rows) break;
    float out[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = g[i][j] / (1.f + expf(-g[i][j])) * u[i][j];
    store4(h + (s0 + r) * f + col, out);
  }
}

// Phase 2: y[s, n] = (h[s] . wo[e][:, n]) * gate[s], cast once; 0 for an
// empty slot.
template <typename T, int BM, int BK>
__global__ void __launch_bounds__(NTHREADS)
moe_down_kernel(const float* __restrict__ h, const T* __restrict__ wo,
                const int* __restrict__ slot_tok, const float* __restrict__ slot_gate,
                T* __restrict__ y, int n_tok, int d, int f, int C) {
  using Tl = Tile<BM, BK>;
  __shared__ __align__(16) float As[BK][Tl::AP];
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ int64_t row_off[BM];
  __shared__ bool full_s[BM];
  __shared__ int n_live;

  const int e = blockIdx.z, c0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int rows = min(BM, C - c0);
  const int64_t s0 = (int64_t)e * C + c0;
  const int tid = threadIdx.x;
  if (tid == 0) n_live = 0;
  __syncthreads();
  if (tid < BM) {
    const int t = tid < rows ? slot_tok[s0 + tid] : n_tok;
    full_s[tid] = t >= 0 && t < n_tok;
    row_off[tid] = tid < rows ? (s0 + tid) * f : -1;
    if (full_s[tid]) atomicMax(&n_live, tid + 1);
  }
  __syncthreads();
  const int n_rows = n_live;

  float acc[Tl::TM][4] = {};
  if (n_rows > 0) {                       // an all-empty tile reads no weights
    const T* woe = wo + (int64_t)e * f * d;
    float av[Tl::NA][4], bv[Tl::NB][4];
    Tl::load_a(h, row_off, 0, av);
    Tl::load_b(woe, 0, n0, d, bv);
    for (int k0 = 0; k0 < f; k0 += BK) {
      Tl::store_a(As, av);
      Tl::store_b(Bs, bv);
      __syncthreads();
      if (k0 + BK < f) {
        Tl::load_a(h, row_off, k0 + BK, av);
        Tl::load_b(woe, k0 + BK, n0, d, bv);
      }
      Tl::mma(As, Bs, n_rows, acc);
      __syncthreads();
    }
  }

  const int ty = tid >> 4, col = n0 + (tid & 15) * 4;
  if (col >= d) return;
#pragma unroll
  for (int i = 0; i < Tl::TM; ++i) {
    const int r = ty * Tl::TM + i;
    if (r >= rows) break;
    const bool keep = full_s[r];
    const float gate = keep ? slot_gate[s0 + r] : 0.f;
    float out[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = keep ? acc[i][j] * gate : 0.f;
    store4(y + (s0 + r) * d + col, out);
  }
}

// Combine, pass 1: slot s joins the list of its token.
__global__ void moe_invert_kernel(const int* __restrict__ slot_tok, int S, int n_tok,
                                  int* __restrict__ counts, int* __restrict__ lists) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const int t = slot_tok[s];
  if (t < 0 || t >= n_tok) return;
  const int pos = atomicAdd(&counts[t], 1);
  if (pos < MAX_K) lists[(int64_t)t * MAX_K + pos] = s;
}

// Combine, pass 2: block (t, column chunk) adds token t's slot rows in
// ascending slot order.
template <typename T>
__global__ void __launch_bounds__(CT)
moe_combine_kernel(const T* __restrict__ y, const int* __restrict__ counts,
                   const int* __restrict__ lists, T* __restrict__ out, int d) {
  __shared__ int slots[MAX_K];
  __shared__ int n_s;
  const int t = blockIdx.x;
  if (threadIdx.x == 0) {
    const int n = counts[t];
    const int m = min(n, MAX_K);
    for (int i = 0; i < m; ++i) {          // insertion sort, <= MAX_K entries
      const int v = lists[(int64_t)t * MAX_K + i];
      int j = i;
      for (; j > 0 && slots[j - 1] > v; --j) slots[j] = slots[j - 1];
      slots[j] = v;
    }
    n_s = n;
  }
  __syncthreads();
  const int n = n_s;
  const int col = (blockIdx.y * CT + threadIdx.x) * 4;
  if (col >= d) return;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (n > MAX_K) {
    acc[0] = acc[1] = acc[2] = acc[3] = nanf("");
  } else {
    for (int i = 0; i < n; ++i) {
      float v[4];
      load4(y + (int64_t)slots[i] * d + col, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] += v[j];
    }
  }
  store4(out + (int64_t)t * d + col, acc);
}

template <typename T, int BM, int BK>
cudaError_t launch_gemm(const void* x, const void* wg, const void* wu, const void* wo,
                        const int* slot_tok, const float* slot_gate, float* h, void* y,
                        int n_tok, int d, int f, int E, int C, cudaStream_t s) {
  const dim3 block(NTHREADS);
  const int mt = (C + BM - 1) / BM;
  moe_gate_up_kernel<T, BM, BK><<<dim3((f + BN - 1) / BN, mt, E), block, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg), static_cast<const T*>(wu),
      slot_tok, h, n_tok, d, f, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_down_kernel<T, BM, BK><<<dim3((d + BN - 1) / BN, mt, E), block, 0, s>>>(
      h, static_cast<const T*>(wo), slot_tok, slot_gate, static_cast<T*>(y), n_tok, d,
      f, C);
  return cudaGetLastError();
}

// Few slots per expert (decode) and K dims that take 64-deep stages: the
// skinny tile; otherwise the 64-slot tile.
template <typename T>
cudaError_t pick_tile(const void* x, const void* wg, const void* wu, const void* wo,
                      const int* slot_tok, const float* slot_gate, float* h, void* y,
                      int n_tok, int d, int f, int E, int C, cudaStream_t s) {
  if (C <= 16 && d % 64 == 0 && f % 64 == 0)
    return launch_gemm<T, 16, 64>(x, wg, wu, wo, slot_tok, slot_gate, h, y, n_tok, d, f,
                                  E, C, s);
  return launch_gemm<T, 64, 16>(x, wg, wu, wo, slot_tok, slot_gate, h, y, n_tok, d, f, E,
                                C, s);
}

template <typename T>
cudaError_t launch_combine(const void* y, const int* slot_tok, void* out, int* counts,
                           int* lists, int n_tok, int d, int S, cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * (size_t)n_tok, s);
  if (err != cudaSuccess) return err;
  moe_invert_kernel<<<(S + 255) / 256, 256, 0, s>>>(slot_tok, S, n_tok, counts, lists);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_combine_kernel<T><<<dim3(n_tok, (d + 4 * CT - 1) / (4 * CT)), CT, 0, s>>>(
      static_cast<const T*>(y), counts, lists, static_cast<T*>(out), d);
  return cudaGetLastError();
}

}  // namespace

// x (T, d); wg/wu (E, d, f); wo (E, f, d); slot_tok (E*C,) int32 with T for an
// empty slot; slot_gate (E*C,) f32; h: f32 scratch (E*C, f); y (E*C, d).
// d and f multiples of 16.  dtype: 0 = float32, 1 = bfloat16.  Returns the
// cudaError_t of the launches.
extern "C" int repro_fused_moe_gemm(const void* x, const void* wg, const void* wu,
                                    const void* wo, const int* slot_tok,
                                    const float* slot_gate, float* h, void* y, int n_tok,
                                    int d, int f, int E, int C, int dtype, void* stream) {
  if (n_tok <= 0 || d <= 0 || f <= 0 || E <= 0 || C <= 0 || d % 16 || f % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)pick_tile<float>(x, wg, wu, wo, slot_tok, slot_gate, h, y, n_tok, d, f,
                                 E, C, s);
  if (dtype == 1)
    return (int)pick_tile<__nv_bfloat16>(x, wg, wu, wo, slot_tok, slot_gate, h, y,
                                         n_tok, d, f, E, C, s);
  return (int)cudaErrorInvalidValue;
}

// y (S, d); slot_tok (S,) int32; out (T, d); counts (T,) and lists
// (T, MAX_K) int32 scratch.  d a multiple of 4.
extern "C" int repro_fused_moe_combine(const void* y, const int* slot_tok, void* out,
                                       int* counts, int* lists, int n_tok, int d, int S,
                                       int dtype, void* stream) {
  if (n_tok <= 0 || d <= 0 || S <= 0 || d % 4) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_combine<float>(y, slot_tok, out, counts, lists, n_tok, d, S, s);
  if (dtype == 1)
    return (int)launch_combine<__nv_bfloat16>(y, slot_tok, out, counts, lists, n_tok, d,
                                              S, s);
  return (int)cudaErrorInvalidValue;
}
