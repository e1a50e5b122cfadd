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
// against ~1.4 GB of weights and rows: operations, at the bf16 tensor-core
// rate.  At decode (T = 8, C = 8) about 50 of the 128 experts hold a token,
// ~1.3 rows each, and each live expert's 9.4 MB of weights meets them once:
// bytes, ~0.47 GB a layer.
//
// Two phases, one kernel each, as three routes that the wrapper picks
// (kernels/fused_moe.py::gemm_route) and passes in:
//   1. gate/up: h = silu(x wg) * (x wu) for the slots' rows of x, read
//      straight from device memory by slot index as each K stage enters shared
//      memory (the TPU kernel's one-hot gather; no gathered copy goes to HBM,
//      the sentinel row lands as zeros); one block computes g and u together,
//      so x is read once for both;
//   2. down: h wo, then the gate, the zero of an empty slot and one cast.
// h goes to a scratch in device memory (the TPU kernel keeps it in VMEM):
// both phases split f and d over blocks, so decode's few live experts spread
// over all SMs, and any f that is a multiple of 16 works (dbrx's 10,752).
//
// bf16 (routes tc_prefill and tc_decode): both products on the tensor cores,
// mma.sync.m16n8k16 with bf16 operands and f32 accumulation, operands moved
// into shared memory by 16-byte cp.async in a ring of stages and read into
// fragments by ldmatrix (the weights, (K, N) with N contiguous, by
// ldmatrix.trans).  x and the weights are bf16 already, so gate/up multiplies
// exactly the products the reference's float32 dot_general does; only the
// order of the sum differs.  h is float32 in the reference: tc_decode writes
// it as two bf16 planes, hi and lo (tcore::split_bf16, the bytes of a
// float32 h), and its down runs two products, hi wo + lo wo, so h keeps about
// 16 bits, as flash splits P; decode is bound by bytes, so the second product
// costs no time.  tc_prefill rounds h to bf16 once and runs one product: over
// seven seeds it kept within 0.68 of phase 9's one-bf16-ulp tolerance (the
// split: 0.60) for a third less time in down; at the decode shape one
// product reached 0.81 of it (the split: 0.20 on the same inputs) (PERF.md).
//   - tc_prefill (many slots an expert): a block takes 128 slots x 128
//     output columns (gate/up: 64 of g and the same 64 of u) in 64-deep
//     stages, a ring of three; 8 warps of 32 rows x 64 columns.  The slot
//     tiles that share a weight tile are neighbours in the grid, so the
//     weight tile is read from HBM about once.
//   - tc_decode (C <= 16): a byte-bound skinny product.  A block of 8 warps
//     stays on each SM; every block lists the experts that hold a token, and
//     the (live expert, 128-column tile) items are dealt to all warps of the
//     grid in a fixed order, each warp running its item alone: the A
//     fragment is its expert's C rows padded to 16, the weights stream
//     through a per-warp ring of four 16-deep stages with 16-byte loads, and
//     no warp waits for another.  Experts with no token cost no item; down
//     writes their y rows as zeros.
// Tiles whose slots are all empty return without reading their expert's
// weights (down writes their zeros), and live rows sit at the front of an
// expert (slots fill from the first), so warps whose rows all lie past the
// tile's last live slot skip the products; rows that are not live read no
// memory (cp.async zero-fill) and down reads no empty row's h.
//
// float32 (route fma): the FMA kernels of the first design, which the
// float32 parity runs need (greedy tokens identical to the CPU's): TF32
// tensor cores keep about three digits.  A choice of dtype, not a fallback.
// Many slots per expert take 64-slot tiles with 16-deep stages (4 x 4
// outputs of each matrix per thread); few (C <= 16) 16-slot tiles with
// 64-deep stages; h is a float32 scratch.
//
// fused_moe_combine computes out[t] = sum of y[s] over the slots s with
// slot_tok[s] == t, accumulated in float32 in ascending slot order and cast
// once, so the plain version (kernels/ref.py::fused_moe_combine_ref), which
// adds in the same order, agrees bit for bit.  It is bound by bytes: the live
// slot rows are read once (~134 MB at prefill, ~0.04 ms).  Two routes
// (kernels/fused_moe.py::combine_route):
//   - scan (S * T small: decode), one launch: each block (token, column
//     chunk) reads the whole slot table, 4 entries a thread, and keeps its
//     token's slots in ascending order by a block prefix count of the
//     matches; no atomics, no sort, no memset.  At decode the time is launch
//     and drain, not bytes: one launch, not three operations.
//   - two_pass (prefill): a memset of per-token counts, a first pass that
//     inverts slot_tok into per-token slot lists (an atomic counter per token
//     only picks a list position), and a summing pass that sorts each
//     token's <= MAX_K slots and adds them.
// A token with more than MAX_K slots gets a NaN row rather than a silently
// partial sum, on both routes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int BN = 64;         // output columns per tile of the float32 route
constexpr int NTHREADS = 256;  // 8 warps; float32: 16 row groups x 16 column groups of 4
constexpr int MAX_K = 32;      // slots per token the combine takes
constexpr int CT = 256;        // combine threads per block

// routes, as kernels/fused_moe.py::gemm_route and ::combine_route name them
constexpr int ROUTE_FMA = 0, ROUTE_TC_PREFILL = 1, ROUTE_TC_DECODE = 2;
constexpr int COMBINE_SCAN = 0, COMBINE_TWO_PASS = 1;

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

// ---------------------------------------------------------------------------
// bf16: both phases on the tensor cores
// ---------------------------------------------------------------------------

namespace tcm {

using namespace tcore;
using bf16 = __nv_bfloat16;

// Per route, true: h as a bf16 high part and a bf16 low part, two products
// in down; false: h rounded to bf16 once, one product (PERF.md, readings)
constexpr bool PREFILL_H_SPLIT = false;
constexpr bool DECODE_H_SPLIT = true;

// Both phases are one product shape: A (slots x K) times B (K x 128 output
// columns).  Gate/up: A = the slots' rows of x (one plane), B = 64 columns
// of wg and the same 64 of wu; down: A = h (and, split, its lo plane), B =
// 128 columns of wo.
template <bool UP, bool SPLIT>
struct Phase {
  static constexpr int NA = UP || !SPLIT ? 1 : 2;     // A planes
  static constexpr int NB = UP ? 2 : 1;               // B matrices
  static constexpr int BNM = 128 / NB;                // columns of each B in a tile
};

struct Args {
  const bf16* a;            // gate/up: x (T, K); down: h (S, K) (split: lo after it)
  const bf16* w0;           // (E, K, N): wg, or wo
  const bf16* w1;           // (E, K, N): wu (gate/up)
  const int* slot_tok;      // (S,), T for an empty slot
  const float* slot_gate;   // (S,)
  bf16* out;                // gate/up: h (S, N) (split: lo after it); down: y (S, N)
  int n_tok, K, N, E, C;
};

__device__ __forceinline__ float swiglu(float g, float u) {
  return g / (1.f + expf(-g)) * u;
}

// h at element offset off of the hi plane, and (SPLIT) of the lo plane
// `plane` elements after it
template <bool SPLIT>
__device__ __forceinline__ void store_h(bf16* hi, int64_t plane, int64_t off, float h0,
                                        float h1) {
  if (SPLIT) {
    uint32_t lo;
    *reinterpret_cast<uint32_t*>(hi + off) = split_bf16(h0, h1, lo);
    *reinterpret_cast<uint32_t*>(hi + plane + off) = lo;
  } else {
    *reinterpret_cast<uint32_t*>(hi + off) = bits(__floats2bfloat162_rn(h0, h1));
  }
}

__device__ __forceinline__ void store_y(bf16* y, int64_t off, bool keep, float gate, float a,
                                        float b) {
  *reinterpret_cast<__nv_bfloat162*>(y + off) =
      __floats2bfloat162_rn(keep ? a * gate : 0.f, keep ? b * gate : 0.f);
}

// -- tc_prefill: 128 slots x 128 output columns a block ----------------------

constexpr int TM = 128;          // slots a tile
constexpr int TK = 64;           // K a stage
constexpr int TSTAGES = 3;       // stages in the ring
constexpr int T_LDA = TK + 8;    // A row stride in bf16: 16 B pad, so ldmatrix's
                                 // 8 rows hit 8 bank groups

template <bool UP>
struct TileCfg {
  using P = Phase<UP, PREFILL_H_SPLIT>;
  static constexpr int LDB = P::BNM + 8;
  static constexpr int A_BYTES = P::NA * TM * T_LDA * 2;
  static constexpr int STAGE = A_BYTES + P::NB * TK * LDB * 2;
  static constexpr int SMEM = TSTAGES * STAGE;
};

template <bool UP>
__device__ __forceinline__ void tile_body(const Args& p) {
  using Cf = TileCfg<UP>;
  using P = typename Cf::P;
  constexpr int LDB = Cf::LDB, BNM = P::BNM;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int64_t row_off[TM];   // element offset of a row of A; -1: a zero row
  __shared__ int n_live_s;          // 1 + the last live row of the tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int e = blockIdx.z, c0 = blockIdx.x * TM, n0 = blockIdx.y * BNM;
  const int rows = min(TM, p.C - c0);
  const int64_t S = (int64_t)p.E * p.C, s0 = (int64_t)e * p.C + c0;
  if (tid == 0) n_live_s = 0;
  __syncthreads();
  if (tid < TM) {
    const int t = tid < rows ? p.slot_tok[s0 + tid] : p.n_tok;
    const bool live = t >= 0 && t < p.n_tok;
    row_off[tid] = live ? (UP ? (int64_t)t : s0 + tid) * p.K : -1;
    if (live) atomicMax(&n_live_s, tid + 1);
  }
  __syncthreads();
  const int n_live = n_live_s;
  if (n_live == 0) {                 // an all-empty tile reads no weights
    if (!UP) {                       // and its y rows are 0
      constexpr int PR = BNM / 8;
      for (int i = tid; i < rows * PR; i += NTHREADS) {
        const int r = i / PR, c = n0 + (i % PR) * 8;
        if (c < p.N)
          *reinterpret_cast<uint4*>(p.out + (s0 + r) * p.N + c) = make_uint4(0, 0, 0, 0);
      }
    }
    return;
  }

  const int64_t w_off = (int64_t)e * p.K * p.N;
  const bf16* w0 = p.w0 + w_off;
  const bf16* w1 = UP ? p.w1 + w_off : p.w0;
  const uint32_t base = smem_u32(smem);
  // one stage: NA planes of TM rows x TK, and NB matrices of TK rows x BNM,
  // in 16-byte pieces; rows past the last live slot, empty slots and K or N
  // past the edge land as zeros and read nothing
  auto load_stage = [&](int slot, int k0) {
    const uint32_t sa = base + slot * Cf::STAGE, sb = sa + Cf::A_BYTES;
    constexpr int AP = TM * TK / 8, BPR = BNM / 8, BP = P::NB * TK * BPR;
#pragma unroll
    for (int pl = 0; pl < P::NA; ++pl)
#pragma unroll
      for (int j = 0; j < AP / NTHREADS; ++j) {
        const int i = tid + j * NTHREADS, r = i / (TK / 8), c = (i % (TK / 8)) * 8;
        const int64_t off = row_off[r];
        const bool in = off >= 0 && k0 + c < p.K;
        cp_async16(sa + (pl * TM * T_LDA + r * T_LDA + c) * 2,
                   p.a + pl * S * p.K + (in ? off + k0 + c : 0), in);
      }
#pragma unroll
    for (int j = 0; j < BP / NTHREADS; ++j) {
      const int i = tid + j * NTHREADS;
      const int m = i / (TK * BPR), r = (i / BPR) % TK, c = (i % BPR) * 8;
      const bool in = k0 + r < p.K && n0 + c < p.N;
      cp_async16(sb + (m * TK * LDB + r * LDB + c) * 2,
                 (m ? w1 : w0) + (in ? (int64_t)(k0 + r) * p.N + n0 + c : 0), in);
    }
  };

  // warp (wm, wn): rows 32 wm .. +31; columns 32 wn .. +31 of g and of u
  // (n-tiles 0-3 and 4-7), or 64 wn .. +63 of wo
  const int wm = warp & 3, wn = warp >> 2;
  const bool warp_live = wm * 32 < n_live;
  float acc[2][8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][j][q] = 0.f;
  const uint32_t a_lane = ((wm * 32 + (lane & 15)) * T_LDA + (lane >> 4) * 8) * 2;
  const uint32_t b_lane = ((((lane >> 3) & 1) * 8 + (lane & 7)) * LDB + (lane >> 4) * 8) * 2;

  const int KT = (p.K + TK - 1) / TK;
#pragma unroll
  for (int st = 0; st < TSTAGES - 1; ++st) {
    if (st < KT) load_stage(st, st * TK);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    // one barrier a stage: stage kt has landed for every thread, and every
    // warp is done with stage kt - 1, whose slot the next copy refills
    cp_async_wait<TSTAGES - 2>();
    __syncthreads();
    const int nk = kt + TSTAGES - 1;
    if (nk < KT) load_stage(nk % TSTAGES, nk * TK);
    cp_async_commit();
    if (!warp_live) continue;
    const uint32_t sa = base + (kt % TSTAGES) * Cf::STAGE, sb = sa + Cf::A_BYTES;
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      uint32_t af[P::NA][2][4];
#pragma unroll
      for (int pl = 0; pl < P::NA; ++pl)
#pragma unroll
        for (int m = 0; m < 2; ++m)
          ldsm_x4(af[pl][m], sa + (pl * TM * T_LDA + m * 16 * T_LDA + kk * 16) * 2 + a_lane);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        const int mat = UP ? jp >> 1 : 0;
        const int col = UP ? wn * 32 + (jp & 1) * 16 : wn * 64 + jp * 16;
        uint32_t bf[4];
        ldsm_x4_t(bf, sb + (mat * TK * LDB + kk * 16 * LDB + col) * 2 + b_lane);
#pragma unroll
        for (int pl = 0; pl < P::NA; ++pl)
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            mma16816(acc[m][2 * jp], af[pl][m], bf[0], bf[1]);
            mma16816(acc[m][2 * jp + 1], af[pl][m], bf[2], bf[3]);
          }
      }
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, t = lane & 3;
  if (UP) {
    if (!warp_live) return;          // rows past the last live slot: down reads none
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn * 32 + j * 8 + 2 * t;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = wm * 32 + m * 16 + g + 8 * i;
          if (col < p.N && r < n_live)
            store_h<PREFILL_H_SPLIT>(p.out, S * p.N, (s0 + r) * p.N + col,
                                     swiglu(acc[m][j][2 * i], acc[m][j + 4][2 * i]),
                                     swiglu(acc[m][j][2 * i + 1], acc[m][j + 4][2 * i + 1]));
        }
      }
  } else {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm * 32 + m * 16 + g + 8 * i;
        if (r >= rows) continue;
        const bool keep = row_off[r] >= 0;
        const float gate = keep ? p.slot_gate[s0 + r] : 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = n0 + wn * 64 + j * 8 + 2 * t;
          if (col < p.N)
            store_y(p.out, (s0 + r) * p.N + col, keep, gate, acc[m][j][2 * i],
                    acc[m][j][2 * i + 1]);
        }
      }
  }
}

__global__ void __launch_bounds__(NTHREADS, 2) moe_gate_up_tc_kernel(const Args p) {
  tile_body<true>(p);
}
__global__ void __launch_bounds__(NTHREADS, 2) moe_down_tc_kernel(const Args p) {
  tile_body<false>(p);
}

// -- tc_decode: (live expert, 128 columns) items, one warp each ---------------

constexpr int SW = 8;            // warps a block
constexpr int SSTAGES = 4;       // stages in each warp's ring
constexpr int S_LDA = 24;        // 16 K + 8 pad (bf16)
constexpr int S_LDB = 136;       // 128 columns + 8 pad (bf16)
constexpr int MAX_E = 256;       // experts the route takes
constexpr int MAX_C = 16;        // slots an expert the route takes: one A fragment

template <bool UP>
struct SkinnyCfg {
  using P = Phase<UP, DECODE_H_SPLIT>;
  static constexpr int A_BYTES = P::NA * 16 * S_LDA * 2;
  static constexpr int STAGE = A_BYTES + 16 * S_LDB * 2;
  static constexpr int WARP = SSTAGES * STAGE;
  static constexpr int SMEM = SW * WARP + MAX_E * MAX_C * 4;   // rings, then the slot table
};

template <bool UP>
__device__ __forceinline__ void skinny_body(const Args& p) {
  using Cf = SkinnyCfg<UP>;
  using P = typename Cf::P;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int live_e[MAX_E];      // the experts holding a token, ascending
  __shared__ int has_tok[MAX_E];
  __shared__ int n_exp_s;
  int* stok = reinterpret_cast<int*>(smem + SW * Cf::WARP);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int S = p.E * p.C;
  for (int i = tid; i < p.E; i += SW * 32) has_tok[i] = 0;
  __syncthreads();
#pragma unroll 4
  for (int i = tid; i < S; i += SW * 32) {
    const int t = p.slot_tok[i];
    stok[i] = t;
    if (t >= 0 && t < p.n_tok) has_tok[i / p.C] = 1;
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int e0 = 0; e0 < p.E; e0 += 32) {
      const bool live = e0 + lane < p.E && has_tok[e0 + lane];
      const unsigned m = __ballot_sync(0xffffffffu, live);
      if (live) live_e[n + __popc(m & ((1u << lane) - 1))] = e0 + lane;
      n += __popc(m);
    }
    if (lane == 0) n_exp_s = n;
  }
  __syncthreads();

  // warps of the grid in a fixed order: warp w of block b is gw = w * G + b,
  // so consecutive items land on different SMs
  const int gw = warp * gridDim.x + blockIdx.x, nw = SW * gridDim.x;
  const int64_t plane = (int64_t)S * (UP ? p.N : p.K);   // the lo plane's offset in h
  if (!UP) {                          // experts with no token: y rows of 0
    for (int e = gw; e < p.E; e += nw) {
      if (has_tok[e]) continue;
      uint4* dst = reinterpret_cast<uint4*>(p.out + (int64_t)e * p.C * p.N);
      for (int i = lane; i < p.C * p.N / 8; i += 32) dst[i] = make_uint4(0, 0, 0, 0);
    }
  }

  const int nt = (p.N + P::BNM - 1) / P::BNM;
  const int n_items = n_exp_s * nt, KS = p.K / 16;
  const uint32_t ring = smem_u32(smem) + warp * Cf::WARP;
  const int r = lane >> 1, half = lane & 1;   // the A piece this lane copies
  const int g = lane >> 2, t = lane & 3;
  const uint32_t a_lane = ((lane & 15) * S_LDA + (lane >> 4) * 8) * 2;
  const uint32_t b_lane = ((((lane >> 3) & 1) * 8 + (lane & 7)) * S_LDB + (lane >> 4) * 8) * 2;

  for (int it = gw; it < n_items; it += nw) {
    const int e = live_e[it / nt], n0 = (it % nt) * P::BNM;
    const int64_t s_e = (int64_t)e * p.C;
    const int tok = r < p.C ? stok[s_e + r] : p.n_tok;
    const bool live = tok >= 0 && tok < p.n_tok;
    const unsigned live_bits = __ballot_sync(0xffffffffu, live);   // bit 2 r: row r
    const bf16* a_row =
        p.a + (live ? (UP ? (int64_t)tok : s_e + r) * p.K + half * 8 : 0);
    const int64_t w_off = (int64_t)e * p.K * p.N;
    const bf16* w0 = p.w0 + w_off;
    const bf16* w1 = UP ? p.w1 + w_off : p.w0;
    // one 16-deep step: the lane's piece of each A plane, 8 pieces of B
    auto load_step = [&](int slot, int ks) {
      const uint32_t sa = ring + slot * Cf::STAGE, sb = sa + Cf::A_BYTES;
      const int k0 = ks * 16;
#pragma unroll
      for (int pl = 0; pl < P::NA; ++pl)
        cp_async16(sa + (pl * 16 * S_LDA + r * S_LDA + half * 8) * 2,
                   a_row + (live ? pl * plane + k0 : 0), live);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = lane + 32 * j, kr = i >> 4, c = (i & 15) * 8;
        const int col = n0 + (UP ? c & 63 : c);
        const bool in = col < p.N;
        cp_async16(sb + (kr * S_LDB + c) * 2,
                   (UP && c >= 64 ? w1 : w0) + (in ? (int64_t)(k0 + kr) * p.N + col : 0), in);
      }
    };

    float acc[16][4];
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
#pragma unroll
    for (int st = 0; st < SSTAGES - 1; ++st) {
      if (st < KS) load_step(st, st);
      cp_async_commit();
    }
    for (int ks = 0; ks < KS; ++ks) {
      cp_async_wait<SSTAGES - 2>();
      __syncwarp();                   // step ks landed for every lane; step ks - 1 is read
      const int nk = ks + SSTAGES - 1;
      if (nk < KS) load_step(nk % SSTAGES, nk);
      cp_async_commit();
      const uint32_t sa = ring + (ks % SSTAGES) * Cf::STAGE, sb = sa + Cf::A_BYTES;
      uint32_t af[P::NA][4];
#pragma unroll
      for (int pl = 0; pl < P::NA; ++pl) ldsm_x4(af[pl], sa + pl * 16 * S_LDA * 2 + a_lane);
#pragma unroll
      for (int jp = 0; jp < 8; ++jp) {
        uint32_t bf[4];
        ldsm_x4_t(bf, sb + jp * 32 + b_lane);
#pragma unroll
        for (int pl = 0; pl < P::NA; ++pl) {
          mma16816(acc[2 * jp], af[pl], bf[0], bf[1]);
          mma16816(acc[2 * jp + 1], af[pl], bf[2], bf[3]);
        }
      }
    }
    cp_async_wait<0>();
    __syncwarp();                     // the next item's copies reuse the ring

    // rows g and g + 8 of the fragment; n-tiles 0-7 of g and 8-15 of u, or
    // 0-15 of wo
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rr = g + 8 * i;
      if (rr >= p.C) continue;
      const bool keep = (live_bits >> (2 * rr)) & 1u;
      const int64_t s = s_e + rr;
      if (UP) {
        if (!keep) continue;          // down reads no empty row's h
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = n0 + j * 8 + 2 * t;
          if (col < p.N)
            store_h<DECODE_H_SPLIT>(p.out, plane, s * p.N + col,
                                    swiglu(acc[j][2 * i], acc[j + 8][2 * i]),
                                    swiglu(acc[j][2 * i + 1], acc[j + 8][2 * i + 1]));
        }
      } else {
        const float gate = keep ? p.slot_gate[s] : 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = n0 + j * 8 + 2 * t;
          if (col < p.N)
            store_y(p.out, s * p.N + col, keep, gate, acc[j][2 * i], acc[j][2 * i + 1]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(SW * 32, 1) moe_gate_up_skinny_kernel(const Args p) {
  skinny_body<true>(p);
}
__global__ void __launch_bounds__(SW * 32, 1) moe_down_skinny_kernel(const Args p) {
  skinny_body<false>(p);
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

cudaError_t launch(void (*kernel)(Args), const Args& p, dim3 grid, int threads, int smem,
                   cudaStream_t s) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, s>>>(p);
  return cudaGetLastError();
}

// gate/up into h, then down; `decode`: the skinny route
cudaError_t launch_gemm(const Args& up, const Args& down, bool decode, cudaStream_t s) {
  cudaError_t err;
  if (decode) {
    const dim3 grid(sm_count());
    err = launch(moe_gate_up_skinny_kernel, up, grid, SW * 32, SkinnyCfg<true>::SMEM, s);
    if (err != cudaSuccess) return err;
    return launch(moe_down_skinny_kernel, down, grid, SW * 32, SkinnyCfg<false>::SMEM, s);
  }
  const int mt = (up.C + TM - 1) / TM;
  err = launch(moe_gate_up_tc_kernel, up,
               dim3(mt, (up.N + TileCfg<true>::P::BNM - 1) / TileCfg<true>::P::BNM, up.E), NTHREADS,
               TileCfg<true>::SMEM, s);
  if (err != cudaSuccess) return err;
  return launch(moe_down_tc_kernel, down,
                dim3(mt, (down.N + TileCfg<false>::P::BNM - 1) / TileCfg<false>::P::BNM, down.E),
                NTHREADS, TileCfg<false>::SMEM, s);
}

}  // namespace tcm

// ---------------------------------------------------------------------------
// combine
// ---------------------------------------------------------------------------

// out[t, col .. col+3] = the rows slots[0 .. n-1] of y added in that order in
// float32, cast once; NaN when the token kept more than MAX_K slots
template <typename T>
__device__ __forceinline__ void add_rows(const T* __restrict__ y, const int* slots, int n,
                                         T* __restrict__ out, int d, int t, int col) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (n > MAX_K) {
    acc[0] = acc[1] = acc[2] = acc[3] = nanf("");
  } else {
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      float v[4];
      load4(y + (int64_t)slots[i] * d + col, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] += v[j];
    }
  }
  store4(out + (int64_t)t * d + col, acc);
}

// Route scan: block (t, column chunk) finds token t's slots in ascending
// order itself, then adds them.
template <typename T>
__global__ void __launch_bounds__(CT)
moe_combine_scan_kernel(const T* __restrict__ y, const int* __restrict__ slot_tok,
                        T* __restrict__ out, int d, int S) {
  __shared__ int slots[MAX_K];
  __shared__ int warp_n[CT / 32];
  const int t = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int n = 0;                                   // t's slots before this round
  for (int s0 = 0; s0 < S; s0 += 4 * CT) {
    const int i0 = s0 + 4 * tid;               // the thread's 4 entries, in order
    int v[4];
    if (i0 + 4 <= S) {
      const int4 q = *reinterpret_cast<const int4*>(slot_tok + i0);
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = i0 + j < S ? slot_tok[i0 + j] : -1;
    }
    int m = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) m += v[j] == t;
    // the matches of the threads before this one: a prefix count over the
    // warp, then over the warps
    int incl = m;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    if (lane == 31) warp_n[warp] = incl;
    __syncthreads();
    int pos = n + incl - m, total = 0;
#pragma unroll
    for (int w = 0; w < CT / 32; ++w) {
      const int c = warp_n[w];
      if (w < warp) pos += c;
      total += c;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (v[j] == t) {
        if (pos < MAX_K) slots[pos] = i0 + j;
        ++pos;
      }
    n += total;
    __syncthreads();                           // slots are written; warp_n is free
  }
  const int col = (blockIdx.y * CT + tid) * 4;
  if (col < d) add_rows(y, slots, n, out, d, t, col);
}

// Route two_pass, pass 1: slot s joins the list of its token.
__global__ void moe_invert_kernel(const int* __restrict__ slot_tok, int S, int n_tok,
                                  int* __restrict__ counts, int* __restrict__ lists) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const int t = slot_tok[s];
  if (t < 0 || t >= n_tok) return;
  const int pos = atomicAdd(&counts[t], 1);
  if (pos < MAX_K) lists[(int64_t)t * MAX_K + pos] = s;
}

// Route two_pass, pass 2: block (t, column chunk) adds token t's slot rows
// in ascending slot order.
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
  const int col = (blockIdx.y * CT + threadIdx.x) * 4;
  if (col < d) add_rows(y, slots, n_s, out, d, t, col);
}

template <typename T, int BM, int BK>
cudaError_t launch_fma(const void* x, const void* wg, const void* wu, const void* wo,
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

// Route fma: few slots per expert (decode) and K dims that take 64-deep
// stages take the skinny tile; otherwise the 64-slot tile.
cudaError_t launch_fma_route(const void* x, const void* wg, const void* wu, const void* wo,
                             const int* slot_tok, const float* slot_gate, float* h, void* y,
                             int n_tok, int d, int f, int E, int C, cudaStream_t s) {
  if (C <= 16 && d % 64 == 0 && f % 64 == 0)
    return launch_fma<float, 16, 64>(x, wg, wu, wo, slot_tok, slot_gate, h, y, n_tok, d, f,
                                     E, C, s);
  return launch_fma<float, 64, 16>(x, wg, wu, wo, slot_tok, slot_gate, h, y, n_tok, d, f, E,
                                   C, s);
}

template <typename T>
cudaError_t launch_combine(const void* y, const int* slot_tok, void* out, int* counts,
                           int* lists, int n_tok, int d, int S, int route, cudaStream_t s) {
  const dim3 grid(n_tok, (d + 4 * CT - 1) / (4 * CT));
  if (route == COMBINE_SCAN) {
    moe_combine_scan_kernel<T><<<grid, CT, 0, s>>>(
        static_cast<const T*>(y), slot_tok, static_cast<T*>(out), d, S);
    return cudaGetLastError();
  }
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * (size_t)n_tok, s);
  if (err != cudaSuccess) return err;
  moe_invert_kernel<<<(S + 255) / 256, 256, 0, s>>>(slot_tok, S, n_tok, counts, lists);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_combine_kernel<T><<<grid, CT, 0, s>>>(static_cast<const T*>(y), counts, lists,
                                            static_cast<T*>(out), d);
  return cudaGetLastError();
}

}  // namespace

// x (T, d); wg/wu (E, d, f); wo (E, f, d); slot_tok (E*C,) int32 with T for an
// empty slot; slot_gate (E*C,) f32; h: a scratch of E*C*f*4 bytes (route fma:
// f32 h; tc_prefill: bf16 h; tc_decode: its bf16 hi plane, then its lo); y
// (E*C, d).  d and f multiples of 16.  dtype: 0 = float32, 1 = bfloat16.
// route (kernels/fused_moe.py::gemm_route): 0 = fma (float32), 1 = tc_prefill,
// 2 = tc_decode (bfloat16; C <= 16, E <= 256).  Returns the cudaError_t of
// the launches.
extern "C" int repro_fused_moe_gemm(const void* x, const void* wg, const void* wu,
                                    const void* wo, const int* slot_tok,
                                    const float* slot_gate, float* h, void* y, int n_tok,
                                    int d, int f, int E, int C, int dtype, int route,
                                    void* stream) {
  if (n_tok <= 0 || d <= 0 || f <= 0 || E <= 0 || C <= 0 || d % 16 || f % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == ROUTE_FMA && dtype == 0)
    return (int)launch_fma_route(x, wg, wu, wo, slot_tok, slot_gate, h, y, n_tok, d, f, E,
                                 C, s);
  const bool decode = route == ROUTE_TC_DECODE;
  if (dtype != 1 || (route != ROUTE_TC_PREFILL && !decode) ||
      (decode && (C > tcm::MAX_C || E > tcm::MAX_E)))
    return (int)cudaErrorInvalidValue;
  using tcm::bf16;
  bf16* hb = reinterpret_cast<bf16*>(h);
  const tcm::Args up{static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
                     static_cast<const bf16*>(wu), slot_tok, slot_gate, hb, n_tok, d, f, E, C};
  const tcm::Args down{hb, static_cast<const bf16*>(wo), nullptr, slot_tok, slot_gate,
                       static_cast<bf16*>(y), n_tok, f, d, E, C};
  return (int)tcm::launch_gemm(up, down, decode, s);
}

// y (S, d); slot_tok (S,) int32; out (T, d); counts (T,) and lists
// (T, MAX_K) int32 scratch of route two_pass (route scan reads neither).
// d a multiple of 4.  route (kernels/fused_moe.py::combine_route): 0 = scan,
// 1 = two_pass.
extern "C" int repro_fused_moe_combine(const void* y, const int* slot_tok, void* out,
                                       int* counts, int* lists, int n_tok, int d, int S,
                                       int dtype, int route, void* stream) {
  if (n_tok <= 0 || d <= 0 || S <= 0 || d % 4 ||
      (route != COMBINE_SCAN && (route != COMBINE_TWO_PASS || !counts || !lists)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_combine<float>(y, slot_tok, out, counts, lists, n_tok, d, S, route, s);
  if (dtype == 1)
    return (int)launch_combine<__nv_bfloat16>(y, slot_tok, out, counts, lists, n_tok, d, S,
                                              route, s);
  return (int)cudaErrorInvalidValue;
}
