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
// What the bf16 kernel (flash_fwd_tc_kernel) does about it: both products
// run on the tensor cores, S = Q K^T and O += P V as bf16 operands with f32
// accumulation (mma.sync.m16n8k16, operands read from shared memory with
// ldmatrix).  One block per (64-row query tile, head, batch), four warps of
// 16 query rows each.  The Q tile stays resident in shared memory (and, at
// D <= 128, in registers); K/V tiles of 64 rows (32 at D = 256) stream
// through a two-stage cp.async ring in bf16, so the next tile's copy overlaps
// this tile's products (one barrier a tile); rows past Skv are zero-filled by
// the copy (src-size 0) and masked, not padded in memory.  The online softmax runs on the
// accumulator fragments, (m, l) per row in registers: S is scaled in f32
// after the product, as the plain version does, masked entries are -inf so
// their p is exactly 0 (a row with no live key so far keeps m = -1e30, finite),
// and l sums the f32 p.  P enters the second product as bf16 split in two,
// a high part and the low part's remainder (two products, both on the tensor
// cores), so P V keeps about 16 of p's bits and the output rounds as the f32
// plain version does (with P in one bf16 part the outputs missed the plain
// version by up to 1.6e-2 at the GQA-8 prefill shape, for 15% less time).  Whole K/V tiles that the causal or window mask removes
// are skipped; only tiles on the diagonal, the window edge or the ragged end
// pay for the per-element mask.  The query tiles are taken last-first, so the
// long causal rows start first.
//
// Route: mma.sync, not wgmma.  wgmma's shared-memory descriptors and
// swizzles are checked only by running on the card (a wrong layout reads
// garbage silently), and mma.sync.m16n8k16 with ldmatrix is the tensor-core
// route whose fragment layouts are fixed by the PTX ISA; moving the products
// to wgmma is queued (ROADMAP).
//
// The float32 kernel (flash_fwd_kernel) keeps the FMA sweep on purpose: it
// serves the float32 parity runs, which hold greedy tokens identical and
// losses within 1e-4 of the CPU; TF32 tensor cores keep about three digits
// and would break them.  That is a choice of dtype, not a fallback.  It
// stages 32-row K/V tiles as f32 in shared memory.
//
// Head dims 16, 32, 64, 128 and 256 (the smoke configs, whisper-medium,
// the dense and MoE configs, recurrentgemma-2b), in every kernel.
//
// Layouts follow the JAX package: q/o (B, Sq, H, D), k/v (B, Skv, Hkv, D),
// contiguous; the kv head of query head h is h / (H / Hkv), any group size
// (recurrentgemma's 10 query heads over one kv head included).  Ragged edges are
// masked by bounds checks, not padded copies.  A row with no live key gives 0
// (acc / max(l, 1e-30)).  The bf16 kernel needs 16-byte-aligned q, k, v, o
// (the wrapper checks).
//
// The int8 entry takes K/V as int8 plus (B, Skv, Hkv, 1) f32 row scales: a
// K/V tile and its scales are loaded together and widened on chip, so float
// K/V never exist in device memory and the K/V bytes read are a quarter of
// float32's, half of bf16's.  bf16 queries (flash_fwd_int8_tc_kernel) take
// the bf16 kernel's tensor-core sweep, one template with it
// (flash_tc_body): the int8 rows arrive by cp.async in a raw buffer and are
// widened to bf16 (exact: int8 values are bf16 values) into the K/V stage
// one tile ahead, by the thread that copied them, so no barrier is added;
// the row scales stay f32 and outside the products: S = (Q K_int8^T) times
// the k scale of its key and the softmax scale, after the product, and P
// times the v scale of its key, in f32, before P's split into its high and
// low parts.  Rows past Skv arrive as zeros with zero scales and are masked,
// so their p is exactly 0, as the TPU kernel's zero-scale padding rows give.
// float32 queries (flash_fwd_int8_kernel) keep the FMA sweep of the first
// design, as the float kernel does, for the float32 parity runs: rows past
// Skv dequantize to 0 there through a clamped row index and a zero scale.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

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

// flash_fwd_kernel over int8 K/V with (B, Skv, Hkv, 1) f32 row scales, for
// float32 queries: the same sweep, with each K/V element dequantized (int8 ->
// f32, times its row scale, as the TPU kernel does) as the tile enters shared
// memory.  It is a
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

// ---------------------------------------------------------------------------
// bf16: the tensor-core sweep
// ---------------------------------------------------------------------------
namespace tc {

using namespace tcore;

constexpr int NW = 4;                  // warps a block, 16 query rows each
constexpr int NT = NW * 32;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int BK = D >= 256 ? 32 : 64;   // key rows a K/V stage
  static constexpr int LD = D + 8;                // shared row stride in bf16: 16 B pad,
                                                  // so ldmatrix's 8 rows hit 8 bank groups
  static constexpr bool Q_REGS = D <= 128;        // Q fragments held in registers
  static constexpr int MIN_BLOCKS = D >= 256 ? 1 : 2;   // blocks an SM, for the registers
  static constexpr int SMEM = (BQ + 4 * BK) * LD * 2;   // Q, then 2 stages of K and V
  // int8 K/V: then one tile's raw int8 K and V rows, and 3 slots of the k and
  // v row scales of a tile
  static constexpr int RAW = 2 * BK * D;
  static constexpr int SMEM8 = SMEM + RAW + 3 * 2 * BK * 4;
};

// 2^x on the MUFU (flushes results below 2^-126 to 0); 2^-inf = 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ROWS rows of D values of type E from g (row r at g + r * stride) into shared
// rows of RB bytes; rows at or past n_in are zero-filled, not read.  Thread
// tid copies pieces tid, tid + NT, ... (the int8 tiles' widening relies on it)
template <int D, int ROWS, int RB, typename E>
__device__ __forceinline__ void load_rows(uint32_t dst, const E* g, int64_t stride, int n_in) {
  constexpr int EP = 16 / (int)sizeof(E), CPR = D / EP;     // values, pieces a row
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * CPR; i += NT) {
    const int r = i / CPR, c = i % CPR;
    const bool in = r < n_in;
    cp_async16(dst + r * RB + c * 16, g + (in ? r * stride : 0) + c * EP, in);
  }
}

// The sweep, for bf16 K/V (INT8 = false: flash_fwd_tc_kernel) or int8 K/V
// with f32 row scales (INT8 = true: flash_fwd_int8_tc_kernel).  int8 tiles:
// the raw rows of tile tt + 1 are copied (cp.async) into one raw buffer while
// tile tt - 1's products run, and the thread that copied a 16-byte piece
// widens it into the bf16 stage of tile tt + 1 once tile tt's products are
// done, so no barrier is added: a stage is written between the barrier that
// ends the products of its previous tile and the barrier before its own.
// Each thread's widening reads only its own pieces, and its next copy
// overwrites them only after.  The row scales take a 3-slot ring, since a
// tile's scales are read by its products while the next-but-one's land.
// One template rather than a copy (as the FMA sweeps are): the bf16
// instantiation times as before on the H100 (scripts/kernel_ab.py flash, at
// the training shape the parent 0.2869 and 0.2902 ms, the template 0.2878
// and 0.2914, in turns in one run).
template <int D, bool INT8, typename KT>
__device__ __forceinline__ void flash_tc_body(
    const __nv_bfloat16* __restrict__ q, const KT* __restrict__ k,
    const float* __restrict__ ks, const KT* __restrict__ v, const float* __restrict__ vs,
    __nv_bfloat16* __restrict__ o, int Sq, int Skv, int H, int Hkv, int causal, int window,
    float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  using C = Cfg<D>;
  constexpr int BK = C::BK, LD = C::LD;
  constexpr int NS = BK / 8;           // S n-tiles (8 keys each)
  constexpr int NO = D / 8;            // O n-tiles (8 columns each)
  constexpr int KD = D / 16;           // k-steps of Q K^T
  constexpr int CPR8 = D / 16;         // 16-byte pieces an int8 row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* KVs = Qs + BQ * LD;   // stage s: K at KVs + 2s*BK*LD, V after it
  // int8: the raw K rows, then the raw V rows, of one tile; then the scale
  // slots, slot i holding BK k scales and BK v scales
  const int8_t* raw = reinterpret_cast<const int8_t*>(KVs + 4 * BK * LD);
  const float* scl = reinterpret_cast<const float*>(raw + C::RAW);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;    // long causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int64_t q_row = (int64_t)H * D, kv_row = (int64_t)Hkv * D;
  const __nv_bfloat16* qb = q + (int64_t)b * Sq * q_row + (int64_t)h * D;
  const KT* kb = k + (int64_t)b * Skv * kv_row + (int64_t)hk * D;
  const KT* vb = v + (int64_t)b * Skv * kv_row + (int64_t)hk * D;
  // int8: row scales of this (batch, kv head), row ki at [ki * Hkv]
  const float* ksb = INT8 ? ks + (int64_t)b * Skv * Hkv + hk : nullptr;
  const float* vsb = INT8 ? vs + (int64_t)b * Skv * Hkv + hk : nullptr;

  // the K/V tiles some query of this block sees (flash_attention.py:90-99)
  const int q_last = min(q0 + BQ - 1, Sq - 1);
  int t_hi = (Skv + BK - 1) / BK;
  if (causal) t_hi = min(t_hi, q_last / BK + 1);
  const int t_lo = window > 0 ? max(0, (q0 - window + 1) / BK) : 0;

  const uint32_t qs_u = smem_u32(Qs), kv_u = smem_u32(KVs);
  const uint32_t raw_u = smem_u32(raw), scl_u = smem_u32(scl);
  constexpr uint32_t STAGE = 2 * BK * LD * 2, VOFF = BK * LD * 2;   // bytes

  // int8: copy tile tt's raw K and V rows, and its scales into slot (tt - t_lo) % 3
  auto load_raw = [&](int tt) {
    const int k0 = tt * BK, n_in = Skv - k0;
    load_rows<D, BK, D>(raw_u, kb + k0 * kv_row, kv_row, n_in);
    load_rows<D, BK, D>(raw_u + BK * D, vb + k0 * kv_row, kv_row, n_in);
    if (tid < 2 * BK) {               // rows past Skv get scale 0
      const int r = tid % BK;
      const bool in = r < n_in;
      const float* src = (tid < BK ? ksb : vsb) + (in ? (int64_t)(k0 + r) * Hkv : 0);
      cp_async4z(scl_u + (((tt - t_lo) % 3) * 2 * BK + tid) * 4, src, in);
    }
    cp_async_commit();
  };
  // int8: this thread's pieces of the raw tile, widened into tile tt's stage
  // (exact: int8 values are bf16 values); the two 16-byte halves of a piece
  // are stored in an order that puts 8 neighbouring lanes on distinct banks
  auto widen = [&](int tt) {
    __nv_bfloat16* st = KVs + ((tt - t_lo) & 1) * 2 * BK * LD;
#pragma unroll
    for (int i = tid; i < BK * CPR8; i += NT) {
      const int r = i / CPR8, c = i % CPR8;
#pragma unroll
      for (int part = 0; part < 2; ++part) {             // K, then V
        const uint4 w = *reinterpret_cast<const uint4*>(raw + part * BK * D + r * D + c * 16);
        uint4 lo, hi;
        widen4(w.x, lo.x, lo.y);
        widen4(w.y, lo.z, lo.w);
        widen4(w.z, hi.x, hi.y);
        widen4(w.w, hi.z, hi.w);
        uint4* dst = reinterpret_cast<uint4*>(st + part * BK * LD + r * LD + c * 16);
        const int first = (c >> 2) & 1;
        dst[first] = first ? hi : lo;
        dst[first ^ 1] = first ? lo : hi;
      }
    }
  };

  load_rows<D, BQ, LD * 2>(qs_u, qb + (int64_t)q0 * q_row, q_row, Sq - q0);
  if constexpr (INT8) {
    if (t_lo < t_hi) {
      load_raw(t_lo);                 // one group with the Q rows
      cp_async_wait<0>();
      compiler_fence();
      widen(t_lo);
      compiler_fence();
      if (t_lo + 1 < t_hi) load_raw(t_lo + 1);
    } else {
      cp_async_commit();
    }
  } else {
    cp_async_commit();
    if (t_lo < t_hi) {
      const int k0 = t_lo * BK;
      load_rows<D, BK, LD * 2>(kv_u, kb + k0 * kv_row, kv_row, Skv - k0);
      load_rows<D, BK, LD * 2>(kv_u + VOFF, vb + k0 * kv_row, kv_row, Skv - k0);
      cp_async_commit();
    }
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_r[2] = {NEG, NEG}, l_r[2] = {0.f, 0.f};   // rows g and g + 8 of the warp
  uint32_t qf[C::Q_REGS ? KD : 1][4];

  // ldmatrix lane addresses (bytes, before the tile's base)
  const int r16 = warp * 16;
  const uint32_t q_lane = ((r16 + (lane & 15)) * LD + (lane >> 4) * 8) * 2;
  const uint32_t k_lane = ((((lane >> 4) << 3) + (lane & 7)) * LD + ((lane >> 3) & 1) * 8) * 2;
  const uint32_t v_lane = ((((lane >> 3) & 1) * 8 + (lane & 7)) * LD + (lane >> 4) * 8) * 2;
  const int row0 = q0 + r16 + g, row1 = row0 + 8;

  for (int tt = t_lo; tt < t_hi; ++tt) {
    const uint32_t cur = kv_u + ((tt - t_lo) & 1) * STAGE;
    // one barrier a tile: tile tt is in its stage for every thread, and every
    // warp is done with tile tt - 1, whose stage the next copy (bf16) or
    // widening (int8) refills
    if constexpr (!INT8) cp_async_wait<0>();
    __syncthreads();
    if constexpr (!INT8) {
      if (tt + 1 < t_hi) {
        const uint32_t nxt = kv_u + ((tt + 1 - t_lo) & 1) * STAGE;
        const int k1 = (tt + 1) * BK;
        load_rows<D, BK, LD * 2>(nxt, kb + k1 * kv_row, kv_row, Skv - k1);
        load_rows<D, BK, LD * 2>(nxt + VOFF, vb + k1 * kv_row, kv_row, Skv - k1);
        cp_async_commit();
      }
    }
    const int k0 = tt * BK;
    // int8: this tile's k scales, then its v scales
    const float* ksc = INT8 ? scl + ((tt - t_lo) % 3) * 2 * BK : nullptr;
    const float* vsc = INT8 ? ksc + BK : nullptr;
    if (C::Q_REGS && tt == t_lo) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) ldsm_x4(qf[C::Q_REGS ? kk : 0], qs_u + q_lane + kk * 32);
    }

    // S = Q K^T
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4];
      if (C::Q_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[C::Q_REGS ? kk : 0][e];
      } else {
        ldsm_x4(qa, qs_u + q_lane + kk * 32);
      }
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        uint32_t kf[4];
        ldsm_x4(kf, cur + k_lane + (jp * 16 * LD + kk * 16) * 2);
        mma16816(s[2 * jp], qa, kf[0], kf[1]);
        mma16816(s[2 * jp + 1], qa, kf[2], kf[3]);
      }
    }

    // scale in f32 after the product (int8: by the k row scale too); mask
    // only where the tile needs it
    const bool edge = k0 + BK > Skv || (causal && k0 + BK - 1 > q0) ||
                      (window > 0 && k0 <= q_last - window);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      float2 kscale = make_float2(1.f, 1.f);
      if constexpr (INT8) kscale = *reinterpret_cast<const float2*>(ksc + j * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e];
        if constexpr (INT8) x *= (e & 1) ? kscale.y : kscale.x;
        x *= scale;
        if (edge) {
          const int key = k0 + j * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? row0 : row1;
          bool live = key < Skv;
          if (causal) live = live && key <= row;
          if (window > 0) live = live && key > row - window;
          x = live ? x : -INFINITY;     // ex2(-inf) = 0: a masked p is exactly 0
        }
        s[j][e] = x;
      }
    }

    // online softmax on the fragments: rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m_r[i];
#pragma unroll
      for (int j = 0; j < NS; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[i] = ex2((m_r[i] - mx) * LOG2E);
      m_r[i] = mx;
      const float mb = mx * LOG2E;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float p0 = ex2(fmaf(s[j][2 * i], LOG2E, -mb));
        const float p1 = ex2(fmaf(s[j][2 * i + 1], LOG2E, -mb));
        s[j][2 * i] = p0;
        s[j][2 * i + 1] = p1;
        sum += p0 + p1;
      }
      l_r[i] = l_r[i] * corr[i] + sum;
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += P V: the S fragments of keys 16 ks .. 16 ks + 15 are P's A
    // fragment; int8: p times the v row scale, in f32, before the split
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t pa[4], pl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a[e]: rows g (e even) or g + 8 (e odd), keys of S tile 2 ks + e / 2
        float x = s[2 * ks + (e >> 1)][(e & 1) * 2];
        float y = s[2 * ks + (e >> 1)][(e & 1) * 2 + 1];
        if constexpr (INT8) {
          const float2 vscale =
              *reinterpret_cast<const float2*>(vsc + (2 * ks + (e >> 1)) * 8 + 2 * t);
          x *= vscale.x;
          y *= vscale.y;
        }
        pa[e] = split_bf16(x, y, pl[e]);
      }
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t vf[4];
        ldsm_x4_t(vf, cur + VOFF + v_lane + (ks * 16 * LD + np * 16) * 2);
        mma16816(acc[2 * np], pa, vf[0], vf[1]);         // P's high part
        mma16816(acc[2 * np + 1], pa, vf[2], vf[3]);
        mma16816(acc[2 * np], pl, vf[0], vf[1]);         // and its low part
        mma16816(acc[2 * np + 1], pl, vf[2], vf[3]);
      }
    }

    // int8: tile tt + 1's raw rows have landed (this thread's pieces); widen
    // them into the stage tile tt - 1 left, then copy tile tt + 2's over them
    if constexpr (INT8) {
      if (tt + 1 < t_hi) {
        cp_async_wait<0>();
        compiler_fence();
        widen(tt + 1);
        compiler_fence();
        if (tt + 2 < t_hi) load_raw(tt + 2);
      }
    }
  }
  cp_async_wait<0>();   // no tile: the Q copy may still be in flight

  // out = acc / l, l summed over the quad that shares a row
  __nv_bfloat16* ob = o + (int64_t)b * Sq * q_row + (int64_t)h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int row = i ? row1 : row0;
    if (row >= Sq) continue;
    __nv_bfloat16* orow = ob + (int64_t)row * q_row + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
  }
}

template <int D>
__global__ void __launch_bounds__(NT, Cfg<D>::MIN_BLOCKS)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                    int Sq, int Skv, int H, int Hkv, int causal, int window, float scale) {
  flash_tc_body<D, false>(q, k, nullptr, v, nullptr, o, Sq, Skv, H, Hkv, causal, window,
                          scale);
}

template <int D>
__global__ void __launch_bounds__(NT, Cfg<D>::MIN_BLOCKS)
flash_fwd_int8_tc_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k,
                         const float* __restrict__ ks, const int8_t* __restrict__ v,
                         const float* __restrict__ vs, __nv_bfloat16* __restrict__ o, int Sq,
                         int Skv, int H, int Hkv, int causal, int window, float scale) {
  flash_tc_body<D, true>(q, k, ks, v, vs, o, Sq, Skv, H, Hkv, causal, window, scale);
}

}  // namespace tc

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

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                      int Skv, int H, int Hkv, int causal, int window, cudaStream_t stream) {
  const auto kernel = tc::flash_fwd_tc_kernel<D>;
  const int smem = tc::Cfg<D>::SMEM;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kernel<<<grid, tc::NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq, Skv, H, Hkv,
      causal, window, (float)(1.0 / sqrt((double)D)));
  return cudaGetLastError();
}

// float32: the FMA sweep; bfloat16: the tensor-core sweep
template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, int B,
                       int Sq, int Skv, int H, int Hkv, int D, int causal,
                       int window, cudaStream_t stream) {
  constexpr bool TC = std::is_same<T, __nv_bfloat16>::value;
  switch (D) {
    case 16:
      return TC ? launch_tc<16>(q, k, v, o, B, Sq, Skv, H, Hkv, causal, window, stream)
                : launch<float, 16>(q, k, v, o, B, Sq, Skv, H, Hkv, causal, window, stream);
    case 32:
      return TC ? launch_tc<32>(q, k, v, o, B, Sq, Skv, H, Hkv, causal, window, stream)
                : launch<float, 32>(q, k, v, o, B, Sq, Skv, H, Hkv, causal, window, stream);
    case 64:
      return TC ? launch_tc<64>(q, k, v, o, B, Sq, Skv, H, Hkv, causal, window, stream)
                : launch<float, 64>(q, k, v, o, B, Sq, Skv, H, Hkv, causal, window, stream);
    case 128:
      return TC ? launch_tc<128>(q, k, v, o, B, Sq, Skv, H, Hkv, causal, window, stream)
                : launch<float, 128>(q, k, v, o, B, Sq, Skv, H, Hkv, causal, window, stream);
    case 256:
      return TC ? launch_tc<256>(q, k, v, o, B, Sq, Skv, H, Hkv, causal, window, stream)
                : launch<float, 256>(q, k, v, o, B, Sq, Skv, H, Hkv, causal, window, stream);
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

template <int D>
cudaError_t launch_tc_int8(const void* q, const void* k, const void* ks, const void* v,
                           const void* vs, void* o, int B, int Sq, int Skv, int H, int Hkv,
                           int causal, int window, cudaStream_t stream) {
  const auto kernel = tc::flash_fwd_int8_tc_kernel<D>;
  const int smem = tc::Cfg<D>::SMEM8;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kernel<<<grid, tc::NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k),
      static_cast<const float*>(ks), static_cast<const int8_t*>(v),
      static_cast<const float*>(vs), static_cast<__nv_bfloat16*>(o), Sq, Skv, H, Hkv, causal,
      window, (float)(1.0 / sqrt((double)D)));
  return cudaGetLastError();
}

// float32 queries: the FMA sweep; bfloat16: the tensor-core sweep
template <typename T>
cudaError_t dispatch_d_int8(const void* q, const void* k, const void* ks, const void* v,
                            const void* vs, void* o, int B, int Sq, int Skv, int H,
                            int Hkv, int D, int causal, int window, cudaStream_t stream) {
  constexpr bool TC = std::is_same<T, __nv_bfloat16>::value;
  switch (D) {
    case 16:
      return TC ? launch_tc_int8<16>(q, k, ks, v, vs, o, B, Sq, Skv, H, Hkv, causal, window, stream)
                : launch_int8<float, 16>(q, k, ks, v, vs, o, B, Sq, Skv, H, Hkv, causal, window,
                                         stream);
    case 32:
      return TC ? launch_tc_int8<32>(q, k, ks, v, vs, o, B, Sq, Skv, H, Hkv, causal, window, stream)
                : launch_int8<float, 32>(q, k, ks, v, vs, o, B, Sq, Skv, H, Hkv, causal, window,
                                         stream);
    case 64:
      return TC ? launch_tc_int8<64>(q, k, ks, v, vs, o, B, Sq, Skv, H, Hkv, causal, window, stream)
                : launch_int8<float, 64>(q, k, ks, v, vs, o, B, Sq, Skv, H, Hkv, causal, window,
                                         stream);
    case 128:
      return TC ? launch_tc_int8<128>(q, k, ks, v, vs, o, B, Sq, Skv, H, Hkv, causal, window,
                                      stream)
                : launch_int8<float, 128>(q, k, ks, v, vs, o, B, Sq, Skv, H, Hkv, causal, window,
                                          stream);
    case 256:
      return TC ? launch_tc_int8<256>(q, k, ks, v, vs, o, B, Sq, Skv, H, Hkv, causal, window,
                                      stream)
                : launch_int8<float, 256>(q, k, ks, v, vs, o, B, Sq, Skv, H, Hkv, causal, window,
                                          stream);
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
