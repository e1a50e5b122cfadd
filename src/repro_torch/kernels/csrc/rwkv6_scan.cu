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
//   arrive as int8 with (B, S, H, 1) f32 row scales; the decay w stays float.
//   Each route is one kernel template for both entries: only the chunk load
//   differs (the serial sweep: FloatRKV / Int8RKV; the chunked form: T =
//   bf16 or int8_t).
//
// What bounds it on this card: bytes.  The chunked form needs about
// 4 D^2 + 2 L D operations a step of a (b, h) on the tensor cores (L = 16):
// at rwkv6-7b's training shape (B 60, S 256, H 64, D 64, bf16) 1.8e10, 0.02
// ms at 989 TFLOP/s, against ~0.69 GB moved (r, k, v, w in, out, the state;
// 0.21 ms at 3.35 TB/s).
//
// bf16 outputs (bf16 r/k/v, or int8 r/k/v with bf16 out): the TPU kernel's
// chunked form, with its three products on the tensor cores
// (wkv6_chunk_kernel; mma.sync.m16n8k16, bf16 in, f32 accumulate).  For a
// chunk of L = 16 steps (one mma tile of rows) from state S0:
//     out  = (r (.) pre) S0 + A V,
//     S_L  = diag(pre_L) S0 + (k (.) suf)^T V,
// with pre[t] = prod_{i<t} w_i, suf[j] = prod_{j<i<L} w_i and
// A[t][j] = sum_d r_t k_j prod_{j<i<t} w_i (j < t), A[t][t] = sum_d r_t u k_t.
// The decays are running products of w (floored at 1e-30, as the TPU
// kernel's log floor), never quotients: every factor is <= 1, the TPU
// kernel's "every exponent <= 0", so nothing can overflow.  A, whose pairs
// need a decay per channel, is built on the CUDA cores as sums over d of
// running products.  Every f32 operand (the decayed r and k, S0, A) enters
// a product as a bf16 high part and the bf16 rounding of its remainder (hi
// hi + hi lo + lo hi, or two products against an exact bf16 operand), so
// the products keep f32 accuracy to about 2^-16; v is exact in bf16 (int8
// v too: its row scale is folded into A's columns and into k (.) suf's
// rows; r's and k's row scales into their f32 values before the split).
// One block per (b, h), 2 D threads, up to 5 blocks an SM: a chunk of r, k,
// v, w (int8: and their row scales) arrives by cp.async into a two-stage
// ring in the (B, S, H, D) layout as is; P1 (all threads, CUDA cores) walks
// each channel down and up for the decays, writes the operand planes and A;
// P3 (warp w: value columns 16w .. 16w+15) runs the products, the state
// S^T staying in that warp's accumulator fragments across chunks, which are
// also the B fragments of (r (.) pre) S0.  Two barriers a chunk.  16-step
// chunks ran faster on the H100 than 32-step ones built of two 16-step
// sub-blocks (whose off-diagonal block was a product through a reference
// row): a third fewer split operands in the walks, no off-diagonal
// products, half the shared memory (scripts/kernel_ab.py wkv6, bf16: 0.147
// against 0.196 ms at the serving shape, 0.50-0.52 against 0.55 at the
// training shape; level with int8 r/k/v).  A ragged S
// ends the last chunk early: rows past S load as 0 and pass the state
// through (w = 1), as the TPU kernel's padding does.
//
// float32 outputs (the float32 parity runs, which hold losses within 1e-4 of
// the CPU): the token-serial sweep (wkv6_kernel), all in f32, a choice of
// dtype as in flash_attention.cu.  One block per (batch, head) of 2 D
// threads; thread (e, p) owns column e of S and its rows p*D/2 ..
// p*D/2+D/2-1 (p = 0, 1) in registers; out_t[e] is the sum of the two
// partial dot products, added across two adjacent lanes by a shuffle, plus
// v_t[e] * sum_d r_t[d] u[d] k_t[d].  The sequence is walked in chunks of 32
// steps loaded into shared memory (r/k/w padded so each thread's float4
// reads are free of bank conflicts), r/k/v dequantized as they enter.  It
// multiplies by the decays themselves (floored at 1e-30) and computes step
// for step what the plain version (kernels/ref.py::rwkv6_scan_ref) computes.
//
// Head dims 16 and 64 (the smoke config's and rwkv6-7b's), both routes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr int CHUNK = 32;          // time steps staged in shared memory at once

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

constexpr int NP = 2;              // threads per column of the state

// How r/k/v reach float32 as a chunk enters shared memory: element g of the
// (B, S, H, D) layout, whose row (b, t, h) has row scale index sr.  The
// loads take the read-only path (__ldg): through plain struct members the
// float kernel ran slower at the serving shape on the H100 than with its
// pointers as const __restrict__ kernel arguments; through __ldg, as fast
// (scripts/kernel_ab.py wkv6).
struct FloatRKV {                  // float32 r/k/v
  const float* __restrict__ r; const float* __restrict__ k; const float* __restrict__ v;
  __device__ __forceinline__ float r_at(int64_t g, int64_t) const { return __ldg(r + g); }
  __device__ __forceinline__ float k_at(int64_t g, int64_t) const { return __ldg(k + g); }
  __device__ __forceinline__ float v_at(int64_t g, int64_t) const { return __ldg(v + g); }
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

// In: how r/k/v are read (FloatRKV or Int8RKV).  TW: dtype of w.  D: head dim.
template <typename In, typename TW, int D>
__global__ void __launch_bounds__(D * NP)
wkv6_kernel(In in, const TW* __restrict__ w, const float* __restrict__ u,
            float* __restrict__ out, float* __restrict__ state, int S, int H) {
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
        out[base + (int64_t)(t0 + t) * row + e] = fmaf(ve, bonus_s[t], acc);
    }
  }

  float* sb = state + ((int64_t)b * H + h) * D * D;
#pragma unroll
  for (int i = 0; i < RPT; ++i) sb[(int64_t)(p * RPT + i) * D + e] = st[i];
}

// ---------------------------------------------------------------------------
// bf16 outputs: the chunked form on the tensor cores
// ---------------------------------------------------------------------------
namespace chunked {

using namespace tcore;
using bf16 = __nv_bfloat16;

constexpr int L = 16;              // steps a chunk: the rows of one mma tile

template <int D>
struct Cfg {
  static constexpr int NT = 2 * D;     // threads: D / 16 warps, warp w owning value
                                       // columns (and the state rows of S^T) 16w..16w+15
  static constexpr int LDP = D + 8;    // bf16 row stride of the operand planes: 16 B pad,
                                       // so ldmatrix's 8 rows hit 8 bank groups
  static constexpr int LDA = L + 8;    // bf16 row stride of A
  static constexpr int SL = D / 4;     // 4-channel slices of a row
  static constexpr int LOG2_SL = D == 64 ? 4 : 2;
  static constexpr int PLANES = 5 * L * LDP * 2 + 2 * L * LDA * 2 + D * 4;
  static constexpr int MIN_BLOCKS = D >= 64 ? 5 : 1;   // ~94 registers at D = 64
};

// bytes of one staged chunk: r, k, v rows of T, w rows of TW, then (int8)
// the chunk's r, k and v row scales
template <typename T, typename TW, int D>
__host__ __device__ constexpr int stage_bytes() {
  return 3 * L * D * (int)sizeof(T) + L * D * (int)sizeof(TW) +
         (std::is_same<T, int8_t>::value ? 3 * L * 4 : 0);
}

// two stages, then the operand planes
template <typename T, typename TW, int D>
__host__ __device__ constexpr int chunk_smem() {
  return 2 * stage_bytes<T, TW, D>() + Cfg<D>::PLANES;
}

// The operand planes (bf16 unless said): r (.) pre and k (.) suf as high
// and low parts, v, A as high and low parts, the chunk's decay per channel
// (f32)
struct Planes {
  bf16 *rdh, *rdl, *ksh, *ksl, *vp, *adh, *adl;
  float* preL;
  template <int D>
  __device__ __forceinline__ static Planes at(unsigned char* p) {
    constexpr int LDP = Cfg<D>::LDP, LDA = Cfg<D>::LDA;
    Planes q;
    q.rdh = reinterpret_cast<bf16*>(p);
    q.rdl = q.rdh + L * LDP;
    q.ksh = q.rdl + L * LDP;
    q.ksl = q.ksh + L * LDP;
    q.vp = q.ksl + L * LDP;
    q.adh = q.vp + L * LDP;
    q.adl = q.adh + L * LDA;
    q.preL = reinterpret_cast<float*>(q.adl + L * LDA);
    return q;
  }
};

// 4 values from shared memory as f32: bf16, f32, or int8 (the integers)
__device__ __forceinline__ void load4(const bf16* p, float (&f)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(x.x << 16);
  f[1] = __uint_as_float(x.x & 0xffff0000u);
  f[2] = __uint_as_float(x.y << 16);
  f[3] = __uint_as_float(x.y & 0xffff0000u);
}
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
}
__device__ __forceinline__ void load4(const int8_t* p, float (&f)[4]) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
  f[0] = byte_to_f32(w, 0x7540);
  f[1] = byte_to_f32(w, 0x7541);
  f[2] = byte_to_f32(w, 0x7542);
  f[3] = byte_to_f32(w, 0x7543);
}

// x as a bf16 high part and the bf16 rounding of its remainder
__device__ __forceinline__ void put(bf16* hi, bf16* lo, int i, float x) {
  const bf16 h = __float2bfloat16_rn(x);
  hi[i] = h;
  lo[i] = __float2bfloat16_rn(x - __bfloat162float(h));
}

// L rows of D values of type E from g (row t at g + t * stride) into dense
// shared rows; rows at or past n are zero-filled, not read
template <int D, typename E>
__device__ __forceinline__ void copy_rows(uint32_t dst, const E* g, int64_t stride, int n) {
  constexpr int EP = 16 / (int)sizeof(E), PR = D / EP;      // values, pieces a row
#pragma unroll
  for (int i = threadIdx.x; i < L * PR; i += Cfg<D>::NT) {
    const int t = i / PR, pc = i - t * PR;
    const bool in = t < n;
    cp_async16(dst + (t * PR + pc) * 16, g + (in ? t * stride : 0) + pc * EP, in);
  }
}

// T: bf16 (repro_rwkv6_scan) or int8_t with f32 row scales rs, ks, vs
// (repro_rwkv6_scan_int8); TW: the dtype of w.  Grid (H, B), 2 D threads.
template <typename T, typename TW, int D>
__global__ void __launch_bounds__(2 * D, Cfg<D>::MIN_BLOCKS)
wkv6_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ rs, const float* __restrict__ ks,
                  const float* __restrict__ vs, const TW* __restrict__ w,
                  const float* __restrict__ u, bf16* __restrict__ out,
                  float* __restrict__ state, int S, int H) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  using C = Cfg<D>;
  constexpr bool INT8 = std::is_same<T, int8_t>::value;
  constexpr int NT = C::NT, LDP = C::LDP, LDA = C::LDA, SL = C::SL;
  constexpr int KD = D / 16;           // 16-channel k-steps
  constexpr int NQ = D / 8;            // 8-channel n-tiles of the state
  constexpr int RB = L * D * (int)sizeof(T), WB = L * D * (int)sizeof(TW);
  constexpr int STG = stage_bytes<T, TW, D>();
  extern __shared__ __align__(16) unsigned char smem[];
  const Planes P = Planes::at<D>(smem + 2 * STG);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.y;
  const int64_t row = (int64_t)H * D;
  const int64_t base = (int64_t)b * S * row + (int64_t)h * D;
  const int64_t sbase = (int64_t)b * S * H + h;     // row scale of (b, t = 0, h)
  const int nch = (S + L - 1) / L;
  const uint32_t smem_u = smem_u32(smem);

  // chunk c -> stage c & 1; a group is committed even past the last chunk,
  // so that wait_group<1> always means "chunk c has landed"
  auto issue = [&](int c) {
    if (c < nch) {
      const int t0 = c * L, n = min(L, S - t0);
      const uint32_t st = smem_u + (c & 1) * STG;
      copy_rows<D>(st, r + base + t0 * row, row, n);
      copy_rows<D>(st + RB, k + base + t0 * row, row, n);
      copy_rows<D>(st + 2 * RB, v + base + t0 * row, row, n);
      copy_rows<D>(st + 3 * RB, w + base + t0 * row, row, n);
      if constexpr (INT8) {
        for (int i = tid; i < 3 * L; i += NT) {
          const int which = i / L, t = i - which * L;
          const bool in = t < n;
          const float* sc = which == 0 ? rs : which == 1 ? ks : vs;
          cp_async4z(st + 3 * RB + WB + i * 4, sc + sbase + (in ? (int64_t)(t0 + t) * H : 0),
                     in);
        }
      }
    }
    cp_async_commit();
  };
  issue(0);
  issue(1);

  // A's entries above the diagonal stay 0
  for (int i = tid; i < 2 * L * LDA; i += NT) P.adh[i] = __float2bfloat16_rn(0.f);

  // P1 roles, both taken by every thread: a walk down (prefix) or up
  // (suffix) one channel; and a pair of rows (p, L-1-p) of A over one
  // 4-channel slice
  const int dir = tid / D, dw = tid % D;
  const int pr = (tid / SL) & 7, sl = tid % SL;
  float uu[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) uu[i] = u[(int64_t)h * D + sl * 4 + i];

  // P3: warp w holds S^T[e][d], e = 16w + g (+8), d = 8q + 2t4 (+1)
  const int g = lane >> 2, t4 = lane & 3;
  const int e0 = warp * 16;
  float st[NQ][4];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[q][e] = 0.f;
  // ldmatrix lane offsets (elements, before a tile's base): A from [m][k]
  // rows, B from [k][n] rows (.trans), A from [k][m] rows (.trans)
  const int a_r = lane & 15, a_c = (lane >> 4) * 8;
  const int bt_r = ((lane >> 3) & 1) * 8 + (lane & 7), bt_c = (lane >> 4) * 8;
  const int at_r = ((lane >> 4) & 1) * 8 + (lane & 7), at_c = ((lane >> 3) & 1) * 8;
  auto addr = [&](const bf16* plane, int rr, int cc, int ld) {
    return smem_u32(plane + rr * ld + cc);
  };

  for (int c = 0; c < nch; ++c) {
    const int t0 = c * L, n = min(L, S - t0);
    cp_async_wait<1>();
    __syncthreads();                  // chunk c has landed; P3 of c - 1 is done

    // ---- P1, CUDA cores: the decays, the operand planes, A
    const unsigned char* sg = smem + (c & 1) * STG;
    const T* sr = reinterpret_cast<const T*>(sg);
    const T* sk = reinterpret_cast<const T*>(sg + RB);
    const T* sv = reinterpret_cast<const T*>(sg + 2 * RB);
    const TW* sw = reinterpret_cast<const TW*>(sg + 3 * RB);
    const float* ssc = reinterpret_cast<const float*>(sg + 3 * RB + WB);   // rs, ks, vs
    auto rsc = [&](int t) { return INT8 ? ssc[t] : 1.f; };
    auto ksc = [&](int t) { return INT8 ? ssc[L + t] : 1.f; };
    auto vsc = [&](int t) { return INT8 ? ssc[2 * L + t] : 1.f; };
    // rows past n pass the state through (w = 1), as the TPU kernel's padding
    auto wdec = [&](int t) { return t < n ? fmaxf(to_f32(sw[t * D + dw]), 1e-30f) : 1.f; };

    if (dir == 0) {                   // pre[t] = prod_{i<t} w_i
      float pre = 1.f;
#pragma unroll
      for (int t = 0; t < L; ++t) {
        put(P.rdh, P.rdl, t * LDP + dw, to_f32(sr[t * D + dw]) * rsc(t) * pre);
        pre *= wdec(t);
      }
      P.preL[dw] = pre;
    } else {                          // suf[j] = prod_{j<i<L} w_i
      float suf = 1.f;
#pragma unroll
      for (int j = L - 1; j >= 0; --j) {
        put(P.ksh, P.ksl, j * LDP + dw, to_f32(sk[j * D + dw]) * ksc(j) * vsc(j) * suf);
        suf *= wdec(j);
      }
    }

    // v rows into their plane (int8: widened, exact; the scale is in A and k)
    for (int i = tid; i < L * D / 8; i += NT) {
      const int t = i / (D / 8), pc = i - t * (D / 8);
      uint4 x;
      if constexpr (INT8) {
        const uint2 raw = *reinterpret_cast<const uint2*>(sv + t * D + pc * 8);
        widen4(raw.x, x.x, x.y);
        widen4(raw.y, x.z, x.w);
      } else {
        x = *reinterpret_cast<const uint4*>(sv + t * D + pc * 8);
      }
      *reinterpret_cast<uint4*>(P.vp + t * LDP + pc * 8) = x;
    }

    // A on the CUDA cores: A[t][j] = sum_d r_t k_j prod_{j<i<t} w_i (j < t;
    // decays as running products, each factor <= 1), A[t][t] = sum_d r_t u
    // k_t; each entry times the row scales of r_t and k_j and the v scale of
    // j.  Rows p and L-1-p give every thread L-1 pairs (iteration i: row p
    // while i < p, then row L-1-p); the SL lanes of a row hold one slice
    // each, and a transposed reduction leaves each lane 16 / SL of the 16
    // sums (the pairs and row p's bonus term) to write
    {
      const int d0 = sl * 4;
      float r1[4], r2[4], x[4], vals[16];
      load4(sr + pr * D + d0, r1);
      load4(sr + (L - 1 - pr) * D + d0, r2);
#pragma unroll
      for (int i = 0; i < L - 1; ++i) {
        const bool second = i >= pr, restart = i == 0 || i == pr;
        const int jj = second ? L - 2 - i : pr - 1 - i;
        float ww[4], kk[4];
        load4(sw + (jj + 1) * D + d0, ww);
        load4(sk + jj * D + d0, kk);
        float acc = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x[e] = restart ? (second ? r2[e] : r1[e]) : x[e] * fmaxf(ww[e], 1e-30f);
          acc = fmaf(x[e], kk[e], acc);
        }
        vals[i] = acc;
      }
      float bonus2;
      {
        float k1[4], k2[4];
        load4(sk + pr * D + d0, k1);
        load4(sk + (L - 1 - pr) * D + d0, k2);
        float b1 = 0.f, b2 = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          b1 = fmaf(r1[e] * uu[e], k1[e], b1);
          b2 = fmaf(r2[e] * uu[e], k2[e], b2);
        }
        vals[L - 1] = b1;
        bonus2 = b2;
      }
      // (constant trip counts throughout, so the 16 sums stay in registers)
#pragma unroll
      for (int lv = 0; lv < C::LOG2_SL; ++lv) {
        const int o = SL >> (lv + 1), half = 8 >> lv;
        const bool up = sl & o;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (q >= half) break;
          const float keep = up ? vals[q + half] : vals[q];
          const float send = up ? vals[q] : vals[q + half];
          vals[q] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
        bonus2 += __shfl_xor_sync(0xffffffffu, bonus2, o);
      }
#pragma unroll
      for (int q = 0; q < 16 / SL; ++q) {
        const int vi = sl * (16 / SL) + q;     // pair vi, or (vi = L - 1) row p's bonus
        const bool second = vi >= pr;
        const int t = vi == L - 1 ? pr : second ? L - 1 - pr : pr;
        const int j = vi == L - 1 ? pr : second ? L - 2 - vi : pr - 1 - vi;
        put(P.adh, P.adl, t * LDA + j, vals[q] * rsc(t) * ksc(j) * vsc(j));
      }
      if (sl == 0) {
        const int t = L - 1 - pr;
        put(P.adh, P.adl, t * LDA + t, bonus2 * rsc(t) * ksc(t) * vsc(t));
      }
    }
    __syncthreads();                  // the planes are written; stage c & 1 is free
    issue(c + 2);

    // ---- P3, tensor cores, warp w: value columns e0 .. e0 + 15
    // S0^T's fragments are the B fragments of (r (.) pre) S0: split in two
    uint32_t sh[KD][2][2], sl2[KD][2][2];
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
#pragma unroll
        for (int hb = 0; hb < 2; ++hb)
          sh[kk][nn][hb] = split_bf16(st[2 * kk + hb][2 * nn], st[2 * kk + hb][2 * nn + 1],
                                      sl2[kk][nn][hb]);

    // out[t][e] = (r (.) pre) S0 (hi hi + hi lo + lo hi) + A V (A in two parts)
    float o[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ah[4], al[4];
      ldsm_x4(ah, addr(P.rdh, a_r, kk * 16 + a_c, LDP));
      ldsm_x4(al, addr(P.rdl, a_r, kk * 16 + a_c, LDP));
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        mma16816(o[nn], ah, sh[kk][nn][0], sh[kk][nn][1]);
        mma16816(o[nn], ah, sl2[kk][nn][0], sl2[kk][nn][1]);
        mma16816(o[nn], al, sh[kk][nn][0], sh[kk][nn][1]);
      }
    }
    {
      uint32_t ah[4], al[4], vf[4];
      ldsm_x4(ah, addr(P.adh, a_r, a_c, LDA));
      ldsm_x4(al, addr(P.adl, a_r, a_c, LDA));
      ldsm_x4_t(vf, addr(P.vp, bt_r, e0 + bt_c, LDP));
      mma16816(o[0], ah, vf[0], vf[1]);
      mma16816(o[1], ah, vf[2], vf[3]);
      mma16816(o[0], al, vf[0], vf[1]);
      mma16816(o[1], al, vf[2], vf[3]);
    }

    // the chunk's rows of out; a ragged S ends the last chunk early
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int t = g + 8 * hr;
      if (t >= n) continue;
      bf16* orow = out + base + (int64_t)(t0 + t) * row + e0 + 2 * t4;
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
        *reinterpret_cast<__nv_bfloat162*>(orow + nn * 8) =
            __floats2bfloat162_rn(o[nn][2 * hr], o[nn][2 * hr + 1]);
    }

    // S^T <- S0^T diag(preL) + V^T (k (.) suf): V^T from the v plane (.trans),
    // k (.) suf in two parts
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const float2 dq = *reinterpret_cast<const float2*>(P.preL + 8 * q + 2 * t4);
      st[q][0] *= dq.x;
      st[q][1] *= dq.y;
      st[q][2] *= dq.x;
      st[q][3] *= dq.y;
    }
    uint32_t va[4];
    ldsm_x4_t(va, addr(P.vp, at_r, e0 + at_c, LDP));
#pragma unroll
    for (int np = 0; np < NQ / 2; ++np) {
      uint32_t bh[4], bl[4];
      ldsm_x4_t(bh, addr(P.ksh, bt_r, np * 16 + bt_c, LDP));
      ldsm_x4_t(bl, addr(P.ksl, bt_r, np * 16 + bt_c, LDP));
      mma16816(st[2 * np], va, bh[0], bh[1]);
      mma16816(st[2 * np + 1], va, bh[2], bh[3]);
      mma16816(st[2 * np], va, bl[0], bl[1]);
      mma16816(st[2 * np + 1], va, bl[2], bl[3]);
    }
  }
  cp_async_wait<0>();                 // the empty groups past the last chunk

  float* sb = state + ((int64_t)b * H + h) * D * D;   // (D, D): [d][e]
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int e = e0 + g + 8 * hr, d = 8 * q + 2 * t4;
      sb[(int64_t)d * D + e] = st[q][2 * hr];
      sb[(int64_t)(d + 1) * D + e] = st[q][2 * hr + 1];
    }
}

template <typename T, typename TW, int D>
cudaError_t launch(const void* r, const void* k, const void* v, const float* rs,
                   const float* ks, const float* vs, const void* w, const float* u, void* out,
                   float* state, int B, int S, int H, cudaStream_t stream) {
  const auto kernel = wkv6_chunk_kernel<T, TW, D>;
  constexpr int smem = chunk_smem<T, TW, D>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, B), Cfg<D>::NT, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), rs, ks, vs,
      static_cast<const TW*>(w), u, static_cast<bf16*>(out), state, S, H);
  return cudaGetLastError();
}

template <typename T, typename TW>
cudaError_t dispatch_d(const void* r, const void* k, const void* v, const float* rs,
                       const float* ks, const float* vs, const void* w, const float* u,
                       void* out, float* state, int B, int S, int H, int D,
                       cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, TW, 16>(r, k, v, rs, ks, vs, w, u, out, state, B, S, H, stream);
    case 64: return launch<T, TW, 64>(r, k, v, rs, ks, vs, w, u, out, state, B, S, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

// w_dtype: 0 = float32, 1 = bfloat16
template <typename T>
cudaError_t dispatch(const void* r, const void* k, const void* v, const float* rs,
                     const float* ks, const float* vs, const void* w, int w_dtype,
                     const float* u, void* out, float* state, int B, int S, int H, int D,
                     cudaStream_t stream) {
  if (w_dtype == 0)
    return dispatch_d<T, float>(r, k, v, rs, ks, vs, w, u, out, state, B, S, H, D, stream);
  if (w_dtype == 1)
    return dispatch_d<T, bf16>(r, k, v, rs, ks, vs, w, u, out, state, B, S, H, D, stream);
  return cudaErrorInvalidValue;
}

}  // namespace chunked

template <typename In, typename TW>
cudaError_t launch(const In& in, const void* w, const float* u, void* out, float* state,
                   int B, int S, int H, int D, cudaStream_t stream) {
  dim3 grid(H, B);
  const TW* wp = static_cast<const TW*>(w);
  float* op = static_cast<float*>(out);
  switch (D) {
    case 16:
      wkv6_kernel<In, TW, 16><<<grid, 16 * NP, 0, stream>>>(in, wp, u, op, state, S, H);
      break;
    case 64:
      wkv6_kernel<In, TW, 64><<<grid, 64 * NP, 0, stream>>>(in, wp, u, op, state, S, H);
      break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// float32 out.  w_dtype: 0 = float32, 1 = bfloat16
template <typename In>
cudaError_t dispatch_w(const In& in, const void* w, int w_dtype, const float* u, void* out,
                       float* state, int B, int S, int H, int D, cudaStream_t stream) {
  if (w_dtype == 0) return launch<In, float>(in, w, u, out, state, B, S, H, D, stream);
  if (w_dtype == 1) return launch<In, __nv_bfloat16>(in, w, u, out, state, B, S, H, D, stream);
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
  if (dtype == 0) {                   // float32: the serial sweep
    const FloatRKV in{static_cast<const float*>(r), static_cast<const float*>(k),
                      static_cast<const float*>(v)};
    return (int)dispatch_w(in, w, w_dtype, u, out, state, B, S, H, D, s);
  }
  if (dtype == 1)                     // bf16: the chunked form on the tensor cores
    return (int)chunked::dispatch<__nv_bfloat16>(r, k, v, nullptr, nullptr, nullptr, w, w_dtype,
                                                 u, out, state, B, S, H, D, s);
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
  if (out_dtype == 0)                 // float32 out: the serial sweep
    return (int)dispatch_w(in, w, w_dtype, u, out, state, B, S, H, D, s);
  if (out_dtype == 1)                 // bf16 out: the chunked form on the tensor cores
    return (int)chunked::dispatch<int8_t>(r, k, v, r_scale, k_scale, v_scale, w, w_dtype, u,
                                          out, state, B, S, H, D, s);
  return (int)cudaErrorInvalidValue;
}
