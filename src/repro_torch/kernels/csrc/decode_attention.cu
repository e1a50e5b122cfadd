// Single-token decode attention for Hopper (sm_90a), plain C interface for
// ctypes: one sweep over a contiguous cache or over the pages of a shared
// pool, each with a native or an int8 cache.
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention
//   (_decode_kernel/_online_update), ::decode_attention_int8
//   (_decode_int8_kernel), ::paged_decode_attention (_paged_decode_kernel)
//   and ::paged_decode_attention_int8 (_paged_decode_int8_kernel).
//
// What bounds it on this card: bytes.  One query row meets the whole live
// cache, so every K/V byte read is used for 2 multiply-adds a query head of
// its group: at B=8, 32 heads, D=128 and ~576 live rows the bf16 cache is
// ~48 MB (~14 us at 3.35 TB/s), the int8 cache ~25 MB (~7 us), against well
// under a GFLOP of work.  In practice the latency of a block's steps, not the
// bytes, set the time: a cache of a few MB is read in a few microseconds.
//
// What this design does about it:
// - One block per (batch, kv head, chunk of `chunk` rows).  The block reads
//   each live K/V row of its chunk once and scores it against all G = H / Hkv
//   query heads of the group, so a GQA or MQA cache is read once, not G times,
//   and a long sequence spreads over many blocks (recurrentgemma-2b's 10 heads
//   over one kv head and 2048 rows give 256 blocks at batch 8, not 80).
// - Chunks are fixed runs of rows counted from row 0 (`chunk`, a multiple of
//   16 and of the engine's page sizes), never a share of the capacity: the
//   contiguous and the paged route cut a sequence at the same rows and sum in
//   the same order, so their outputs agree bit for bit.  The wrapper's split
//   plan (decode_attention.py::split_plan) gives the grid.  A chunk holding no
//   live row (past valid_len, or before the window) exits at once.
// - The chunk's rows move to shared memory with 16-byte cp.async, K in one
//   group and V in another, so the scores run while V is in flight.
// - bf16 queries (decode_tc_kernel): both products on the tensor cores
//   (mma.sync.m16n8k16, bf16 in, f32 accumulate).  The group's query heads,
//   padded to 16, are the A operand of S = Q K^T; P V takes P from the f32
//   softmax as a bf16 high part plus a bf16 low part (two products), so P
//   keeps about 16 bits.  An int8 cache is widened to bf16 in shared memory
//   (int8 values are exact in bf16) and its row scales are applied in f32:
//   to the scores after the product, and to p before P V.  The cache is never
//   widened in device memory.  On CUDA cores these products were latency
//   bound (about one instruction a cycle per SM in the shuffle reductions).
// - float32 queries (decode_kernel): the CUDA-core sweep, all in f32, for the
//   float32 parity runs (identical greedy tokens against the CPU); TF32
//   tensor cores would round the cache to 10 bits.  A choice of dtype.
// - A chunk's partial softmax state (m, l, acc) per query head goes, in f32,
//   to a scratch the wrapper allocates; the last block of a (batch, kv head)
//   to finish -- a counter per (batch, kv head) that the last block resets to
//   0 -- merges the partials in ascending chunk order.  One launch per call,
//   deterministic, no float atomics.  A sequence whose live rows fit one chunk
//   writes its output directly.
// A row with no live key (valid_len 0) gives 0.
//
// The sweep is one template over a row-address policy.  Contiguous: row r of
// sequence b is row b*Skv + r of the cache.  Paged: row r is row
// r % page_size of page table[b][r / page_size] of the pool (P, page_size,
// Hkv, D), the layout the serve engine's page pool has per layer.  A paged
// block copies the table entries of its chunk's live pages into shared
// memory first (one read each); entries of pages outside the live rows are
// never read, as the TPU kernel's `live` guard skips them.  Shared prefix
// pages are read once per sequence, as the TPU kernel reads them.
//
// All pointers must be 16-byte aligned (the wrappers check); every row of
// D >= 16 values is a multiple of 16 bytes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace {

using namespace tcore;

constexpr int NT = 256;           // threads a block of the f32 sweep
constexpr int TNT = 256;          // threads a block of the tensor-core sweep
constexpr float NEG = -1e30f;     // the TPU kernel's NEG_INF
constexpr int MAXH = 8;           // query heads a thread accumulates at once
constexpr int HU = 4;             // query heads a row's scores reduce at once

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// N contiguous elements loaded as one aligned vector.
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float (&out)[N]) {
  const Vec<T, N> x = *reinterpret_cast<const Vec<T, N>*>(p);
#pragma unroll
  for (int e = 0; e < N; ++e) out[e] = to_f32(x.v[e]);
}

// Row-address policies: where cache row r of the block's sequence lies, in
// rows of Hkv * D values (and of Hkv row scales).  `setup` runs once per
// block, by all its threads, for the live rows [r0, r1) of its chunk (at
// most `chunk` of them).
struct ContiguousRows {
  int Skv;
  int64_t base;
  __host__ __device__ __forceinline__ int capacity() const { return Skv; }
  __device__ __forceinline__ void setup(int b, int, int, int*) { base = (int64_t)b * Skv; }
  __device__ __forceinline__ int64_t row(int r) const { return base + r; }
};

struct PagedRows {
  const int* table;       // (B, NP) page ids
  int NP, page_size;
  const int* ids;         // the pool row of each live row of the chunk, in shared memory
  int r0;
  __host__ __device__ __forceinline__ int capacity() const { return NP * page_size; }
  // one table read a row (live pages only) and one division, not one a copy
  __device__ __forceinline__ void setup(int b, int r0_, int r1, int* smem) {
    r0 = r0_;
    for (int j = threadIdx.x; j < r1 - r0; j += blockDim.x) {
      const int p = (r0 + j) / page_size;
      smem[j] = table[(int64_t)b * NP + p] * page_size + (r0 + j - p * page_size);
    }
    ids = smem;
    __syncthreads();
  }
  __device__ __forceinline__ int64_t row(int r) const { return ids[r - r0]; }
};

// The shape of a float32-sweep block's work, fixed by the cache type and
// the head dim.
template <typename KT, int D>
struct Shape {
  // scores: LPR lanes a row, EPL values a lane (16 bytes or more)
  static constexpr int LPR = (D * (int)sizeof(KT) / 16) < 32 ? D * (int)sizeof(KT) / 16 : 32;
  static constexpr int EPL = D / LPR;
  static constexpr int NRG = NT / LPR;              // rows scored at once
  // P V: VEC columns a thread (4 bytes of a 16-bit or int8 row, 8 of f32)
  static constexpr int VEC = sizeof(KT) == 4 ? 2 : 4 / (int)sizeof(KT);
  static constexpr int NCV = D / VEC;               // column vectors a row
  static constexpr int SLOTS = NT / NCV;            // threads a column vector
  static_assert(D % LPR == 0 && NCV <= NT && NT % NCV == 0, "unsupported head dim");
};

// Shared memory of a float32-sweep block, in bytes, laid out in this order.
struct Smem {
  int kv, scale, q, p, red, ml, table, total;
  __host__ __device__ Smem(int chunk, int G, int D, int kt_bytes, bool int8, int slots,
                           int page_size) {
    kv = chunk * D * kt_bytes;                         // K, then V
    scale = int8 ? chunk * 4 : 0;                      // k scales, then v scales
    q = G * D * 4;                                     // q of the group, f32
    p = G * chunk * 4;                                 // scores, then probabilities
    red = slots * D * 4;                               // P V partial sums
    ml = 2 * G * 4;                                    // the chunk's (m, l) per head
    table = page_size > 0 ? chunk * 4 : 0;             // the paged rows' pool rows
    total = 2 * kv + 2 * scale + q + p + red + ml + table + 16;
  }
};

// The rows of a block: live rows [r0, r1) of chunk c; n_live chunks of the
// sequence hold a live row, from chunk c_lo.  valid == 0: no live key.
struct Span {
  int valid, r0, r1, c_lo, n_live;
  __device__ Span(int valid_len, int capacity, int c, int chunk, int window) {
    valid = valid_len < 0 ? 0 : min(valid_len, capacity);
    // live rows: k_pos < valid and, with a window, k_pos > valid - 1 - window
    const int lo = window > 0 ? max(0, valid - window) : 0;
    r0 = max(c * chunk, lo);
    r1 = min((c + 1) * chunk, valid);
    c_lo = lo / chunk;
    n_live = (valid + chunk - 1) / chunk - c_lo;
  }
};

// After a block of a (batch, kv head) has left its partials (acc records of
// D floats at part, (m, l) pairs at part_ml, for query heads h0 .. h0+G-1 and
// chunks c_lo .. c_lo+n_live-1): true in the last block to arrive, which then
// merges them into ob (G x D) in ascending chunk order and resets the
// counter.  Shared memory: ms, ls (G floats each), wts (G x wmax floats) and
// stage (stage_bytes, at least (MAXH + 2) x D floats).  Every thread of the
// block calls it.
template <typename QT, int D, int NTH>
__device__ void merge_chunks(float* part, float* part_ml, int* cnt, QT* ob, int G, int NC,
                             int64_t rec0, int c_lo, int n_live, float* ms, float* ls,
                             float* wts, int wmax, float* stage, int stage_bytes) {
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(cnt, 1) == n_live - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid == 0) *cnt = 0;               // ready for the next call
  // M and L per head: a warp a head, a lane a chunk; L sums the chunks'
  // l_c exp(m_c - M) in ascending chunk order
  const float* mlb = part_ml + rec0 * 2;
  for (int g = warp; g < G; g += NTH / 32) {
    const float* mlg = mlb + ((int64_t)g * NC + c_lo) * 2;
    float M = NEG;
    for (int x = lane; x < n_live; x += 32) M = fmaxf(M, __ldcg(mlg + 2 * x));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    float Lsum = 0.f;
    for (int x0 = 0; x0 < n_live; x0 += 32) {
      const int x = x0 + lane;
      const float lw = x < n_live ? __ldcg(mlg + 2 * x + 1) * expf(__ldcg(mlg + 2 * x) - M) : 0.f;
      for (int y = 0; y < 32 && x0 + y < n_live; ++y)
        Lsum += __shfl_sync(0xffffffffu, lw, y);
    }
    if (lane == 0) { ms[g] = M; ls[g] = Lsum; }
  }
  // acc: MAXH x D running sums at the head of the stage, then two halves
  // that take the records of a batch of heads and chunks in turn (cp.async):
  // the next batch lands while this one is summed, in ascending chunk order
  float* accs = stage;
  const int R = (stage_bytes / 4 - MAXH * D) / (2 * D);   // records a half holds
  const int wb = min(min(n_live, R), wmax);               // chunks a batch
  const int hb = max(1, min(min(G, MAXH), R / wb));       // heads a batch
  const int n_cb = (n_live + wb - 1) / wb, n_rounds = n_cb * ((G + hb - 1) / hb);
  const float* accb = part + rec0 * D;
  auto issue = [&](int r) {             // round r: heads h0 .. , chunks cb ..
    const int h0 = r / n_cb * hb, cb = r % n_cb * wb;
    const int nh = min(hb, G - h0), nb = min(wb, n_live - cb);
    float* recs = stage + MAXH * D + (r & 1) * R * D;
    for (int i = tid; i < nh * nb * (D / 4); i += NTH) {
      const int rr = i / (D / 4), pc = i - rr * (D / 4);
      const int hh = rr / nb, x = rr - hh * nb;
      cp_async16(smem_u32(recs + rr * D + pc * 4),
                 accb + ((int64_t)(h0 + hh) * NC + c_lo + cb + x) * D + pc * 4);
    }
    cp_async_commit();
  };
  __syncthreads();                      // M is set
  issue(0);
  for (int r = 0; r < n_rounds; ++r) {
    const int h0 = r / n_cb * hb, cb = r % n_cb * wb;
    const int nh = min(hb, G - h0), nb = min(wb, n_live - cb);
    if (r + 1 < n_rounds) {
      issue(r + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    for (int i = tid; i < nh * nb; i += NTH) {
      const int hh = i / nb, x = i - hh * nb;
      wts[hh * wb + x] = expf(__ldcg(mlb + ((int64_t)(h0 + hh) * NC + c_lo + cb + x) * 2) -
                              ms[h0 + hh]);
    }
    __syncthreads();                    // this round's records and weights are in
    const float* recs = stage + MAXH * D + (r & 1) * R * D;
    for (int i = tid; i < nh * D; i += NTH) {       // a thread keeps its outputs
      const int hh = i / D, d = i - hh * D;
      const float* rx = recs + hh * nb * D + d;
      const float* wx = wts + hh * wb;
      float a = cb ? accs[i] : 0.f;
#pragma unroll 4
      for (int x = 0; x < nb; ++x) a = fmaf(rx[x * D], wx[x], a);
      if (cb + nb < n_live) {
        accs[i] = a;
      } else {
        ob[h0 * D + i] = from_f32<QT>(a / fmaxf(ls[h0 + hh], 1e-30f));
      }
    }
    __syncthreads();                    // this half and the weights are free
  }
}

// float32 queries: the CUDA-core sweep.  QT: query/output type; KT: cache
// type (QT, or int8_t with row scales); Rows: ContiguousRows or PagedRows.
// Grid (chunks, Hkv, B).
template <typename QT, typename KT, int D, bool INT8, typename Rows>
__global__ void __launch_bounds__(NT)
decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
              const float* __restrict__ k_scale, const KT* __restrict__ v,
              const float* __restrict__ v_scale, const int* __restrict__ valid_len,
              QT* __restrict__ o, float* __restrict__ part, int* __restrict__ counter,
              const Rows rows_arg, int H, int Hkv, int chunk, int window, int page_size,
              float scale) {
  using S = Shape<KT, D>;
  const int c = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int NC = gridDim.x, G = H / Hkv;
  // the scratch: acc records (B, H, NC, D), then (m, l) pairs (B, H, NC, 2)
  float* part_ml = part + (int64_t)gridDim.z * H * NC * D;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  Rows rows = rows_arg;
  const Span sp(valid_len[b], rows.capacity(), c, chunk, window);
  QT* ob = o + ((int64_t)b * H + (int64_t)hk * G) * D;
  if (sp.valid == 0) {                  // no live key: 0, written by chunk 0
    if (c == 0)
      for (int i = tid; i < G * D; i += NT) ob[i] = from_f32<QT>(0.f);
    return;
  }
  if (sp.r0 >= sp.r1) return;           // no live row in this chunk
  const int r0 = sp.r0, r1 = sp.r1, n = r1 - r0, n_live = sp.n_live;

  const Smem L(chunk, G, D, sizeof(KT), INT8, S::SLOTS,
               std::is_same<Rows, PagedRows>::value ? page_size : 0);
  extern __shared__ __align__(128) unsigned char smem[];
  KT* Ks = reinterpret_cast<KT*>(smem);
  KT* Vs = reinterpret_cast<KT*>(smem + L.kv);
  float* ksc = reinterpret_cast<float*>(smem + 2 * L.kv);
  float* vsc = ksc + (INT8 ? chunk : 0);
  float* qs = reinterpret_cast<float*>(smem + 2 * L.kv + 2 * L.scale);
  float* ps = qs + G * D;
  float* red = ps + G * chunk;
  float* ms = red + S::SLOTS * D;
  float* ls = ms + G;
  int* tbl = reinterpret_cast<int*>(ls + G);

  rows.setup(b, r0, r1, tbl);

  // copy the live rows: K and its scales, then V and its scales
  constexpr int PPR = D * (int)sizeof(KT) / 16;     // 16-byte pieces a row
  const int64_t kv_row = (int64_t)Hkv * D;
  const uint32_t ks_u = smem_u32(Ks), vs_u = smem_u32(Vs);
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const KT* src = (pass ? v : k) + (int64_t)hk * D;
    const uint32_t dst = pass ? vs_u : ks_u;
    for (int i = tid; i < n * PPR; i += NT) {
      const int j = i / PPR, pc = i - j * PPR;
      cp_async16(dst + (j * PPR + pc) * 16, src + rows.row(r0 + j) * kv_row + pc * (16 / sizeof(KT)));
    }
    if (INT8) {
      const float* sc = (pass ? v_scale : k_scale) + hk;
      float* sdst = pass ? vsc : ksc;
      for (int j = tid; j < n; j += NT) cp_async4(smem_u32(sdst + j), sc + rows.row(r0 + j) * Hkv);
    }
    cp_async_commit();
  }

  // the group's query rows, f32
  const QT* qb = q + ((int64_t)b * H + (int64_t)hk * G) * D;
  constexpr int QV = 16 / (int)sizeof(QT);          // q values a 16-byte load
  for (int i = tid; i < G * D / QV; i += NT) {
    float x[QV];
    load_f32<QT, QV>(qb + i * QV, x);
#pragma unroll
    for (int e = 0; e < QV; ++e) qs[i * QV + e] = x[e];
  }
  cp_async_wait<1>();                   // K has landed
  __syncthreads();

  // scores: LPR lanes a row, HU heads at a time with their q slices in
  // registers; s = (q . k) * scale in f32
  {
    const int rg = tid / S::LPR, gl = tid % S::LPR;
    for (int g0 = 0; g0 < G; g0 += HU) {
      float qr[HU][S::EPL];
#pragma unroll
      for (int u = 0; u < HU; ++u) {
        if (g0 + u < G) {                         // uniform over the block
          load_f32<float, S::EPL>(qs + (g0 + u) * D + gl * S::EPL, qr[u]);
        } else {
#pragma unroll
          for (int e = 0; e < S::EPL; ++e) qr[u][e] = 0.f;
        }
      }
      for (int jb = 0; jb < n; jb += S::NRG) {   // uniform over the warp
        const int j = jb + rg;
        float kk[S::EPL];
        if (j < n) {
          load_f32<KT, S::EPL>(Ks + j * D + gl * S::EPL, kk);
          if (INT8) {
            const float sk = ksc[j];
#pragma unroll
            for (int e = 0; e < S::EPL; ++e) kk[e] *= sk;
          }
        } else {
#pragma unroll
          for (int e = 0; e < S::EPL; ++e) kk[e] = 0.f;
        }
        float s[HU];
#pragma unroll
        for (int u = 0; u < HU; ++u) {
          s[u] = 0.f;
#pragma unroll
          for (int e = 0; e < S::EPL; ++e) s[u] = fmaf(qr[u][e], kk[e], s[u]);
        }
#pragma unroll
        for (int off = S::LPR / 2; off > 0; off >>= 1)
#pragma unroll
          for (int u = 0; u < HU; ++u)
            if (g0 + u < G) s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
        if (gl == 0 && j < n)
#pragma unroll
          for (int u = 0; u < HU; ++u)
            if (g0 + u < G) ps[(g0 + u) * chunk + j] = s[u] * scale;
      }
    }
  }
  __syncthreads();

  // the chunk's softmax per head: a warp a head
  for (int g = warp; g < G; g += NT / 32) {
    float* pg = ps + g * chunk;
    float mx = NEG;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, pg[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(pg[j] - mx);
      pg[j] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) { ms[g] = mx; ls[g] = sum; }
  }
  cp_async_wait<0>();                   // V has landed
  __syncthreads();

  // acc[g][d] = sum_j p[g][j] v[j][d]: thread (column vector cv, slot);
  // slots split the heads, and the rows too when the heads are fewer
  const int cv = tid % S::NCV, slot = tid / S::NCV;
  const int HS = min(G, S::SLOTS), RS = S::SLOTS / HS;
  const int hs = slot % HS, rs = slot / HS;
  const int seg = ((n + RS - 1) / RS + 3) & ~3;       // rows a slot, from a multiple of 4
  const int j0 = min(n, rs * seg), j1 = min(n, j0 + seg);
  const bool merge = n_live > 1;
  for (int g0 = hs; g0 < G; g0 += HS * MAXH) {      // heads g0, g0 + HS, ...
    float acc[MAXH][S::VEC];
#pragma unroll
    for (int i = 0; i < MAXH; ++i)
#pragma unroll
      for (int e = 0; e < S::VEC; ++e) acc[i][e] = 0.f;
    if (rs < RS) {
      int j = j0;
      for (; j + 4 <= j1; j += 4) {                 // 4 rows: 4 loads in flight
        float vv[4][S::VEC];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          load_f32<KT, S::VEC>(Vs + (j + r) * D + cv * S::VEC, vv[r]);
          if (INT8) {
            const float sv = vsc[j + r];
#pragma unroll
            for (int e = 0; e < S::VEC; ++e) vv[r][e] *= sv;
          }
        }
#pragma unroll
        for (int i = 0; i < MAXH; ++i) {
          const int g = g0 + i * HS;
          if (g < G) {
            const float4 p4 = *reinterpret_cast<const float4*>(ps + g * chunk + j);
            const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int e = 0; e < S::VEC; ++e) acc[i][e] = fmaf(p[r], vv[r][e], acc[i][e]);
          }
        }
      }
      for (; j < j1; ++j) {
        float vv[S::VEC];
        load_f32<KT, S::VEC>(Vs + j * D + cv * S::VEC, vv);
        if (INT8) {
          const float sv = vsc[j];
#pragma unroll
          for (int e = 0; e < S::VEC; ++e) vv[e] *= sv;
        }
#pragma unroll
        for (int i = 0; i < MAXH; ++i) {
          const int g = g0 + i * HS;
          if (g < G) {
            const float p = ps[g * chunk + j];
#pragma unroll
            for (int e = 0; e < S::VEC; ++e) acc[i][e] = fmaf(p, vv[e], acc[i][e]);
          }
        }
      }
    }
    // sum the row slices in order, then write out or to the scratch
#pragma unroll
    for (int i = 0; i < MAXH; ++i) {
      if (RS > 1 && i > 0) break;       // RS > 1 only when G < SLOTS: one head a thread
      const int g = g0 + i * HS;
      if (RS > 1) {
        __syncthreads();
        if (g < G && rs < RS)
#pragma unroll
          for (int e = 0; e < S::VEC; ++e) red[(rs * HS + hs) * D + cv * S::VEC + e] = acc[i][e];
        __syncthreads();
        if (rs == 0 && g < G)
#pragma unroll
          for (int e = 0; e < S::VEC; ++e) {
            float a = red[hs * D + cv * S::VEC + e];
            for (int r = 1; r < RS; ++r) a += red[(r * HS + hs) * D + cv * S::VEC + e];
            acc[i][e] = a;
          }
      }
      if (rs != 0 || g >= G) continue;
      const int h = hk * G + g;
      if (!merge) {
        const float inv = 1.f / fmaxf(ls[g], 1e-30f);
#pragma unroll
        for (int e = 0; e < S::VEC; ++e) ob[g * D + cv * S::VEC + e] = from_f32<QT>(acc[i][e] * inv);
      } else {
        const int64_t rec = ((int64_t)b * H + h) * NC + c;
#pragma unroll
        for (int e = 0; e < S::VEC; ++e) part[rec * D + cv * S::VEC + e] = acc[i][e];
        if (cv == 0) { part_ml[2 * rec] = ms[g]; part_ml[2 * rec + 1] = ls[g]; }
      }
    }
  }
  if (!merge) return;
  // the partials of the last block to arrive are merged; the stage is K, V,
  // their scales and q (free now), the weights go where the scores were
  merge_chunks<QT, D, NT>(part, part_ml, counter + (int64_t)b * Hkv + hk, ob, G, NC,
                          ((int64_t)b * H + (int64_t)hk * G) * NC, sp.c_lo, n_live, ms, ls,
                          ps, chunk, reinterpret_cast<float*>(smem), 2 * L.kv + 2 * L.scale + L.q);
}

// bf16 queries: both products on the tensor cores.  KT: __nv_bfloat16, or
// int8_t with row scales, widened to bf16 (exact) one of two ways:
// FRAG = false: an int8 row lands in the upper half of its bf16 row and the
//   tile is widened in place, once, before the products (one query head a kv
//   head or more: the grids of a few blocks an SM, where a block's latency
//   counts);
// FRAG = true: the tile stays int8 (half the shared memory, so more blocks
//   of a long grid are resident) and each B fragment is widened as it is
//   read (one query head a kv head, MHA).
// Grid (chunks, Hkv, B), TNT threads.  Shared memory, in this order: K and V
// rows (bf16 rows of D + 8 values, or int8 rows of D + 16 bytes: 16 bytes of
// pad, so 8 rows read together hit 8 bank groups), the int8 rows' scales, Q
// as bf16 rows of D + 8 (G16 = G padded to 16, pad rows 0), P as f32 rows of
// PSTR, (m, l) per head, the paged table.
struct TcSmem {
  int row, kv, scale, q, p, ml, table, total, pstr, g16;
  __host__ __device__ TcSmem(int chunk, int G, int D, bool int8, bool frag, int page_size) {
    g16 = (G + 15) & ~15;
    pstr = chunk + 4;                                  // f32: 4 banks a row apart
    row = frag ? D + 16 : (D + 8) * 2;                 // bytes a K or V row
    kv = chunk * row;                                  // K, then V
    scale = int8 ? chunk * 4 : 0;                      // k scales, then v scales
    q = g16 * (D + 8) * 2;
    p = g16 * pstr * 4;
    ml = 2 * G * 4;
    table = page_size > 0 ? chunk * 4 : 0;             // the paged rows' pool rows
    total = 2 * kv + 2 * scale + q + p + ml + table;
  }
};

// two int8 values as a packed bf16 pair (exact)
__device__ __forceinline__ uint32_t widen2(int8_t lo, int8_t hi) {
  return bits(__floats2bfloat162_rn((float)lo, (float)hi));
}

template <typename KT, int D, bool INT8, bool FRAG, typename Rows>
__global__ void __launch_bounds__(TNT)
decode_tc_kernel(const __nv_bfloat16* __restrict__ q, const KT* __restrict__ k,
                 const float* __restrict__ k_scale, const KT* __restrict__ v,
                 const float* __restrict__ v_scale, const int* __restrict__ valid_len,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ part,
                 int* __restrict__ counter, const Rows rows_arg, int H, int Hkv, int chunk,
                 int window, int page_size, float scale) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = D + 8, NW = TNT / 32;
  const int c = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int NC = gridDim.x, G = H / Hkv;
  float* part_ml = part + (int64_t)gridDim.z * H * NC * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  Rows rows = rows_arg;
  const Span sp(valid_len[b], rows.capacity(), c, chunk, window);
  bf16* ob = o + ((int64_t)b * H + (int64_t)hk * G) * D;
  if (sp.valid == 0) {                  // no live key: 0, written by chunk 0
    if (c == 0)
      for (int i = tid; i < G * D; i += TNT) ob[i] = __float2bfloat16(0.f);
    return;
  }
  if (sp.r0 >= sp.r1) return;           // no live row in this chunk
  const int r0 = sp.r0, n = sp.r1 - sp.r0, n_live = sp.n_live;

  const TcSmem L(chunk, G, D, INT8, FRAG, std::is_same<Rows, PagedRows>::value ? page_size : 0);
  const int G16 = L.g16, PSTR = L.pstr;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Kb = reinterpret_cast<bf16*>(smem);
  bf16* Vb = reinterpret_cast<bf16*>(smem + L.kv);
  const int8_t* Kr = reinterpret_cast<const int8_t*>(smem);   // FRAG: int8 rows of RS bytes
  const int8_t* Vr = Kr + L.kv;
  constexpr int RS = D + 16;
  float* ksc = reinterpret_cast<float*>(smem + 2 * L.kv);
  float* vsc = ksc + (INT8 ? chunk : 0);
  bf16* Qs = reinterpret_cast<bf16*>(smem + 2 * L.kv + 2 * L.scale);
  float* ps = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(Qs) + L.q);
  float* ms = ps + G16 * PSTR;
  float* ls = ms + G;
  int* tbl = reinterpret_cast<int*>(ls + G);

  rows.setup(b, r0, sp.r1, tbl);

  // copy: K (and its scales), then V, each row into its padded bf16 row (an
  // int8 row into the row's upper D bytes, from byte D + 16); rows past n are
  // zero-filled, not read
  const int64_t kv_row = (int64_t)Hkv * D;
  constexpr int EP = 16 / (int)sizeof(KT), PPR = D / EP;     // 16-byte pieces a row
  constexpr int RAW = INT8 && !FRAG ? D + 16 : 0;            // the row's first byte
  constexpr int ROWB = FRAG ? RS : LD * 2;                   // bytes a row
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const KT* src = (pass ? v : k) + (int64_t)hk * D;
    const uint32_t dst = smem_u32(pass ? Vb : Kb);
    for (int i = tid; i < chunk * PPR; i += TNT) {
      const int j = i / PPR, pc = i - j * PPR;
      const bool in = j < n;
      cp_async16(dst + j * ROWB + RAW + pc * 16,
                 src + (in ? rows.row(r0 + j) * kv_row : 0) + pc * EP, in);
    }
    if (INT8) {
      const float* sc = (pass ? v_scale : k_scale) + hk;
      float* sdst = pass ? vsc : ksc;
      for (int j = tid; j < n; j += TNT) cp_async4(smem_u32(sdst + j), sc + rows.row(r0 + j) * Hkv);
    }
    cp_async_commit();
  }

  // the group's query rows as bf16, rows G .. G16-1 zero; P's pad rows zero
  const bf16* qb = q + ((int64_t)b * H + (int64_t)hk * G) * D;
  for (int i = tid; i < G16 * (D / 8); i += TNT) {
    const int r = i / (D / 8), pc = i - r * (D / 8);
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r < G) x = *reinterpret_cast<const uint4*>(qb + r * D + pc * 8);
    *reinterpret_cast<uint4*>(Qs + r * LD + pc * 8) = x;
  }
  for (int i = G * PSTR + tid; i < G16 * PSTR; i += TNT) ps[i] = 0.f;

  // an int8 tile widened in place, row by row: the D / 16 lanes of a row
  // hold all of it in registers before any of them writes its bf16 values
  auto widen = [&](bf16* base) {
    constexpr int LPR = D / 16, RPW = 32 / LPR;             // lanes a row, rows a warp
    for (int j0 = warp * RPW; j0 < chunk; j0 += NW * RPW) {
      const int j = j0 + lane / LPR, pc = lane % LPR;
      unsigned char* row = reinterpret_cast<unsigned char*>(base + j * LD);
      const uint4 w = *reinterpret_cast<const uint4*>(row + RAW + pc * 16);
      __syncwarp();
      const uint32_t in4[4] = {w.x, w.y, w.z, w.w};
      uint32_t out8[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t u = in4[e] ^ 0x80808080u;
        out8[2 * e] = bits(__floats2bfloat162_rn(byte_to_f32(u, 0x7540), byte_to_f32(u, 0x7541)));
        out8[2 * e + 1] = bits(__floats2bfloat162_rn(byte_to_f32(u, 0x7542), byte_to_f32(u, 0x7543)));
      }
      uint4* d = reinterpret_cast<uint4*>(row + pc * 32);
      d[0] = make_uint4(out8[0], out8[1], out8[2], out8[3]);
      d[1] = make_uint4(out8[4], out8[5], out8[6], out8[7]);
    }
  };
  cp_async_wait<1>();                   // K has landed
  __syncthreads();
  if (INT8 && !FRAG) {
    widen(Kb);
    __syncthreads();
  }

  // S = Q K^T: a warp an 8-key n-tile, 16 heads at a time; s scaled in f32
  // after the product (and by the k row scale); keys past n are not written
  for (int nt = warp; nt < chunk / 8; nt += NW) {
    for (int hg = 0; hg < G16; hg += 16) {
      float sacc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qa[4], kf[2];
        ldsm_x4(qa, smem_u32(Qs + (hg + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8));
        if constexpr (FRAG) {         // b0 (k 2t..2t+1, key g), b1 (k 2t+8..)
          const int8_t* kr = Kr + (nt * 8 + g) * RS + kk * 16 + 2 * t;
          kf[0] = widen2(kr[0], kr[1]);
          kf[1] = widen2(kr[8], kr[9]);
        } else {
          ldsm_x2(kf, smem_u32(Kb + (nt * 8 + (lane & 7)) * LD + kk * 16 + ((lane >> 3) & 1) * 8));
        }
        mma16816(sacc, qa, kf[0], kf[1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = hg + g + (e >> 1) * 8, j = nt * 8 + 2 * t + (e & 1);
        if (hh < G && j < n) ps[hh * PSTR + j] = sacc[e] * scale * (INT8 ? ksc[j] : 1.f);
      }
    }
  }
  cp_async_wait<0>();                   // V has landed
  __syncthreads();
  if (INT8 && !FRAG) widen(Vb);         // read only after the softmax's barrier

  // the chunk's softmax per head (a warp a head); l sums the f32 p; P keeps
  // p, times the v row scale of an int8 cache; keys n .. chunk-1 get 0
  const bool merge = n_live > 1;
  const int64_t rec0 = ((int64_t)b * H + (int64_t)hk * G) * NC;
  for (int hh = warp; hh < G; hh += NW) {
    float* pg = ps + hh * PSTR;
    float mx = NEG;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, pg[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int j = lane; j < chunk; j += 32) {
      const float p = j < n ? expf(pg[j] - mx) : 0.f;
      sum += p;
      pg[j] = INT8 ? p * vsc[j < n ? j : 0] : p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      ms[hh] = mx;
      ls[hh] = sum;
      if (merge) {
        part_ml[2 * (rec0 + (int64_t)hh * NC + c)] = mx;
        part_ml[2 * (rec0 + (int64_t)hh * NC + c) + 1] = sum;
      }
    }
  }
  __syncthreads();

  // O = P V: a warp a pair of 8-column n-tiles, 16 heads at a time; P split
  // into bf16 high and low parts, both multiplied on the tensor cores
  for (int hg = 0; hg < G16; hg += 16) {
    for (int np = warp; np < D / 16; np += NW) {
      float oacc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int ks = 0; ks < chunk / 16; ++ks) {
        const float* p0 = ps + (hg + g) * PSTR + ks * 16 + 2 * t;
        const float* p1 = p0 + 8 * PSTR;
        const float2 x0 = *reinterpret_cast<const float2*>(p0);
        const float2 x1 = *reinterpret_cast<const float2*>(p1);
        const float2 x2 = *reinterpret_cast<const float2*>(p0 + 8);
        const float2 x3 = *reinterpret_cast<const float2*>(p1 + 8);
        uint32_t pa[4], pl[4];
        pa[0] = split_bf16(x0.x, x0.y, pl[0]);
        pa[1] = split_bf16(x1.x, x1.y, pl[1]);
        pa[2] = split_bf16(x2.x, x2.y, pl[2]);
        pa[3] = split_bf16(x3.x, x3.y, pl[3]);
        uint32_t vf[4];
        if constexpr (FRAG) {         // b0 (keys 2t..2t+1, column g), b1 (keys 2t+8..)
          const int8_t* vr = Vr + (ks * 16 + 2 * t) * RS + np * 16 + g;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            vf[2 * i] = widen2(vr[i * 8], vr[RS + i * 8]);
            vf[2 * i + 1] = widen2(vr[8 * RS + i * 8], vr[9 * RS + i * 8]);
          }
        } else {
          ldsm_x4_t(vf, smem_u32(Vb + (ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                                 np * 16 + (lane >> 4) * 8));
        }
        mma16816(oacc[0], pa, vf[0], vf[1]);
        mma16816(oacc[0], pl, vf[0], vf[1]);
        mma16816(oacc[1], pa, vf[2], vf[3]);
        mma16816(oacc[1], pl, vf[2], vf[3]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int hh = hg + g + e2 * 8, col = np * 16 + i * 8 + 2 * t;
          if (hh >= G) continue;
          const float a0 = oacc[i][2 * e2], a1 = oacc[i][2 * e2 + 1];
          if (!merge) {
            const float inv = 1.f / fmaxf(ls[hh], 1e-30f);
            *reinterpret_cast<__nv_bfloat162*>(ob + hh * D + col) =
                __floats2bfloat162_rn(a0 * inv, a1 * inv);
          } else {
            *reinterpret_cast<float2*>(part + (rec0 + (int64_t)hh * NC + c) * D + col) =
                make_float2(a0, a1);
          }
        }
    }
  }
  if (!merge) return;
  // the stage is K, V, their scales and Q (free now); the weights go where P was
  merge_chunks<bf16, D, TNT>(part, part_ml, counter + (int64_t)b * Hkv + hk, ob, G, NC, rec0,
                             sp.c_lo, n_live, ms, ls, ps, chunk, reinterpret_cast<float*>(smem),
                             2 * L.kv + 2 * L.scale + L.q);
}

template <typename QT, typename KT, int D, bool INT8, typename Rows>
cudaError_t launch(const void* q, const void* k, const float* ks, const void* v,
                   const float* vs, const int* valid, void* o, float* part, int* counter,
                   int B, Rows rows, int page_size, int H, int Hkv, int chunk, int window,
                   cudaStream_t stream) {
  const int G = H / Hkv;
  const int paged_ps = std::is_same<Rows, PagedRows>::value ? page_size : 0;
  constexpr bool TC = std::is_same<QT, __nv_bfloat16>::value;
  const bool frag = INT8 && G == 1;
  const int smem = TC ? TcSmem(chunk, G, D, INT8, frag, paged_ps).total
                      : Smem(chunk, G, D, sizeof(KT), INT8, Shape<KT, D>::SLOTS, paged_ps).total;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  const int NC = (rows.capacity() + chunk - 1) / chunk;
  dim3 grid(NC, Hkv, B);
  const float scale = (float)(1.0 / sqrt((double)D));   // as the f32 of 1/math.sqrt(D)
  if constexpr (TC) {
    auto kernel = decode_tc_kernel<KT, D, INT8, false, Rows>;
    if constexpr (INT8) {
      if (frag) kernel = decode_tc_kernel<KT, D, true, true, Rows>;
    }
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, TNT, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const KT*>(k), ks,
        static_cast<const KT*>(v), vs, valid, static_cast<__nv_bfloat16*>(o), part, counter,
        rows, H, Hkv, chunk, window, page_size, scale);
  } else {
    const auto kernel = decode_kernel<QT, KT, D, INT8, Rows>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, NT, smem, stream>>>(
        static_cast<const QT*>(q), static_cast<const KT*>(k), ks, static_cast<const KT*>(v), vs,
        valid, static_cast<QT*>(o), part, counter, rows, H, Hkv, chunk, window, page_size,
        scale);
  }
  return cudaGetLastError();
}

template <typename QT, typename KT, bool INT8, typename Rows>
cudaError_t dispatch_d(const void* q, const void* k, const float* ks, const void* v,
                       const float* vs, const int* valid, void* o, float* part, int* counter,
                       int B, Rows rows, int page_size, int H, int Hkv, int D, int chunk,
                       int window, cudaStream_t s) {
  switch (D) {
    case 16: return launch<QT, KT, 16, INT8>(q, k, ks, v, vs, valid, o, part, counter, B, rows, page_size, H, Hkv, chunk, window, s);
    case 32: return launch<QT, KT, 32, INT8>(q, k, ks, v, vs, valid, o, part, counter, B, rows, page_size, H, Hkv, chunk, window, s);
    case 64: return launch<QT, KT, 64, INT8>(q, k, ks, v, vs, valid, o, part, counter, B, rows, page_size, H, Hkv, chunk, window, s);
    case 128: return launch<QT, KT, 128, INT8>(q, k, ks, v, vs, valid, o, part, counter, B, rows, page_size, H, Hkv, chunk, window, s);
    case 256: return launch<QT, KT, 256, INT8>(q, k, ks, v, vs, valid, o, part, counter, B, rows, page_size, H, Hkv, chunk, window, s);
    default: return cudaErrorInvalidValue;
  }
}

// dtype (of q, o and a native cache): 0 = float32, 1 = bfloat16.
template <bool INT8, typename Rows>
int dispatch(const void* q, const void* k, const float* ks, const void* v,
             const float* vs, const int* valid, void* o, float* part, int* counter, int B,
             Rows rows, int page_size, int H, int Hkv, int D, int chunk, int window,
             int dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || chunk <= 0 || chunk % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    using KT = typename std::conditional<INT8, int8_t, float>::type;
    return (int)dispatch_d<float, KT, INT8>(q, k, ks, v, vs, valid, o, part, counter, B, rows,
                                            page_size, H, Hkv, D, chunk, window, s);
  }
  if (dtype == 1) {
    using KT = typename std::conditional<INT8, int8_t, __nv_bfloat16>::type;
    return (int)dispatch_d<__nv_bfloat16, KT, INT8>(q, k, ks, v, vs, valid, o, part, counter,
                                                    B, rows, page_size, H, Hkv, D, chunk,
                                                    window, s);
  }
  return (int)cudaErrorInvalidValue;
}

PagedRows paged_rows(const int* table, int NP, int page_size) {
  return PagedRows{table, NP, page_size, nullptr, 0};
}

}  // namespace

// Every entry takes the split: part, an f32 scratch of B * H * n_chunks *
// (D + 2) values (n_chunks = ceil(capacity / chunk); the (B, H, n_chunks, D)
// acc records, then the (B, H, n_chunks, 2) (m, l) pairs), and counter, B * Hkv
// ints that are 0 before the call and are 0 again after it.  window <= 0: no
// window.  Each entry returns the cudaError_t of the launch.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const int* valid, void* o, float* part, int* counter,
                                      int B, int Skv, int H, int Hkv, int D, int chunk,
                                      int window, int dtype, void* stream) {
  if (Skv <= 0) return (int)cudaErrorInvalidValue;
  return dispatch<false>(q, k, nullptr, v, nullptr, valid, o, part, counter, B,
                         ContiguousRows{Skv, 0}, 0, H, Hkv, D, chunk, window, dtype, stream);
}

// k/v int8 (B, Skv, Hkv, D); k_scale/v_scale f32 (B, Skv, Hkv, 1).
extern "C" int repro_decode_attention_int8(const void* q, const void* k,
                                           const float* k_scale, const void* v,
                                           const float* v_scale, const int* valid,
                                           void* o, float* part, int* counter, int B,
                                           int Skv, int H, int Hkv, int D, int chunk,
                                           int window, int dtype, void* stream) {
  if (Skv <= 0) return (int)cudaErrorInvalidValue;
  return dispatch<true>(q, k, k_scale, v, v_scale, valid, o, part, counter, B,
                        ContiguousRows{Skv, 0}, 0, H, Hkv, D, chunk, window, dtype, stream);
}

// k/v pages (P, page_size, Hkv, D) of the pool; table (B, NP) int32 page ids,
// read only for the pages that hold live rows.
extern "C" int repro_paged_decode_attention(const void* q, const void* k_pages,
                                            const void* v_pages, const int* table,
                                            const int* valid, void* o, float* part,
                                            int* counter, int B, int NP, int page_size,
                                            int H, int Hkv, int D, int chunk, int window,
                                            int dtype, void* stream) {
  if (NP <= 0 || page_size <= 0) return (int)cudaErrorInvalidValue;
  return dispatch<false>(q, k_pages, nullptr, v_pages, nullptr, valid, o, part, counter, B,
                         paged_rows(table, NP, page_size), page_size, H, Hkv, D, chunk,
                         window, dtype, stream);
}

// int8 pages (P, page_size, Hkv, D) + f32 row scales (P, page_size, Hkv, 1).
extern "C" int repro_paged_decode_attention_int8(
    const void* q, const void* k_pages, const float* k_scales, const void* v_pages,
    const float* v_scales, const int* table, const int* valid, void* o, float* part,
    int* counter, int B, int NP, int page_size, int H, int Hkv, int D, int chunk,
    int window, int dtype, void* stream) {
  if (NP <= 0 || page_size <= 0) return (int)cudaErrorInvalidValue;
  return dispatch<true>(q, k_pages, k_scales, v_pages, v_scales, valid, o, part, counter, B,
                        paged_rows(table, NP, page_size), page_size, H, Hkv, D, chunk,
                        window, dtype, stream);
}
