// Batched piecewise-polynomial queries on Hopper (sm_90a).
//
// Launchers with a plain C interface, bound with ctypes by
// repro_torch/kernels/ppoly_eval/kernel.py:
//
//   ppoly_eval_vec_launch        replace repro/kernels/ppoly_eval/kernel.py
//   ppoly_eval_launch              ppoly_eval_pallas (_ppoly_kernel/_eval_one)
//   ppoly_min_eval_vec_launch    replace ppoly_min_eval_pallas
//   ppoly_min_eval_launch          (_ppoly_min_kernel)
//   ppoly_first_crossing_row_launch  replace ppoly_first_crossing_pallas
//   ppoly_first_crossing_launch        (_first_crossing_kernel with
//                                      ref.first_crossing_candidates)
//
// What bounds them: all are memory-bound on this card.  A query reads one
// float32 (q or y) and writes one or two (value, argmin); the piece tables
// are small (P*(1+K) floats per function and row).  At the analysis path's
// shape (B = 10,000, T = 1024, P = 9, K = 3) ppoly_eval moves 83.4 MB, about
// 25 us at 3.35 TB/s, while its float32 work is about 0.2 GFLOP, about 3 us
// at 67 TFLOP/s; ppoly_min_eval at F = 2 moves 126 MB, about 38 us.
//
// Two routes for evaluation and for the minimum, chosen by shape alone:
//
// * "vec" (P <= 16, K <= 3, F <= 4; every call of the analysis path).  The
//   card has to keep about 18 KB of loads in flight on each SM to reach its
//   memory rate (3.35 TB/s times about 0.7 us of latency, over 132 SMs), and
//   no second latency may stand in series with the first.  So one warp takes
//   one row and a span of up to 256 of its queries: each lane issues two
//   16-byte loads of q (ld.global.nc, no L1 allocation: the data is touched
//   once) before anything else, 1 KB a warp: about 48 KB an SM for the
//   evaluation (40 registers a thread) and 28 KB for the minimum (72, its 9
//   running minima and argmins); then it loads the row's tables into the
//   warp's own slice of shared memory (__syncwarp, no block barrier), so
//   both loads are in flight together.  The starts sit in registers
//   (templated on P and K, so the count is unrolled); the chosen piece's
//   start and coefficients are read from shared memory by index (conflict-
//   free: K is 1, 2 or 3 and P <= 16).  Results leave as 16-byte streaming
//   stores (st.global.cs).  A row whose first query is not 16-byte aligned
//   (T % 4 != 0) has a scalar head of up to 3 queries and a scalar tail of up
//   to 3, taken by lanes of the row's first warp; the wrapper gives the
//   outputs the alignment of q.  Blocks of 4 warps, one warp per (row, span):
//   10,000 blocks at the analysis path's shape.  (Four or eight loads a
//   lane, or blocks of 8 warps, measured slower:
//   kernels/ppoly_eval/variants.py.)  That more loads in flight buy nothing
//   points at the arithmetic for what is left to the bound: the count of
//   starts costs about two instructions a piece and a query, and each warp
//   computes between its loads and its stores.
// * "tile" (the rest: P up to 64, F up to 6 in the checks): the first
//   design.  One thread per (b, t) query, blocks of 4 rows x 128 queries
//   that stage their rows' piece tables in shared memory behind a block
//   barrier, then load q.
//
// The two routes of the evaluation and the minimum select the piece by
// counting `start <= t` over all P pieces, exactly as the reference does,
// so duplicate starts (jumps) resolve to the same piece; then run Horner on
// that one piece; the minimum skips absent slots (first start >= 5e29) and
// keeps the lowest slot on ties (strict <).  The two routes therefore give
// the same bits.  The TPU kernel's one-hot masked Horner and its 8 x 128
// blocks are not carried over: they exist for the TPU's vector lanes.
//
// The first crossing has two routes, chosen by shape alone (P, K, T):
//
// * "row" (P <= 16, K <= 3, few levels a row; the analysis path asks for one
//   level a row, T = 1).  There the work is a few hundred bytes a row and
//   the time is one launch and one DRAM round trip, so the design keeps
//   every thread busy and puts nothing in series with the loads: one thread
//   per (row, piece), 16 lanes a row, two rows a warp, blocks of 8 rows.
//   Each thread issues its independent loads first (its start, its K
//   coefficients, one level of its row), takes the next start from its
//   neighbour by a shuffle, computes its piece's candidate, and the 16 lanes
//   take their minimum by xor shuffles; one lane stores.  No shared memory,
//   no barrier.  More levels a row loop in chunks of 16, one level a lane,
//   each broadcast from its lane by a shuffle.
// * "tile" (the rest: P > 16, or more than 16 levels a row, one pass of the
//   row route; its serial loop over the levels loses to this one from 32
//   levels on): the first design, one thread per (b, t) level, P up to any
//   size the shared memory takes.  It is the oracle of the row route.
//
// Both fold the same candidates with fminf, seeded with kBig; the
// candidates are never NaN (a NaN start is a padding piece, and every other
// NaN fails its comparison and yields kBig), so the order of the fold does
// not change the result and the two routes give the same bits.
//
// Arithmetic: built without fast math and with -fmad=false, so every
// multiply and add rounds as in the plain PyTorch version, division and sqrt
// are IEEE, and the crossing thresholds (c0 >= y - tol, u <= plen) compare
// the same numbers.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr float kPadStart = 1e30f;
constexpr float kPadHalf = 5e29f;   // PAD_START * 0.5: absent-slot threshold
constexpr float kBig = 3e37f;       // "+inf" that survives float32 arithmetic
constexpr int kQueries = 128;       // queries (threads along x) per block
constexpr int kMaxRows = 4;         // rows (threads along y) per block
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

// Cooperative copy of n contiguous floats from global to shared memory.
__device__ inline void stage(float* dst, const float* src, long long n) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (long long i = tid; i < n; i += nthreads) dst[i] = src[i];
}

// Piece index of t: (number of starts <= t) - 1, clamped at 0.
__device__ inline int piece_index(const float* s, int P, float t) {
  int cnt = 0;
  for (int p = 0; p < P; ++p) cnt += (s[p] <= t) ? 1 : 0;
  return cnt > 0 ? cnt - 1 : 0;
}

// Horner on one piece's K ascending coefficients, local coordinate u.
__device__ inline float horner(const float* c, int K, float u) {
  float acc = 0.0f;
  for (int k = K - 1; k >= 0; --k) acc = acc * u + c[k];
  return acc;
}

__global__ void ppoly_eval_kernel(const float* __restrict__ starts,
                                  const float* __restrict__ coeffs,
                                  const float* __restrict__ q,
                                  float* __restrict__ out,
                                  int B, int P, int K, int T) {
  extern __shared__ float smem[];
  const int rows = blockDim.y;
  const int b0 = blockIdx.x * rows;
  const int nrows = min(rows, B - b0);
  float* s_sh = smem;                       // (rows, P)
  float* c_sh = smem + rows * P;            // (rows, P, K)
  stage(s_sh, starts + (long long)b0 * P, (long long)nrows * P);
  stage(c_sh, coeffs + (long long)b0 * P * K, (long long)nrows * P * K);
  __syncthreads();

  const int r = threadIdx.y;
  const int b = b0 + r;
  const int j = blockIdx.y * kQueries + threadIdx.x;
  if (r >= nrows || j >= T) return;
  const float* s = s_sh + r * P;
  const float t = q[(long long)b * T + j];
  const int idx = piece_index(s, P, t);
  out[(long long)b * T + j] = horner(c_sh + ((long long)r * P + idx) * K, K,
                                     t - s[idx]);
}

__global__ void ppoly_min_eval_kernel(const float* __restrict__ starts,
                                      const float* __restrict__ coeffs,
                                      const float* __restrict__ q,
                                      float* __restrict__ vals,
                                      int* __restrict__ arg,
                                      int B, int F, int P, int K, int T) {
  extern __shared__ float smem[];
  const int rows = blockDim.y;
  const int b0 = blockIdx.x * rows;
  const int nrows = min(rows, B - b0);
  float* s_sh = smem;                       // (rows, F, P)
  float* c_sh = smem + rows * F * P;        // (rows, F, P, K)
  stage(s_sh, starts + (long long)b0 * F * P, (long long)nrows * F * P);
  stage(c_sh, coeffs + (long long)b0 * F * P * K,
        (long long)nrows * F * P * K);
  __syncthreads();

  const int r = threadIdx.y;
  const int b = b0 + r;
  const int j = blockIdx.y * kQueries + threadIdx.x;
  if (r >= nrows || j >= T) return;
  const float t = q[(long long)b * T + j];
  float best = kBig;
  int best_f = 0;
  for (int f = 0; f < F; ++f) {
    const float* s = s_sh + ((long long)r * F + f) * P;
    if (!(s[0] < kPadHalf)) continue;       // absent slot
    const int idx = piece_index(s, P, t);
    const float v = horner(c_sh + (((long long)r * F + f) * P + idx) * K, K,
                           t - s[idx]);
    if (v < best) {                         // strict: ties keep the lowest f
      best = v;
      best_f = f;
    }
  }
  vals[(long long)b * T + j] = best;
  arg[(long long)b * T + j] = best_f;
}

// First-crossing candidate of one piece: ref.first_crossing_candidates,
// operation for operation.
__device__ inline float crossing_candidate(float s, float c0, float c1,
                                           float c2, float plen, float y,
                                           float tol) {
  const float lvl = y - tol;
  float cand = (c0 >= lvl) ? s : kBig;
  const bool below = c0 < lvl;
  // an increasing linear piece crosses y before its end
  const float u = (y - c0) / ((c1 > 0.0f) ? c1 : 1.0f);
  const bool ok = (c2 == 0.0f) && (c1 > 0.0f) && below && (u <= plen);
  cand = fminf(cand, ok ? s + u : kBig);
  // a quadratic piece crosses y before its end (stable q-branch roots)
  const float b = c1;
  const float c = c0 - y;
  const float disc = b * b - 4.0f * c2 * c;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float qm = -0.5f * (b + ((b >= 0.0f) ? sq : -sq));
  float r1 = qm / ((c2 != 0.0f) ? c2 : 1.0f);
  float r2 = c / ((qm != 0.0f) ? qm : 1.0f);
  r1 = (r1 >= 0.0f) ? r1 : kBig;
  r2 = ((qm != 0.0f) && (r2 >= 0.0f)) ? r2 : kBig;
  const float uq = fminf(r1, r2);
  const bool okq = (c2 != 0.0f) && (disc >= 0.0f) && below && (uq <= plen);
  return fminf(cand, okq ? s + uq : kBig);
}

__global__ void ppoly_first_crossing_kernel(const float* __restrict__ starts,
                                            const float* __restrict__ coeffs,
                                            const float* __restrict__ y,
                                            float* __restrict__ out,
                                            int B, int P, int K, int T) {
  extern __shared__ float smem[];
  const int rows = blockDim.y;
  const int b0 = blockIdx.x * rows;
  const int nrows = min(rows, B - b0);
  float* s_sh = smem;                       // (rows, P)
  float* c_sh = smem + rows * P;            // (rows, P, K)
  stage(s_sh, starts + (long long)b0 * P, (long long)nrows * P);
  stage(c_sh, coeffs + (long long)b0 * P * K, (long long)nrows * P * K);
  __syncthreads();

  const int r = threadIdx.y;
  const int b = b0 + r;
  const int j = blockIdx.y * kQueries + threadIdx.x;
  if (r >= nrows || j >= T) return;
  const float* s = s_sh + r * P;
  const float* c = c_sh + (long long)r * P * K;
  const float yv = y[(long long)b * T + j];
  const float tol = 1e-6f * fmaxf(1.0f, fabsf(yv));
  float best = kBig;
  for (int p = 0; p < P; ++p) {
    const float sp = s[p];
    if (!(sp < kPadHalf)) continue;         // padding piece
    const float nxt = (p + 1 < P) ? s[p + 1] : kPadStart;
    const float* cp = c + (long long)p * K;
    const float c1 = K > 1 ? cp[1] : 0.0f;
    const float c2 = K > 2 ? cp[2] : 0.0f;
    best = fminf(best, crossing_candidate(sp, cp[0], c1, c2, nxt - sp, yv,
                                          tol));
  }
  out[(long long)b * T + j] = best;
}

// ---------------------------------------------------------- "vec" route ----
constexpr int kVecWarps = 4;              // warps per block, one (row, span) each
constexpr int kVecLoads = 2;              // 16-byte q loads per lane per span
constexpr int kSpan4 = 32 * kVecLoads;    // float4s of one row per warp (256 queries)
constexpr int kVecQ = 4 * kVecLoads + 1;  // queries per lane: vector, then one scalar
constexpr int kVecMaxP = 16;
constexpr int kVecMaxF = 4;

__device__ __forceinline__ float4 load_stream4(const float4* p) {
  float4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ float load_stream(const float* p) {
  float v;
  asm volatile("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ float lane_of(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// One warp's share of a row: float4s [i0, i0 + kSpan4) of the row's aligned
// body and, in the row's first span, one scalar query of the head or the
// tail for lanes 0-2 and 4-6.
struct Span {
  long long off;  // b * T: the row's first query
  int head;       // scalar queries before the row's first 16-byte boundary
  int n4;         // float4s in the aligned body
  int i0;         // this span's first float4
  int js;         // this lane's scalar query (column), or -1
};

__device__ __forceinline__ Span span_of(const float* q, int b, int u, int T,
                                        int lane) {
  Span sp;
  sp.off = (long long)b * T;
  const int mis = (int)((reinterpret_cast<uintptr_t>(q + sp.off) >> 2) & 3);
  sp.head = min(T, (4 - mis) & 3);
  sp.n4 = (T - sp.head) >> 2;
  const int tail = (T - sp.head) & 3;
  sp.i0 = u * kSpan4;
  sp.js = -1;
  if (u == 0) {
    if (lane < sp.head) {
      sp.js = lane;
    } else if (lane >= 4 && lane < 4 + tail) {
      sp.js = sp.head + 4 * sp.n4 + (lane - 4);
    }
  }
  return sp;
}

// Every q load of the lane, issued before anything else of the warp.
__device__ __forceinline__ void load_queries(const float* q, const Span& sp,
                                             int lane,
                                             float4 (&qv)[kVecLoads],
                                             float& qs) {
  const float4* q4 = reinterpret_cast<const float4*>(q + sp.off + sp.head);
#pragma unroll
  for (int v = 0; v < kVecLoads; ++v) {
    const int i = sp.i0 + v * 32 + lane;
    qv[v] = i < sp.n4 ? load_stream4(q4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  qs = sp.js >= 0 ? load_stream(q + sp.off + sp.js) : 0.0f;
}

// The row's n_s starts, then its n_c coefficients, into the warp's slice of
// shared memory (at most N floats): all loads first, then the stores, then
// a warp barrier.  Issued after the q loads, so both are in flight at once.
template <int N>
__device__ __forceinline__ void stage_row(float* tab,
                                          const float* __restrict__ s, int n_s,
                                          const float* __restrict__ c, int n_c,
                                          int lane) {
  constexpr int kPerLane = (N + 31) / 32;
  float r[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int i = lane + 32 * j;
    r[j] = i < n_s ? __ldg(s + i) : (i < n_s + n_c ? __ldg(c + (i - n_s)) : 0.0f);
  }
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int i = lane + 32 * j;
    if (i < n_s + n_c) tab[i] = r[j];
  }
  __syncwarp();
}

// Value at t of one function: its P starts in registers (s) and in shared
// memory (tab_s), its coefficients in shared memory (tab_c, P x K).  The
// piece is the count of starts <= t, less one, at least 0; then Horner.
template <int P, int K>
__device__ __forceinline__ float piece_value(const float (&s)[P],
                                             const float* tab_s,
                                             const float* tab_c, float t) {
  int cnt = 0;
#pragma unroll
  for (int p = 0; p < P; ++p) cnt += (s[p] <= t) ? 1 : 0;
  const int idx = cnt > 0 ? cnt - 1 : 0;
  const float u = t - tab_s[idx];
  const float* c = tab_c + idx * K;
  float acc = 0.0f;
#pragma unroll
  for (int k = K - 1; k >= 0; --k) acc = acc * u + c[k];
  return acc;
}

// Warp w of the grid takes row w / spans, span w % spans.
__device__ __forceinline__ bool warp_span(int B, int spans, int* b, int* u) {
  const long long w = (long long)blockIdx.x * kVecWarps + (threadIdx.x >> 5);
  if (w >= (long long)B * spans) return false;
  *b = (int)(w / spans);
  *u = (int)(w - (long long)*b * spans);
  return true;
}

template <int P, int K>
__global__ void __launch_bounds__(kVecWarps * 32)
ppoly_eval_vec_kernel(const float* __restrict__ starts,
                      const float* __restrict__ coeffs,
                      const float* __restrict__ q, float* __restrict__ out,
                      int B, int T, int spans) {
  __shared__ float table[kVecWarps][P * (1 + K)];
  int b, u;
  if (!warp_span(B, spans, &b, &u)) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const Span sp = span_of(q, b, u, T, lane);
  float4 qv[kVecLoads];
  float qs;
  load_queries(q, sp, lane, qv, qs);
  float* tab = table[threadIdx.x >> 5];
  stage_row<P * (1 + K)>(tab, starts + (long long)b * P, P,
                         coeffs + (long long)b * P * K, P * K, lane);
  float s[P];
#pragma unroll
  for (int p = 0; p < P; ++p) s[p] = tab[p];
  const float* tc = tab + P;
  float4* o4 = reinterpret_cast<float4*>(out + sp.off + sp.head);
#pragma unroll
  for (int v = 0; v < kVecLoads; ++v) {
    const int i = sp.i0 + v * 32 + lane;
    if (i < sp.n4) {
      float4 r;
      r.x = piece_value<P, K>(s, tab, tc, qv[v].x);
      r.y = piece_value<P, K>(s, tab, tc, qv[v].y);
      r.z = piece_value<P, K>(s, tab, tc, qv[v].z);
      r.w = piece_value<P, K>(s, tab, tc, qv[v].w);
      __stcs(o4 + i, r);
    }
  }
  if (sp.js >= 0) __stcs(out + sp.off + sp.js, piece_value<P, K>(s, tab, tc, qs));
}

template <int P, int K>
__global__ void __launch_bounds__(kVecWarps * 32)
ppoly_min_eval_vec_kernel(const float* __restrict__ starts,
                          const float* __restrict__ coeffs,
                          const float* __restrict__ q,
                          float* __restrict__ vals, int* __restrict__ arg,
                          int B, int F, int T, int spans) {
  __shared__ float table[kVecWarps][kVecMaxF * P * (1 + K)];
  int b, u;
  if (!warp_span(B, spans, &b, &u)) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const Span sp = span_of(q, b, u, T, lane);
  float4 qv[kVecLoads];
  float qs;
  load_queries(q, sp, lane, qv, qs);
  float* tab = table[threadIdx.x >> 5];
  stage_row<kVecMaxF * P * (1 + K)>(tab, starts + (long long)b * F * P, F * P,
                                    coeffs + (long long)b * F * P * K,
                                    F * P * K, lane);
  float best[kVecQ];
  int who[kVecQ];
#pragma unroll
  for (int j = 0; j < kVecQ; ++j) {
    best[j] = kBig;
    who[j] = 0;
  }
  for (int f = 0; f < F; ++f) {
    const float* ts = tab + f * P;
    if (!(ts[0] < kPadHalf)) continue;      // absent slot (the whole warp)
    const float* tc = tab + F * P + f * P * K;
    float s[P];
#pragma unroll
    for (int p = 0; p < P; ++p) s[p] = ts[p];
#pragma unroll
    for (int j = 0; j < 4 * kVecLoads; ++j) {
      const float v = piece_value<P, K>(s, ts, tc, lane_of(qv[j / 4], j % 4));
      if (v < best[j]) {                    // strict: ties keep the lowest f
        best[j] = v;
        who[j] = f;
      }
    }
    if (sp.js >= 0) {
      const float v = piece_value<P, K>(s, ts, tc, qs);
      if (v < best[kVecQ - 1]) {
        best[kVecQ - 1] = v;
        who[kVecQ - 1] = f;
      }
    }
  }
  float4* v4 = reinterpret_cast<float4*>(vals + sp.off + sp.head);
  int4* a4 = reinterpret_cast<int4*>(arg + sp.off + sp.head);
#pragma unroll
  for (int v = 0; v < kVecLoads; ++v) {
    const int i = sp.i0 + v * 32 + lane;
    if (i < sp.n4) {
      __stcs(v4 + i, make_float4(best[4 * v], best[4 * v + 1], best[4 * v + 2],
                                 best[4 * v + 3]));
      __stcs(a4 + i, make_int4(who[4 * v], who[4 * v + 1], who[4 * v + 2],
                               who[4 * v + 3]));
    }
  }
  if (sp.js >= 0) {
    __stcs(vals + sp.off + sp.js, best[kVecQ - 1]);
    __stcs(arg + sp.off + sp.js, who[kVecQ - 1]);
  }
}

// ------------------------------------------- the first crossing, "row" ----
constexpr int kRowLanes = 16;             // lanes a row: one per piece, P <= 16
constexpr int kRowThreads = 128;          // threads a block: 8 rows
constexpr unsigned kFullMask = 0xffffffffu;

template <int K>
__global__ void __launch_bounds__(kRowThreads)
ppoly_first_crossing_row_kernel(const float* __restrict__ starts,
                                const float* __restrict__ coeffs,
                                const float* __restrict__ y,
                                float* __restrict__ out, int B, int P, int T) {
  const long long b =
      ((long long)blockIdx.x * kRowThreads + threadIdx.x) / kRowLanes;
  const int p = threadIdx.x % kRowLanes;    // this lane's piece, and level
  const bool row = b < B;
  const bool mine = row && p < P;
  // every load first, none depending on another
  float s = kPadStart, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
  if (mine) {
    const long long i = b * P + p;
    s = __ldg(starts + i);
    c0 = __ldg(coeffs + i * K);
    if (K > 1) c1 = __ldg(coeffs + i * K + 1);
    if (K > 2) c2 = __ldg(coeffs + i * K + 2);
  }
  const float* yr = y + (row ? b : 0) * T;
  float yl = (row && p < T) ? __ldg(yr + p) : 0.0f;
  const float next = __shfl_down_sync(kFullMask, s, 1, kRowLanes);
  const float plen = ((p + 1 < P) ? next : kPadStart) - s;
  const bool real = mine && (s < kPadHalf);  // else a padding piece or none
  // the rows of a warp share T, so every loop below is the same for all
  // of its lanes, as the shuffles ask
  for (int t0 = 0; t0 < T; t0 += kRowLanes) {
    if (t0 > 0) yl = (row && t0 + p < T) ? __ldg(yr + t0 + p) : 0.0f;
    const int n = min(kRowLanes, T - t0);
    float res = 0.0f;
    for (int j = 0; j < n; ++j) {
      const float yv = __shfl_sync(kFullMask, yl, j, kRowLanes);
      const float tol = 1e-6f * fmaxf(1.0f, fabsf(yv));
      float v = real ? fminf(kBig, crossing_candidate(s, c0, c1, c2, plen, yv,
                                                      tol))
                     : kBig;
#pragma unroll
      for (int o = kRowLanes / 2; o > 0; o >>= 1) {
        v = fminf(v, __shfl_xor_sync(kFullMask, v, o, kRowLanes));
      }
      if (p == j) res = v;
    }
    if (row && t0 + p < T) out[b * T + t0 + p] = res;
  }
}

// Warps per row: the aligned body of any row holds at most T / 4 float4s.
int vec_spans(int T) {
  const int n4 = T / 4;
  return n4 > kSpan4 ? (n4 + kSpan4 - 1) / kSpan4 : 1;
}

bool vec_grid(int B, int T, int* spans, unsigned* blocks) {
  *spans = vec_spans(T);
  const long long n = ((long long)B * *spans + kVecWarps - 1) / kVecWarps;
  *blocks = (unsigned)n;
  return n <= INT_MAX;
}

template <int P, int K>
cudaError_t eval_vec(const float* starts, const float* coeffs, const float* q,
                     float* out, int B, int T, cudaStream_t stream) {
  int spans;
  unsigned blocks;
  if (!vec_grid(B, T, &spans, &blocks)) return cudaErrorInvalidValue;
  ppoly_eval_vec_kernel<P, K><<<blocks, kVecWarps * 32, 0, stream>>>(
      starts, coeffs, q, out, B, T, spans);
  return cudaGetLastError();
}

template <int P, int K>
cudaError_t min_eval_vec(const float* starts, const float* coeffs,
                         const float* q, float* vals, int* arg, int B, int F,
                         int T, cudaStream_t stream) {
  int spans;
  unsigned blocks;
  if (!vec_grid(B, T, &spans, &blocks)) return cudaErrorInvalidValue;
  ppoly_min_eval_vec_kernel<P, K><<<blocks, kVecWarps * 32, 0, stream>>>(
      starts, coeffs, q, vals, arg, B, F, T, spans);
  return cudaGetLastError();
}

// The instance for a run-time P (1..kVecMaxP) at a compile-time K.
template <int K, int P = 1>
cudaError_t eval_vec_p(int p, const float* starts, const float* coeffs,
                       const float* q, float* out, int B, int T,
                       cudaStream_t stream) {
  if constexpr (P > kVecMaxP) {
    return cudaErrorInvalidValue;
  } else {
    return p == P ? eval_vec<P, K>(starts, coeffs, q, out, B, T, stream)
                  : eval_vec_p<K, P + 1>(p, starts, coeffs, q, out, B, T,
                                         stream);
  }
}

template <int K, int P = 1>
cudaError_t min_eval_vec_p(int p, const float* starts, const float* coeffs,
                           const float* q, float* vals, int* arg, int B, int F,
                           int T, cudaStream_t stream) {
  if constexpr (P > kVecMaxP) {
    return cudaErrorInvalidValue;
  } else {
    return p == P ? min_eval_vec<P, K>(starts, coeffs, q, vals, arg, B, F, T,
                                       stream)
                  : min_eval_vec_p<K, P + 1>(p, starts, coeffs, q, vals, arg,
                                             B, F, T, stream);
  }
}

template <int K>
cudaError_t crossing_row(const float* starts, const float* coeffs,
                         const float* y, float* out, int B, int P, int T,
                         cudaStream_t stream) {
  constexpr int rows = kRowThreads / kRowLanes;
  const long long blocks = ((long long)B + rows - 1) / rows;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  ppoly_first_crossing_row_kernel<K><<<(unsigned)blocks, kRowThreads, 0,
                                       stream>>>(starts, coeffs, y, out, B, P,
                                                 T);
  return cudaGetLastError();
}

// Rows per block so that the staged tables fit the default shared memory;
// a single row that does not fit asks for the opt-in maximum.
int rows_for(size_t floats_per_row) {
  int rows = kMaxRows;
  while (rows > 1 && rows * floats_per_row * sizeof(float) > kDefaultSmem) {
    rows /= 2;
  }
  return rows;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

int ppoly_eval_launch(const float* starts, const float* coeffs,
                      const float* q, float* out, int B, int P, int K, int T,
                      void* stream) {
  const size_t per_row = (size_t)P * (1 + K);
  const int rows = rows_for(per_row);
  const size_t smem = rows * per_row * sizeof(float);
  cudaError_t err = prepare(ppoly_eval_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + rows - 1) / rows, (T + kQueries - 1) / kQueries);
  dim3 block(kQueries, rows);
  ppoly_eval_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      starts, coeffs, q, out, B, P, K, T);
  return (int)cudaGetLastError();
}

int ppoly_min_eval_launch(const float* starts, const float* coeffs,
                          const float* q, float* vals, int* arg, int B, int F,
                          int P, int K, int T, void* stream) {
  const size_t per_row = (size_t)F * P * (1 + K);
  const int rows = rows_for(per_row);
  const size_t smem = rows * per_row * sizeof(float);
  cudaError_t err = prepare(ppoly_min_eval_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + rows - 1) / rows, (T + kQueries - 1) / kQueries);
  dim3 block(kQueries, rows);
  ppoly_min_eval_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      starts, coeffs, q, vals, arg, B, F, P, K, T);
  return (int)cudaGetLastError();
}

// The "vec" route: P <= 16, K <= 3, F <= 4.  The outputs must have q's
// alignment modulo 16 bytes (the wrapper allocates them so).
int ppoly_eval_vec_launch(const float* starts, const float* coeffs,
                          const float* q, float* out, int B, int P, int K,
                          int T, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (K) {
    case 1: return (int)eval_vec_p<1>(P, starts, coeffs, q, out, B, T, st);
    case 2: return (int)eval_vec_p<2>(P, starts, coeffs, q, out, B, T, st);
    case 3: return (int)eval_vec_p<3>(P, starts, coeffs, q, out, B, T, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int ppoly_min_eval_vec_launch(const float* starts, const float* coeffs,
                              const float* q, float* vals, int* arg, int B,
                              int F, int P, int K, int T, void* stream) {
  if (F < 1 || F > kVecMaxF) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (K) {
    case 1: return (int)min_eval_vec_p<1>(P, starts, coeffs, q, vals, arg, B, F, T, st);
    case 2: return (int)min_eval_vec_p<2>(P, starts, coeffs, q, vals, arg, B, F, T, st);
    case 3: return (int)min_eval_vec_p<3>(P, starts, coeffs, q, vals, arg, B, F, T, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The "row" route of the first crossing: P <= 16, K <= 3.
int ppoly_first_crossing_row_launch(const float* starts, const float* coeffs,
                                    const float* y, float* out, int B, int P,
                                    int K, int T, void* stream) {
  if (P < 1 || P > kRowLanes) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (K) {
    case 1: return (int)crossing_row<1>(starts, coeffs, y, out, B, P, T, st);
    case 2: return (int)crossing_row<2>(starts, coeffs, y, out, B, P, T, st);
    case 3: return (int)crossing_row<3>(starts, coeffs, y, out, B, P, T, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int ppoly_first_crossing_launch(const float* starts, const float* coeffs,
                                const float* y, float* out, int B, int P,
                                int K, int T, void* stream) {
  const size_t per_row = (size_t)P * (1 + K);
  const int rows = rows_for(per_row);
  const size_t smem = rows * per_row * sizeof(float);
  cudaError_t err = prepare(ppoly_first_crossing_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + rows - 1) / rows, (T + kQueries - 1) / kQueries);
  dim3 block(kQueries, rows);
  ppoly_first_crossing_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      starts, coeffs, y, out, B, P, K, T);
  return (int)cudaGetLastError();
}

}  // extern "C"
