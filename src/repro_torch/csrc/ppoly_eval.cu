// Batched piecewise-polynomial queries on Hopper (sm_90a).
//
// Three launchers with a plain C interface, bound with ctypes by
// repro_torch/kernels/ppoly_eval/kernel.py:
//
//   ppoly_eval_launch            replaces repro/kernels/ppoly_eval/kernel.py
//                                ppoly_eval_pallas (_ppoly_kernel/_eval_one)
//   ppoly_min_eval_launch        replaces ppoly_min_eval_pallas
//                                (_ppoly_min_kernel)
//   ppoly_first_crossing_launch  replaces ppoly_first_crossing_pallas
//                                (_first_crossing_kernel with
//                                ref.first_crossing_candidates)
//
// What bounds them: all three are memory-bound on this card.  A query reads
// one float32 (q or y) and writes one or two (value, argmin); the piece
// tables are small (P*(1+K) floats per row) and are read once per block.
// Example: ppoly_eval at B = 10,000, T = 1024, P = 3, K = 2 moves about
// 82 MB (q and out dominate), about 24 us at 3.35 TB/s, while its float32
// work is about 0.2 GFLOP, about 3 us at 67 TFLOP/s.
//
// Design: one thread per (b, t) query; a block covers a tile of rows times
// 128 queries, so neighbouring threads read neighbouring q and write
// neighbouring outputs (coalesced 128-byte lines).  The block stages its
// rows' piece tables in shared memory once, and every query thread of the
// row reads them from there.  Each thread selects its piece by counting
// `start <= t` over all P pieces, exactly as the reference does, so
// duplicate starts (jumps) resolve to the same piece; then it runs Horner on
// that one piece.  The TPU kernel's one-hot masked Horner and its 8 x 128
// blocks are not carried over: they exist for the TPU's vector lanes.
//
// Arithmetic: built without fast math and with -fmad=false, so every
// multiply and add rounds as in the plain PyTorch version, division and sqrt
// are IEEE, and the crossing thresholds (c0 >= y - tol, u <= plen) compare
// the same numbers.

#include <cuda_runtime.h>

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
