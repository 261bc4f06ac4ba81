// RWKV-6 wkv forward on Hopper (sm_90a): the chunked linear-attention
// recurrence with data-dependent decay, float32 throughout.
//
// One launcher with a plain C interface, bound with ctypes by
// repro_torch/kernels/wkv6/kernel.py:
//
//   wkv6_launch   replaces repro/kernels/wkv6/kernel.py wkv6_pallas
//                 (_wkv_kernel)
//
// What it computes: r, k, v, w (B, L, H, N), u (H, N), s0 (B, H, N, N), all
// float32 and contiguous, N <= 64, chunk C in {16, 32, 64}, any L >= 1.
// Per chunk of C tokens, for each head: the log-decay lw = log(max(w,
// 1e-30)), its inclusive cumsum cum and exclusive cume = cum - lw; the
// intra-chunk attention att[t][s] = sum_n r[t,n] exp(min(cume[t,n] -
// cum[s,n], 0)) k[s,n] for s < t (log space: never a ratio of two exps,
// which overflows for near-zero decays); diag[t] = sum_n r[t,n] u[n] k[t,n];
//   y[t] = (r[t] * exp(cume[t])) . S + sum_{s<t} att[t][s] v[s] + diag[t] v[t]
//   S   <- exp(total) * S + sum_t (k[t] * exp(total - cum[t])) (x) v[t]
// with total = cum of the chunk's last token.  Outputs y (B, L, H, N) and
// s_final (B, H, N, N), float32.
//
// What bounds it: bytes.  At the prefill shape B = 2, L = 4096, H = 32,
// N = 64, C = 32 it reads r, k, v, w and writes y, 5 x 67.1 MB, plus s0
// and s_final (1 MB each): 0.10 ms at 3.35 TB/s.  Its operations, the two
// N x N contractions per chunk (2 C N^2 each), the C(C-1)/2 N decay terms
// and att . v, come to about 6 GFLOP: 0.09 ms at 67 TFLOP/s in float32.
// This kernel is the simple one: float32 on the CUDA cores, the decay
// exponentials recomputed per value slab; tensor cores and TMA are later
// work.
//
// Design: the TPU kernel walks the chunks on its last grid axis with the
// (N, N) state in VMEM scratch.  Here a block loops over the chunks in order
// itself, and the grid is (B * H, ceil(N / 16)): the value columns of the
// state and of y are independent given a chunk's C x C attention matrix, so
// each block owns a slab of 16 value columns, keeps its N x 16 state slab in
// shared memory across chunks, and recomputes the chunk's att for itself.
// The prefill shape then runs 256 blocks, not 64.  Per chunk the block
// stages r, k and the log-decay (C x N, rows padded to N + 1 floats so that
// lanes reading neighbouring rows hit distinct banks) and its v slab in
// shared memory, takes the cumsum (one thread per column), builds att over
// the strictly lower triangle (rows t and R - 1 - t paired so that every
// lane has work), then writes y for its slab and advances the state slab.
// The (B, L, H, N) layout is read in place with strides: nothing is
// transposed.  In a ragged last chunk only its R < C tokens are touched,
// which is what the reference's padding (r = k = v = 0, w = 1, so lw = 0)
// computes: y and s_final are the same.
//
// Arithmetic: no fast math (logf, expf, IEEE division), as in the plain
// version.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNV = 16;          // value columns per block (a slab)
constexpr int kMaxN = 64;

size_t smem_floats(int N, int C) {
  const int LD = N + 1;
  return (size_t)4 * C * LD      // r (then r_dec), k (then k_fut), cum, cume
         + (size_t)C * kNV       // v slab
         + (size_t)C * (C + 1)   // att
         + (size_t)N * kNV       // state slab
         + C + 2 * N;            // diag, exp(total), u
}

__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ sout, int L, int H,
            int N, int C) {
  extern __shared__ float smem[];
  const int LD = N + 1;
  float* sr = smem;                  // (C, LD)
  float* sk = sr + C * LD;           // (C, LD)
  float* scum = sk + C * LD;         // (C, LD)
  float* scume = scum + C * LD;      // (C, LD): lw, then cume
  float* sv = scume + C * LD;        // (C, kNV)
  float* satt = sv + C * kNV;        // (C, C + 1)
  float* ss = satt + C * (C + 1);    // (N, kNV)
  float* sdiag = ss + N * kNV;       // (C)
  float* setot = sdiag + C;          // (N)
  float* su = setot + N;             // (N)

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int m0 = blockIdx.y * kNV;
  const int nv = min(kNV, N - m0);
  const long long step = (long long)H * N;                // token to token
  const long long base = ((long long)b * L * H + h) * N;  // token 0, head h
  const long long sbase = (long long)bh * N * N;

  for (int i = tid; i < N * kNV; i += kThreads) {
    const int n = i / kNV;
    const int m = i % kNV;
    ss[i] = m < nv ? s0[sbase + (long long)n * N + m0 + m] : 0.0f;
  }
  for (int n = tid; n < N; n += kThreads) su[n] = u[(long long)h * N + n];

  for (int c0 = 0; c0 < L; c0 += C) {
    const int R = min(C, L - c0);    // tokens of this chunk
    const long long cb = base + (long long)c0 * step;

    // stage r, k, log-decay and the v slab
    for (int i = tid; i < R * N; i += kThreads) {
      const int t = i / N;
      const int n = i % N;
      const long long g = cb + (long long)t * step + n;
      sr[t * LD + n] = r[g];
      sk[t * LD + n] = k[g];
      scume[t * LD + n] = logf(fmaxf(w[g], 1e-30f));
    }
    for (int i = tid; i < R * kNV; i += kThreads) {
      const int t = i / kNV;
      const int m = i % kNV;
      sv[i] = m < nv ? v[cb + (long long)t * step + m0 + m] : 0.0f;
    }
    __syncthreads();

    // cumsum of the log-decay, one thread per column (threads 0 .. N - 1);
    // diag, one thread per token (threads 255 down to 256 - R)
    if (tid < N) {
      float acc = 0.0f;
      for (int t = 0; t < R; ++t) {
        const float lw = scume[t * LD + tid];
        acc += lw;
        scum[t * LD + tid] = acc;
        scume[t * LD + tid] = acc - lw;
      }
    }
    {
      const int t = kThreads - 1 - tid;
      if (t < R) {
        float acc = 0.0f;
        for (int n = 0; n < N; ++n) acc += sr[t * LD + n] * su[n] * sk[t * LD + n];
        sdiag[t] = acc;
      }
    }
    __syncthreads();

    // att over the strictly lower triangle: pair p holds row p (p entries)
    // and row R - 1 - p (R - 1 - p entries), R - 1 lanes of work together;
    // an odd R's middle row appears in both halves and is taken once
    if (R > 1) {
      const int per = R - 1;
      const int pairs = (R + 1) / 2;
      for (int i = tid; i < pairs * per; i += kThreads) {
        const int p = i / per;
        const int j = i % per;
        int t = p;
        int s = j;
        if (j >= p) {
          t = R - 1 - p;
          s = j - p;
          if (t == p) continue;
        }
        const float* rt = sr + t * LD;
        const float* ce = scume + t * LD;
        const float* ks = sk + s * LD;
        const float* cs = scum + s * LD;
        float acc = 0.0f;
        for (int n = 0; n < N; ++n)
          acc += rt[n] * expf(fminf(ce[n] - cs[n], 0.0f)) * ks[n];
        satt[t * (C + 1) + s] = acc;
      }
    }
    __syncthreads();

    // r_dec = r exp(cume) over r; k_fut = k exp(total - cum) over k
    for (int i = tid; i < R * N; i += kThreads) {
      const int t = i / N;
      const int n = i % N;
      sr[t * LD + n] *= expf(scume[t * LD + n]);
      sk[t * LD + n] *= expf(scum[(R - 1) * LD + n] - scum[t * LD + n]);
    }
    for (int n = tid; n < N; n += kThreads) setot[n] = expf(scum[(R - 1) * LD + n]);
    __syncthreads();

    // y of this slab: state applied, intra-chunk attention, bonus
    for (int i = tid; i < R * kNV; i += kThreads) {
      const int t = i / kNV;
      const int m = i % kNV;
      if (m >= nv) continue;
      float inter = 0.0f;
      for (int n = 0; n < N; ++n) inter += sr[t * LD + n] * ss[n * kNV + m];
      float intra = 0.0f;
      for (int s = 0; s < t; ++s) intra += satt[t * (C + 1) + s] * sv[s * kNV + m];
      y[cb + (long long)t * step + m0 + m] = inter + intra + sdiag[t] * sv[t * kNV + m];
    }
    __syncthreads();

    // state advance of the slab
    for (int i = tid; i < N * kNV; i += kThreads) {
      const int n = i / kNV;
      const int m = i % kNV;
      float acc = 0.0f;
      for (int t = 0; t < R; ++t) acc += sk[t * LD + n] * sv[t * kNV + m];
      ss[i] = setot[n] * ss[i] + acc;
    }
    __syncthreads();
  }

  for (int i = tid; i < N * kNV; i += kThreads) {
    const int n = i / kNV;
    const int m = i % kNV;
    if (m < nv) sout[sbase + (long long)n * N + m0 + m] = ss[i];
  }
}

}  // namespace

extern "C" {

// All pointers to contiguous float32 device memory.  Returns a cudaError_t.
int wkv6_launch(const void* r, const void* k, const void* v, const void* w,
                const void* u, const void* s0, void* y, void* s_final, int B,
                int L, int H, int N, int chunk, void* stream) {
  if (B < 1 || L < 1 || H < 1 || N < 1 || N > kMaxN ||
      (chunk != 16 && chunk != 32 && chunk != 64) ||
      (long long)B * H > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_floats(N, chunk) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (N + kNV - 1) / kNV);
  wkv6_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(s_final), L, H, N, chunk);
  return (int)cudaGetLastError();
}

}  // extern "C"
