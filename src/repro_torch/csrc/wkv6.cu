// RWKV-6 wkv forward on Hopper (sm_90a): the chunked linear-attention
// recurrence with data-dependent decay, float32 in and out.
//
// Launchers with a plain C interface, bound with ctypes by
// repro_torch/kernels/wkv6/kernel.py; both replace
// repro/kernels/wkv6/kernel.py wkv6_pallas (_wkv_kernel):
//
//   wkv6_launch           the serial route (L <= chunk: a decode step)
//   wkv6_intra_launch     the chunked route (L > chunk: a prefill), phase 1
//   wkv6_scan_launch      and phase 2, one kernel each: wkv6_intra_kernel
//                         then wkv6_scan_kernel
//
// What it computes: r, k, v, w (B, L, H, N), u (H, N), s0 (B, H, N, N), all
// float32 and contiguous, N <= 64, chunk C in {16, 32, 64}, any L >= 1.
// Per chunk of C tokens, for each head: the log-decay lw = log(max(w,
// 1e-30)), its inclusive cumsum cum and exclusive cume = cum - lw; the
// intra-chunk attention att[t][s] = sum_n r[t,n] exp(cume[t,n] - cum[s,n])
// k[s,n] for s < t (never a ratio of two exps, which overflows for
// near-zero decays); diag[t] = sum_n r[t,n] u[n] k[t,n];
//   y[t] = (r[t] * exp(cume[t])) . S + sum_{s<t} att[t][s] v[s] + diag[t] v[t]
//   S   <- exp(total) * S + sum_t (k[t] * exp(total - cum[t])) (x) v[t]
// with total = cum of the chunk's last token.  Outputs y (B, L, H, N) and
// s_final (B, H, N, N), float32.  A ragged last chunk is treated as the
// reference's padding (r = k = v = 0, w = 1, so lw = 0) treats it: y and
// s_final are the same.
//
// What bounds it: bytes.  At the prefill shape B = 2, L = 4096, H = 32,
// N = 64, C = 32 the function reads r, k, v, w and writes y, 5 x 67.1 MB,
// plus s0 and s_final (1 MB each): 337.6 MB, 0.1008 ms at 3.35 TB/s.  Its
// operations come to about 6 GFLOP: 0.09 ms even at the 67 TFLOP/s float32
// rate of the CUDA cores.
//
// ---- The serial route (wkv6_kernel) ----
// Grid (B * H, ceil(N / 16)): a block owns a slab of 16 value columns of the
// state, keeps its N x 16 state slab in shared memory, and walks the chunks
// in order, recomputing the chunk's C x C attention for itself.  Per chunk
// it stages r, k and the log-decay (rows padded to N + 1 floats) and its v
// slab, takes the cumsum (one thread per column), builds att over the
// strictly lower triangle, writes y of its slab and advances its state
// slab.  In a ragged last chunk only its R < C tokens are touched, so a
// decode step (L = 1) touches one row.  At the prefill shape it runs 256
// blocks, each 128 chunks long, at 19 us a chunk: latency-bound, 24x the
// bytes bound.  Decode steps (L <= chunk) take it.
//
// ---- The chunked route (every call with L > chunk) ----
// Most of a chunk's work does not depend on the carried state: the cumsum,
// the intra-chunk attention, att . v, the bonus and the chunk's own state
// increment.  So the route splits it off:
//
// wkv6_intra_kernel, one block of 256 threads per (b, h, chunk): 8,192
//   blocks at the prefill shape, 53 KB of shared memory at C = 32 (q and
//   k_fut are computed in place over r and k), so 4 blocks share an SM.  It
//   stages r, k, v, w with cp.async, takes the log-decay cumsum by
//   warp-shuffle scans, and writes
//     y_intra = att . v + diag v        into y,
//     r_dec   = r * exp(cume)           (C x NP) into scratch,
//     dS_c    = k_fut^T . v             (NP x NP) into scratch, and
//     exp(total_c)                      (NP) into scratch,
//   with NP = N rounded up to 16 (zero padded).
// wkv6_scan_kernel, one block per (b, h, slab of 32 value columns): 128
//   blocks at the prefill shape.  Consumer warps, one per (16-token row
//   tile, 8 value columns), keep their 64 x 8 piece of S in registers, as
//   the B operand of the tensor-core product, and walk the chunks:
//     y_c += r_dec_c . S ;  S <- exp(total_c) * S + dS_c.
//   The loads of later chunks (r_dec, the dS slab, the y slab, exp(total))
//   do not depend on S: four producer warps stream them with cp.async
//   through a ring of eight stages in shared memory (five at C = 64) under
//   a full and an empty mbarrier a stage, so the consumers' serial chain is
//   only the state's own multiply-add.  A chunk's y is stored once the next
//   chunk's products are issued, so that their latency overlaps.  It
//   writes s_final.
//
// Scratch, allocated by the wrapper with torch.empty (one buffer):
// B H nc NP (C + NP + 1) floats, nc = ceil(L / C).  At the prefill shape
// with C = 32: 67.1 MB of r_dec, 134.2 MB of dS and 2.1 MB of exp(total),
// 203.4 MB; at L = 32,768 (B = 1): 813.7 MB.  The split moves about 0.88 GB
// at the prefill shape (the intra kernel reads 268.4 MB and writes
// 270.5 MB; the scan reads r_dec, dS, exp(total) and y and writes y, about
// 338 MB): a floor of about 0.26 ms at 3.35 TB/s, against the function's
// 0.1008 ms.
//
// The intra-chunk attention on tensor cores, in log space where it matters.
// The chunk is cut into sub-chunks of 16 tokens.
//   Diagonal sub-blocks (s and t in one sub-chunk): the exact pairwise form
//   exp(min(cume_t - cum_s, 0)), 16 * 15 / 2 * N exponentials a sub-chunk,
//   computed once a block (the serial kernel does it once per value slab).
//   Off-diagonal sub-blocks (t in sub-chunk i, s in an earlier one): with
//   the reference point ref = cume at the first token of sub-chunk i,
//     att_ts = sum_n (r_tn e^{cume_tn - ref_n}) (k_sn e^{ref_n - cum_sn}).
//   cum does not increase (lw <= 0), so for t >= 16 i, cume_t = cum_{t-1}
//   <= cum_{16 i - 1} = ref, and for s < 16 i, cum_s >= cum_{16 i - 1} =
//   ref: both exponents are <= 0 (clamped at 0 against rounding of the
//   scan).  Neither factor overflows, and the product underflows only where
//   exp(cume_t - cum_s) itself does.  One reference point for the whole
//   chunk would not do: with near-zero decays lw reaches -69 a token and
//   e^{+...} overflows float32 within two tokens.  These blocks are then a
//   matrix product q . kk^T.
//
// Products on tensor cores in 3xTF32: the off-diagonal att blocks, att . v,
// dS_c = k_fut^T . v and the scan's r_dec . S run as mma.sync m16n8k8 TF32.
// Each operand x is split into hi = x with its low 13 mantissa bits zeroed
// and lo = (x - hi) likewise, and hi.hi + hi.lo + lo.hi is summed in
// float32 (lo.lo, below 2^-22 relative, is dropped).  Plain TF32 keeps 10
// mantissa bits, a relative error of order 1e-4 to 1e-3 on these sums,
// above the bar of relative L2 1e-4 against the plain version; the split
// keeps float32's accuracy.  The operation count (about 6 GFLOP) is not
// what limits this function, so the point of the tensor cores is to take
// the contractions off the serial chain and out of scalar FMA loops, not
// their rate.
//
// Arithmetic: no fast math (logf, expf, IEEE division), as in the plain
// version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ============================== serial route ===============================
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


// ============================= chunked route ===============================

constexpr int kSub = 16;              // tokens per sub-chunk
constexpr int kIntraThreads = 256;
constexpr int kSlab = 32;             // value columns per scan block
constexpr int kProducerWarps = 4;     // scan warps that only issue copies
// depth of the scan's cp.async ring: as many stages as fit in about 195 KB
template <int C>
constexpr int kStages = C == 64 ? 5 : 8;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int pad16(int n) { return (n + 15) / 16 * 16; }

// rows of the kk buffer before sub-chunk i's factors (i >= 1 owns 16 i rows)
__host__ __device__ constexpr int kk_row0(int i) { return kSub * i * (i - 1) / 2; }

// ---- mma.sync m16n8k8 TF32 in 3xTF32 ----
// Fragments (g = lane / 4, q = lane % 4): A (16 x 8, row-major) a0 (g, q),
// a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4); B (8 x 8) b0 (k = q, n =
// g), b1 (q + 4, g); C/D (16 x 8) d0 (g, 2q), d1 (g, 2q + 1), d2 (g + 8, 2q),
// d3 (g + 8, 2q + 1).

__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return __float_as_uint(x) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the 3xTF32 split of a fragment: hi = x with its low 13 mantissa bits
// zeroed, lo = (x - hi) likewise
template <int M>
struct Split {
  uint32_t hi[M], lo[M];
  __device__ __forceinline__ explicit Split(const float (&x)[M]) {
#pragma unroll
    for (int i = 0; i < M; ++i) {
      hi[i] = tf32_bits(x[i]);
      lo[i] = tf32_bits(x[i] - __uint_as_float(hi[i]));
    }
  }
};

// d += a . b in 3xTF32: lo.hi + hi.lo + hi.hi, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const Split<4>& a, const Split<2>& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// A fragment from a row-major tile p (row stride ld)
__device__ __forceinline__ void frag_a(float (&a)[4], const float* p, int ld,
                                       int g, int q) {
  a[0] = p[g * ld + q];
  a[1] = p[(g + 8) * ld + q];
  a[2] = p[g * ld + q + 4];
  a[3] = p[(g + 8) * ld + q + 4];
}

// ---- cp.async: 16 or 4 bytes, zero-filled where !ok ----
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// ---- mbarriers ----
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// arrives on bar once every cp.async this thread issued before has landed;
// counts as one of the arrivals bar was initialised with
__device__ __forceinline__ void cp_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- phase 1: wkv6_intra_kernel, one block per (b, h, chunk) ----

template <int C>
struct IntraSmem {
  static constexpr int kS = C / kSub;        // sub-chunks
  static constexpr int kKK = kk_row0(kS);    // rows of kk over all i
  static constexpr int kLDA = C + 4;         // att row stride
  // r (then q), k (then k_fut), cum, cume (rows of NP + 4); v (rows of
  // NP + 8); kk; att; u: 53 KB at C = 32, N = 64, so that 4 blocks fit an
  // SM.  Row strides of 4 or 8 mod 32 floats keep most fragment loads free
  // of bank conflicts.
  static size_t floats(int NP) {
    return (size_t)4 * C * (NP + 4) + (size_t)C * (NP + 8) +
           (size_t)kKK * (NP + 4) + (size_t)C * kLDA + NP;
  }
};

template <int C>
__global__ void __launch_bounds__(kIntraThreads, C == 64 ? 1 : 4)
wkv6_intra_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, float* __restrict__ y,
                  float* __restrict__ rdec, float* __restrict__ dS,
                  float* __restrict__ dec, int L, int H, int N, int NP, int nc,
                  int vec) {
  using Smem = IntraSmem<C>;
  constexpr int S = Smem::kS;
  constexpr int LDA = Smem::kLDA;
  constexpr int kWarps = kIntraThreads / 32;
  extern __shared__ __align__(16) float chunk_smem[];
  float* smem = chunk_smem;
  const int LD4 = NP + 4;
  const int LD8 = NP + 8;
  float* sR = smem;                  // (C, LD4): r, then q = r e^{cume - ref}
  float* sK = sR + C * LD4;          // (C, LD4): k, then k_fut = k e^{total - cum}
  float* sCum = sK + C * LD4;        // (C, LD4)
  float* sCume = sCum + C * LD4;     // (C, LD4): w, then cume
  float* sV = sCume + C * LD4;       // (C, LD8)
  float* sKK = sV + C * LD8;         // (kKK, LD4): k e^{ref - cum}
  float* sAtt = sKK + Smem::kKK * LD4;   // (C, LDA)
  float* sU = sAtt + C * LDA;        // (NP)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int g = lane >> 2;
  const int q = lane & 3;
  const long long tile = blockIdx.x;           // bh * nc + c
  const int c = (int)(tile % nc);
  const int bh = (int)(tile / nc);
  const int b = bh / H;
  const int h = bh % H;
  const int R = min(C, L - c * C);             // tokens of this chunk
  const long long step = (long long)H * N;     // token to token
  const long long gb = ((long long)b * L + (long long)c * C) * step + (long long)h * N;

  // 1. stage r, k, v and w; zeros past the R tokens and past N
  if (vec) {
    const int q4 = NP / 4;
    for (int i = tid; i < C * q4; i += kIntraThreads) {
      const int t = i / q4;
      const int n = (i % q4) * 4;
      const bool ok = t < R && n < N;
      const long long gi = ok ? gb + t * step + n : 0;
      cp16(sR + t * LD4 + n, r + gi, ok);
      cp16(sK + t * LD4 + n, k + gi, ok);
      cp16(sV + t * LD8 + n, v + gi, ok);
      cp16(sCume + t * LD4 + n, w + gi, ok);
    }
  } else {
    for (int i = tid; i < C * NP; i += kIntraThreads) {
      const int t = i / NP;
      const int n = i % NP;
      const bool ok = t < R && n < N;
      const long long gi = ok ? gb + t * step + n : 0;
      cp4(sR + t * LD4 + n, r + gi, ok);
      cp4(sK + t * LD4 + n, k + gi, ok);
      cp4(sV + t * LD8 + n, v + gi, ok);
      cp4(sCume + t * LD4 + n, w + gi, ok);
    }
  }
  cp_commit();
  for (int i = tid; i < C * LDA; i += kIntraThreads) sAtt[i] = 0.0f;
  for (int n = tid; n < NP; n += kIntraThreads) sU[n] = n < N ? u[(long long)h * N + n] : 0.0f;
  cp_wait<0>();
  __syncthreads();

  // 2. log-decay (0 where padded, as w = 1) and its inclusive cumsum over
  //    the C tokens: warp-shuffle scans of TPW tokens, CPW columns a warp
  {
    constexpr int TPW = C < 32 ? C : 32;
    constexpr int CPW = 32 / TPW;
    constexpr int SEG = C / TPW;
    const int tl = lane % TPW;
    for (int n = wid * CPW + lane / TPW; n < NP; n += kWarps * CPW) {
      float carry = 0.0f;
#pragma unroll
      for (int sg = 0; sg < SEG; ++sg) {
        const int t = sg * TPW + tl;
        const float lw = (t < R && n < N) ? logf(fmaxf(sCume[t * LD4 + n], 1e-30f)) : 0.0f;
        float x = lw;
#pragma unroll
        for (int o = 1; o < TPW; o <<= 1) {
          const float p = __shfl_up_sync(kFull, x, o, TPW);
          if (tl >= o) x += p;
        }
        x += carry;
        sCum[t * LD4 + n] = x;
        sCume[t * LD4 + n] = x - lw;
        carry = __shfl_sync(kFull, x, TPW - 1, TPW);
      }
    }
  }
  __syncthreads();

  // 3a. the diagonal sub-blocks of att, exactly: first the 120 entries
  //     below the diagonal of each sub-chunk (rows p + 1 and 15 - p
  //     paired, 16 entries a pair, row 8 alone), then the bonus diag[t] on
  //     the diagonal, which takes no exponential
  for (int e = tid; e < S * 120 + C; e += kIntraThreads) {
    const int si = e < S * 120 ? e / 120 : (e - S * 120) / kSub;
    const int p = (e % 120) / 16;
    const int j = (e % 120) % 16;
    const int t = e < S * 120 ? si * kSub + (j <= p ? p + 1 : kSub - 1 - p) : e - S * 120;
    const int s = e < S * 120 ? si * kSub + (j <= p ? j : j - p - 1) : t;
    const float4* rt = reinterpret_cast<const float4*>(sR + t * LD4);
    const float4* ks = reinterpret_cast<const float4*>(sK + s * LD4);
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);   // four short chains
    if (s == t) {
      const float4* uu = reinterpret_cast<const float4*>(sU);
      for (int n4 = 0; n4 < NP / 4; ++n4) {
        const float4 a = rt[n4], bk = ks[n4], cu = uu[n4];
        acc.x += a.x * cu.x * bk.x;
        acc.y += a.y * cu.y * bk.y;
        acc.z += a.z * cu.z * bk.z;
        acc.w += a.w * cu.w * bk.w;
      }
    } else {
      const float4* ce = reinterpret_cast<const float4*>(sCume + t * LD4);
      const float4* cs = reinterpret_cast<const float4*>(sCum + s * LD4);
      for (int n4 = 0; n4 < NP / 4; ++n4) {
        const float4 a = rt[n4], bk = ks[n4], et = ce[n4], es = cs[n4];
        acc.x += a.x * expf(fminf(et.x - es.x, 0.0f)) * bk.x;
        acc.y += a.y * expf(fminf(et.y - es.y, 0.0f)) * bk.y;
        acc.z += a.z * expf(fminf(et.z - es.z, 0.0f)) * bk.z;
        acc.w += a.w * expf(fminf(et.w - es.w, 0.0f)) * bk.w;
      }
    }
    sAtt[t * LDA + s] = (acc.x + acc.y) + (acc.z + acc.w);
  }
  __syncthreads();   // r and k are read above and overwritten below

  // 3b. elementwise, each element by one thread: r_dec (to scratch), q =
  //     r e^{cume - ref_i} over r for the rows of sub-chunk i (r_dec itself
  //     for i = 0, where ref = 0), k_fut = k e^{total - cum} over k, and
  //     kk^(i) = k e^{ref_i - cum} for the rows before each later
  //     sub-chunk i
  float* rd = rdec + tile * C * NP;
  for (int i = tid; i < C * NP; i += kIntraThreads) {
    const int t = i / NP;
    const int n = i % NP;
    const float rv = sR[t * LD4 + n];
    const float kv = sK[t * LD4 + n];
    const float ce = sCume[t * LD4 + n];
    const float cu = sCum[t * LD4 + n];
    const float rdv = rv * expf(ce);
    rd[i] = rdv;
    const int si = t / kSub;
    for (int j = si + 1; j < S; ++j)
      sKK[(kk_row0(j) + t) * LD4 + n] = kv * expf(fminf(sCume[j * kSub * LD4 + n] - cu, 0.0f));
    sR[t * LD4 + n] =
        si == 0 ? rdv : rv * expf(fminf(ce - sCume[si * kSub * LD4 + n], 0.0f));
    sK[t * LD4 + n] = kv * expf(sCum[(C - 1) * LD4 + n] - cu);
  }
  for (int n = tid; n < NP; n += kIntraThreads)
    dec[tile * NP + n] = expf(sCum[(C - 1) * LD4 + n]);
  __syncthreads();

  // 4. tensor cores: the off-diagonal sub-blocks of att, q . kk^T, one warp
  //    per later sub-chunk i (its 2 i tiles of 16 x 8 at once); and dS =
  //    k_fut^T . v (NP x NP, to scratch), one warp per (16 rows, half the
  //    columns).  A warp splits each A fragment once for all its tiles.
  if constexpr (S > 1) {
    if (wid < S - 1) {
      const int i = wid + 1;
      const float* A = sR + i * kSub * LD4;                  // q: (16, NP)
      const float* Bt = sKK + kk_row0(i) * LD4;              // (16 i, NP): B^T
      float d[2 * (S - 1)][4] = {};
      for (int kk = 0; kk < NP; kk += 8) {
        float a[4];
        frag_a(a, A + kk, LD4, g, q);
        const Split<4> as(a);
#pragma unroll
        for (int nt = 0; nt < 2 * (S - 1); ++nt) {
          if (nt < 2 * i) {
            const float* bt = Bt + (nt * 8 + g) * LD4 + kk;
            const float bb[2] = {bt[q], bt[q + 4]};
            mma3(d[nt], as, Split<2>(bb));
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2 * (S - 1); ++nt) {
        if (nt < 2 * i) {
          float* o = sAtt + (i * kSub + g) * LDA + nt * 8 + 2 * q;
          o[0] = d[nt][0];
          o[1] = d[nt][1];
          o[8 * LDA] = d[nt][2];
          o[8 * LDA + 1] = d[nt][3];
        }
      }
    }
  }
  {
    const int half = NP / 16;                 // n-tiles per warp, <= 4
    if (wid < 2 * half) {
      const int mt = wid >> 1;
      const int nt0 = (wid & 1) * half;
      float d[4][4] = {};
#pragma unroll
      for (int kk = 0; kk < C; kk += 8) {
        // A (n, t) = k_fut[t][n], B (t, m) = v[t][m]
        const float* At = sK + kk * LD4 + mt * 16;
        const float a[4] = {At[q * LD4 + g], At[q * LD4 + g + 8],
                            At[(q + 4) * LD4 + g], At[(q + 4) * LD4 + g + 8]};
        const Split<4> as(a);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < half) {
            const float* Bm = sV + kk * LD8 + (nt0 + j) * 8;
            const float bb[2] = {Bm[q * LD8 + g], Bm[(q + 4) * LD8 + g]};
            mma3(d[j], as, Split<2>(bb));
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < half) {
          float* o = dS + tile * NP * NP + (long long)(mt * 16 + g) * NP + (nt0 + j) * 8 + 2 * q;
          *reinterpret_cast<float2*>(o) = make_float2(d[j][0], d[j][1]);
          *reinterpret_cast<float2*>(o + 8 * NP) = make_float2(d[j][2], d[j][3]);
        }
      }
    }
  }
  __syncthreads();

  // 5. y_intra = att . v over the lower sub-blocks, into y: one warp per
  //    8 value columns, all C / 16 row tiles at once (the B fragment split
  //    once for them)
  if (wid < NP / 8) {
    constexpr int MT = C / 16;
    const int nt = wid;
    float d[MT][4] = {};
#pragma unroll
    for (int kk = 0; kk < C; kk += 8) {
      const float* Bm = sV + kk * LD8 + nt * 8;
      const float bb[2] = {Bm[q * LD8 + g], Bm[(q + 4) * LD8 + g]};
      const Split<2> bs(bb);
#pragma unroll
      for (int mt = kk / 16; mt < MT; ++mt) {   // att is 0 above the sub-blocks
        float a[4];
        frag_a(a, sAtt + mt * 16 * LDA + kk, LDA, g, q);
        mma3(d[mt], Split<4>(a), bs);
      }
    }
    const int m = nt * 8 + 2 * q;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int t = mt * 16 + g;
      float* yo = y + gb + t * step + m;
      if (vec && m < N) {   // N % 4 == 0: m + 1 < N too, 8-byte aligned
        if (t < R) *reinterpret_cast<float2*>(yo) = make_float2(d[mt][0], d[mt][1]);
        if (t + 8 < R) *reinterpret_cast<float2*>(yo + 8 * step) = make_float2(d[mt][2], d[mt][3]);
      } else {
        if (m < N && t < R) yo[0] = d[mt][0];
        if (m + 1 < N && t < R) yo[1] = d[mt][1];
        if (m < N && t + 8 < R) yo[8 * step] = d[mt][2];
        if (m + 1 < N && t + 8 < R) yo[8 * step + 1] = d[mt][3];
      }
    }
  }
}

// ---- phase 2: wkv6_scan_kernel, one block per (b, h, 32 value columns) ----

template <int C>
struct ScanSmem {
  static constexpr int kLDS = kSlab + 8;   // dS and y slab row stride
  // one consumer warp per (16-token row tile, 8 value columns), and the
  // producer warps that issue the ring's copies
  static constexpr int kConsumers = 32 * (C / 16) * (kSlab / 8);
  static constexpr int kProducers = 32 * kProducerWarps;
  static constexpr int kThreads = kConsumers + kProducers;
  // one ring stage: r_dec (C, NP + 4), dS slab (NP, kLDS), y slab (C,
  // kLDS), exp(total) (NP)
  static int stage_floats(int NP) { return C * (NP + 4) + NP * kLDS + C * kLDS + NP; }
};

template <int C>
__global__ void __launch_bounds__(ScanSmem<C>::kThreads, 1)
wkv6_scan_kernel(const float* __restrict__ rdec, const float* __restrict__ dS,
                 const float* __restrict__ dec, const float* __restrict__ s0,
                 float* __restrict__ y, float* __restrict__ sout, int L, int H,
                 int N, int NP, int nc, int vec) {
  constexpr int kNT = kSlab / 8;             // consumer warps across the slab
  constexpr int kK = kStages<C>;
  constexpr int kCons = ScanSmem<C>::kConsumers;
  constexpr int kProd = ScanSmem<C>::kProducers;
  constexpr int LDS = ScanSmem<C>::kLDS;
  extern __shared__ __align__(16) float chunk_smem[];
  float* smem = chunk_smem;
  __shared__ uint64_t full[kK];              // stage landed (every producer)
  __shared__ uint64_t empty[kK];             // stage read (every consumer)
  const int LDR = NP + 4;
  const int SF = C * LDR + NP * LDS + C * LDS + NP;   // ScanSmem<C>::stage_floats
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int m0 = blockIdx.y * kSlab;
  const int KS = NP / 8;
  const long long step = (long long)H * N;
  const long long yb = (long long)b * L * step + (long long)h * N;

  if (tid == 0) {
    for (int i = 0; i < kK; ++i) {
      mbar_init(&full[i], kProd);
      mbar_init(&empty[i], kCons);
    }
  }
  __syncthreads();

  if (tid >= kCons) {
    // the producers: chunk c's r_dec, dS slab, y slab and exp(total) into
    // stage c % kK once the consumers are done with chunk c - kK
    const int pt = tid - kCons;
    const int q4 = NP / 4;
    for (int c = 0; c < nc; ++c) {
      const int st = c % kK;
      if (c >= kK) mbar_wait(&empty[st], (c / kK - 1) & 1);
      float* sRd = smem + st * SF;
      float* sDs = sRd + C * LDR;
      float* sY = sDs + NP * LDS;
      float* sDec = sY + C * LDS;
      const long long tile = (long long)bh * nc + c;
      const float* grd = rdec + tile * C * NP;
      for (int i = pt; i < C * q4; i += kProd) {
        const int t = i / q4;
        const int n = (i % q4) * 4;
        cp16(sRd + t * LDR + n, grd + t * NP + n, true);
      }
      const float* gds = dS + tile * NP * NP + m0;
      for (int i = pt; i < NP * (kSlab / 4); i += kProd) {
        const int n = i / (kSlab / 4);
        const int m = (i % (kSlab / 4)) * 4;
        const bool ok = m0 + m < NP;
        cp16(sDs + n * LDS + m, ok ? gds + n * NP + m : dS, ok);
      }
      for (int i = pt; i < q4; i += kProd) cp16(sDec + i * 4, dec + tile * NP + i * 4, true);
      const int R = min(C, L - c * C);
      const float* gy = y + yb + (long long)c * C * step + m0;
      if (vec) {
        for (int i = pt; i < C * (kSlab / 4); i += kProd) {
          const int t = i / (kSlab / 4);
          const int m = (i % (kSlab / 4)) * 4;
          const bool ok = t < R && m0 + m < N;
          cp16(sY + t * LDS + m, ok ? gy + t * step + m : y, ok);
        }
      } else {
        for (int i = pt; i < C * kSlab; i += kProd) {
          const int t = i / kSlab;
          const int m = i % kSlab;
          const bool ok = t < R && m0 + m < N;
          cp4(sY + t * LDS + m, ok ? gy + t * step + m : y, ok);
        }
      }
      cp_arrive(&full[st]);
    }
    cp_wait<0>();
    return;
  }

  // the consumers
  const int mt = wid / kNT;                  // rows 16 mt .. 16 mt + 15
  const int nt = wid % kNT;                  // slab columns 8 nt .. 8 nt + 7
  // the warp's piece of S as B fragments: rows 8 ks + q (+ 4), column col
  const int col = m0 + nt * 8 + g;
  float st[8][2];
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = ks * 8 + q + 4 * j;
      st[ks][j] = (ks < KS && n < N && col < N)
                      ? s0[(long long)bh * N * N + (long long)n * N + col]
                      : 0.0f;
    }
  }

  const int tr = mt * 16 + g;                // this thread's rows tr, tr + 8
  const int tc = nt * 8 + 2 * q;             // and slab columns tc, tc + 1
  const int m = m0 + tc;
  // chunk c: wait for its stage, y_intra + r_dec . S into (d, d1) (even
  // and odd k-steps), then S <- exp(total) * S + dS
  auto run = [&](int c, float (&d)[4], float (&d1)[4]) {
    const int sg = c % kK;
    mbar_wait(&full[sg], (c / kK) & 1);
    const float* sRd = smem + sg * SF;
    const float* sDs = sRd + C * LDR;
    const float* sY = sDs + NP * LDS;
    const float* sDec = sY + C * LDS;
    d[0] = sY[tr * LDS + tc];
    d[1] = sY[tr * LDS + tc + 1];
    d[2] = sY[(tr + 8) * LDS + tc];
    d[3] = sY[(tr + 8) * LDS + tc + 1];
#pragma unroll
    for (int i = 0; i < 4; ++i) d1[i] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      if (ks < KS) {
        float a[4];
        frag_a(a, sRd + mt * 16 * LDR + ks * 8, LDR, g, q);
        const float bb[2] = {st[ks][0], st[ks][1]};
        if (ks % 2)
          mma3(d1, Split<4>(a), Split<2>(bb));
        else
          mma3(d, Split<4>(a), Split<2>(bb));
      }
    }
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      if (ks < KS) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = ks * 8 + q + 4 * j;
          st[ks][j] = sDec[n] * st[ks][j] + sDs[n * LDS + nt * 8 + g];
        }
      }
    }
    mbar_arrive(&empty[sg]);   // this thread is done with stage sg
  };
  // y of chunk c, stored once the products of chunk c + 1 are issued, so
  // that their latency overlaps
  auto finish = [&](int c, const float (&d)[4], const float (&d1)[4]) {
    const int R = min(C, L - c * C);
    float* yo = y + yb + (long long)(c * C + tr) * step + m;
    if (m < N && tr < R) yo[0] = d[0] + d1[0];
    if (m + 1 < N && tr < R) yo[1] = d[1] + d1[1];
    if (m < N && tr + 8 < R) yo[8 * step] = d[2] + d1[2];
    if (m + 1 < N && tr + 8 < R) yo[8 * step + 1] = d[3] + d1[3];
  };
  float dA[4], dA1[4], dB[4], dB1[4];        // even and odd chunks
  for (int c = 0; c < nc; c += 2) {
    run(c, dA, dA1);
    if (c > 0) finish(c - 1, dB, dB1);
    if (c + 1 < nc) {
      run(c + 1, dB, dB1);
      finish(c, dA, dA1);
    }
  }
  if (nc % 2)
    finish(nc - 1, dA, dA1);
  else
    finish(nc - 1, dB, dB1);

  if (mt == 0 && col < N) {   // every row tile's warps hold the same S
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = ks * 8 + q + 4 * j;
        if (ks < KS && n < N) sout[(long long)bh * N * N + (long long)n * N + col] = st[ks][j];
      }
    }
  }
}

// Scratch layout: r_dec (tiles C NP), dS (tiles NP NP), exp(total) (tiles NP).
struct Scratch {
  float* rdec;
  float* dS;
  float* dec;
};

template <int C>
Scratch split_scratch(float* scratch, long long tiles, int NP) {
  float* dS = scratch + tiles * C * NP;
  return {scratch, dS, dS + tiles * NP * NP};
}

// 1 when rows of N floats may be moved as float4: N % 4 == 0 and every
// pointer OR-ed into bits is 16-byte aligned.
int vec_ok(int N, uintptr_t bits) { return (N % 4 == 0 && (bits & 15) == 0) ? 1 : 0; }

uintptr_t addr(const void* p) { return reinterpret_cast<uintptr_t>(p); }

template <int C>
int launch_intra(const float* r, const float* k, const float* v, const float* w,
                 const float* u, float* y, float* scratch, int B, int L, int H, int N,
                 cudaStream_t stream) {
  const int NP = pad16(N);
  const int nc = (L + C - 1) / C;
  const long long tiles = (long long)B * H * nc;
  const Scratch sc = split_scratch<C>(scratch, tiles, NP);
  const size_t smem = IntraSmem<C>::floats(NP) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(wkv6_intra_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  wkv6_intra_kernel<C><<<(unsigned)tiles, kIntraThreads, smem, stream>>>(
      r, k, v, w, u, y, sc.rdec, sc.dS, sc.dec, L, H, N, NP, nc, 
      vec_ok(N, addr(r) | addr(k) | addr(v) | addr(w) | addr(y)));
  return (int)cudaGetLastError();
}

template <int C>
int launch_scan(const float* s0, float* y, float* sout, float* scratch, int B, int L,
                int H, int N, cudaStream_t stream) {
  const int NP = pad16(N);
  const int nc = (L + C - 1) / C;
  const Scratch sc = split_scratch<C>(scratch, (long long)B * H * nc, NP);
  const size_t smem = (size_t)kStages<C> * ScanSmem<C>::stage_floats(NP) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(wkv6_scan_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (NP + kSlab - 1) / kSlab);
  wkv6_scan_kernel<C><<<grid, ScanSmem<C>::kThreads, smem, stream>>>(
      sc.rdec, sc.dS, sc.dec, s0, y, sout, L, H, N, NP, nc, vec_ok(N, addr(y)));
  return (int)cudaGetLastError();
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


// Floats of scratch the chunked route needs: B H nc NP (C + NP + 1), with
// nc = ceil(L / chunk) and NP = N rounded up to 16.  -1 for a bad shape.
long long wkv6_scratch_floats(int B, int L, int H, int N, int chunk) {
  if (B < 1 || L < 1 || H < 1 || N < 1 || N > kMaxN ||
      (chunk != 16 && chunk != 32 && chunk != 64)) {
    return -1;
  }
  const long long NP = pad16(N);
  const long long nc = (L + chunk - 1) / chunk;
  return (long long)B * H * nc * NP * (chunk + NP + 1);
}

// A chunked launch's checks: wkv6_scratch_floats of the shape is defined
// and the grid of wkv6_intra_kernel fits.
bool chunked_shape_ok(int B, int L, int H, int N, int chunk) {
  const long long tiles = (long long)B * H * ((L + chunk - 1) / chunk);
  return wkv6_scratch_floats(B, L, H, N, chunk) >= 0 && tiles <= 2147483647LL;
}

// The chunked route is wkv6_intra_launch then wkv6_scan_launch on one
// stream, with one scratch of wkv6_scratch_floats floats.  All pointers to
// contiguous float32 device memory.  Each returns a cudaError_t.

// Phase 1: y_intra into y; r_dec, dS and exp(total) into scratch.
int wkv6_intra_launch(const void* r, const void* k, const void* v, const void* w,
                      const void* u, void* y, void* scratch, int B, int L, int H,
                      int N, int chunk, void* stream) {
  if (!chunked_shape_ok(B, L, H, N, chunk)) return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (chunk) {
    case 16:
      return launch_intra<16>(f(r), f(k), f(v), f(w), f(u), m(y), m(scratch), B, L, H, N, st);
    case 32:
      return launch_intra<32>(f(r), f(k), f(v), f(w), f(u), m(y), m(scratch), B, L, H, N, st);
    default:
      return launch_intra<64>(f(r), f(k), f(v), f(w), f(u), m(y), m(scratch), B, L, H, N, st);
  }
}

// Phase 2: the state scan from s0 over phase 1's scratch; adds y_inter
// into y and writes s_final.
int wkv6_scan_launch(const void* s0, void* y, void* s_final, void* scratch, int B,
                     int L, int H, int N, int chunk, void* stream) {
  if (!chunked_shape_ok(B, L, H, N, chunk)) return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (chunk) {
    case 16:
      return launch_scan<16>(f(s0), m(y), m(s_final), m(scratch), B, L, H, N, st);
    case 32:
      return launch_scan<32>(f(s0), m(y), m(s_final), m(scratch), B, L, H, N, st);
    default:
      return launch_scan<64>(f(s0), m(y), m(s_final), m(scratch), B, L, H, N, st);
  }
}

}  // extern "C"
