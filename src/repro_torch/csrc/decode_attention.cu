// Decode attention on Hopper (sm_90a): one query position per query head
// against a key/value cache, GQA, online softmax in float32.
//
// Launchers with a plain C interface, bound with ctypes by
// repro_torch/kernels/decode_attention/kernel.py.  They replace no TPU
// kernel: the reference decodes with XLA einsums (repro/models/attention.py
// attn_decode: the cache repeated to every query head, float32 scores over
// every slot, slots that hold no token masked to -1e30) and has no Pallas
// kernel for it.  The port's plain version of the same arithmetic
// (repro_torch/kernels/decode_attention/ref.py) upcasts the whole bf16 cache
// to float32 and multiplies on the CUDA cores, 17x its bytes bound at
// yi-9b's serving shape; this kernel was added to take that step to the
// memory's rate.
//
//   decode_attention_launch         the attention (bf16 or float32), and
//                                   the merge of the KV splits when the
//                                   call is split
//   decode_attention_blocks_per_sm  resident blocks an SM holds, for the
//                                   binding's choice of the split count
//
// What it computes: q (B, Hk, G, D), k and v (B, Hk, S, D), contiguous, all
// bf16 or all float32, G <= 16 query heads a kv head, D a multiple of 8 up
// to 128, and n_valid in 1..S.  For every (b, kv head j, query head g):
//   s_t = (q . k_t) / sqrt(D) for t < n_valid,  p = softmax(s),
//   out = sum_t p_t v_t,
// in q's type.  Slots t >= n_valid are never read: in the plain version
// they score -1e30 and weigh exp(-1e30 - m) = 0 exactly, so leaving them
// out is the same function.  A window model's ring buffer holds its tokens
// in slots 0 .. n_valid - 1 too, and the softmax does not care about their
// order.
//
// What bounds it: bytes.  At yi-9b's serving shape (B = 128, Hk = 4, G = 8,
// D = 128, S = 4096, n_valid about 2,250) the valid K and V are 128 x 4 x
// 2,250 x 128 x 2 B x 2 = 590 MB a layer, 0.176 ms at 3.35 TB/s; q and out
// add 2 MB.  Its operations, 4 G D flops a position, are 4.7 GFLOP a layer:
// 0.005 ms on the tensor cores, 0.07 ms even on the CUDA cores.
//
// The bf16 kernel (decode_tc_kernel<DP>): a block of four warps owns one
// (batch row, kv head, KV split) and reads each K and V element of its
// range from device memory once, for all G query heads.
// - K and V stream through a ring of three stages in shared memory, 64
//   positions a stage, by cp.async (16 bytes a thread and copy); the copy of
//   a row at or past the range's end is given a source size of 0, so it
//   reads nothing and fills the row with zeros.  Rows are padded by 16
//   bytes, which keeps ldmatrix free of bank conflicts; D is padded to DP
//   (16, 32, 64 or 128 columns), the padding zeroed once.
// - Each warp takes 16 positions of every stage and keeps its own running
//   max, sum and float32 accumulator for the G heads (rows of an m16 tile;
//   rows past G are zero and never stored).  Scores are mma.sync m16n8k16
//   with q (registers) and k (ldmatrix) in bf16 and float32 accumulation:
//   a bf16 x bf16 product is exact in float32, so only the order of the
//   float32 sums differs from the plain version.
// - P . V keeps P at float32 precision: each probability is split into
//   three bf16 terms by rounding to nearest, p = hi + mid + lo exactly (8
//   significant bits a term, and the sign of each remainder gives a ninth),
//   and the three products with the bf16 V are summed in float32 by three
//   mma.sync into one accumulator.  Rounding P once to bf16, as the prefill
//   kernel does, would be a lower precision than the reference's float32
//   decode.
// - At the end the four warps' partial results are merged through shared
//   memory by their maxima.  An unsplit call writes out / l in q's type
//   (round to nearest, as .to() does); a split call writes its unscaled
//   accumulator, max and sum in float32 for decode_merge_kernel.
// - Two blocks share an SM (104 KB of shared memory each at DP = 128), so
//   six stages, 209 KB, are in flight on each SM: more than the 20 KB an SM
//   needs to keep device memory busy.
// The float32 kernel (decode_f32_kernel): the same blocks and splits on
// the CUDA cores, 32 positions a tile in shared memory, fmaf products.  No
// served configuration keeps its cache in float32 (the smoke models and
// the float32 cross-checks do), so it is plain rather than fast.
//
// Splits: where B * Hk blocks do not fill every SM's resident slots once
// (serving a few requests), the binding cuts the valid range into
// whole-tile splits, as many as fill the slots once, and
// decode_merge_kernel combines them by log-sum-exp.  At yi-9b's B = 128 and
// Hk = 4 there are 512 blocks and no split: one launch a layer.
//
// Arithmetic: no fast math (expf and IEEE division, as in the plain
// version); the scale is the division by sqrt(D) that the plain version
// does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;           // positions a stage: 16 a warp
constexpr int kStages = 3;
constexpr int kMaxGroup = 16;       // query heads a kv head: the m16 tile
constexpr int kF32Tile = 32;        // positions a tile of the float32 kernel
constexpr int kMaxD = 128;

// ---- the bf16 tensor-core kernel ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; src_bytes 0 reads nothing and writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr,
                                                  uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a . b, m16n8k16, bf16 inputs, float32 accumulator
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) = hi + mid + lo, each a bf16 pair (x0 in the low half): exact
// for normal float32 values
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float r0 = x0 - __low2float(h), r1 = x1 - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(r0 - __low2float(m), r1 - __high2float(m));
  hi = as_u32(h);
  mid = as_u32(m);
  lo = as_u32(l);
}

// two bf16 of q at (row, col), zero outside G x D
__device__ __forceinline__ uint32_t q_pair(const __nv_bfloat16* q, int row,
                                           int col, int G, int D) {
  if (row >= G || col >= D) return 0u;
  return *reinterpret_cast<const uint32_t*>(q + row * D + col);
}

template <int DP>
struct TcSmem {
  static constexpr int kRow = DP + 8;                  // bf16 a padded row
  static constexpr int kStage = 2 * kTile * kRow;      // K then V
  static constexpr int kBytes = kStages * kStage * 2;
  // the warps' partial results, merged at the end, fit in the ring
  static_assert(kWarps * kMaxGroup * (DP + 2) * 4 <= kBytes, "merge space");
};

template <int DP>
__global__ void __launch_bounds__(kThreads, 2)
decode_tc_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ part_o,
                 float* __restrict__ part_ml, int Hk, int G, int D, int S,
                 int n_valid, int split_len, float sqrt_d) {
  using Sm = TcSmem<DP>;
  constexpr int kRow = Sm::kRow;
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  const int split = blockIdx.x, splits = gridDim.x;
  const long long bh = (long long)blockIdx.z * Hk + blockIdx.y;
  const int start = split * split_len;
  const int end = min(n_valid, start + split_len);
  const int ntiles = (end - start + kTile - 1) / kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = lane >> 2, c2 = (lane & 3) * 2;

  // the padding columns D .. DP - 1 of every stage, never copied to
  if (D < DP) {
    for (int i = threadIdx.x; i < kStages * 2 * kTile * (DP - D);
         i += kThreads) {
      const int row = i / (DP - D), col = D + i % (DP - D);
      smem[row * kRow + col] = __float2bfloat16_rn(0.f);
    }
  }
  const __nv_bfloat16* kb = k + bh * S * D;
  const __nv_bfloat16* vb = v + bh * S * D;
  const auto load_tile = [&](int t) {
    __nv_bfloat16* ks = smem + (t % kStages) * Sm::kStage;
    __nv_bfloat16* vs = ks + kTile * kRow;
    const int p0 = start + t * kTile;
    constexpr int kChunks = DP / 8;                 // 16-byte chunks a row
    for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
      const int row = i / kChunks, ch = i % kChunks;
      if (ch * 8 >= D) continue;
      const int p = p0 + row;
      const bool ok = p < end;
      const long long off = (long long)(ok ? p : 0) * D + ch * 8;
      cp_async16(smem_addr(ks + row * kRow + ch * 8), kb + off, ok ? 16 : 0);
      cp_async16(smem_addr(vs + row * kRow + ch * 8), vb + off, ok ? 16 : 0);
    }
  };
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntiles) load_tile(t);
    cp_async_commit();
  }

  // q as the A operand: rows are the G heads, columns the head dims
  const __nv_bfloat16* qb = q + bh * G * D;
  uint32_t qa[DP / 16][4];
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    const int col = ks * 16 + c2;
    qa[ks][0] = q_pair(qb, r0, col, G, D);
    qa[ks][1] = q_pair(qb, r0 + 8, col, G, D);
    qa[ks][2] = q_pair(qb, r0, col + 8, G, D);
    qa[ks][3] = q_pair(qb, r0 + 8, col + 8, G, D);
  }

  float o[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();            // tile t landed; tile t - 1's stage is free
    if (t + kStages - 1 < ntiles) load_tile(t + kStages - 1);
    cp_async_commit();
    const __nv_bfloat16* ks = smem + (t % kStages) * Sm::kStage + warp * 16 * kRow;
    const __nv_bfloat16* vs = ks + kTile * kRow;

    // scores of this warp's 16 positions: s[n] holds positions 8n .. 8n + 7
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t b[4];
      ldmatrix_x4(smem_addr(ks + ((lane >> 4) * 8 + (lane & 7)) * kRow +
                            kk * 16 + ((lane >> 3) & 1) * 8),
                  b);
      mma_bf16(s[0], qa[kk], b[0], b[1]);
      mma_bf16(s[1], qa[kk], b[2], b[3]);
    }
    const int p0 = start + t * kTile + warp * 16;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = p0 + n * 8 + c2 + (e & 1) < end;
        s[n][e] = ok ? s[n][e] / sqrt_d : -INFINITY;
      }
    }
    // online softmax over the rows r0 (e = 0, 1) and r0 + 8 (e = 2, 3)
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = fmaxf(fmaxf(s[0][2 * h], s[0][2 * h + 1]),
                       fmaxf(s[1][2 * h], s[1][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[h], mx);
      const float base = m_new == -INFINITY ? 0.f : m_new;
      alpha[h] = expf(m_run[h] - base);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          s[n][e] = expf(s[n][e] - base);
          sum += s[n][e];
        }
      }
      l_run[h] = l_run[h] * alpha[h] + sum;     // this thread's columns
      m_run[h] = m_new;
    }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    // P (16 heads x 16 positions) as three bf16 A operands
    uint32_t ph[4], pm[4], pl[4];
    split3(s[0][0], s[0][1], ph[0], pm[0], pl[0]);
    split3(s[0][2], s[0][3], ph[1], pm[1], pl[1]);
    split3(s[1][0], s[1][1], ph[2], pm[2], pl[2]);
    split3(s[1][2], s[1][3], ph[3], pm[3], pl[3]);
#pragma unroll
    for (int n = 0; n < DP / 16; ++n) {
      uint32_t b[4];
      ldmatrix_x4_trans(smem_addr(vs + (((lane >> 3) & 1) * 8 + (lane & 7)) * kRow +
                                  n * 16 + (lane >> 4) * 8),
                        b);
      mma_bf16(o[2 * n], pl, b[0], b[1]);
      mma_bf16(o[2 * n], pm, b[0], b[1]);
      mma_bf16(o[2 * n], ph, b[0], b[1]);
      mma_bf16(o[2 * n + 1], pl, b[2], b[3]);
      mma_bf16(o[2 * n + 1], pm, b[2], b[3]);
      mma_bf16(o[2 * n + 1], ph, b[2], b[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();              // the ring is free for the warps' results

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
  }
  float* so = reinterpret_cast<float*>(smem);          // [warp][16][DP]
  float* sm = so + kWarps * kMaxGroup * DP;             // [warp][16] max
  float* sl = sm + kWarps * kMaxGroup;                  // [warp][16] sum
  float* row_a = so + (warp * kMaxGroup + r0) * DP;
  float* row_b = row_a + 8 * DP;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    row_a[n * 8 + c2] = o[n][0];
    row_a[n * 8 + c2 + 1] = o[n][1];
    row_b[n * 8 + c2] = o[n][2];
    row_b[n * 8 + c2 + 1] = o[n][3];
  }
  if ((lane & 3) == 0) {
    sm[warp * kMaxGroup + r0] = m_run[0];
    sm[warp * kMaxGroup + r0 + 8] = m_run[1];
    sl[warp * kMaxGroup + r0] = l_run[0];
    sl[warp * kMaxGroup + r0 + 8] = l_run[1];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int h = i / D, d = i % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm[w * kMaxGroup + h]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = sm[w * kMaxGroup + h];
      const float e = mw == -INFINITY ? 0.f : expf(mw - M);
      L += sl[w * kMaxGroup + h] * e;
      O += so[(w * kMaxGroup + h) * DP + d] * e;
    }
    if (splits == 1) {
      out[bh * G * D + i] = __float2bfloat16_rn(O / L);
    } else {
      const long long r = (bh * splits + split) * G + h;
      part_o[r * D + d] = O;
      if (d == 0) {
        part_ml[2 * r] = M;
        part_ml[2 * r + 1] = L;
      }
    }
  }
}

// ---- the float32 kernel: the same blocks on the CUDA cores ----

__global__ void __launch_bounds__(kThreads)
decode_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  float* __restrict__ part_o, float* __restrict__ part_ml,
                  int Hk, int G, int D, int S, int n_valid, int split_len,
                  float sqrt_d) {
  constexpr int kKRow = kMaxD + 1;                      // no bank conflicts
  __shared__ float qs[kMaxGroup * kMaxD];
  __shared__ float ks[kF32Tile * kKRow];
  __shared__ float vs[kF32Tile * kMaxD];
  __shared__ float ps[kMaxGroup * kF32Tile];
  __shared__ float ms[kMaxGroup], ls[kMaxGroup], as[kMaxGroup];
  const int split = blockIdx.x, splits = gridDim.x;
  const long long bh = (long long)blockIdx.z * Hk + blockIdx.y;
  const int start = split * split_len;
  const int end = min(n_valid, start + split_len);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kPer = kMaxGroup * kMaxD / kThreads;   // (head, dim) a thread
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    qs[(i / D) * kMaxD + i % D] = q[bh * G * D + i];
  }
  if (threadIdx.x < G) {
    ms[threadIdx.x] = -INFINITY;
    ls[threadIdx.x] = 0.f;
  }
  float acc[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) acc[r] = 0.f;
  const float* kb = k + bh * S * D;
  const float* vb = v + bh * S * D;
  for (int p0 = start; p0 < end; p0 += kF32Tile) {
    const int rows = min(kF32Tile, end - p0);
    __syncthreads();            // the previous tile is consumed
    for (int i = threadIdx.x; i < rows * D; i += kThreads) {
      const int row = i / D, d = i % D;
      ks[row * kKRow + d] = kb[(long long)p0 * D + i];
      vs[row * kMaxD + d] = vb[(long long)p0 * D + i];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < G * kF32Tile; i += kThreads) {
      const int h = i / kF32Tile, j = i % kF32Tile;
      float s = -INFINITY;
      if (j < rows) {
        float a = 0.f;
        for (int d = 0; d < D; ++d) a = fmaf(qs[h * kMaxD + d], ks[j * kKRow + d], a);
        s = a / sqrt_d;
      }
      ps[i] = s;
    }
    __syncthreads();
    for (int h = warp; h < G; h += kWarps) {
      const float s = ps[h * kF32Tile + lane];
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = ms[h], m_new = fmaxf(m_old, mx);
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float p = expf(s - base);
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ps[h * kF32Tile + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - base);
        as[h] = alpha;
        ls[h] = ls[h] * alpha + sum;
        ms[h] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int i = threadIdx.x + r * kThreads;
      if (i < G * D) {
        const int h = i / D, d = i % D;
        float a = acc[r] * as[h];
        for (int j = 0; j < rows; ++j) a = fmaf(ps[h * kF32Tile + j], vs[j * kMaxD + d], a);
        acc[r] = a;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = threadIdx.x + r * kThreads;
    if (i >= G * D) continue;
    const int h = i / D, d = i % D;
    if (splits == 1) {
      out[bh * G * D + i] = acc[r] / ls[h];
    } else {
      const long long row = (bh * splits + split) * G + h;
      part_o[row * D + d] = acc[r];
      if (d == 0) {
        part_ml[2 * row] = ms[h];
        part_ml[2 * row + 1] = ls[h];
      }
    }
  }
}

// ---- the merge of a split call's partial results ----

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void decode_merge_kernel(const float* __restrict__ part_o,
                                    const float* __restrict__ part_ml,
                                    T* __restrict__ out, long long n, int G,
                                    int D, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long row = i / D;                 // (b, kv head, query head)
  const int d = (int)(i % D);
  const long long bh = row / G;
  const int h = (int)(row % G);
  float M = -INFINITY;
  for (int s = 0; s < splits; ++s) {
    M = fmaxf(M, part_ml[2 * ((bh * splits + s) * G + h)]);
  }
  float L = 0.f, O = 0.f;
  for (int s = 0; s < splits; ++s) {
    const long long r = (bh * splits + s) * G + h;
    const float e = expf(part_ml[2 * r] - M);
    L += part_ml[2 * r + 1] * e;
    O += part_o[r * D + d] * e;
  }
  out[i] = from_float<T>(O / L);
}

template <int DP>
cudaError_t prepare_tc() {
  // once a device (CUDA keeps the attributes per device; setting them on
  // every launch would cost host time on every decode step): a bit a
  // device in `done`, devices past 63 set on every launch
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(decode_tc_kernel<DP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           TcSmem<DP>::kBytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(decode_tc_kernel<DP>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

template <int DP>
cudaError_t launch_tc(dim3 grid, const void* q, const void* k, const void* v,
                      void* out, float* part_o, float* part_ml, int Hk, int G,
                      int D, int S, int n_valid, int split_len, float sqrt_d,
                      cudaStream_t stream) {
  cudaError_t err = prepare_tc<DP>();
  if (err != cudaSuccess) return err;
  decode_tc_kernel<DP><<<grid, kThreads, TcSmem<DP>::kBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      part_o, part_ml, Hk, G, D, S, n_valid, split_len, sqrt_d);
  return cudaGetLastError();
}

template <int DP>
cudaError_t occupancy_tc(int* blocks) {
  cudaError_t err = prepare_tc<DP>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, decode_tc_kernel<DP>, kThreads, TcSmem<DP>::kBytes);
}

int padded_dim(int D) { return D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : 128; }

}  // namespace

extern "C" {

// Resident blocks of the kernel that takes (D, dtype) on one SM, into
// *blocks.  dtype: 0 float32, 1 bfloat16.  Returns a cudaError_t.
int decode_attention_blocks_per_sm(int D, int dtype, int* blocks) {
  if (D < 8 || D > kMaxD || D % 8 != 0 || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, decode_f32_kernel, kThreads, 0);
  }
  switch (padded_dim(D)) {
    case 16: return (int)occupancy_tc<16>(blocks);
    case 32: return (int)occupancy_tc<32>(blocks);
    case 64: return (int)occupancy_tc<64>(blocks);
    default: return (int)occupancy_tc<128>(blocks);
  }
}

// q (B, Hk, G, D), k and v (B, Hk, S, D), out (B, Hk, G, D), contiguous,
// 16-byte aligned, all of one dtype (0 float32, 1 bfloat16).  The valid
// positions 0 .. n_valid - 1 are cut into `splits` ranges of split_len;
// with splits > 1, part_o (B, Hk, splits, G, D) and part_ml (B, Hk, splits,
// G, 2) float32 hold the ranges' results until the merge.  Returns a
// cudaError_t.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            void* out, float* part_o, float* part_ml, int B,
                            int Hk, int G, int D, int S, int n_valid,
                            int splits, int split_len, float sqrt_d, int dtype,
                            void* stream) {
  const auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (B < 1 || B > 65535 || Hk < 1 || Hk > 65535 || G < 1 || G > kMaxGroup ||
      D < 8 || D > kMaxD || D % 8 != 0 || n_valid < 1 || n_valid > S ||
      splits < 1 || split_len < 1 ||
      (long long)(splits - 1) * split_len >= n_valid ||
      (long long)splits * split_len < n_valid || (dtype != 0 && dtype != 1) ||
      misaligned(q) || misaligned(k) || misaligned(v) || misaligned(out) ||
      (splits > 1 && (part_o == nullptr || part_ml == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(splits, Hk, B);
  cudaError_t err;
  if (dtype == 0) {
    decode_f32_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), part_o,
        part_ml, Hk, G, D, S, n_valid, split_len, sqrt_d);
    err = cudaGetLastError();
  } else {
    switch (padded_dim(D)) {
      case 16:
        err = launch_tc<16>(grid, q, k, v, out, part_o, part_ml, Hk, G, D, S,
                            n_valid, split_len, sqrt_d, st);
        break;
      case 32:
        err = launch_tc<32>(grid, q, k, v, out, part_o, part_ml, Hk, G, D, S,
                            n_valid, split_len, sqrt_d, st);
        break;
      case 64:
        err = launch_tc<64>(grid, q, k, v, out, part_o, part_ml, Hk, G, D, S,
                            n_valid, split_len, sqrt_d, st);
        break;
      default:
        err = launch_tc<128>(grid, q, k, v, out, part_o, part_ml, Hk, G, D, S,
                             n_valid, split_len, sqrt_d, st);
    }
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long n = (long long)B * Hk * G * D;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  if (dtype == 0) {
    decode_merge_kernel<float><<<blocks, threads, 0, st>>>(
        part_o, part_ml, static_cast<float*>(out), n, G, D, splits);
  } else {
    decode_merge_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        part_o, part_ml, static_cast<__nv_bfloat16*>(out), n, G, D, splits);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
