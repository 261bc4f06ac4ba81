// Flash attention forward on Hopper (sm_90a): causal GQA with an optional
// sliding window, online softmax in float32.
//
// Two launchers with a plain C interface, bound with ctypes by
// repro_torch/kernels/flash_attention/kernel.py.  Both replace
// repro/kernels/flash_attention/kernel.py flash_attention_pallas
// (_flash_kernel); the binding picks one by dtype and head size:
//
//   flash_attention_tc_launch  bfloat16 q, k, v with D % 8 == 0: the
//                              tensor-core kernel (wgmma on TMA-staged tiles)
//   flash_attention_launch     float32, and bfloat16 with D % 8 != 0 (no
//                              valid TMA row stride; no config has it): the
//                              float32 kernel on the CUDA cores
//
// What both compute: q (B, H, S, D), k and v (B, Hkv, S, D), contiguous,
// H % Hkv == 0, D <= 128, any S.  Query head h reads KV head h / (H / Hkv).
// Query i attends key j when j < S, j <= i (causal) and j > i - window
// (sliding window).  Scores, softmax and the accumulator are float32;
// masked scores are -1e30 and masked probabilities exactly 0; the output is
// acc / max(l, 1e-30) in q's type.
//
// What bounds them: operations.  Each attended (query, key) pair costs 4 D
// flops (q.k and p.v), so the yi-9b prefill call (B = 2, H = 32, Hkv = 4,
// S = 4096, D = 128, causal) does 2.75e11 flops: 0.278 ms at the card's
// 989 TFLOP/s bf16 tensor-core rate, against 151 MB of q, k, v and out,
// 0.045 ms at 3.35 TB/s.
//
// The tensor-core kernel.  One block of three warpgroups owns 128 query
// rows of one (b, h), the tile of longest causal rows first:
// - warpgroup 0 is the producer: it gives up registers (setmaxnreg 24) and
//   one thread starts every TMA load (cp.async.bulk.tensor): the Q tile
//   once, then 128-key K and V tiles through a two-stage ring in shared
//   memory, each stage with a full and an empty mbarrier for K and for V.
//   The tensor maps (built on the host with cuTensorMapEncodeTiled, reached
//   through cudaGetDriverEntryPoint, so no -lcuda) view q, k and v as
//   (B * heads, S, D) with 128-row x 64-column boxes and the 128-byte
//   swizzle; a D = 128 row is two boxes.  TMA fills rows past S and columns
//   past D with zeros, so nothing is padded in device memory.
// - warpgroups 1 and 2 are consumers (setmaxnreg 240), 64 query rows each.
//   Per key tile: S = Q K^T by wgmma m64n128k16, both operands in shared
//   memory, K-major; the K stage is released; mask (only on tiles that cross
//   the diagonal, the window's edge or S), online softmax in registers (row
//   max by quad shuffles, running m, l and alpha); P rounded to bf16 in
//   registers is the A operand of O += P V (wgmma m64n{64,128}k16, V
//   MN-major from shared memory through the transpose bit); the V stage is
//   released.  The accumulator stays float32 in registers.
// - the key-tile loop starts at the window's first tile and ends at the
//   diagonal, so tiles wholly above the diagonal or outside the window are
//   never loaded (the TPU kernel's pl.when(needed)).
// - epilogue: acc / max(l, 1e-30) to bf16, stores masked for rows >= S and
//   columns >= D.
// D <= 64 runs with 64 columns per tile and D <= 128 with 128 (a template).
//
// The one numerical change: the probabilities enter P.V as bf16 (as in
// FlashAttention-2/3 and SDPA's own kernels); l sums them in float32 before
// rounding.  Q.K^T from bf16 operands is exact up to the order of the float32
// sums.  Rounding each p_j to bf16 moves o by at most 2^-8 sum_j p_j |v_j|,
// and rounding o to bf16 by 2^-8 |o|, so each element is held to
// |got - want| <= 2^-8 |want| + 2^-8 (P|V|) + 2e-5 against the plain
// version in float32 (repro_torch/kernels/flash_attention/ref.py
// flash_error), beside the max abs 0.03 and relative L2 4e-3 bars.
//
// The float32 kernel.  One block of 256 threads per (query tile of 64 rows,
// b * H + h), the tile of longest causal rows first.  The block stages its
// query tile, then one 64-key tile of K and of V at a time, in shared memory
// as float32 (rows padded by 4 floats, so that 16 lanes reading 16 rows hit
// distinct banks).  Thread (ty, tx) of the 16 x 16 grid owns query rows
// 4 ty .. 4 ty + 3: it computes their scores against keys tx + 16 j (a 4 x 4
// register tile of the 64 x 64 product), reduces the row max and sum over
// the 16 lanes of its row group with shuffles, writes the probabilities to a
// shared tile, and accumulates columns c * 64 + 4 tx .. + 3 of the output
// rows (a 4 x 8 register tile for D = 128).  It runs on the CUDA cores at
// the float32 rate (67 TFLOP/s), as the TPU kernel casts q, k and v to
// float32.  The key-tile loop is bounded as above; rows and keys past S are
// masked in the kernel.
//
// Arithmetic: no fast math (expf, IEEE division), as in the plain version.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kMaxQTiles = 65535;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);    // round to nearest even, as torch's cast
}

// Rows r0 .. r0 + 63 of a contiguous (S, D) slab into a (64, DP + 4) float
// tile; rows at or past S and columns at or past D are zero.
template <typename T, int DP>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int r0, int S, int D) {
  constexpr int LD = DP + 4;
  const int rows = min(kBQ, S - r0);
  for (int i = threadIdx.x; i < kBQ * DP; i += kThreads) {
    const int r = i / DP;
    const int c = i % DP;
    float x = 0.0f;
    if (r < rows && c < D) x = to_f32(src[(long long)(r0 + r) * D + c]);
    dst[r * LD + c] = x;
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int H, int Hkv,
                 int S, int D, int causal, int window, float scale) {
  constexpr int LD = DP + 4;         // padded row of a Q, K or V tile
  constexpr int LDP = kBK + 4;       // padded row of the probability tile
  constexpr int NC = DP / 64;        // output column chunks a thread owns
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + kBQ * LD;
  float* v_s = k_s + kBK * LD;
  float* p_s = v_s + kBK * LD;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int kvh = (bh % H) / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const long long slab = (long long)S * D;
  const T* kp = k + ((long long)b * Hkv + kvh) * slab;
  const T* vp = v + ((long long)b * Hkv + kvh) * slab;
  T* op = out + (long long)bh * slab;

  stage<T, DP>(q_s, q + (long long)bh * slab, q0, S, D);

  // key tiles [t_begin, t_end): from the window's first key to the diagonal
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_end = causal ? q_last + 1 : S;
  const int t_begin = k_begin / kBK;
  const int t_end = (k_end + kBK - 1) / kBK;
  const int d_end = (D + 3) & ~3;

  float m[4], l[4], acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.0f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();                 // the last tile's K, V and P are read
    stage<T, DP>(k_s, kp, k0, S, D);
    stage<T, DP>(v_s, vp, k0, S, D);
    __syncthreads();

    // scores of rows 4 ty + i against keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < d_end; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_s + (ty * 4 + i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // mask, online softmax, probabilities to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        ok[j] = col < S && (!causal || col <= row) &&
                (window <= 0 || col > row - window);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
        sum += p;
        p_s[(ty * 4 + i) * LDP + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P V over the tile's keys (P is 0 and V is 0 past S)
    const int j_end = (min(kBK, S - k0) + 3) & ~3;
    for (int j = 0; j < j_end; j += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pr[i] = *reinterpret_cast<const float4*>(p_s + (ty * 4 + i) * LDP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(
              v_s + (j + jj) * LD + c * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = jj == 0 ? pr[i].x : jj == 1 ? pr[i].y
                          : jj == 2 ? pr[i].z : pr[i].w;
            acc[i][4 * c + 0] = fmaf(p, vv.x, acc[i][4 * c + 0]);
            acc[i][4 * c + 1] = fmaf(p, vv.y, acc[i][4 * c + 1]);
            acc[i][4 * c + 2] = fmaf(p, vv.z, acc[i][4 * c + 2]);
            acc[i][4 * c + 3] = fmaf(p, vv.w, acc[i][4 * c + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = c * 64 + tx * 4 + e;
        if (d < D) op[(long long)row * D + d] = from_f32<T>(acc[i][4 * c + e] / denom);
      }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int Hkv, int S, int D, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem =
      (size_t)(kBQ * (DP + 4) + 2 * kBK * (DP + 4) + kBQ * (kBK + 4)) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  flash_fwd_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, Hkv, S, D, causal,
      window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// ------------------------------------------------- the tensor-core kernel ----
namespace tc {

constexpr int kBQ = 128;                // query rows per block
constexpr int kBK = 128;                // keys per K or V tile
constexpr int kThreads = 384;           // producer + two consumer warpgroups
constexpr int kBoxCols = 64;            // bf16 columns of a 128-byte swizzled row
constexpr int kBoxBytes = 128 * 128;    // one TMA box: 128 rows of 128 bytes
constexpr int kStages = 2;              // the K/V ring
constexpr int kMaxQTiles = 65535;
constexpr int kEncodeFailed = -1;       // cuTensorMapEncodeTiled refused
constexpr float kNegInf = -1e30f;
static_assert(kBQ == kBK, "Q, K and V share one box shape");

// Shared memory of one block from a 1024-byte aligned base (the 128-byte
// swizzle repeats every 8 rows of 128 bytes).  Barriers: 0 Q full, 1 + s K
// full, 3 + s V full, 5 + s K empty, 7 + s V empty, for stage s.
template <int DP>
struct Smem {
  static constexpr int kTile = DP / kBoxCols * kBoxBytes;   // a Q, K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;
  static constexpr int kBytes = kBar + 9 * 8 + 1024;        // + alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box (64 columns from c0, 128 rows from c1, slab c2) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory matrix descriptor for the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving register reads or writes across the
// asynchronous products' fences
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (m64 x n128, f32) = a . b (+ d when scale_d), a and b in shared memory,
// both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (m64 x n128, f32) += a . b, a in registers (bf16 pairs), b in shared
// memory, MN-major (the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64 x n64, f32) += a . b, a in registers (bf16 pairs), b in shared
// memory, MN-major (the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&o)[DP / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DP == 128) {
    wgmma_rs_n128(o, a, db);
  } else {
    wgmma_rs_n64(o, a, db);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);   // round to nearest even
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    __nv_bfloat16* __restrict__ out, int H, int Hkv, int S,
                    int D, int causal, int window, float scale) {
  using L = Smem<DP>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base + L::kQ;
  const uint32_t sk = base + L::kK;
  const uint32_t sv = base + L::kV;
  const uint32_t bar = base + L::kBar;

  const int bh = blockIdx.x;
  const int kvh = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  // key tiles [t_begin, t_begin + n_tiles): from the window's first key to
  // the diagonal
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_end = causal ? q_last + 1 : S;
  const int t_begin = k_begin / kBK;
  const int n_tiles = (k_end + kBK - 1) / kBK - t_begin;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 5; ++i) mbar_init(bar + 8 * i, 1);   // the producer
    for (int i = 5; i < 9; ++i) mbar_init(bar + 8 * i, 8);   // 8 consumer warps
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread starts every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar, L::kTile);
      for (int c = 0; c < DP / kBoxCols; ++c)
        tma_load(sq + c * kBoxBytes, &tq, bar, c * kBoxCols, q0, bh);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it & 1;
        const uint32_t parity = ((it >> 1) & 1) ^ 1;   // the first round is free
        const int k0 = (t_begin + it) * kBK;
        mbar_wait(bar + 8 * (5 + s), parity);
        mbar_expect_tx(bar + 8 * (1 + s), L::kTile);
        for (int c = 0; c < DP / kBoxCols; ++c)
          tma_load(sk + s * L::kTile + c * kBoxBytes, &tk, bar + 8 * (1 + s),
                   c * kBoxCols, k0, kvh);
        mbar_wait(bar + 8 * (7 + s), parity);
        mbar_expect_tx(bar + 8 * (3 + s), L::kTile);
        for (int c = 0; c < DP / kBoxCols; ++c)
          tma_load(sv + s * L::kTile + c * kBoxBytes, &tv, bar + 8 * (3 + s),
                   c * kBoxCols, k0, kvh);
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    constexpr int NO = DP / 2;                 // accumulator registers
    const int c = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) & 3;
    const int lane = threadIdx.x & 31;
    const int wg_row = q0 + 64 * c;            // the warpgroup's first row
    const int row0 = wg_row + 16 * warp + (lane >> 2);   // rows row0, row0 + 8
    const int col0 = 2 * (lane & 3);
    // register r of an m64 accumulator holds row row0 + 8 ((r >> 1) & 1) and
    // column 8 (r >> 2) + col0 + (r & 1)
    const uint32_t qa = sq + c * 64 * 128;     // this warpgroup's rows of each box

    float o[NO];
#pragma unroll
    for (int r = 0; r < NO; ++r) o[r] = 0.0f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.0f, 0.0f};                 // this thread's share of each row
    float sc[kBK / 2];
    uint32_t pa[kBK / 16][4];

    mbar_wait(bar, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it & 1;
      const uint32_t parity = (it >> 1) & 1;
      const int k0 = (t_begin + it) * kBK;
      const uint32_t kt = sk + s * L::kTile;
      const uint32_t vt = sv + s * L::kTile;

      // S = Q K^T: k16 steps along D; a step past 64 columns moves to the
      // next box, one inside a box moves 32 bytes along the swizzled row
      mbar_wait(bar + 8 * (1 + s), parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        wgmma_ss_n128(sc, desc(qa + off, 16, 1024), desc(kt + off, 16, 1024),
                      kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar + 8 * (5 + s));

      // mask, online softmax; P to bf16 A fragments (register pairs 8 kk +
      // 2 j, + 1 are the j-th 32-bit register of k16 step kk)
      const bool masked = k0 + kBK > S || (causal && k0 + kBK - 1 > wg_row) ||
                          (window > 0 && k0 <= wg_row + 63 - window);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int r = 0; r < kBK / 2; ++r) {
        const int i = (r >> 1) & 1;
        float x = sc[r] * scale;
        if (masked) {
          const int row = row0 + 8 * i;
          const int col = k0 + 8 * (r >> 2) + col0 + (r & 1);
          const bool ok = col < S && (!causal || col <= row) &&
                          (window <= 0 || col > row - window);
          if (!ok) x = kNegInf;
        }
        sc[r] = x;
        mx[i] = fmaxf(mx[i], x);
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        alpha[i] = expf(m[i] - mx[i]);
        m[i] = mx[i];
      }
      float sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < kBK / 2; r += 2) {
        const int i = (r >> 1) & 1;
        float p0 = expf(sc[r] - m[i]);
        float p1 = expf(sc[r + 1] - m[i]);
        if (masked) {
          if (sc[r] == kNegInf) p0 = 0.0f;
          if (sc[r + 1] == kNegInf) p1 = 0.0f;
        }
        sum[i] += p0 + p1;                     // float32, before rounding
        pa[r / 8][(r % 8) / 2] = pack_bf16(p0, p1);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
#pragma unroll
      for (int r = 0; r < NO; ++r) o[r] *= alpha[(r >> 1) & 1];

      // O += P V: k16 steps along the keys, 16 rows (2048 bytes) each; the
      // next 64 columns of V are one box (kBoxBytes) further
      mbar_wait(bar + 8 * (3 + s), parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_pv<DP>(o, pa[kk], desc(vt + kk * 2048, kBoxBytes, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar + 8 * (7 + s));
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
    __nv_bfloat16* op = out + (long long)bh * S * D;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row >= S) continue;
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + col0;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(op + (long long)row * D + col) =
              __floats2bfloat162_rn(o[4 * j + 2 * i] / denom,
                                    o[4 * j + 2 * i + 1] / denom);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime (no
// -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (slabs, S, D) bf16 as 128-row x 64-column boxes with the 128-byte swizzle;
// rows past S and columns past D read as zero
bool make_map(CUtensorMap* map, const void* ptr, int S, int D, int slabs) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)slabs};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {kBoxCols, kBK, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int Hkv, int S, int D, int causal, int window, float scale,
           cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, S, D, B * H) || !make_map(&mk, k, S, D, B * Hkv) ||
      !make_map(&mv, v, S, D, B * Hkv)) {
    return kEncodeFailed;
  }
  const int smem = Smem<DP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  flash_fwd_tc_kernel<DP><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), H, Hkv, S, D, causal,
      window, scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

extern "C" {

// dtype: 0 float32, 1 bfloat16; window <= 0: none.  Returns a cudaError_t.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int H, int Hkv, int S, int D,
                           int causal, int window, float scale, int dtype,
                           void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || S < 1 || D < 1 ||
      D > 128 || (S + kBQ - 1) / kBQ > kMaxQTiles ||
      (long long)B * H > 2147483647LL || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return D <= 64 ? launch<float, 64>(q, k, v, out, B, H, Hkv, S, D, causal,
                                       window, scale, st)
                   : launch<float, 128>(q, k, v, out, B, H, Hkv, S, D, causal,
                                        window, scale, st);
  }
  return D <= 64 ? launch<__nv_bfloat16, 64>(q, k, v, out, B, H, Hkv, S, D,
                                             causal, window, scale, st)
                 : launch<__nv_bfloat16, 128>(q, k, v, out, B, H, Hkv, S, D,
                                              causal, window, scale, st);
}

// bfloat16 q, k, v and out; D % 8 == 0 (TMA needs 16-byte row strides) and
// q, k, v 16-byte aligned; window <= 0: none.  Returns a cudaError_t, or -1
// when cuTensorMapEncodeTiled refused a tensor map.
int flash_attention_tc_launch(const void* q, const void* k, const void* v,
                              void* out, int B, int H, int Hkv, int S, int D,
                              int causal, int window, float scale,
                              void* stream) {
  const auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || S < 1 || D < 8 ||
      D > 128 || D % 8 != 0 || (S + tc::kBQ - 1) / tc::kBQ > tc::kMaxQTiles ||
      (long long)B * H > 2147483647LL || misaligned(q) || misaligned(k) ||
      misaligned(v) || misaligned(out)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D <= 64 ? tc::launch<64>(q, k, v, out, B, H, Hkv, S, D, causal,
                                  window, scale, st)
                 : tc::launch<128>(q, k, v, out, B, H, Hkv, S, D, causal,
                                   window, scale, st);
}

}  // extern "C"
