// Flash attention forward on Hopper (sm_90a): causal GQA with an optional
// sliding window, online softmax in float32.
//
// One launcher with a plain C interface, bound with ctypes by
// repro_torch/kernels/flash_attention/kernel.py:
//
//   flash_attention_launch   replaces repro/kernels/flash_attention/kernel.py
//                            flash_attention_pallas (_flash_kernel)
//
// What it computes: q (B, H, S, D), k and v (B, Hkv, S, D), contiguous, in
// float32 or bfloat16, H % Hkv == 0, D <= 128, any S.  Query head h reads KV
// head h / (H / Hkv).  Query i attends key j when j < S, j <= i (causal) and
// j > i - window (sliding window).  Scores, softmax and the P.V sums are
// float32 whatever the element type; masked scores are -1e30 and masked
// probabilities exactly 0; the output is acc / max(l, 1e-30) in q's type.
//
// What bounds it: operations.  Each attended (query, key) pair costs 4 D
// flops (q.k and p.v), so a causal prefill at B = 2, H = 32, S = 4096,
// D = 128 does 2.75e11 flops: 0.28 ms at the card's 989 TFLOP/s bf16 rate,
// against 151 MB of q, k, v and out, 0.045 ms at 3.35 TB/s.  This kernel
// computes in float32 on the CUDA cores (67 TFLOP/s), as the TPU kernel
// casts q, k and v to float32; the bf16 tensor-core product (wgmma, TMA) is
// later work.
//
// Design: one block of 256 threads per (query tile of 64 rows, b * H + h),
// the tile of longest causal rows first.  The block stages its query tile,
// then one 64-key tile of K and of V at a time, in shared memory as float32
// (rows padded by 4 floats, so that 16 lanes reading 16 rows hit distinct
// banks).  Thread (ty, tx) of the 16 x 16 grid owns query rows 4 ty .. 4 ty
// + 3: it computes their scores against keys tx + 16 j (a 4 x 4 register
// tile of the 64 x 64 product), reduces the row max and sum over the 16
// lanes of its row group with shuffles, writes the probabilities to a shared
// tile, and accumulates columns c * 64 + 4 tx .. + 3 of the output rows (a
// 4 x 8 register tile for D = 128, so no thread holds a 128-float row).  The
// key-tile loop starts at the window's first key and ends at the diagonal,
// so tiles wholly above the diagonal or outside the window are never read
// (the TPU kernel's pl.when(needed)).  Rows and keys past S are masked in
// the kernel, and the staged tiles are zero there: nothing is padded in
// device memory.
//
// Arithmetic: no fast math (expf, IEEE division), as in the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // extern "C"
