// Causal GQA flash-attention forward for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (see ../ops.py).
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::flash_attention_fwd
// (body `_fa_kernel`).  Same function: q (B,S,H,D), k/v (B,T,Hkv,D) ->
// out (B,S,H,D); query head h reads KV head h / G; key j is valid for query i
// when j <= i (causal) and i - j < window (window > 0); scores scaled by
// `scale`; online softmax with m, l and the accumulator in fp32, inputs read
// as fp32, l floored at 1e-30; output in q's dtype.  Unlike the TPU kernel it
// takes S and T that are not tile multiples, and any D that is a multiple of 8
// up to 256.  A query row with no valid key at all gives zeros, as the TPU
// kernel's skipped blocks do; causal self-attention (S <= T) never has one.
//
// What bounds it on this card: operations.  Causal attention does about
// 2*B*H*S*T*D multiply-adds for (B*S*H + 2*B*T*Hkv)*D elements read, hundreds
// of operations per byte.  This first kernel computes in fp32 FMAs on the
// SMs' CUDA cores (67 TFLOP/s), as the TPU kernel computes in fp32, so it sits
// far above the bf16 tensor-core bound; `wgmma` and TMA are the next step
// (ROADMAP Queue 2).  What the design does:
//   * The TPU grid (B, H, nQ, nK) walks the K/V blocks of a q block in order
//     on one core.  Here a block owns (b, h, q tile) and loops over the K/V
//     tiles itself, from the window's lower edge to the causal diagonal, so
//     the tiles above the diagonal or outside the window are never loaded
//     (the TPU kernel's `pl.when` skip); the blocks run in parallel.
//   * One query head per block: the G heads of one KV head read the same K/V
//     tiles, which stay in the 50 MB L2 cache (K and V of one batch row at
//     S = 4096, D = 256, bf16 are 4 MB).
//   * The q tile (BQ rows), one K tile and one V tile (32 keys each) and the
//     tile of probabilities sit in shared memory as fp32, row stride padded
//     to odd so that the 16 threads of a row group read 16 banks.  256
//     threads as 16 x 16: thread (ty, tx) owns rows ty*RQ .. +RQ-1, keys tx
//     and tx + 16 of the score tile, and output columns tx + 16*c.  A row's
//     max and sum are reduced over its 16 threads by shuffles.
//   * Tile sizes by D: (BQ, DP) = (64, 64), (64, 128) or (32, 256), for
//     41.6, 74.4 and 102.8 KB of shared memory (above 48 KB only after
//     cudaFuncSetAttribute), so 5, 3 or 2 blocks fit on an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 32;        // keys per K/V tile
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;

// Eight consecutive elements of one row: one 16-byte load for bf16, two for
// fp32.
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
  __device__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ void to_float(float* x) const {
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  __device__ void load(const __nv_bfloat16* p) {
    u = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ void to_float(float* x) const {
    // little endian: the element at the lower address is the low half-word
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ inline void store(float* p, float x) { *p = x; }
__device__ inline void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Rows [r0, r0 + rows) of a (len, heads, D) slab at head `hd`, as fp32 into
// shared memory with row stride `ld`; rows at or past `valid` are zeros.
template <typename T>
__device__ void load_tile(float* dst, int ld, const T* src, int r0, int rows,
                          int valid, int heads, int hd, int D) {
  const int C = D / 8;
  for (int i = threadIdx.x; i < rows * C; i += kThreads) {
    const int r = i / C, c = i - r * C;
    Chunk<T> ch;
    if (r0 + r < valid) ch.load(src + ((size_t)(r0 + r) * heads + hd) * D + c * 8);
    ch.to_float(dst + r * ld + c * 8);
  }
}

template <typename T, int DP, int BQ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S, int T_len,
                 int H, int Hkv, int D, int causal, int window, float scale) {
  constexpr int RQ = BQ / 16;   // query rows a thread owns
  constexpr int RK = kBK / 16;  // keys of a tile a thread scores
  constexpr int NC = DP / 16;   // output columns a thread owns
  constexpr int LDQ = DP + 1, LDK = DP + 1, LDV = DP, LDP = kBK + 1;

  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LDQ;
  float* sV = sK + kBK * LDK;
  float* sP = sV + kBK * LDV;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const T* qb = q + (size_t)b * S * H * D;
  const T* kb = k + (size_t)b * T_len * Hkv * D;
  const T* vb = v + (size_t)b * T_len * Hkv * D;
  load_tile(sQ, LDQ, qb, q0, BQ, S, H, h, D);

  float m[RQ], l[RQ], acc[RQ][NC];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // keys any row of this tile may see
  const int q_last = min(q0 + BQ, S) - 1;
  const int k_hi = causal ? min(T_len, q_last + 1) : T_len;
  const int k_lo = window ? max(0, q0 - window + 1) : 0;

  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the previous tile's sK, sV, sP are no longer read
    load_tile(sK, LDK, kb, k0, kBK, k_hi, Hkv, kvh, D);
    load_tile(sV, LDV, vb, k0, kBK, k_hi, Hkv, kvh, D);
    __syncthreads();

    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[RQ], kv[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = sQ[(ty * RQ + i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < RK; ++j) kv[j] = sK[(tx + 16 * j) * LDK + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = q0 + ty * RQ + i;
      bool ok[RK];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int key = k0 + tx + 16 * j;
        ok[j] = key < k_hi && (!causal || key <= row) &&
                (!window || row - key < window);
        s[i][j] *= scale;
        if (ok[j]) mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        sP[(ty * RQ + i) * LDP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

    const int kn = min(kBK, k_hi - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        vv[c] = (tx + 16 * c < D) ? sV[kk * LDV + tx + 16 * c] : 0.f;
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float p = sP[(ty * RQ + i) * LDP + kk];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] += p * vv[c];
      }
    }
  }

  T* ob = out + (size_t)b * S * H * D;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty * RQ + i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) store(ob + ((size_t)row * H + h) * D + col, acc[i][c] / denom);
    }
  }
}

template <int DP, int BQ>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (DP + 1) + kBK * (DP + 1) + kBK * DP + BQ * (kBK + 1));
}

template <typename T, int DP, int BQ>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S,
           int T_len, int H, int Hkv, int D, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DP, BQ>();
  auto kernel = flash_fwd_kernel<T, DP, BQ>;
  static bool configured = false;  // once per instantiation (one card)
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, T_len, H, Hkv, D,
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int S, int T_len, int H, int Hkv, int D, int causal, int window,
             float scale, cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64, 64>(q, k, v, out, B, S, T_len, H, Hkv, D, causal, window, scale, stream);
  if (D <= 128)
    return launch<T, 128, 64>(q, k, v, out, B, S, T_len, H, Hkv, D, causal, window, scale, stream);
  return launch<T, 256, 32>(q, k, v, out, B, S, T_len, H, Hkv, D, causal, window, scale, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  q (B,S,H,D), k/v (B,T,Hkv,D), out (B,S,H,D),
// all contiguous and 16-byte aligned.  causal: 0 or 1; window: 0 for none.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int T_len, int H, int Hkv, int D,
                                      int causal, int window, float scale,
                                      void* stream) {
  if (B < 1 || S < 1 || T_len < 1 || Hkv < 1 || H % Hkv != 0 || D < 8 ||
      D % 8 != 0 || D > kMaxD || window < 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, B, S, T_len, H, Hkv, D, causal, window, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, S, T_len, H, Hkv, D, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
