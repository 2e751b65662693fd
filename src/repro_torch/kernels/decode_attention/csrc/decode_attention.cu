// Single-token decode attention for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (see ../ops.py).
//
// Replaces the TPU kernel
//   src/repro/kernels/decode_attention/decode_attention.py::decode_attention_fwd
// (body `_kernel`).  Same function: one query token per (batch, head) attends
// over a (B, T, Hkv, D) KV cache; query head h reads KV head h / G; entries
// idx < min(pos + 1, T) are valid (the ring-buffer rule for window caches is the
// same bound, since idx < T); scores scaled by 1/sqrt(D); softmax statistics
// and the accumulator in fp32; l floored at 1e-30; output in q's dtype.
//
// What bounds it on this card: bytes.  Each key costs 4*G*D operations for
// 2*D*sizeof(T) bytes of K and V, far below the ~295 operations a byte at which
// the H100's compute starts to matter, so the least time is the K/V bytes of
// the valid entries over 3.35 TB/s.  The TPU kernel's grid (B, H, nT) walks
// the cache in order on one core, one query head per program.  Carried over
// block by block it would read an MQA cache G times (G = 8 for gemma-2b) and
// give B*H programs, 32 at batch 4, for 132 SMs.  So this design:
//   * split pass: grid (B * Hkv * head groups, n_split).  A block holds the
//     (up to 8) query rows of its KV head in registers, so K/V is read once for
//     all heads of a group, and streams one slice of the valid cache with
//     16-byte loads (one 8-element chunk per lane, the next key's chunks
//     fetched while the current one is used).  Online softmax in fp32; the
//     block writes an unnormalised partial (acc, m, l) to fp32 scratch.
//     Splits are sized on the host from the valid length, so the blocks past
//     `pos` are never launched; a block whose slice starts at or past the limit
//     still exits at once (the TPU kernel's `pl.when` skip).
//   * combine pass: one block per (b, h) merges the splits' partials.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 256;
constexpr int kMaxSplit = 1024;
constexpr float kNegInf = -1e30f;

// Eight consecutive elements of one row: one 16-byte load for bf16, two for
// fp32.  Starts at zero, so lanes that never load hold zeros.
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
  __device__ void to_float(float (&x)[8]) const {
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
  __device__ void to_float(float (&x)[8]) const {
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

// Split pass.  Block (row group, split): query heads g0 .. g0+gn-1 of KV head
// kvh in batch b, keys [start, end) of the valid cache.
//
// Lanes: a key's D elements are C = D/8 chunks; L (a power of two >= C) lanes
// take one key, so a warp takes 32/L keys at once, one per lane segment.  Each
// segment runs its own online softmax; segments, then warps, are merged at the
// end.
template <typename T, int GM>
__global__ void __launch_bounds__(kThreads)
split_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, float* __restrict__ part_acc,
             float* __restrict__ part_ml, int H, int Hkv, int T_len, int D,
             int n_grp, int limit, int split_len, int n_split, float scale) {
  const int split = blockIdx.y;
  const int start = split * split_len;
  if (start >= limit) return;
  const int end = min(start + split_len, limit);

  const int grp = blockIdx.x % n_grp;
  const int bk = blockIdx.x / n_grp;
  const int b = bk / Hkv, kvh = bk % Hkv;
  const int G = H / Hkv;
  const int g0 = grp * GM;
  const int gn = min(GM, G - g0);
  const int row0 = b * H + kvh * G + g0;  // (b, h) row of the group's first head

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int C = D / 8;
  int L = 1;
  while (L < C) L <<= 1;
  const int kpw = 32 / L;
  const int c = lane & (L - 1);
  const int seg = lane / L;
  const bool active = c < C;

  float qf[GM][8];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    Chunk<T> ch;
    if (active && g < gn) ch.load(q + (size_t)(row0 + g) * D + c * 8);
    ch.to_float(qf[g]);
  }

  float m[GM], l[GM], acc[GM][8];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  const size_t t_stride = (size_t)Hkv * D;  // elements between keys t and t+1
  const size_t base = ((size_t)b * T_len * Hkv + kvh) * D + c * 8;
  const T* kp = k + base;
  const T* vp = v + base;
  const int step = kWarps * kpw;

  Chunk<T> kc, vc;
  {
    const int t = start + warp * kpw + seg;
    if (active && t < end) {
      kc.load(kp + t * t_stride);
      vc.load(vp + t * t_stride);
    }
  }
  // t0 is the same on all lanes of a warp, so every lane reaches the shuffles.
  for (int t0 = start + warp * kpw; t0 < end; t0 += step) {
    const int t = t0 + seg;
    float kf[8], vf[8];
    kc.to_float(kf);
    vc.to_float(vf);
    const int tn = t + step;
    if (active && tn < end) {
      kc.load(kp + tn * t_stride);
      vc.load(vp + tn * t_stride);
    }
    float s[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) d += qf[g][e] * kf[e];
      for (int off = L / 2; off > 0; off >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, off);
      s[g] = d * scale;
    }
    if (t < end) {  // the same on all lanes of a segment
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float m_new = fmaxf(m[g], s[g]);
        const float corr = expf(m[g] - m_new);
        const float p = expf(s[g] - m_new);
        l[g] = l[g] * corr + p;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = acc[g][e] * corr + p * vf[e];
        m[g] = m_new;
      }
    }
  }

  // merge the warp's segments: lane i with lane i ^ off holds the same chunk
  for (int off = L; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mx = fmaxf(m[g], mo);
      const float c1 = expf(m[g] - mx), c2 = expf(mo - mx);
      l[g] = l[g] * c1 + lo * c2;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[g][e] = acc[g][e] * c1 + __shfl_xor_sync(0xffffffffu, acc[g][e], off) * c2;
      m[g] = mx;
    }
  }

  __shared__ float sm_acc[kWarps][GM][kMaxD];
  __shared__ float sm_m[kWarps][GM], sm_l[kWarps][GM];
  if (lane < L && active) {
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e) sm_acc[warp][g][c * 8 + e] = acc[g][e];
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
  }
  __syncthreads();

  // merge the warps and write the split's partial for each query row
  for (int i = threadIdx.x; i < gn * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float a = 0.f;
    for (int w = 0; w < kWarps; ++w) a += sm_acc[w][g][d] * expf(sm_m[w][g] - mx);
    part_acc[((size_t)(row0 + g) * n_split + split) * D + d] = a;
  }
  if (threadIdx.x < gn) {
    const int g = threadIdx.x;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) sum += sm_l[w][g] * expf(sm_m[w][g] - mx);
    float* ml = part_ml + ((size_t)(row0 + g) * n_split + split) * 2;
    ml[0] = mx;
    ml[1] = sum;
  }
}

// Combine pass.  Block per (b, h) row: merges the n_valid launched splits.
template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ part_acc,
               const float* __restrict__ part_ml, T* __restrict__ out, int D,
               int n_valid, int n_split) {
  const int row = blockIdx.x;
  const float* ml = part_ml + (size_t)row * n_split * 2;
  __shared__ float w[kMaxSplit];
  __shared__ float denom;
  float mx = kNegInf;
  for (int s = 0; s < n_valid; ++s) mx = fmaxf(mx, ml[2 * s]);
  for (int s = threadIdx.x; s < n_valid; s += kThreads) w[s] = expf(ml[2 * s] - mx);
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.f;
    for (int s = 0; s < n_valid; ++s) sum += ml[2 * s + 1] * w[s];
    denom = fmaxf(sum, 1e-30f);
  }
  __syncthreads();
  const float* acc = part_acc + (size_t)row * n_split * D;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float a = 0.f;
    for (int s = 0; s < n_valid; ++s) a += acc[(size_t)s * D + d] * w[s];
    store(out + (size_t)row * D + d, a / denom);
  }
}

template <typename T, int GM>
void launch(const void* q, const void* k, const void* v, void* out,
            float* part_acc, float* part_ml, int B, int H, int Hkv, int T_len,
            int D, int limit, int split_len, int n_split, float scale,
            cudaStream_t stream) {
  const int G = H / Hkv;
  const int n_grp = (G + GM - 1) / GM;
  const dim3 grid(B * Hkv * n_grp, n_split);
  split_kernel<T, GM><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), part_acc, part_ml, H, Hkv, T_len, D, n_grp,
      limit, split_len, n_split, scale);
  const int n_valid = (limit + split_len - 1) / split_len;
  combine_kernel<T><<<B * H, kThreads, 0, stream>>>(
      part_acc, part_ml, static_cast<T*>(out), D, n_valid, n_split);
}

template <typename T>
int dispatch(int gm, const void* q, const void* k, const void* v, void* out,
             float* part_acc, float* part_ml, int B, int H, int Hkv, int T_len,
             int D, int limit, int split_len, int n_split, float scale,
             cudaStream_t stream) {
  switch (gm) {
    case 1: launch<T, 1>(q, k, v, out, part_acc, part_ml, B, H, Hkv, T_len, D, limit, split_len, n_split, scale, stream); break;
    case 2: launch<T, 2>(q, k, v, out, part_acc, part_ml, B, H, Hkv, T_len, D, limit, split_len, n_split, scale, stream); break;
    case 4: launch<T, 4>(q, k, v, out, part_acc, part_ml, B, H, Hkv, T_len, D, limit, split_len, n_split, scale, stream); break;
    case 8: launch<T, 8>(q, k, v, out, part_acc, part_ml, B, H, Hkv, T_len, D, limit, split_len, n_split, scale, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  gm: query heads a block takes (1, 2, 4 or 8).
// part_acc: (B*H, n_split, D) fp32; part_ml: (B*H, n_split, 2) fp32.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int decode_attention_launch(int dtype, const void* q, const void* k,
                                       const void* v, void* out, float* part_acc,
                                       float* part_ml, int B, int H, int Hkv,
                                       int T_len, int D, int limit, int gm,
                                       int split_len, int n_split, float scale,
                                       void* stream) {
  if (D % 8 != 0 || D > kMaxD || H % Hkv != 0 || limit < 1 || limit > T_len ||
      split_len < 1 || n_split < 1 || n_split > kMaxSplit ||
      (long long)split_len * n_split < limit)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(gm, q, k, v, out, part_acc, part_ml, B, H, Hkv, T_len, D, limit, split_len, n_split, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(gm, q, k, v, out, part_acc, part_ml, B, H, Hkv, T_len, D, limit, split_len, n_split, scale, s);
  return (int)cudaErrorInvalidValue;
}
