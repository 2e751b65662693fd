// Mamba2 SSD chunked-scan forward for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (see ../ops.py).
//
// Replaces the TPU kernel
//   src/repro/kernels/ssd_scan/ssd_scan.py::ssd_fwd  (body `_ssd_kernel`).
// Same function: x (B,S,nh,P) and B/C (B,S,G,N) in fp32 or bf16, dt (B,S,nh)
// and A (nh,) in fp32; head h reads group h / (nh/G).  The sequence is cut
// into chunks of Q tokens (S % Q == 0); within a chunk, with a = dt*A and
// a_cum its inclusive cumsum,
//   y_i = sum_{j<=i} (C_i.B_j) exp(a_cum_i - a_cum_j) dt_j x_j
//         + exp(a_cum_i) C_i . state
//   state <- exp(a_tot) state + sum_j B_j (dt_j exp(a_tot - a_cum_j) x_j)^T
// with the fp32 (N,P) state zero before the first chunk.  Outputs y
// (B,S,nh,P) in x's dtype and the final state (B,nh,N,P) in fp32.  Inputs
// are read as fp32 and every sum is taken in fp32, as the TPU kernel does.
//
// What bounds it on this card: per (b, h, chunk) it does Q(Q+1)(N+P) + 4QNP
// operations for Q(2N+P+1)+QP elements moved, so at mamba2's widths (Q=256,
// N=128, P=64) and bf16 the bytes and the bf16 tensor-core operations take
// about as long as each other.  This first kernel multiplies in fp32 on the
// CUDA cores (67 TFLOP/s), far above both; a chunk-parallel split and
// `wgmma` are the next step (ROADMAP Queue 2).  What the design does:
//   * The TPU grid (B, nh, n_chunks) walks the chunks of one (b, h) in order
//     on one core, carrying the state in VMEM scratch.  Here one block owns
//     (b, h) and loops over the chunks itself, with the fp32 (N,P) state in
//     shared memory (32 KB at N=128, P=64); the B*nh blocks run in parallel.
//   * The cumsum of dt*A is a block scan (warp shuffles, then the warps'
//     totals); the TPU kernel's lower-triangular ones matmul fed its matrix
//     unit and has no purpose here.
//   * The intra-chunk part goes in row tiles of 64: for row tile I, over the
//     column tiles J <= I only, the 64x64 scores C_I B_J^T, scaled by
//     exp(a_cum_i - a_cum_j) dt_j where j <= i and zero elsewhere, then
//     multiplied into x_J.  A full (Q x Q) fp32 matrix (256 KB at Q=256) and
//     fp32 B and C of a whole chunk (128 KB each) would not fit beside the
//     state; one C tile, one B tile, one x tile and the score tile do (140 KB
//     at mamba2's widths, 91 KB at zamba2's N=64).
//   * The state's contribution exp(a_cum_i) C_I . state is taken once per
//     row tile before its column tiles; during the last row tile, which
//     visits every column tile, each thread folds the tile's B and x into
//     the state entries it owns, so B and x are not read a second time.
//   * 256 threads as 16 x 16: thread (ty, tx) owns rows ty + 16r and columns
//     tx + 16c of each tile, so that the 16 threads of a half warp read 16
//     consecutive words (or, for float4 reads of B rows of stride N + 4,
//     distinct bank groups).
// Limits: N a multiple of 4 up to 128, P up to 64, Q up to 1024.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr int kRT = 64;         // rows (and columns) of a tile
constexpr int kMaxN = 128;
constexpr int kMaxP = 64;
constexpr int kMaxQ = 1024;
constexpr int kLDS = kRT + 16;  // row stride of the score tile: no conflicts

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

constexpr size_t smem_floats(int N, int P, int Q) {
  return (size_t)N * P + 2 * (size_t)kRT * (N + 4) + (size_t)kRT * P +
         (size_t)kRT * kLDS + 3 * (size_t)Q;
}

// In-place inclusive prefix sum of a[0..Q), Q <= kMaxQ.  Every thread calls
// it; each thread sums its run of up to four elements, the warps scan their
// threads' totals by shuffles, and each warp adds the totals of the warps
// before it.
__device__ void block_cumsum(float* a, int Q, float* warp_sums) {
  constexpr int kPer = kMaxQ / kThreads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (Q + kThreads - 1) / kThreads;
  const int start = tid * per;
  float vals[kPer];
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (k < per && start + k < Q) run += a[start + k];
    vals[k] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  float before = incl - run;
  for (int w = 0; w < warp; ++w) before += warp_sums[w];
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    if (k < per && start + k < Q) a[start + k] = before + vals[k];
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, T* __restrict__ y,
               float* __restrict__ state_out, int S, int nh, int P, int G,
               int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float warp_sums[kThreads / 32];
  const int LDN = N + 4;                     // a multiple of 4: float4 rows
  float* state = smem;                       // N x P
  float* Cs = state + N * P;                 // kRT x LDN
  float* Bs = Cs + kRT * LDN;                // kRT x LDN
  float* xs = Bs + kRT * LDN;                // kRT x P
  float* Ss = xs + kRT * P;                  // kRT x kLDS
  float* dts = Ss + kRT * kLDS;              // Q
  float* acum = dts + Q;                     // Q
  float* w = acum + Q;                       // Q

  const int bh = blockIdx.x;
  const int b = bh / nh, h = bh % nh;
  const int g = h / (nh / G);
  const float Ah = A[h];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int nT = (Q + kRT - 1) / kRT;
  const int nc = S / Q;
  const int64_t x_row = (int64_t)nh * P;     // elements between two tokens
  const int64_t bc_row = (int64_t)G * N;
  const T* xb = x + (int64_t)b * S * x_row + (int64_t)h * P;
  const T* Bb = Bm + (int64_t)b * S * bc_row + (int64_t)g * N;
  const T* Cb = Cm + (int64_t)b * S * bc_row + (int64_t)g * N;
  const float* dtb = dt + (int64_t)b * S * nh + h;
  T* yb = y + (int64_t)b * S * x_row + (int64_t)h * P;

  for (int e = tid; e < N * P; e += kThreads) state[e] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const int64_t s0 = (int64_t)c * Q;
    __syncthreads();   // the previous chunk is done with every shared array
    for (int j = tid; j < Q; j += kThreads) {
      const float d = dtb[(s0 + j) * nh];
      dts[j] = d;
      acum[j] = d * Ah;
    }
    __syncthreads();
    block_cumsum(acum, Q, warp_sums);
    __syncthreads();
    const float a_tot = acum[Q - 1];
    for (int j = tid; j < Q; j += kThreads)
      w[j] = dts[j] * expf(a_tot - acum[j]);

    for (int I = 0; I < nT; ++I) {
      const bool last = I == nT - 1;
      __syncthreads();
      for (int e = tid; e < kRT * N; e += kThreads) {
        const int i = e / N, n = e - i * N;
        const int gi = I * kRT + i;
        Cs[i * LDN + n] = gi < Q ? to_f(Cb[(s0 + gi) * bc_row + n]) : 0.f;
      }
      __syncthreads();

      // the state's contribution: exp(a_cum_i) C_i . state
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
      for (int n = 0; n < N; n += 4) {
        float4 cv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          cv[r] = *reinterpret_cast<const float4*>(&Cs[(ty + 16 * r) * LDN + n]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float sv[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            sv[q] = tx + 16 * q < P ? state[(n + k) * P + tx + 16 * q] : 0.f;
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][q] += comp(cv[r], k) * sv[q];
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int gi = I * kRT + ty + 16 * r;
        const float dec = gi < Q ? expf(acum[gi]) : 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] *= dec;
      }

      for (int J = 0; J <= I; ++J) {
        __syncthreads();   // B, x and score tiles free; the state read above
        for (int e = tid; e < kRT * N; e += kThreads) {
          const int j = e / N, n = e - j * N;
          const int gj = J * kRT + j;
          Bs[j * LDN + n] = gj < Q ? to_f(Bb[(s0 + gj) * bc_row + n]) : 0.f;
        }
        for (int e = tid; e < kRT * P; e += kThreads) {
          const int j = e / P, p = e - j * P;
          const int gj = J * kRT + j;
          xs[e] = gj < Q ? to_f(xb[(s0 + gj) * x_row + p]) : 0.f;
        }
        __syncthreads();

        // scores C_I B_J^T, decayed and masked to j <= i
        float s[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) s[r][q] = 0.f;
        for (int n = 0; n < N; n += 4) {
          float4 cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            cv[r] = *reinterpret_cast<const float4*>(&Cs[(ty + 16 * r) * LDN + n]);
            bv[r] = *reinterpret_cast<const float4*>(&Bs[(tx + 16 * r) * LDN + n]);
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              s[r][q] += cv[r].x * bv[q].x + cv[r].y * bv[q].y +
                         cv[r].z * bv[q].z + cv[r].w * bv[q].w;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int gi = I * kRT + ty + 16 * r;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int gj = J * kRT + tx + 16 * q;
            const float v = (gj <= gi && gi < Q)
                                ? s[r][q] * expf(acum[gi] - acum[gj]) * dts[gj]
                                : 0.f;
            Ss[(ty + 16 * r) * kLDS + tx + 16 * q] = v;
          }
        }
        __syncthreads();

        const int jn = min(kRT, Q - J * kRT);
        for (int j = 0; j < jn; ++j) {
          float sv[4], xv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) sv[r] = Ss[(ty + 16 * r) * kLDS + j];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            xv[q] = tx + 16 * q < P ? xs[j * P + tx + 16 * q] : 0.f;
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][q] += sv[r] * xv[q];
        }

        if (last) {
          // fold this column tile into the state entries this thread owns
          // (n = ty + 16r, p = tx + 16q); the decay first, at the first tile
          const float keep = J == 0 ? expf(a_tot) : 1.f;
          float st[8][4];
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int n = ty + 16 * r, p = tx + 16 * q;
              st[r][q] = (n < N && p < P) ? state[n * P + p] * keep : 0.f;
            }
          for (int j = 0; j < jn; ++j) {
            const float wj = w[J * kRT + j];
            float bv[8], xv[4];
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              const int n = ty + 16 * r;
              bv[r] = n < N ? Bs[j * LDN + n] * wj : 0.f;
            }
#pragma unroll
            for (int q = 0; q < 4; ++q)
              xv[q] = tx + 16 * q < P ? xs[j * P + tx + 16 * q] : 0.f;
#pragma unroll
            for (int r = 0; r < 8; ++r)
#pragma unroll
              for (int q = 0; q < 4; ++q) st[r][q] += bv[r] * xv[q];
          }
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int n = ty + 16 * r, p = tx + 16 * q;
              if (n < N && p < P) state[n * P + p] = st[r][q];
            }
        }
      }

#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int gi = I * kRT + ty + 16 * r;
        if (gi >= Q) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = tx + 16 * q;
          if (p < P) store(&yb[(s0 + gi) * x_row + p], acc[r][q]);
        }
      }
    }
  }
  __syncthreads();
  float* so = state_out + (int64_t)bh * N * P;
  for (int e = tid; e < N * P; e += kThreads) so[e] = state[e];
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* state, int B, int S, int nh, int P,
           int G, int N, int Q, cudaStream_t stream) {
  auto kernel = ssd_fwd_kernel<T>;
  static bool configured = false;  // once per instantiation (one card)
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(sizeof(float) * smem_floats(kMaxN, kMaxP, kMaxQ)));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const size_t bytes = sizeof(float) * smem_floats(N, P, Q);
  kernel<<<B * nh, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y),
      static_cast<float*>(state), S, nh, P, G, N, Q);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (of x, Bm, Cm and y).  x (B,S,nh,P),
// dt (B,S,nh) fp32, A (nh,) fp32, Bm/Cm (B,S,G,N), y (B,S,nh,P),
// state (B,nh,N,P) fp32, all contiguous.  Q is the chunk: S % Q == 0.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ssd_scan_launch(int dtype, const void* x, const void* dt,
                               const void* A, const void* Bm, const void* Cm,
                               void* y, void* state, int B, int S, int nh,
                               int P, int G, int N, int Q, void* stream) {
  if (B < 1 || S < 1 || nh < 1 || G < 1 || nh % G != 0 || P < 1 ||
      P > kMaxP || N < 4 || N % 4 != 0 || N > kMaxN || Q < 1 || Q > kMaxQ ||
      S % Q != 0 || (int64_t)B * nh > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, Cm, y, state, B, S, nh, P, G, N, Q, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state, B, S, nh, P, G,
                                 N, Q, s);
  return (int)cudaErrorInvalidValue;
}
