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
// (B,S,nh,P) in x's dtype and the final state (B,nh,N,P) in fp32.  Every sum
// is taken in fp32, as the TPU kernel does.
//
// What bounds it on this card: one pass over the data (x, dt, A, B and C
// read once, y and the state written once) at 3.35 TB/s, 0.0445 ms at
// mamba2's training shape (B=4, S=2048, nh=64, P=64, N=128, Q=256, bf16);
// its Q(Q+1)(N+P) + 4QNP operations a (b, h, chunk) at the bf16 tensor-core
// peak take about as long.  Two routes, by dtype:
//
// bf16: four chunk-parallel passes on the tensor cores (`mma.sync.m16n8k16`
// bf16 -> fp32, `ldmatrix`, `cp.async`), the decomposition `ssd_chunked`
// spells out and Mamba2's own GPU kernels use (arXiv:2405.21060 sections
// 6-7: chunk state, state passing, chunk scan, with C.B^T once per group).
// The chunk states go through device memory between passes, so this
// design's own byte floor lies above the one-pass bound: x read twice, y
// written once, the chunk states (B, nc, nh, N, P) fp32 written, read,
// written and read, about 485 MB or 0.145 ms at mamba2's training shape.
//   1. `ssd_chunk_state_kernel`, a block per (b, c, h) and all N state rows
//      (64 at a time where N <= 64): the chunk's a = dt*A and its inclusive
//      cumsum (a block scan, written to `acum` (B, nh, S)),
//      w = dt exp(a_tot - a_cum), and states[c] = (w o B)^T X.  B's tile
//      comes through `ldmatrix.trans` as the A fragment, is scaled by w in
//      fp32 and carried as a bf16 hi/lo pair (two MMAs into one fp32
//      accumulator); X is the B operand, also through `ldmatrix.trans`,
//      each fragment serving both 64-row halves of the state.  Tiles of 64
//      tokens in a two-slot cp.async ring.  2048 blocks at mamba2's shape.
//   2. `ssd_chunk_cb_kernel`, a block per (b, c, g), 64 x 64 tile pair
//      I >= J and 32-row half: C.B^T once per group rather than once per
//      head, only the tiles on and below the diagonal, in fp32 (bf16
//      products summed in fp32: exact as the fp32 kernel's) into `cb`
//      (B, nc, G, LQ, LQ), LQ = Q rounded up to 64.  8.4 MB at mamba2's
//      shape, which its 64 heads then read from L2.
//   3. `ssd_state_pass_kernel`, a thread per 4 entries of one (b, h)'s
//      (N, P): h_prev[c] = h, h = exp(a_tot[c]) h + states[c] over the
//      chunks in order, in fp32 on the CUDA cores, h_prev written over
//      `states` in place and the last h to `state`.  Bytes only; the next
//      chunk's load is issued before this one's store.
//   4. `ssd_chunk_scan_kernel`, a block per (b, c, h, 64-row tile I), the
//      long row tiles first (8192 blocks at mamba2's shape):
//        y_I = exp(a_cum_I) o (C_I h_prev[c]) + sum_{J<=I} M_IJ X_J,
//        M_IJ = CB_IJ o exp(a_cum_i - a_cum_j) o dt_j where j <= i.
//      h_prev is split hi/lo into shared memory once a block, its loads all
//      in flight together; M is built in registers in the A-fragment layout
//      from C.B^T read straight from L2 (the next tile's read issued before
//      this tile's MMAs), with exp as ex2 of a_cum log2 e (the accurate
//      expf of every entry took a third of the pass) and the mask only on
//      the diagonal tile, and split hi/lo; X_J comes through a two-slot
//      cp.async ring (its second slot reuses h_prev's space) and
//      `ldmatrix.trans`; on the diagonal tile a warp skips the column steps
//      wholly above its rows.  y is rounded to bf16 once, at the store.
//   Why three hi/lo pairs: M, w o B and h_prev are fp32, and one bf16 of any
//   one of them misses the gate of half a bf16 ulp against fp32 on some
//   outputs (tests/test_torch_ssd.py emulates the passes); as hi + lo they
//   carry 16 significant bits and meet it as exact fp32 does.  C, B and X
//   are bf16 already: exact operands.
//   x, B and C are read through their own batch, token and head (group)
//   strides, only the last dimension contiguous: mamba2 passes views of its
//   conv output (a token stride of 4352 elements), which are not copied.
//   16-byte copies need 8-element aligned pointers, strides, N and P; other
//   layouts are read an element at a time.  Left for later: `wgmma` and
//   TMA, and keeping the states out of device memory.
//
// fp32: `ssd_fwd_kernel`, on the CUDA cores (67 TFLOP/s), far above both
// bounds; it serves fp32 callers and the fp32 checks.  Its design:
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
// Limits (both routes): N a multiple of 4 up to 128, P up to 64, Q up to
// 1024.

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
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

constexpr size_t smem_floats(int N, int P, int Q) {
  return (size_t)N * P + 2 * (size_t)kRT * (N + 4) + (size_t)kRT * P +
         (size_t)kRT * kLDS + 3 * (size_t)Q;
}

// In-place inclusive prefix sum of a[0..Q), Q <= kMaxQ, by a block of
// THREADS threads.  Every thread calls it; each thread sums its run of up to
// kMaxQ / THREADS elements, the warps scan their threads' totals by
// shuffles, and each warp adds the totals of the warps before it.
template <int THREADS = kThreads>
__device__ void block_cumsum(float* a, int Q, float* warp_sums) {
  constexpr int kPer = kMaxQ / THREADS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (Q + THREADS - 1) / THREADS;
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


// ------------------------------------------------------------ bf16 route

typedef __nv_bfloat16 bf16;

constexpr int kMT = 64;             // rows of a tile: tokens, or state rows
constexpr int kMmaThreads = 128;    // passes 1 and 4: 4 warps of 16 rows
constexpr int kCBRows = 32;         // pass 2: rows of C.B^T a block computes
constexpr int kCBThreads = 64;      // pass 2: 2 warps of 16 rows
constexpr int kPassThreads = 256;   // pass 3: a float4 of state a thread

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes if !ok (src-size
// 0: nothing is read).
__device__ inline void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ inline void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ inline void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col); bf16 in, fp32 accumulate.
__device__ inline void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ inline uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x, y) as bf16 pairs hi = bf16(x, y) and lo = bf16((x, y) - hi): hi + lo
// carries 16 significant bits; x sits in the low half-word.
__device__ inline void split_bf16(float x, float y, uint32_t& hi,
                                  uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x (ex2.approx: 2 ulp; -inf gives 0)
__device__ inline float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A bf16 pair (low half first) times (w.x, w.y) in fp32, split hi/lo.
__device__ inline void scale_split(uint32_t raw, float2 w, uint32_t& hi,
                                   uint32_t& lo) {
  __nv_bfloat162 v;
  *reinterpret_cast<uint32_t*>(&v) = raw;
  const float2 f = __bfloat1622float2(v);
  split_bf16(f.x * w.x, f.y * w.y, hi, lo);
}

// Rows [r0, r0 + ROWS) of a slab whose row r starts at src + r * stride,
// columns [0, cols_pad), into shared memory with row stride ld; rows at or
// past `valid` and columns at or past `cols` are zeros.  vec: 16-byte
// cp.async (src, stride and cols 8-element aligned; cols_pad a multiple of
// 8); otherwise element by element.
template <int ROWS, int THREADS>
__device__ inline void load_rows(bf16* dst, int ld, const bf16* src,
                                 int64_t stride, int r0, int valid, int cols,
                                 int cols_pad, bool vec) {
  if (vec) {
    const int ch = cols_pad / 8;
    for (int i = threadIdx.x; i < ROWS * ch; i += THREADS) {
      const int r = i / ch, c = i - r * ch;
      const bool ok = r0 + r < valid && c * 8 < cols;
      cp_async16(dst + r * ld + c * 8,
                 ok ? src + (int64_t)(r0 + r) * stride + c * 8 : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * cols_pad; i += THREADS) {
      const int r = i / cols_pad, c = i - r * cols_pad;
      const bool ok = r0 + r < valid && c < cols;
      dst[r * ld + c] = ok ? src[(int64_t)(r0 + r) * stride + c]
                           : __float2bfloat16(0.f);
    }
  }
}

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Shared memory of each pass (bytes); PP is P and NP is N rounded up to 16,
// LQ is Q rounded up to kMT.  Mirrored by ops.py::smem_bytes.
constexpr int state_rows(int NP) { return NP > kMT ? 2 * kMT : kMT; }
constexpr size_t state_smem_bytes(int NR, int PP, int Q) {
  return 2 * (size_t)kMT * ((NR + 8) + (PP + 8)) * sizeof(bf16) +
         2 * (size_t)round_up(Q, kMT) * sizeof(float);
}
constexpr size_t cb_smem_bytes(int NP) {
  return (size_t)(kCBRows + kMT) * (NP + 8) * sizeof(bf16);
}
constexpr size_t scan_smem_bytes(int NP, int PP, int Q) {
  return ((size_t)kMT * (NP + 8) +
          (size_t)((2 * NP > kMT ? 2 * NP : kMT) + kMT) * (PP + 8)) *
             sizeof(bf16) +
         (size_t)round_up(Q, kMT) * sizeof(float2);
}

// Pass 1.  Block (b, c, h) in blockIdx.x (h fastest) and NR = 64 * MTW
// state rows from n0 = NR * blockIdx.y (MTW = 2 when N > 64: the whole
// state, so that the chunk's scan and its X tiles serve 128 rows); warp w
// owns the 16-row m-tiles w + 4 mt, mt < MTW, and all P columns.
template <int PP, int MTW>
__global__ void __launch_bounds__(kMmaThreads)
ssd_chunk_state_kernel(const bf16* __restrict__ x, int64_t x_sb, int64_t x_ss,
                       int64_t x_sh, const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const bf16* __restrict__ Bm, int64_t b_sb,
                       int64_t b_ss, int64_t b_sg, float* __restrict__ states,
                       float* __restrict__ acum, int S, int nh, int P, int G,
                       int N, int Q, int vec) {
  constexpr int NR = kMT * MTW, LDB = NR + 8, LDP = PP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float warp_sums[kMmaThreads / 32];
  const int nc = S / Q, LQ = round_up(Q, kMT), nT = LQ / kMT;
  bf16* sB = reinterpret_cast<bf16*>(smem_raw);   // 2 slots of kMT x LDB
  bf16* sX = sB + 2 * kMT * LDB;                   // 2 slots of kMT x LDP
  float* sdt = reinterpret_cast<float*>(sX + 2 * kMT * LDP);   // LQ
  float* sw = sdt + LQ;                                         // LQ

  const int h = blockIdx.x % nh, c = (blockIdx.x / nh) % nc,
            b = blockIdx.x / (nh * nc);
  const int n0 = blockIdx.y * NR;
  const int g = h / (nh / G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int64_t s0 = (int64_t)c * Q;
  const bf16* xc = x + b * x_sb + s0 * x_ss + h * x_sh;
  const bf16* bc = Bm + b * b_sb + s0 * b_ss + g * b_sg + n0;
  const int ncols = min(N - n0, NR);

  load_rows<kMT, kMmaThreads>(sB, LDB, bc, b_ss, 0, Q, ncols, NR, vec);
  load_rows<kMT, kMmaThreads>(sX, LDP, xc, x_ss, 0, Q, P, PP, vec);
  cp_async_commit();

  // a = dt * A, its inclusive cumsum, then w = dt exp(a_tot - a_cum)
  const float Ah = A[h];
  const float* dtc = dt + ((int64_t)b * S + s0) * nh + h;
  for (int j = tid; j < LQ; j += kMmaThreads) {
    const float d = j < Q ? dtc[(int64_t)j * nh] : 0.f;
    sdt[j] = d;
    sw[j] = d * Ah;
  }
  __syncthreads();
  block_cumsum<kMmaThreads>(sw, Q, warp_sums);
  __syncthreads();
  const float a_tot = sw[Q - 1];
  if (blockIdx.y == 0) {
    float* ac = acum + ((int64_t)b * nh + h) * S + s0;
    for (int j = tid; j < Q; j += kMmaThreads) ac[j] = sw[j];
  }
  __syncthreads();
  for (int j = tid; j < LQ; j += kMmaThreads)
    sw[j] = j < Q ? sdt[j] * expf(a_tot - sw[j]) : 0.f;
  // (the barrier at the top of the first tile makes w visible)

  float acc[MTW][PP / 8][4];
#pragma unroll
  for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
    for (int n = 0; n < PP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  bool live[MTW];   // the m-tile holds a state row below N
#pragma unroll
  for (int mt = 0; mt < MTW; ++mt) live[mt] = n0 + 16 * (warp + 4 * mt) < N;

  for (int it = 0; it < nT; ++it) {
    // tile it has landed, and every warp is done with tile it - 1, whose
    // slot takes tile it + 1 while this one is computed on
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < nT) {
      const int nb = (it + 1) & 1;
      load_rows<kMT, kMmaThreads>(sB + nb * kMT * LDB, LDB, bc, b_ss,
                                  (it + 1) * kMT, Q, ncols, NR, vec);
      load_rows<kMT, kMmaThreads>(sX + nb * kMT * LDP, LDP, xc, x_ss,
                                  (it + 1) * kMT, Q, P, PP, vec);
      cp_async_commit();
    }
    if (!live[0]) continue;
    const bf16* tB = sB + (it & 1) * kMT * LDB;
    const bf16* tX = sX + (it & 1) * kMT * LDP;
    const int steps = (min(kMT, Q - it * kMT) + 15) / 16;
#pragma unroll
    for (int kk = 0; kk < kMT / 16; ++kk) {
      if (kk >= steps) break;
      const int j = it * kMT + kk * 16 + 2 * t;
      const float2 w0 = make_float2(sw[j], sw[j + 1]);
      const float2 w8 = make_float2(sw[j + 8], sw[j + 9]);
      // A = (w o B)^T: the stored [token][n] tile, transposed by ldmatrix;
      // regs 0/1 hold tokens 2t, 2t+1 and regs 2/3 tokens 2t+8, 2t+9
      uint32_t ah[MTW][4], al[MTW][4];
#pragma unroll
      for (int mt = 0; mt < MTW; ++mt) {
        if (!live[mt]) continue;
        uint32_t raw[4];
        ldsm_x4_trans(raw, tB + (kk * 16 + (lane & 7) + 8 * (lane >> 4)) * LDB +
                               16 * (warp + 4 * mt) + 8 * ((lane >> 3) & 1));
        scale_split(raw[0], w0, ah[mt][0], al[mt][0]);
        scale_split(raw[1], w0, ah[mt][1], al[mt][1]);
        scale_split(raw[2], w8, ah[mt][2], al[mt][2]);
        scale_split(raw[3], w8, ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int dn = 0; dn < PP / 16; ++dn) {
        uint32_t bv[4];   // columns dn*16 + 0..7 in bv[0..1], + 8..15 in bv[2..3]
        ldsm_x4_trans(bv, tX + (kk * 16 + (lane & 15)) * LDP + dn * 16 +
                              8 * (lane >> 4));
#pragma unroll
        for (int mt = 0; mt < MTW; ++mt) {
          if (!live[mt]) continue;
          mma_bf16(acc[mt][2 * dn], ah[mt], bv[0], bv[1]);
          mma_bf16(acc[mt][2 * dn], al[mt], bv[0], bv[1]);
          mma_bf16(acc[mt][2 * dn + 1], ah[mt], bv[2], bv[3]);
          mma_bf16(acc[mt][2 * dn + 1], al[mt], bv[2], bv[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  float* st = states + (((int64_t)b * nc + c) * nh + h) * N * P;
#pragma unroll
  for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = n0 + 16 * (warp + 4 * mt) + gq + 8 * r;
      if (n >= N) continue;
#pragma unroll
      for (int nt = 0; nt < PP / 8; ++nt) {
        const int p = nt * 8 + 2 * t;
        if (p < P) st[n * P + p] = acc[mt][nt][2 * r];
        if (p + 1 < P) st[n * P + p + 1] = acc[mt][nt][2 * r + 1];
      }
    }
}

// Pass 2.  Block x = 2 * (tile pair I >= J) + (32-row half), y = (c, g) with
// g fastest, z = b; warp w owns rows I*64 + 32*half + 16w .. +15 and the
// tile's 64 columns.
__global__ void __launch_bounds__(kCBThreads)
ssd_chunk_cb_kernel(const bf16* __restrict__ Bm, int64_t b_sb, int64_t b_ss,
                    int64_t b_sg, const bf16* __restrict__ Cm, int64_t c_sb,
                    int64_t c_ss, int64_t c_sg, float* __restrict__ cb, int S,
                    int G, int N, int Q, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int NP = round_up(N, 16), LDN = NP + 8;
  const int LQ = round_up(Q, kMT), nc = S / Q;
  bf16* sC = reinterpret_cast<bf16*>(smem_raw);   // kCBRows x LDN
  bf16* sB = sC + kCBRows * LDN;                   // kMT x LDN

  const int pair = blockIdx.x >> 1, half = blockIdx.x & 1;
  int I = 0;
  while ((I + 1) * (I + 2) / 2 <= pair) ++I;
  const int J = pair - I * (I + 1) / 2;
  const int grp = blockIdx.y % G, c = blockIdx.y / G, b = blockIdx.z;
  const int64_t s0 = (int64_t)c * Q;
  const int i0 = I * kMT + half * kCBRows;
  load_rows<kCBRows, kCBThreads>(sC, LDN, Cm + b * c_sb + s0 * c_ss + grp * c_sg,
                                 c_ss, i0, Q, N, NP, vec);
  load_rows<kMT, kCBThreads>(sB, LDN, Bm + b * b_sb + s0 * b_ss + grp * b_sg,
                             b_ss, J * kMT, Q, N, NP, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  float acc[kMT / 8][4];
#pragma unroll
  for (int n = 0; n < kMT / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int ks = 0; ks < NP / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, sC + (warp * 16 + (lane & 15)) * LDN + ks * 16 + 8 * (lane >> 4));
#pragma unroll
    for (int nj = 0; nj < kMT / 16; ++nj) {
      uint32_t bk[4];   // tokens nj*16 + 0..7 in bk[0..1], + 8..15 in bk[2..3]
      ldsm_x4(bk, sB + (nj * 16 + (lane & 7) + 8 * (lane >> 4)) * LDN +
                      ks * 16 + 8 * ((lane >> 3) & 1));
      mma_bf16(acc[2 * nj], a, bk[0], bk[1]);
      mma_bf16(acc[2 * nj + 1], a, bk[2], bk[3]);
    }
  }
  float* out = cb + (((int64_t)b * nc + c) * G + grp) * LQ * LQ;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = i0 + warp * 16 + gq + 8 * r;
#pragma unroll
    for (int n = 0; n < kMT / 8; ++n)
      *reinterpret_cast<float2*>(out + (int64_t)row * LQ + J * kMT + 8 * n +
                                 2 * t) =
          make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// Pass 3.  Block x = (b, h), y = a slice of kPassThreads float4s of (N, P).
__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass_kernel(float* __restrict__ states,
                      const float* __restrict__ acum,
                      float* __restrict__ state_out, int S, int nh, int NP4,
                      int Q) {
  const int e = blockIdx.y * kPassThreads + threadIdx.x;
  if (e >= NP4) return;
  const int b = blockIdx.x / nh, h = blockIdx.x % nh, nc = S / Q;
  const int64_t step = (int64_t)nh * NP4;   // float4s from chunk c to c + 1
  float4* st = reinterpret_cast<float4*>(states) +
               ((int64_t)b * nc * nh + h) * NP4 + e;
  const float* last = acum + ((int64_t)b * nh + h) * S + Q - 1;
  float4 hv = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 next = st[0];
  for (int c = 0; c < nc; ++c) {
    const float4 s = next;
    if (c + 1 < nc) next = st[(c + 1) * step];
    const float d = expf(last[(int64_t)c * Q]);
    st[c * step] = hv;
    hv.x = hv.x * d + s.x;
    hv.y = hv.y * d + s.y;
    hv.z = hv.z * d + s.z;
    hv.w = hv.w * d + s.w;
  }
  reinterpret_cast<float4*>(state_out)[(int64_t)blockIdx.x * NP4 + e] = hv;
}

// Pass 4.  Block x = (b, c, h, I) with I fastest, counted from the last row
// tile down; warp w owns rows I*64 + 16w .. +15 and all P columns.
template <int PP>
__global__ void __launch_bounds__(kMmaThreads)
ssd_chunk_scan_kernel(const bf16* __restrict__ x, int64_t x_sb, int64_t x_ss,
                      int64_t x_sh, const float* __restrict__ dt,
                      const bf16* __restrict__ Cm, int64_t c_sb, int64_t c_ss,
                      int64_t c_sg, const float* __restrict__ cb,
                      const float* __restrict__ states,
                      const float* __restrict__ acum, bf16* __restrict__ y,
                      int S, int nh, int P, int G, int N, int Q, int vec) {
  constexpr int LDP = PP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int NP = round_up(N, 16), LDN = NP + 8;
  const int nc = S / Q, LQ = round_up(Q, kMT), nT = LQ / kMT;
  const int hrows = 2 * NP > kMT ? 2 * NP : kMT;
  bf16* sC = reinterpret_cast<bf16*>(smem_raw);   // kMT x LDN
  bf16* sH = sC + kMT * LDN;       // h_prev hi (NP x LDP), then lo; X slot 1
  bf16* sHl = sH + NP * LDP;
  bf16* sX0 = sH + hrows * LDP;    // X slot 0: kMT x LDP
  // (a_cum log2 e, dt) of each column; a_cum -inf past Q, so that a row
  // there decays to 0
  float2* sAD = reinterpret_cast<float2*>(sX0 + kMT * LDP);   // LQ

  int bx = blockIdx.x;
  const int I = nT - 1 - bx % nT;
  bx /= nT;
  const int h = bx % nh;
  bx /= nh;
  const int c = bx % nc, b = bx / nc;
  const int g = h / (nh / G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int64_t s0 = (int64_t)c * Q;
  const bf16* xc = x + b * x_sb + s0 * x_ss + h * x_sh;
  const int r0 = I * kMT;
  const int ncol = (I + 1) * kMT;   // columns j < ncol take part

  load_rows<kMT, kMmaThreads>(sC, LDN, Cm + b * c_sb + s0 * c_ss + g * c_sg,
                              c_ss, r0, Q, N, NP, vec);
  load_rows<kMT, kMmaThreads>(sX0, LDP, xc, x_ss, 0, Q, P, PP, vec);
  cp_async_commit();

  const float* ac = acum + ((int64_t)b * nh + h) * S + s0;
  const float* dtc = dt + ((int64_t)b * S + s0) * nh + h;
  for (int j = tid; j < ncol; j += kMmaThreads)
    sAD[j] = j < Q ? make_float2(ac[j] * kLog2e, dtc[(int64_t)j * nh])
                   : make_float2(-__int_as_float(0x7f800000), 0.f);
  // h_prev[c] (zero before the first chunk) as a bf16 hi/lo pair, zeros
  // past N and P: every thread's loads issued before any is used
  const bool carry = c > 0;
  if (carry) {
    constexpr int kQuads = kMaxN * PP / 4 / kMmaThreads;   // 4 floats each
    const float* hp = states + (((int64_t)b * nc + c) * nh + h) * N * P;
    float4 v[kQuads];
#pragma unroll
    for (int k = 0; k < kQuads; ++k) {
      const int q = tid + k * kMmaThreads;
      const int n = q / (PP / 4), p = (q % (PP / 4)) * 4;
      v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n >= N || p >= P) continue;
      if ((P & 3) == 0) {
        v[k] = __ldg(reinterpret_cast<const float4*>(hp + n * P + p));
      } else {
        const float* r = hp + n * P + p;
        v[k].x = r[0];
        if (p + 1 < P) v[k].y = r[1];
        if (p + 2 < P) v[k].z = r[2];
        if (p + 3 < P) v[k].w = r[3];
      }
    }
#pragma unroll
    for (int k = 0; k < kQuads; ++k) {
      const int q = tid + k * kMmaThreads;
      const int n = q / (PP / 4), p = (q % (PP / 4)) * 4;
      if (n >= NP) continue;
      uint2 hi, lo;
      split_bf16(v[k].x, v[k].y, hi.x, lo.x);
      split_bf16(v[k].z, v[k].w, hi.y, lo.y);
      *reinterpret_cast<uint2*>(sH + n * LDP + p) = hi;
      *reinterpret_cast<uint2*>(sHl + n * LDP + p) = lo;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  const int wr = warp * 16;                  // the warp's rows in the tile
  const int ia = r0 + wr + gq, ib = ia + 8;  // this thread's rows in the chunk
  const bool rows_ok = r0 + wr < Q;
  const float aa = sAD[ia].x, ab = sAD[ib].x;   // -inf past Q
  float acc[PP / 8][4];
#pragma unroll
  for (int n = 0; n < PP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  if (rows_ok && carry) {
    // exp(a_cum_i) (C_I h_prev): C exact, h_prev as hi + lo
    for (int ks = 0; ks < NP / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, sC + (wr + (lane & 15)) * LDN + ks * 16 + 8 * (lane >> 4));
#pragma unroll
      for (int dn = 0; dn < PP / 16; ++dn) {
        uint32_t bh[4], bl[4];
        const int off = (ks * 16 + (lane & 15)) * LDP + dn * 16 + 8 * (lane >> 4);
        ldsm_x4_trans(bh, sH + off);
        ldsm_x4_trans(bl, sHl + off);
        mma_bf16(acc[2 * dn], a, bh[0], bh[1]);
        mma_bf16(acc[2 * dn], a, bl[0], bl[1]);
        mma_bf16(acc[2 * dn + 1], a, bh[2], bh[3]);
        mma_bf16(acc[2 * dn + 1], a, bl[2], bl[3]);
      }
    }
    const float da = exp2f(aa), db = exp2f(ab);
#pragma unroll
    for (int n = 0; n < PP / 8; ++n) {
      acc[n][0] *= da;
      acc[n][1] *= da;
      acc[n][2] *= db;
      acc[n][3] *= db;
    }
  }

  // C.B^T of tile (I, J) at this thread's A-fragment places: for column
  // step kk, rows ia and ib, columns 2t, 2t+1 and 2t+8, 2t+9
  const float* cbt = cb + (((int64_t)b * nc + c) * G + g) * LQ * LQ;
  float2 cbr[4][4];
  auto load_cb = [&](int J) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int j = J * kMT + kk * 16 + 2 * t;
      cbr[kk][0] = __ldg(reinterpret_cast<const float2*>(cbt + (int64_t)ia * LQ + j));
      cbr[kk][1] = __ldg(reinterpret_cast<const float2*>(cbt + (int64_t)ib * LQ + j));
      cbr[kk][2] = __ldg(reinterpret_cast<const float2*>(cbt + (int64_t)ia * LQ + j + 8));
      cbr[kk][3] = __ldg(reinterpret_cast<const float2*>(cbt + (int64_t)ib * LQ + j + 8));
    }
  };
  if (rows_ok) load_cb(0);

  for (int J = 0; J <= I; ++J) {
    // X_J has landed, and every warp is done with the other slot (at J = 0,
    // with h_prev, whose space is slot 1)
    cp_async_wait<0>();
    __syncthreads();
    if (J + 1 <= I) {
      load_rows<kMT, kMmaThreads>(((J + 1) & 1) ? sH : sX0, LDP, xc, x_ss,
                                  (J + 1) * kMT, Q, P, PP, vec);
      cp_async_commit();
    }
    if (!rows_ok) continue;
    const bf16* tX = (J & 1) ? sH : sX0;
    // on the diagonal tile, warp w's rows see column steps kk <= w only
    const int steps = J < I ? kMT / 16 : warp + 1;
    // M_ij = CB_ij exp(a_cum_i - a_cum_j) dt_j; below the diagonal tile
    // every j <= i, and a row past Q has a_cum = -inf and C.B^T = 0
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < kMT / 16; ++kk) {
      if (kk >= steps) break;
      const int j = J * kMT + kk * 16 + 2 * t;
      const float2 c0 = sAD[j], c1 = sAD[j + 1], c8 = sAD[j + 8],
                   c9 = sAD[j + 9];
      // rows ia, ib of columns j, j+1 (regs 0, 1) and j+8, j+9 (regs 2, 3)
      float m[4][2] = {
          {cbr[kk][0].x * ex2(aa - c0.x) * c0.y,
           cbr[kk][0].y * ex2(aa - c1.x) * c1.y},
          {cbr[kk][1].x * ex2(ab - c0.x) * c0.y,
           cbr[kk][1].y * ex2(ab - c1.x) * c1.y},
          {cbr[kk][2].x * ex2(aa - c8.x) * c8.y,
           cbr[kk][2].y * ex2(aa - c9.x) * c9.y},
          {cbr[kk][3].x * ex2(ab - c8.x) * c8.y,
           cbr[kk][3].y * ex2(ab - c9.x) * c9.y}};
      if (J == I) {   // masked to j <= i < Q
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = r & 1 ? ib : ia, jr = j + 8 * (r >> 1);
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (!(jr + e <= i && i < Q)) m[r][e] = 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_bf16(m[r][0], m[r][1], ah[kk][r], al[kk][r]);
    }
    if (J < I) load_cb(J + 1);   // in flight during this tile's MMAs
#pragma unroll
    for (int kk = 0; kk < kMT / 16; ++kk) {
      if (kk >= steps) break;
#pragma unroll
      for (int dn = 0; dn < PP / 16; ++dn) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, tX + (kk * 16 + (lane & 15)) * LDP + dn * 16 +
                              8 * (lane >> 4));
        mma_bf16(acc[2 * dn], ah[kk], bv[0], bv[1]);
        mma_bf16(acc[2 * dn], al[kk], bv[0], bv[1]);
        mma_bf16(acc[2 * dn + 1], ah[kk], bv[2], bv[3]);
        mma_bf16(acc[2 * dn + 1], al[kk], bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();
  if (!rows_ok) return;

  bf16* yc = y + ((int64_t)b * S + s0) * nh * P + (int64_t)h * P;
  const int64_t y_row = (int64_t)nh * P;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r ? ib : ia;
    if (i >= Q) continue;
    bf16* yr = yc + i * y_row;
#pragma unroll
    for (int nt = 0; nt < PP / 8; ++nt) {
      const int p = nt * 8 + 2 * t;
      if ((P & 1) == 0 && p < P) {
        *reinterpret_cast<__nv_bfloat162*>(yr + p) =
            __floats2bfloat162_rn(acc[nt][2 * r], acc[nt][2 * r + 1]);
      } else {
        if (p < P) yr[p] = __float2bfloat16(acc[nt][2 * r]);
        if (p + 1 < P) yr[p + 1] = __float2bfloat16(acc[nt][2 * r + 1]);
      }
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

struct Strided {   // a (B, S, heads, D) bf16 view: pointer and three strides
  const bf16* p;
  int64_t sb, ss, sh;
};

template <int PP>
int launch_mma(Strided x, const float* dt, const float* A, Strided Bm,
               Strided Cm, bf16* y, float* state, float* states, float* cb,
               float* acum, int B, int S, int nh, int P, int G, int N, int Q,
               int vec, cudaStream_t stream) {
  static bool configured = false;  // once per instantiation (one card)
  if (!configured) {
    cudaError_t err = allow_smem(ssd_chunk_state_kernel<PP, 1>,
                                 state_smem_bytes(kMT, PP, kMaxQ));
    if (err == cudaSuccess)
      err = allow_smem(ssd_chunk_state_kernel<PP, 2>,
                       state_smem_bytes(2 * kMT, PP, kMaxQ));
    if (err == cudaSuccess)
      err = allow_smem(ssd_chunk_cb_kernel, cb_smem_bytes(kMaxN));
    if (err == cudaSuccess)
      err = allow_smem(ssd_chunk_scan_kernel<PP>,
                       scan_smem_bytes(kMaxN, PP, kMaxQ));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int nc = S / Q, nT = round_up(Q, kMT) / kMT, NP = round_up(N, 16);
  cudaError_t err;

  const int NR = state_rows(NP);
  const dim3 grid1(B * nc * nh, (NP + NR - 1) / NR);
  const size_t smem1 = state_smem_bytes(NR, PP, Q);
  if (NR == kMT)
    ssd_chunk_state_kernel<PP, 1><<<grid1, kMmaThreads, smem1, stream>>>(
        x.p, x.sb, x.ss, x.sh, dt, A, Bm.p, Bm.sb, Bm.ss, Bm.sh, states, acum,
        S, nh, P, G, N, Q, vec);
  else
    ssd_chunk_state_kernel<PP, 2><<<grid1, kMmaThreads, smem1, stream>>>(
        x.p, x.sb, x.ss, x.sh, dt, A, Bm.p, Bm.sb, Bm.ss, Bm.sh, states, acum,
        S, nh, P, G, N, Q, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  ssd_chunk_cb_kernel<<<dim3(nT * (nT + 1), nc * G, B), kCBThreads,
                        cb_smem_bytes(NP), stream>>>(
      Bm.p, Bm.sb, Bm.ss, Bm.sh, Cm.p, Cm.sb, Cm.ss, Cm.sh, cb, S, G, N, Q,
      vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int NP4 = N * P / 4;
  ssd_state_pass_kernel<<<dim3(B * nh, (NP4 + kPassThreads - 1) / kPassThreads),
                          kPassThreads, 0, stream>>>(states, acum, state, S,
                                                     nh, NP4, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  ssd_chunk_scan_kernel<PP>
      <<<B * nc * nh * nT, kMmaThreads, scan_smem_bytes(NP, PP, Q), stream>>>(
          x.p, x.sb, x.ss, x.sh, dt, Cm.p, Cm.sb, Cm.ss, Cm.sh, cb, states,
          acum, y, S, nh, P, G, N, Q, vec);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// fp32 on the CUDA cores: x (B,S,nh,P), dt (B,S,nh), A (nh,), Bm/Cm
// (B,S,G,N), y (B,S,nh,P), state (B,nh,N,P), all fp32 and contiguous.  Q is
// the chunk: S % Q == 0.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y,
                               void* state, int B, int S, int nh, int P, int G,
                               int N, int Q, void* stream) {
  if (B < 1 || S < 1 || nh < 1 || G < 1 || nh % G != 0 || P < 1 ||
      P > kMaxP || N < 4 || N % 4 != 0 || N > kMaxN || Q < 1 || Q > kMaxQ ||
      S % Q != 0 || (int64_t)B * nh > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  return launch<float>(x, dt, A, Bm, Cm, y, state, B, S, nh, P, G, N, Q,
                       static_cast<cudaStream_t>(stream));
}

// bf16 on the tensor cores, four passes.  x (B,S,nh,P) and Bm/Cm (B,S,G,N)
// bf16 with the given batch, token and head (group) strides in elements and
// the last dimension contiguous; dt (B,S,nh) and A (nh,) fp32 contiguous;
// y (B,S,nh,P) bf16 and state (B,nh,N,P) fp32 contiguous.  Scratch, fp32:
// states (B, S/Q, nh, N, P), cb (B, S/Q, G, LQ, LQ) with LQ = Q rounded up
// to 64, acum (B, nh, S).  Returns the first failed launch's cudaError_t (0
// on success).
extern "C" int ssd_scan_mma_launch(
    const void* x, int64_t x_sb, int64_t x_ss, int64_t x_sh, const void* dt,
    const void* A, const void* Bm, int64_t b_sb, int64_t b_ss, int64_t b_sg,
    const void* Cm, int64_t c_sb, int64_t c_ss, int64_t c_sg, void* y,
    void* state, void* states, void* cb, void* acum, int B, int S, int nh,
    int P, int G, int N, int Q, void* stream) {
  if (B < 1 || S < 1 || nh < 1 || G < 1 || nh % G != 0 || P < 1 ||
      P > kMaxP || N < 4 || N % 4 != 0 || N > kMaxN || Q < 1 || Q > kMaxQ ||
      S % Q != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t nc = S / Q, nT = round_up(Q, kMT) / kMT;
  if (B > 65535 || nc * G > 65535 || (int64_t)B * nc * nh * nT > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const Strided xs{static_cast<const bf16*>(x), x_sb, x_ss, x_sh};
  const Strided bs{static_cast<const bf16*>(Bm), b_sb, b_ss, b_sg};
  const Strided cs{static_cast<const bf16*>(Cm), c_sb, c_ss, c_sg};
  auto whole = [](const Strided& v) {   // rows of 16-byte chunks
    return aligned16(v.p) && v.sb % 8 == 0 && v.ss % 8 == 0 && v.sh % 8 == 0;
  };
  const int vec = P % 8 == 0 && N % 8 == 0 && whole(xs) && whole(bs) &&
                  whole(cs);
  const float* dtp = static_cast<const float*>(dt);
  const float* Ap = static_cast<const float*>(A);
  bf16* yp = static_cast<bf16*>(y);
  float *sp = static_cast<float*>(state), *stp = static_cast<float*>(states),
        *cbp = static_cast<float*>(cb), *acp = static_cast<float*>(acum);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int PP = round_up(P, 16);
  if (PP == 16)
    return launch_mma<16>(xs, dtp, Ap, bs, cs, yp, sp, stp, cbp, acp, B, S, nh, P, G, N, Q, vec, s);
  if (PP == 32)
    return launch_mma<32>(xs, dtp, Ap, bs, cs, yp, sp, stp, cbp, acp, B, S, nh, P, G, N, Q, vec, s);
  if (PP == 48)
    return launch_mma<48>(xs, dtp, Ap, bs, cs, yp, sp, stp, cbp, acp, B, S, nh, P, G, N, Q, vec, s);
  return launch_mma<64>(xs, dtp, Ap, bs, cs, yp, sp, stp, cbp, acp, B, S, nh, P, G, N, Q, vec, s);
}
