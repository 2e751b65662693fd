// Causal GQA flash-attention forward for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (see ../ops.py).
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::flash_attention_fwd
// (body `_fa_kernel`).  Same function: q (B,S,H,D), k/v (B,T,Hkv,D) ->
// out (B,S,H,D); query head h reads KV head h / G; key j is valid for query i
// when j <= i (causal) and i - j < window (window > 0); scores scaled by
// `scale`; online softmax with m, l and the accumulator in fp32, l floored at
// 1e-30; output in q's dtype.  Unlike the TPU kernel it takes S and T that
// are not tile multiples, and any D that is a multiple of 8 up to 256.  A
// query row with no valid key at all gives zeros, as the TPU kernel's skipped
// blocks do; causal self-attention (S <= T) never has one.
//
// What bounds it on this card: operations.  Causal attention does about
// 4*B*H*D*S(S+1)/2 operations (QK^T and PV, a multiply-add each) for
// (B*S*H + 2*B*T*Hkv)*D elements read, hundreds of operations per byte.
// Two routes, by dtype:
//
// bf16: `flash_fwd_mma_kernel`, on the tensor cores.  Its bound is those
// operations at 989 TFLOP/s; it issues 1.5 times as many in MMAs (below).
// The FlashAttention-2 structure, with `mma.sync` rather than `wgmma`:
//   * A block owns (q tile of 64 rows, b, h); its 4 warps own 16 rows each.
//     The 1-D grid puts every (b, h)'s last q tile first and its first q
//     tile last, so the long causal rows start first and the short ones
//     fill the tail (with (b, h) outermost and the q tiles reversed within
//     each, the kernel was 1.4 times slower at gemma-2b's training shape,
//     PERF.md).  The block loops over the K/V
//     tiles from the window's lower edge to the causal diagonal, so tiles
//     outside them are never loaded (the TPU kernel's `pl.when` skip); a
//     warp whose rows all lie above a tile skips its arithmetic.
//   * Shared memory holds the Q tile, loaded once, and two K and two V tiles
//     of BK keys, filled by `cp.async.cg` (16 B a copy) one tile ahead of the
//     arithmetic (`commit_group` / `wait_group`), one barrier a tile.  The
//     tail past S, T or D is zero-filled by the copy's src-size operand.
//     Rows are padded by 16 B so that the 8 rows one `ldmatrix` reads fall
//     in 8 different groups of 4 banks (at D = 256 an unpadded row is 512 B
//     and all 8 would collide).
//   * QK^T: `ldmatrix.x4` gives Q's A fragments and K's B fragments (K's
//     [key][d] rows are the column layout already); Q is re-read from shared
//     memory for every K tile, since at D = 256 the accumulator alone is 128
//     registers a thread.  `mma.sync.m16n8k16` bf16 -> fp32, then the scale
//     (times log2 e, for exp2), the mask at -1e30 (only on a tile that
//     crosses the diagonal, the window's edge or T), the row max and sum
//     over a quad of threads by shuffles; the accumulator is rescaled only
//     when a row's max moved.
//   * PV: the m16n8k16 C fragments of two score n-tiles are the A fragment
//     of one k-step, so P never goes through shared memory.  P is carried as
//     hi = bf16(p) and lo = bf16(p - hi), two MMAs into one fp32 accumulator
//     with V's B fragments from `ldmatrix.x4.trans`.  One bf16 P would round
//     p to 8 bits and miss the gate of half a bf16 ulp against fp32 on about
//     a fifth of the outputs; hi + lo keeps 16 bits, as close as fp32 P.
//   * Tiles by D (DP = D padded to 16, BK keys a K/V tile, shared memory):
//     (64, 64, 46,080 B), (80, 32, 33,792 B), (128, 64, 87,040 B),
//     (256, 32, 101,376 B), so two blocks fit on an SM at D = 256, where the
//     accumulator leaves ptxas at 255 registers a thread.
//     `scripts/flash_tiles.py` times other choices.
//   Left for the `wgmma` design: TMA copies into an `mbarrier` ring, a
//   producer warp with consumer warpgroups, 64-row `wgmma` with B (and A)
//   read from shared memory, and the G query heads of one KV head in one
//   block, so that MQA reads each K/V tile once rather than G times from L2.
//
// fp32: `flash_fwd_kernel`, on the CUDA cores (67 TFLOP/s), as the TPU
// kernel computes in fp32; far above the tensor-core bound.  Its design:
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

// Eight consecutive elements of one row: two 16-byte loads.  Only fp32
// reaches this kernel; bf16 takes the tensor-core kernel below.
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

__device__ inline void store(float* p, float x) { *p = x; }

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


// ------------------------------------------------------------ bf16 route

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

// Rows [r0, r0 + ROWS) of a slab whose row r starts at src + r * stride, into
// shared memory with row stride LD, by cp.async; rows at or past `valid` and
// columns at or past D are zeros.
template <int ROWS, int DP, int LD, int THREADS>
__device__ inline void load_rows_async(__nv_bfloat16* dst,
                                       const __nv_bfloat16* src, size_t stride,
                                       int r0, int valid, int D) {
  constexpr int CH = DP / 8;   // 16-byte chunks of a row
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, c = i - r * CH;
    const bool ok = r0 + r < valid && c * 8 < D;
    cp_async16(dst + r * LD + c * 8,
               ok ? src + (size_t)(r0 + r) * stride + c * 8 : src, ok);
  }
}

template <int DP, int BK, int WARPS>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (16 * WARPS + 4 * BK) * (DP + 8);
}

template <int DP, int BK, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, int S, int T_len, int H,
                     int Hkv, int D, int causal, int window, float scale) {
  constexpr int BQ = 16 * WARPS, THREADS = 32 * WARPS;
  constexpr int LD = DP + 8;   // row stride in elements: 16 B of padding
  constexpr int NS = BK / 8;   // n-tiles of 8 keys in a score tile
  constexpr int NO = DP / 8;   // n-tiles of 8 columns in the output
  static_assert(DP % 16 == 0 && BK % 16 == 0, "tiles are 16-multiples");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BQ * LD;       // two tiles of BK rows
  __nv_bfloat16* sV = sK + 2 * BK * LD;   // two tiles of BK rows

  // block x is (q tile, b, h), h fastest; the q tiles from the last down,
  // so that the long causal rows of every (b, h) start first
  const int n_q = (S + BQ - 1) / BQ;
  const int B = gridDim.x / (n_q * H);
  const int h = blockIdx.x % H, bt = blockIdx.x / H;
  const int b = bt % B, q0 = (n_q - 1 - bt / B) * BQ;
  const int kvh = h / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;   // a fragment's row, column pair
  const int w0 = q0 + warp * 16;           // the warp's first query row

  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)Hkv * D;
  const __nv_bfloat16* qb = q + ((size_t)b * S * H + h) * D;
  const __nv_bfloat16* kb = k + ((size_t)b * T_len * Hkv + kvh) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * T_len * Hkv + kvh) * D;

  // keys any row of this tile may see
  const int q_last = min(q0 + BQ, S) - 1;
  const int k_hi = causal ? min(T_len, q_last + 1) : T_len;
  const int k_lo = window ? max(0, q0 - window + 1) : 0;
  const int n_tiles = k_lo < k_hi ? (k_hi - k_lo + BK - 1) / BK : 0;
  const float scale_log2 = scale * 1.4426950408889634f;   // exp(x) = exp2(x log2 e)

  load_rows_async<BQ, DP, LD, THREADS>(sQ, qb, q_stride, q0, S, D);
  if (n_tiles > 0) {
    load_rows_async<BK, DP, LD, THREADS>(sK, kb, kv_stride, k_lo, k_hi, D);
    load_rows_async<BK, DP, LD, THREADS>(sV, vb, kv_stride, k_lo, k_hi, D);
  }
  cp_async_commit();

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // rows w0 + g and w0 + g + 8: the running max, and this thread's share of
  // the running sum (its quad's four shares add up at the end)
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_lo + it * BK;
    // tile it has landed, and every warp is done with tile it - 1, whose
    // buffers take tile it + 1 while this one is computed on
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_tiles) {
      const int nb = (it + 1) & 1;
      load_rows_async<BK, DP, LD, THREADS>(sK + nb * BK * LD, kb, kv_stride,
                                           k0 + BK, k_hi, D);
      load_rows_async<BK, DP, LD, THREADS>(sV + nb * BK * LD, vb, kv_stride,
                                           k0 + BK, k_hi, D);
      cp_async_commit();
    }

    // a warp whose rows all lie past S, or above this tile's first key, has
    // nothing to add
    if (w0 < S && !(causal && k0 > w0 + 15)) {
      const __nv_bfloat16* tK = sK + (it & 1) * BK * LD;
      const __nv_bfloat16* tV = sV + (it & 1) * BK * LD;

      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < DP / 16; ++kd) {
        uint32_t a[4];
        ldsm_x4(a, sQ + (warp * 16 + (lane & 15)) * LD + kd * 16 +
                       8 * (lane >> 4));
#pragma unroll
        for (int nj = 0; nj < NS / 2; ++nj) {
          uint32_t bk[4];   // keys nj*16 + 0..7 in bk[0..1], + 8..15 in bk[2..3]
          ldsm_x4(bk, tK + (nj * 16 + (lane & 7) + 8 * (lane >> 4)) * LD +
                          kd * 16 + 8 * ((lane >> 3) & 1));
          mma_bf16(s[2 * nj], a, bk[0], bk[1]);
          mma_bf16(s[2 * nj + 1], a, bk[2], bk[3]);
        }
      }

      // s[j][e] is row w0 + g + 8 * (e >> 1), key k0 + 8 * j + 2 * t + (e & 1),
      // scaled into log2 units; only a tile that crosses the diagonal, the
      // window's edge or T needs the mask (-1e30), and the same for the warp
      const bool edge = k0 + BK > k_hi || (causal && k0 + BK - 1 > w0) ||
                        (window && w0 + 15 - k0 >= window);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = w0 + g + 8 * (e >> 1);
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const bool ok = !edge || (key < k_hi && (!causal || key <= row) &&
                                    (!window || row - key < window));
          s[j][e] = ok ? s[j][e] * scale_log2 : kNegInf;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      // a row with no valid key yet keeps m = -1e30 and subtracts 0, so that
      // its masked scores give exp2(-1e30) = 0
      float corr[2], m_sub[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        m_sub[r] = m_new == kNegInf ? 0.f : m_new;
        corr[r] = exp2f(m[r] - m_sub[r]);
        m[r] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = exp2f(s[j][e] - m_sub[e >> 1]);
          sum[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
      // the accumulator is rescaled only when some row's max moved
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int n = 0; n < NO; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
      }

      // P V: score n-tiles 2kk and 2kk+1 are the A fragment of k-step kk
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t ph[4], pl[4];
        split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int dn = 0; dn < DP / 16; ++dn) {
          uint32_t bv[4];   // columns dn*16 + 0..7 in bv[0..1], + 8..15 in bv[2..3]
          ldsm_x4_trans(bv, tV + (kk * 16 + (lane & 15)) * LD + dn * 16 +
                                8 * (lane >> 4));
          mma_bf16(acc[2 * dn], ph, bv[0], bv[1]);
          mma_bf16(acc[2 * dn], pl, bv[0], bv[1]);
          mma_bf16(acc[2 * dn + 1], ph, bv[2], bv[3]);
          mma_bf16(acc[2 * dn + 1], pl, bv[2], bv[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  __nv_bfloat16* ob = out + ((size_t)b * S * H + h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = w0 + g + 8 * r;
    if (row >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int n = 0; n < NO; ++n)
      if (8 * n < D)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * q_stride + 8 * n +
                                           2 * t) =
            __floats2bfloat162_rn(acc[n][2 * r] / denom,
                                  acc[n][2 * r + 1] / denom);
  }
}

template <int DP, int BK, int WARPS>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B,
               int S, int T_len, int H, int Hkv, int D, int causal, int window,
               float scale, cudaStream_t stream) {
  constexpr size_t bytes = mma_smem_bytes<DP, BK, WARPS>();
  static_assert(bytes <= 232448, "more shared memory than a block may have");
  auto kernel = flash_fwd_mma_kernel<DP, BK, WARPS>;
  static bool configured = false;  // once per instantiation (one card)
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const long long blocks =
      (long long)((S + 16 * WARPS - 1) / (16 * WARPS)) * B * H;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, 32 * WARPS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      S, T_len, H, Hkv, D, causal, window, scale);
  return (int)cudaGetLastError();
}

// bf16 goes to the tensor cores.  The table (DP, BK, WARPS) by D is mirrored
// by ops.py::MMA_TILES.
template <>
int dispatch<__nv_bfloat16>(const void* q, const void* k, const void* v,
                            void* out, int B, int S, int T_len, int H, int Hkv,
                            int D, int causal, int window, float scale,
                            cudaStream_t stream) {
  if (D <= 64)
    return launch_mma<64, 64, 4>(q, k, v, out, B, S, T_len, H, Hkv, D, causal, window, scale, stream);
  if (D <= 80)
    return launch_mma<80, 32, 4>(q, k, v, out, B, S, T_len, H, Hkv, D, causal, window, scale, stream);
  if (D <= 128)
    return launch_mma<128, 64, 4>(q, k, v, out, B, S, T_len, H, Hkv, D, causal, window, scale, stream);
  return launch_mma<256, 32, 4>(q, k, v, out, B, S, T_len, H, Hkv, D, causal, window, scale, stream);
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
