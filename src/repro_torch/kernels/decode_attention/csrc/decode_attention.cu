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
// give B*H programs, 32 at batch 4, for 132 SMs.  So a block here takes the
// query heads of one KV head (K/V read once for all of them) and one slice
// ("split") of the valid cache; the host sizes the splits (ops.py::plan) so
// that every SM holds as many blocks as fit on it, and a block whose slice
// starts at or past the limit exits at once (the TPU kernel's `pl.when`
// skip).  Two routes, by dtype, behind the one entry point:
//
// bf16: `decode_mma_kernel`, on the tensor cores (`mma.sync.m16n8k16`).
//   * The products run transposed: S^T = K Q^T and O^T += V^T P^T, keys as
//     the MMA's 16 rows and up to 8 query heads as its 8 columns (G > 8
//     takes more blocks).  With the heads as the rows of an A tile instead,
//     padded to 16, half of every MMA is zero rows at G = 8 and the
//     accumulator is D/2 registers a thread, and the kernel is bound by each
//     warp's chain of MMAs rather than by bytes (PERF.md, section 6).  Here the
//     accumulator is D/4 registers, and Q^T's B fragments stay in registers
//     for the whole block.
//   * K and V stream through shared memory in tiles of 16 keys a warp,
//     filled by `cp.async.cg` (16 B a copy) into a ring of STAGES tiles, so
//     that STAGES - 1 tiles are in flight while one is computed on, one
//     barrier a tile.  Keys past the split's end are zero-filled by the
//     copy's src-size operand and masked.  Rows are padded by 16 B so that
//     the 8 rows one `ldmatrix` reads fall in 8 different groups of 4 banks.
//   * Each warp takes its own 16 keys of a tile and keeps its own online
//     softmax (in log2 units, `exp2f`) and fp32 accumulator over all of D;
//     warp 0 merges the others' once, at the end, through shared memory in
//     their fragment layout.
//   * Fragments: `ldmatrix.x4` gives K's A fragments, `ldmatrix.x4.trans`
//     V^T's, `ldmatrix.x2` Q^T's B fragments.  P^T's B fragments are S^T's C
//     fragments, rounded to bf16 pairs and transposed in registers by
//     `movmatrix.trans`.  P goes in as hi = bf16(p) and lo = bf16(p - hi),
//     two MMAs into one fp32 accumulator: one bf16 P would round p to 8
//     bits and miss the gate of half a bf16 ulp against fp32
//     (tests/test_torch_decode_attention.py counts the outputs).
//
// fp32: `decode_simt_kernel`, on the CUDA cores (the fp32 gate of 2e-5 is
// out of reach of bf16 or TF32 products).  A block holds up to 8 query rows of
// its KV head in registers and streams its slice with 16-byte loads, one key's
// 8-element chunks across a lane segment, the next key fetched while the
// current one is used; segments, then warps, merge at the end.
//
// Both routes: a plan of one split writes the output directly, in one launch.
// Otherwise each block writes an unnormalised partial (acc, m, l) to fp32
// scratch and `decode_combine_kernel` merges the partials of a (b, h) row in
// parallel: one block per (row, 32 columns of D), its 8 warps taking every
// 8th split, each lane one column.
//
// Given an `lse` pointer, whichever launch writes the output also writes each
// (b, h) row's log-sum-exp of its scaled scores, in natural units (the bf16
// route converts its log2 max once, there).  The cache handed in is then one
// rank's slice of a cache split over keys, and the ranks' (out, lse) pairs
// merge as the splits here do (distributed/sharding.py::merge_partials).
// Without it nothing else changes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 256;
constexpr int kMaxSplit = 1024;
constexpr int kHeads = 8;      // query heads of one KV head in a bf16 block
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

// ------------------------------------------------------------ fp32 route

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// Eight consecutive fp32 elements of one row: two 16-byte loads.  Starts at
// zero, so lanes that never load hold zeros.
struct Chunk {
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

// Block (row group, split): query heads g0 .. g0+gn-1 of KV head kvh in batch
// b, keys [start, end) of the valid cache.
//
// Lanes: a key's D elements are C = D/8 chunks; L (a power of two >= C) lanes
// take one key, so a warp takes 32/L keys at once, one per lane segment.  Each
// segment runs its own online softmax; segments, then warps, are merged at the
// end.
template <int GM>
__global__ void __launch_bounds__(kThreads)
decode_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ out,
                   float* __restrict__ part_acc, float* __restrict__ part_ml,
                   float* __restrict__ lse, int H, int Hkv, int T_len, int D,
                   int n_grp, int limit, int split_len, int n_split,
                   float scale) {
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
    Chunk ch;
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
  const float* kp = k + base;
  const float* vp = v + base;
  const int step = kWarps * kpw;

  Chunk kc, vc;
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

  // merge the warps: the output if this is the only split, else the split's
  // partial for each query row
  for (int i = threadIdx.x; i < gn * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float a = 0.f, sum = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float cw = expf(sm_m[w][g] - mx);
      a += sm_acc[w][g][d] * cw;
      sum += sm_l[w][g] * cw;
    }
    const size_t row = row0 + g;
    if (n_split == 1) {
      out[row * D + d] = a / fmaxf(sum, 1e-30f);
      if (lse != nullptr && d == 0) lse[row] = mx + logf(sum);
    } else {
      part_acc[(row * n_split + split) * D + d] = a;
      if (d == 0) {
        part_ml[(row * n_split + split) * 2] = mx;
        part_ml[(row * n_split + split) * 2 + 1] = sum;
      }
    }
  }
}

template <int GM>
void launch_simt(const float* q, const float* k, const float* v, float* out,
                 float* part_acc, float* part_ml, float* lse, int B, int H,
                 int Hkv,
                 int T_len, int D, int limit, int split_len, int n_split,
                 float scale, cudaStream_t stream) {
  const int n_grp = (H / Hkv + GM - 1) / GM;
  const dim3 grid(B * Hkv * n_grp, n_split);
  decode_simt_kernel<GM><<<grid, kThreads, 0, stream>>>(
      q, k, v, out, part_acc, part_ml, lse, H, Hkv, T_len, D, n_grp, limit,
      split_len, n_split, scale);
}

int dispatch_simt(int gm, const void* q, const void* k, const void* v,
                  void* out, float* part_acc, float* part_ml, float* lse, int B,
                  int H, int Hkv, int T_len, int D, int limit, int split_len,
                  int n_split, float scale, cudaStream_t stream) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  switch (gm) {
    case 1: launch_simt<1>(qf, kf, vf, of, part_acc, part_ml, lse, B, H, Hkv, T_len, D, limit, split_len, n_split, scale, stream); break;
    case 2: launch_simt<2>(qf, kf, vf, of, part_acc, part_ml, lse, B, H, Hkv, T_len, D, limit, split_len, n_split, scale, stream); break;
    case 4: launch_simt<4>(qf, kf, vf, of, part_acc, part_ml, lse, B, H, Hkv, T_len, D, limit, split_len, n_split, scale, stream); break;
    case 8: launch_simt<8>(qf, kf, vf, of, part_acc, part_ml, lse, B, H, Hkv, T_len, D, limit, split_len, n_split, scale, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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

__device__ inline void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// The 8x8 b16 matrix whose row g, columns 2t and 2t+1 thread (g, t) holds
// in x, transposed: the thread gets row g, columns 2t and 2t+1 of the
// transpose.
__device__ inline uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

// Shared memory of one block: the Q rows and the K and V rings, rows padded
// by 16 B; after the loop the same bytes hold warps 1..WARPS-1's (acc, m, l)
// in their fragment layout.
template <int DP, int WARPS, int STAGES>
constexpr int mma_smem_bytes() {
  constexpr int ring = 2 * (kHeads + 2 * STAGES * 16 * WARPS) * (DP + 8);
  constexpr int merge = 4 * 32 * (WARPS - 1) * (DP / 4 + 4);
  return ring > merge ? ring : merge;
}

// Block (head group, split): the query heads g0 .. g0+gn-1 (gn <= 8) of KV
// head kvh in batch b, keys [start, end) of the valid cache.  The products
// run transposed, keys as the MMA's 16 rows and the heads as its 8 columns:
// S^T = K Q^T, and O^T += V^T P^T, so that no row of a tile is padding when
// G = 8 and the accumulator is DP/4 registers a thread.
template <int DP, int WARPS, int STAGES>
__global__ void __launch_bounds__(32 * WARPS)
decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ part_acc,
                  float* __restrict__ part_ml, float* __restrict__ lse, int H,
                  int Hkv, int T_len, int D, int n_grp, int limit,
                  int split_len, int n_split, float scale) {
  constexpr int BK = 16 * WARPS;   // keys a tile: 16 a warp
  constexpr int THREADS = 32 * WARPS;
  constexpr int LD = DP + 8;       // row stride in elements: 16 B of padding
  constexpr int KD = DP / 16;      // k-steps of S^T, m-tiles of O^T
  static_assert(DP % 16 == 0 && STAGES >= 2, "tiles are 16-multiples");

  const int split = blockIdx.y;
  const int start = split * split_len;
  if (start >= limit) return;
  const int end = min(start + split_len, limit);
  const int n_tiles = (end - start + BK - 1) / BK;

  const int grp = blockIdx.x % n_grp, bk = blockIdx.x / n_grp;
  const int b = bk / Hkv, kvh = bk % Hkv;
  const int G = H / Hkv;
  const int g0 = grp * kHeads, gn = min(kHeads, G - g0);
  const int row0 = b * H + kvh * G + g0;  // (b, h) row of the group's first head

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kHeads * LD;         // STAGES tiles of BK rows
  __nv_bfloat16* sV = sK + STAGES * BK * LD;    // STAGES tiles of BK rows

  const size_t kv_stride = (size_t)Hkv * D;
  const __nv_bfloat16* kb = k + ((size_t)b * T_len * Hkv + kvh) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * T_len * Hkv + kvh) * D;

  // Q in its own group, then tiles 0 .. STAGES-2 in flight, one group each
  load_rows_async<kHeads, DP, LD, THREADS>(sQ, q + (size_t)row0 * D, D, 0, gn, D);
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) {
      load_rows_async<BK, DP, LD, THREADS>(sK + s * BK * LD, kb, kv_stride,
                                           start + s * BK, end, D);
      load_rows_async<BK, DP, LD, THREADS>(sV + s * BK * LD, vb, kv_stride,
                                           start + s * BK, end, D);
    }
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;   // a fragment's row, column pair
  const float scale_log2 = scale * 1.4426950408889634f;   // exp(x) = exp2(x log2 e)

  // Q^T's B fragments for every k-step, held for the whole block: head g,
  // d = 16 kd + 2t (+1) in qb[kd][0], + 8 in qb[kd][1]
  cp_async_wait<STAGES - 1>();
  __syncthreads();
  uint32_t qb[KD][2];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd)
    ldsm_x2(qb[kd], sQ + (lane & 7) * LD + kd * 16 + 8 * ((lane >> 3) & 1));

  // O^T: acc[mt][e] is d = 16 mt + g + 8 (e >> 1), head 2t + (e & 1)
  float acc[KD][4];
#pragma unroll
  for (int mt = 0; mt < KD; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;
  // heads 2t and 2t + 1: the warp's running max (log2 units), and this
  // thread's share of the running sum (its keys g and g + 8; the 8 threads
  // of a column add up at the end)
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    // tile it has landed, and every warp is done with tile it - 1, whose
    // stage takes tile it + STAGES - 1 while this one is computed on
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    {
      const int nt = it + STAGES - 1;
      if (nt < n_tiles) {
        const int st = nt % STAGES;
        load_rows_async<BK, DP, LD, THREADS>(sK + st * BK * LD, kb, kv_stride,
                                             start + nt * BK, end, D);
        load_rows_async<BK, DP, LD, THREADS>(sV + st * BK * LD, vb, kv_stride,
                                             start + nt * BK, end, D);
      }
      cp_async_commit();
    }

    const int kw = start + it * BK + 16 * warp;   // the warp's first key
    if (kw >= end) continue;                      // past the split: nothing
    const __nv_bfloat16* tK = sK + ((it % STAGES) * BK + 16 * warp) * LD;
    const __nv_bfloat16* tV = sV + ((it % STAGES) * BK + 16 * warp) * LD;

    // S^T = K Q^T over the warp's 16 keys, in two chains (even and odd
    // k-steps): s[e] is key kw + g + 8 (e >> 1), head 2t + (e & 1)
    float s[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t a[4];   // keys 0..15 by d 16 kd .. +15, row-major
      ldsm_x4(a, tK + (lane & 15) * LD + kd * 16 + 8 * (lane >> 4));
      if (kd & 1)
        mma_bf16(s2, a, qb[kd][0], qb[kd][1]);
      else
        mma_bf16(s, a, qb[kd][0], qb[kd][1]);
    }

    // scaled into log2 units; keys past the split's end (only in its last
    // tile) at -1e30.  The warp's first key is valid, so every max is finite.
    const bool edge = kw + 16 > end;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = !edge || kw + g + 8 * (e >> 1) < end;
      s[e] = ok ? (s[e] + s2[e]) * scale_log2 : kNegInf;
    }
    float corr[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float mx = fmaxf(s[c], s[2 + c]);   // over the warp's 16 keys
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      const float m_new = fmaxf(m[c], mx);
      corr[c] = exp2f(m[c] - m_new);
      m[c] = m_new;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) s[e] = exp2f(s[e] - m[e & 1]);
#pragma unroll
    for (int c = 0; c < 2; ++c) l[c] = l[c] * corr[c] + s[c] + s[2 + c];
    // the accumulator is rescaled only when some head's max moved
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int mt = 0; mt < KD; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][e] *= corr[e & 1];
    }

    // P^T's B fragments: each 8x8 half (keys 0..7, 8..15) of P, as bf16 hi
    // and lo, transposed in registers
    uint32_t hi[2], lo[2], bh[2], bl[2];
    split_bf16(s[0], s[1], hi[0], lo[0]);
    split_bf16(s[2], s[3], hi[1], lo[1]);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      bh[j] = movmatrix_trans(hi[j]);
      bl[j] = movmatrix_trans(lo[j]);
    }
    // O^T += V^T P^T: V^T's A fragments from V's [key][d] rows, transposed
#pragma unroll
    for (int mt = 0; mt < KD; ++mt) {
      uint32_t a[4];
      ldsm_x4_trans(a, tV + ((lane & 7) + 8 * (lane >> 4)) * LD + mt * 16 +
                           8 * ((lane >> 3) & 1));
      mma_bf16(acc[mt], a, bh[0], bh[1]);
      mma_bf16(acc[mt], a, bl[0], bl[1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp is done with the ring: it takes the merge

#pragma unroll
  for (int c = 0; c < 2; ++c) {
    l[c] += __shfl_xor_sync(0xffffffffu, l[c], 4);
    l[c] += __shfl_xor_sync(0xffffffffu, l[c], 8);
    l[c] += __shfl_xor_sync(0xffffffffu, l[c], 16);
  }
  // warps 1.. hand (acc, m, l) to warp 0 in their fragment layout, one
  // float a lane a slot (no bank conflicts); a warp that had no key has
  // m = -1e30 and weight 0
  constexpr int SLOTS = KD * 4 + 4;
  float* sMerge = reinterpret_cast<float*>(smem_raw);
  if (warp > 0) {
    float* mine = sMerge + (warp - 1) * SLOTS * 32 + lane;
#pragma unroll
    for (int mt = 0; mt < KD; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[(mt * 4 + e) * 32] = acc[mt][e];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      mine[(KD * 4 + c) * 32] = m[c];
      mine[(KD * 4 + 2 + c) * 32] = l[c];
    }
  }
  __syncthreads();
  if (warp > 0) return;
#pragma unroll
  for (int w = 1; w < WARPS; ++w) {
    const float* theirs = sMerge + (w - 1) * SLOTS * 32 + lane;
    float c0[2], c1[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float mw = theirs[(KD * 4 + c) * 32];
      const float m_new = fmaxf(m[c], mw);
      c0[c] = exp2f(m[c] - m_new);
      c1[c] = exp2f(mw - m_new);
      l[c] = l[c] * c0[c] + theirs[(KD * 4 + 2 + c) * 32] * c1[c];
      m[c] = m_new;
    }
#pragma unroll
    for (int mt = 0; mt < KD; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[mt][e] = acc[mt][e] * c0[e & 1] + theirs[(mt * 4 + e) * 32] * c1[e & 1];
  }

  // the output if this is the only split, else the split's partial, m in
  // log2 units: thread (g, t) holds heads 2t, 2t + 1 at d = 16 mt + g (+ 8)
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int head = 2 * t + c;
    if (head >= gn) continue;
    const size_t row = row0 + head;
    const float inv = 1.f / fmaxf(l[c], 1e-30f);
#pragma unroll
    for (int mt = 0; mt < KD; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int d = 16 * mt + g + 8 * r;
        if (d >= D) continue;
        const float a = acc[mt][2 * r + c];
        if (n_split == 1)
          out[row * D + d] = __float2bfloat16(a * inv);
        else
          part_acc[(row * n_split + split) * D + d] = a;
      }
    if (n_split > 1 && g == 0) {
      part_ml[(row * n_split + split) * 2] = m[c];
      part_ml[(row * n_split + split) * 2 + 1] = l[c];
    } else if (n_split == 1 && lse != nullptr && g == 0) {
      lse[row] = m[c] * kLn2 + logf(l[c]);
    }
  }
}

template <int DP, int WARPS, int STAGES>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               float* part_acc, float* part_ml, float* lse, int B, int H,
               int Hkv,
               int T_len, int D, int limit, int split_len, int n_split,
               float scale, cudaStream_t stream) {
  constexpr int bytes = mma_smem_bytes<DP, WARPS, STAGES>();
  static_assert(bytes <= 232448, "more shared memory than a block may have");
  auto kernel = decode_mma_kernel<DP, WARPS, STAGES>;
  static bool configured = false;  // once per instantiation (one card)
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int n_grp = (H / Hkv + kHeads - 1) / kHeads;
  const dim3 grid(B * Hkv * n_grp, n_split);
  kernel<<<grid, 32 * WARPS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      part_acc, part_ml, lse, H, Hkv, T_len, D, n_grp, limit, split_len,
      n_split, scale);
  return (int)cudaGetLastError();
}

// The table (DP, WARPS, STAGES) by D is mirrored by ops.py::MMA_TILES.
int dispatch_mma(const void* q, const void* k, const void* v, void* out,
                 float* part_acc, float* part_ml, float* lse, int B, int H,
                 int Hkv,
                 int T_len, int D, int limit, int split_len, int n_split,
                 float scale, cudaStream_t stream) {
  if (D <= 64)
    return launch_mma<64, 4, 4>(q, k, v, out, part_acc, part_ml, lse, B, H, Hkv, T_len, D, limit, split_len, n_split, scale, stream);
  if (D <= 80)
    return launch_mma<80, 4, 4>(q, k, v, out, part_acc, part_ml, lse, B, H, Hkv, T_len, D, limit, split_len, n_split, scale, stream);
  if (D <= 128)
    return launch_mma<128, 4, 4>(q, k, v, out, part_acc, part_ml, lse, B, H, Hkv, T_len, D, limit, split_len, n_split, scale, stream);
  return launch_mma<256, 4, 3>(q, k, v, out, part_acc, part_ml, lse, B, H, Hkv, T_len, D, limit, split_len, n_split, scale, stream);
}

// ------------------------------------------------------------ combine

constexpr int kCombineWarps = 8;

__device__ inline void store(float* p, float x) { *p = x; }
__device__ inline void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Block (b, h row, 32 columns of D): merges the row's partials of the splits
// that hold a valid key (ceil(limit / split_len) of them).  m is in log2
// units when LOG2 (the bf16 route), natural units otherwise; the row's lse,
// if asked for, in natural units.
template <typename T, bool LOG2>
__global__ void __launch_bounds__(32 * kCombineWarps)
decode_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_ml, T* __restrict__ out,
                      float* __restrict__ lse, int D, int limit, int split_len,
                      int n_split) {
  constexpr int THREADS = 32 * kCombineWarps;
  const int row = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = blockIdx.y * 32 + lane;
  const int n_valid = (limit + split_len - 1) / split_len;
  const float* ml = part_ml + (size_t)row * n_split * 2;
  __shared__ float w[kMaxSplit];
  __shared__ float stat[2][kCombineWarps];
  __shared__ float part[kCombineWarps][32];

  // the largest m over the splits, then each split's weight and the sum
  float mx = kNegInf;
  for (int s = threadIdx.x; s < n_valid; s += THREADS) mx = fmaxf(mx, ml[2 * s]);
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) stat[0][warp] = mx;
  __syncthreads();
  mx = stat[0][0];
#pragma unroll
  for (int i = 1; i < kCombineWarps; ++i) mx = fmaxf(mx, stat[0][i]);
  float sum = 0.f;
  for (int s = threadIdx.x; s < n_valid; s += THREADS) {
    const float cw = LOG2 ? exp2f(ml[2 * s] - mx) : expf(ml[2 * s] - mx);
    w[s] = cw;
    sum += ml[2 * s + 1] * cw;
  }
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) stat[1][warp] = sum;
  __syncthreads();
  float denom = 0.f;
#pragma unroll
  for (int i = 0; i < kCombineWarps; ++i) denom += stat[1][i];
  denom = fmaxf(denom, 1e-30f);
  if (lse != nullptr && blockIdx.y == 0 && threadIdx.x == 0)
    lse[row] = (LOG2 ? mx * kLn2 : mx) + logf(denom);

  // warp i takes every 8th split from i, lane j column d
  float a = 0.f;
  if (d < D) {
    const float* acc = part_acc + (size_t)row * n_split * D + d;
#pragma unroll 4
    for (int s = warp; s < n_valid; s += kCombineWarps)
      a += acc[(size_t)s * D] * w[s];
  }
  part[warp][lane] = a;
  __syncthreads();
  if (warp == 0 && d < D) {
#pragma unroll
    for (int i = 1; i < kCombineWarps; ++i) a += part[i][lane];
    store(out + (size_t)row * D + d, a / denom);
  }
}

template <typename T, bool LOG2>
int launch_combine(const float* part_acc, const float* part_ml, void* out,
                   float* lse, int rows, int D, int limit, int split_len,
                   int n_split, cudaStream_t stream) {
  const dim3 grid(rows, (D + 31) / 32);
  decode_combine_kernel<T, LOG2><<<grid, 32 * kCombineWarps, 0, stream>>>(
      part_acc, part_ml, static_cast<T*>(out), lse, D, limit, split_len,
      n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32 (CUDA cores; gm, the query heads a block takes, is 1, 2, 4
// or 8), 1 bfloat16 (tensor cores; gm must be 8, the n of one MMA).
// q (B,H,D), k/v (B,T,Hkv,D), out (B,H,D), contiguous and 16-byte aligned.
// n_split == 1 writes out directly and reads no scratch (part_acc and
// part_ml may be null); otherwise part_acc is (B*H, n_split, D) fp32 and
// part_ml (B*H, n_split, 2) fp32, and a second launch merges them.  lse, if
// not null, is (B*H,) fp32: each row's log-sum-exp of its scaled scores.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int decode_attention_launch(int dtype, const void* q, const void* k,
                                       const void* v, void* out, float* part_acc,
                                       float* part_ml, float* lse, int B,
                                       int H, int Hkv, int T_len, int D,
                                       int limit, int gm,
                                       int split_len, int n_split, float scale,
                                       void* stream) {
  if (B < 1 || Hkv < 1 || H % Hkv != 0 || D < 8 || D % 8 != 0 || D > kMaxD ||
      limit < 1 || limit > T_len || split_len < 1 || n_split < 1 ||
      n_split > kMaxSplit || (long long)split_len * n_split < limit ||
      (long long)split_len * (n_split - 1) >= limit ||
      (n_split > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0) {
    err = dispatch_simt(gm, q, k, v, out, part_acc, part_ml, lse, B, H, Hkv, T_len, D, limit, split_len, n_split, scale, s);
    if (err == 0 && n_split > 1)
      err = launch_combine<float, false>(part_acc, part_ml, out, lse, B * H, D, limit, split_len, n_split, s);
  } else if (dtype == 1 && gm == kHeads) {
    err = dispatch_mma(q, k, v, out, part_acc, part_ml, lse, B, H, Hkv, T_len, D, limit, split_len, n_split, scale, s);
    if (err == 0 && n_split > 1)
      err = launch_combine<__nv_bfloat16, true>(part_acc, part_ml, out, lse, B * H, D, limit, split_len, n_split, s);
  } else {
    err = (int)cudaErrorInvalidValue;
  }
  return err;
}
