// Fused crop -> cast -> normalize for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (see ../ops.py).
//
// Replaces the TPU kernel
//   src/repro/kernels/fused_preprocess/fused_preprocess.py::fused_preprocess_fwd
//   (body `_kernel`).
// Same function: images (B,H,W,C) uint8 and a window (y0, x0, h, w) give
// out (B,h,w,C) fp32 with
//   out[b,y,x,c] = (images[b,y0+y,x0+x,c] / 255 - mean[c]) / std[c]
// computed in that order with IEEE fp32 division, as the plain version
// writes it.
//
// What bounds it on this card: bytes.  Each output element costs one byte
// read and four written, so the memory rate is the limit (at B=256 and a
// 224 x 224 x 3 window, 192.7 MB, about 0.058 ms at 3.35 TB/s), provided
// the written bytes leave as whole sectors, enough loads are in flight,
// and an element costs a few instructions.  What the design does:
//   * The TPU kernel slices the window out first (`lax.slice`) and runs one
//     grid step per image on the slice.  Here the window is read in place:
//     output row r = (b, y) is the L = w*C contiguous input bytes from
//     ((b*H + y0+y)*W + x0)*C on, and the output is one flat array.
//   * The output is cut into quads of 4 elements, each one float4 store;
//     every quad is 16-byte aligned, whatever L is.  The 32 lanes of a warp
//     take 32 neighbouring quads, so one store instruction writes 512
//     contiguous bytes: whole sectors.  (Threads that each wrote 64
//     contiguous bytes of their own left every instruction's sectors half
//     written, and that, not the loads, set the kernel's time.)
//   * A block takes a segment of G rows at a time (G*L a multiple of 4, and
//     about kSegment elements), its threads kQuads quads each a pass.  A
//     quad's row and column come from its offset in the segment by a
//     division done as a multiply (FastDiv).  A pass issues every quad's
//     loads before any arithmetic: the one or two aligned 32-bit words that
//     hold its 4 bytes, and only those, so a window that ends on the last
//     byte of the batch reads nothing past it.  A row starts at any byte
//     offset (a centre 224 crop of 250 x 3 starts 39 bytes into its row,
//     whose stride is 750), so a funnel shift lines the bytes up.  A quad
//     that crosses a row's end (L not a multiple of 4) and the output's
//     last partial quad take their elements one at a time.
//   * The grid is what stays resident on the card (the SMs times the blocks
//     an SM holds).  A block walks its segments by a constant stride of
//     rows, kept as (b, y) and advanced without a division.
//   * No division per element for C <= kTableC: each block first builds the
//     256 * C possible outputs in shared memory, with IEEE division, and an
//     element is one lookup.  Channel c's 256 values start at c * kStride;
//     kStride = 256 + 8 puts a value's C channels in distinct banks (a flat
//     region of an image asks for one value in every channel).  Above
//     kTableC the kernel divides per element, with mean and std staged in
//     shared memory.  Rows start on channel 0, so an element's channel is
//     its column mod C.
//   * Offsets into the batch and the output are 64-bit: B*H*W*C passes 2^31
//     at 16384 images of 250 x 250 x 3.  Within a segment they are 32-bit:
//     the wrapper keeps L and h below 2^29.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 64;
constexpr int kTableC = 4;             // channels up to here use the table
constexpr int kStride = 256 + 8;       // table floats between two channels
constexpr int kQuads = 4;              // quads a thread takes in a pass
constexpr int kSegment = 4 * kThreads * kQuads;   // elements a pass covers
constexpr int kMaxDevices = 64;

struct Channels {
  float mean[kMaxC];
  float std[kMaxC];
};

// x / d for 0 <= x < 2^31 and 1 <= d < 2^31 by a multiply (CUTLASS's
// FastDivmod): mul = ceil(2^p / d) with p = 31 + ceil(log2 d).
struct FastDiv {
  int d;
  unsigned mul, shr;
};

FastDiv fast_div(int d) {
  FastDiv f{d, 0u, 0u};
  if (d != 1) {
    int log2 = 0;
    while ((1ll << log2) < d) ++log2;          // ceil(log2 d)
    const int p = 31 + log2;
    f.mul = static_cast<unsigned>(((1ull << p) + d - 1) / d);
    f.shr = static_cast<unsigned>(p - 32);
  }
  return f;
}

__device__ __forceinline__ int quot(const FastDiv& f, int x) {
  return f.mul == 0 ? x : static_cast<int>(__umulhi(x, f.mul) >> f.shr);
}

struct Geometry {
  FastDiv row_len;                     // L = w * C
  FastDiv h;                           // rows of the window
  FastDiv C;
  int H, W, y0, x0;
  int G;                               // rows a segment
  int64_t rows;                        // B * h
  int64_t segments;                    // ceil(rows / G)
};

// The first window byte of row i of the segment whose first row is (b, y).
__device__ __forceinline__ const uint8_t* row_src(const uint8_t* images,
                                                  const Geometry& g,
                                                  int64_t b, int y, int i) {
  const int t = y + i;
  const int db = quot(g.h, t);
  return images + (((b + db) * g.H + g.y0 + (t - db * g.h.d)) * g.W + g.x0) *
                      static_cast<int64_t>(g.C.d);
}

template <bool kTable>
__device__ __forceinline__ float normalize(int v, int c, const float* s_tab,
                                           const float* s_mean,
                                           const float* s_std) {
  if (kTable) return s_tab[c * kStride + v];
  return (static_cast<float>(v) / 255.0f - s_mean[c]) / s_std[c];
}

template <bool kTable>
__global__ void __launch_bounds__(kThreads)
fused_preprocess_kernel(const uint8_t* __restrict__ images,
                        float* __restrict__ out, Channels ch, Geometry g) {
  __shared__ float s_tab[kTable ? kTableC * kStride : 1];
  __shared__ float s_mean[kTable ? 1 : kMaxC];
  __shared__ float s_std[kTable ? 1 : kMaxC];
  const int C = g.C.d, L = g.row_len.d, h = g.h.d;
  if (kTable) {
    for (int i = threadIdx.x; i < 256 * C; i += kThreads) {
      const int c = i >> 8;
      const float v = static_cast<float>(i & 255) / 255.0f;
      s_tab[c * kStride + (i & 255)] = (v - ch.mean[c]) / ch.std[c];
    }
  } else if (threadIdx.x < C) {
    s_mean[threadIdx.x] = ch.mean[threadIdx.x];
    s_std[threadIdx.x] = ch.std[threadIdx.x];
  }
  __syncthreads();
  // this block's segments: blockIdx.x, then every gridDim.x; the first row
  // of each as (b, y), advanced by `step` rows
  const int64_t first = static_cast<int64_t>(blockIdx.x) * g.G;
  int64_t b = first / h;
  int y = static_cast<int>(first - b * h);
  const int step = gridDim.x * g.G;
  const int db = step / h, dy = step - db * h;
  for (int64_t s = blockIdx.x; s < g.segments; s += gridDim.x) {
    const int64_t r0 = s * g.G;
    const int n = static_cast<int>(g.rows - r0 < g.G ? g.rows - r0 : g.G) * L;
    float* seg_out = out + r0 * L;
    for (int pass = 0; pass < n; pass += kSegment) {
      // every quad's words first: lo holds its first byte, hi the rest
      uint32_t lo[kQuads], hi[kQuads];
      int shift[kQuads], col[kQuads];
#pragma unroll
      for (int u = 0; u < kQuads; ++u) {
        const int o = pass + 4 * (threadIdx.x + u * kThreads);
        const int i = quot(g.row_len, o);
        col[u] = o - i * L;
        lo[u] = hi[u] = 0u;
        shift[u] = 0;
        if (o + 4 <= n && col[u] + 4 <= L) {
          const uintptr_t addr = reinterpret_cast<uintptr_t>(
              row_src(images, g, b, y, i) + col[u]);
          const uint32_t* word = reinterpret_cast<const uint32_t*>(addr & ~3);
          shift[u] = 8 * static_cast<int>(addr & 3);
          lo[u] = __ldg(word);
          if (shift[u] != 0) hi[u] = __ldg(word + 1);
        }
      }
#pragma unroll
      for (int u = 0; u < kQuads; ++u) {
        const int o = pass + 4 * (threadIdx.x + u * kThreads);
        if (o >= n) continue;
        float v[4];
        if (o + 4 <= n && col[u] + 4 <= L) {
          const uint32_t q = __funnelshift_r(lo[u], hi[u], shift[u]);
          int c = col[u] - quot(g.C, col[u]) * C;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            v[j] = normalize<kTable>((q >> (8 * j)) & 0xff, c, s_tab, s_mean,
                                     s_std);
            c = c + 1 == C ? 0 : c + 1;
          }
        } else {                       // across a row's end, or the last quad
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            v[j] = 0.0f;
            if (o + j < n) {
              const int i = quot(g.row_len, o + j);
              const int cj = o + j - i * L;
              v[j] = normalize<kTable>(
                  __ldg(row_src(images, g, b, y, i) + cj),
                  cj - quot(g.C, cj) * C, s_tab, s_mean, s_std);
            }
          }
        }
        if (o + 4 <= n) {
          *reinterpret_cast<float4*>(seg_out + o) =
              make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 3; ++j)
            if (o + j < n) seg_out[o + j] = v[j];
        }
      }
    }
    b += db;
    y += dy;
    if (y >= h) {
      y -= h;
      ++b;
    }
  }
}

// Blocks that stay resident on the current device: its SMs times the blocks
// of the kernel an SM holds; asked once a device.
template <bool kTable>
int resident_blocks() {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return 0;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, fused_preprocess_kernel<kTable>, kThreads, 0) !=
            cudaSuccess)
      return 0;
    cached[dev] = sms * per_sm;
  }
  return cached[dev];
}

template <bool kTable>
int launch(const uint8_t* images, float* out, const Channels& ch,
           const Geometry& g, cudaStream_t stream) {
  const int resident = resident_blocks<kTable>();
  if (resident == 0) {
    const cudaError_t err = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err : cudaErrorUnknown);
  }
  const int blocks = static_cast<int>(
      g.segments < resident ? g.segments : static_cast<int64_t>(resident));
  fused_preprocess_kernel<kTable><<<blocks, kThreads, 0, stream>>>(
      images, out, ch, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  The caller has
// checked the window, C <= kMaxC, w*C and h below 2^29, a non-empty output
// and a 16-byte aligned `out`.
extern "C" int fused_preprocess_launch(const void* images, void* out,
                                       const float* mean, const float* std,
                                       int B, int H, int W, int C, int y0,
                                       int x0, int h, int w, void* stream) {
  Channels ch;
  for (int c = 0; c < C; ++c) {
    ch.mean[c] = mean[c];
    ch.std[c] = std[c];
  }
  const int L = w * C;
  // G rows a segment: about kSegment elements, G * L a multiple of 4
  const int align = L % 4 == 0 ? 1 : L % 2 == 0 ? 2 : 4;
  const int G = L >= kSegment / align ? align : kSegment / L / align * align;
  Geometry g{fast_div(L), fast_div(h), fast_div(C), H, W, y0, x0, G,
             static_cast<int64_t>(B) * h, 0};
  g.segments = (g.rows + G - 1) / G;
  const auto* src = static_cast<const uint8_t*>(images);
  auto* dst = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  return C <= kTableC ? launch<true>(src, dst, ch, g, s)
                      : launch<false>(src, dst, ch, g, s);
}
