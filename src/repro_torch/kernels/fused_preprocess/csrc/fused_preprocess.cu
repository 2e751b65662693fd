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
// read and four written, against five operations, so the memory rate is the
// limit (at B=256 and a 224 x 224 x 3 window, 192.7 MB, about 0.058 ms at
// 3.35 TB/s).  What the design does:
//   * The TPU kernel slices the window out first (`lax.slice`) and runs one
//     grid step per image on the slice.  Here the window is read in place:
//     one block walks one output row (b, y) at a time, whose w*C bytes are
//     contiguous in the input from ((b*H + y0+y)*W + x0)*C on, so the
//     threads of a warp read consecutive bytes and write consecutive floats.
//   * Rows start at any byte offset (a centre crop of 224 from 250 starts at
//     13*3 = 39 bytes into a row), so the kernel reads single bytes and uses
//     no vector loads.
//   * mean and std come by value, up to kMaxC channels, and are staged in
//     shared memory: the C distinct values a warp asks for are broadcast.
//   * Offsets are 64-bit: B*H*W*C passes 2^31 at 16384 images of 250 x 250
//     x 3.  A row's length w*C is below 2^31 (the wrapper checks).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 64;
constexpr int64_t kMaxBlocks = 1 << 20;   // rows beyond this loop in a block

struct Channels {
  float mean[kMaxC];
  float std[kMaxC];
};

__global__ void __launch_bounds__(kThreads)
fused_preprocess_kernel(const uint8_t* __restrict__ images,
                        float* __restrict__ out, Channels ch, int64_t rows,
                        int H, int W, int C, int y0, int x0, int h, int w) {
  __shared__ float s_mean[kMaxC];
  __shared__ float s_std[kMaxC];
  if (threadIdx.x < C) {
    s_mean[threadIdx.x] = ch.mean[threadIdx.x];
    s_std[threadIdx.x] = ch.std[threadIdx.x];
  }
  __syncthreads();
  const int row_len = w * C;
  const int c_step = kThreads % C;     // channel advance of one stride
  const int c_first = threadIdx.x % C; // rows start on channel 0
  for (int64_t r = blockIdx.x; r < rows; r += gridDim.x) {
    const int64_t b = r / h;
    const int64_t y = r - b * h;
    const uint8_t* src = images + ((b * H + y0 + y) * W + x0) * C;
    float* dst = out + r * row_len;
    int c = c_first;
    for (int j = threadIdx.x; j < row_len; j += kThreads) {
      const float v = static_cast<float>(src[j]) / 255.0f;
      dst[j] = (v - s_mean[c]) / s_std[c];
      c += c_step;
      if (c >= C) c -= C;
    }
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  The caller has
// checked the window, C <= kMaxC and a non-empty output.
extern "C" int fused_preprocess_launch(const void* images, void* out,
                                       const float* mean, const float* std,
                                       int B, int H, int W, int C, int y0,
                                       int x0, int h, int w, void* stream) {
  Channels ch;
  for (int c = 0; c < C; ++c) {
    ch.mean[c] = mean[c];
    ch.std[c] = std[c];
  }
  const int64_t rows = static_cast<int64_t>(B) * h;
  const int blocks = static_cast<int>(rows < kMaxBlocks ? rows : kMaxBlocks);
  fused_preprocess_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(images), static_cast<float*>(out), ch, rows,
      H, W, C, y0, x0, h, w);
  return static_cast<int>(cudaGetLastError());
}
