// Fused I420 input stage for Hopper (sm_90a): one pass over the camera bytes
// emits the full-resolution BGR float frame and the YOLO input.
//
// Replaces the TPU kernel isbfsar_tpu/ops/pallas_input.py::fused_i420_inputs
// (pallas_call at :118, body _kernel :49-95), with a batch dimension: the
// batched pipeline step feeds it B frames at once.
//
//   bgr  (B, H, W, 3) f32: studio-range BT.601, Y' = (Y - 16) * 1.164,
//        U, V minus 128 with a 2x nearest chroma upsample,
//        B = Y' + 2.018 U, G = Y' - 0.391 U - 0.813 V, R = Y' + 1.596 V,
//        clipped to [0, 255];
//   yolo (B, 3, S, S) f32, planes R, G, B: exact cv2 INTER_AREA resize
//        (wr . plane . wc^T) of the clipped BGR planes, divided by 255.
//
// Bound on this card: bytes. Per 480x640 frame with S = 256 it must read
// 1.5 H W = 460,800 B of u8 and write 12 H W = 3,686,400 B of BGR plus
// 12 S^2 = 786,432 B of YOLO input: 4.93 MB, so 78.9 MB for B = 16, about
// 23.6 us at 3.35 TB/s. It does a few operations per byte.
//
// Design: one launch whose blocks take one of two roles. BGR blocks give a
// thread to each pixel: it reads its Y byte and the (y/2, x/2) chroma bytes
// and writes three floats. YOLO blocks give a thread to each output pixel:
// INTER_AREA from 480 -> 256 rows and 640 -> 256 columns touches at most
// ceil(scale) + 1 source rows and columns, so the wrapper passes banded tables
// (a start index and kr / kc weights per output row / column) instead of the
// dense 480- and 640-long weight rows, and the thread decodes its few taps
// straight from the u8 bytes (re-reads hit L1/L2), so no f32 intermediate
// goes through device memory. Arithmetic uses round-to-nearest intrinsics
// so that nvcc's FMA contraction does not move the decode away from the
// plain PyTorch version; the tap sums run rows first, then columns, the
// contraction order of the plain version.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float clip255(float v) { return fminf(fmaxf(v, 0.0f), 255.0f); }

__device__ __forceinline__ void decode(const uint8_t* __restrict__ frame, int H, int W, int y,
                                       int x, float& b, float& g, float& r) {
  const int hw = H * W;
  const int c = (y >> 1) * (W >> 1) + (x >> 1);
  const float yy = __fmul_rn(static_cast<float>(frame[y * W + x]) - 16.0f, 1.164f);
  const float u = static_cast<float>(frame[hw + c]) - 128.0f;
  const float v = static_cast<float>(frame[hw + (hw >> 2) + c]) - 128.0f;
  r = clip255(__fadd_rn(yy, __fmul_rn(1.596f, v)));
  g = clip255(__fsub_rn(__fsub_rn(yy, __fmul_rn(0.391f, u)), __fmul_rn(0.813f, v)));
  b = clip255(__fadd_rn(yy, __fmul_rn(2.018f, u)));
}

__global__ void __launch_bounds__(kThreads)
    fused_i420_kernel(const uint8_t* __restrict__ yuv, float* __restrict__ bgr,
                      float* __restrict__ yolo, int B, int H, int W, int S,
                      const int* __restrict__ row_lo, const float* __restrict__ row_w, int kr,
                      const int* __restrict__ col_lo, const float* __restrict__ col_w, int kc,
                      int bgr_blocks) {
  const int frame_bytes = H * W + (H * W >> 1);
  if (static_cast<int>(blockIdx.x) < bgr_blocks) {
    const int p = blockIdx.x * kThreads + threadIdx.x;
    if (p >= B * H * W) return;
    const int n = p / (H * W);
    const int rem = p - n * H * W;
    const int y = rem / W;
    const int x = rem - y * W;
    float b, g, r;
    decode(yuv + static_cast<size_t>(n) * frame_bytes, H, W, y, x, b, g, r);
    float* out = bgr + static_cast<size_t>(p) * 3;
    out[0] = b;
    out[1] = g;
    out[2] = r;
    return;
  }
  const int q = (blockIdx.x - bgr_blocks) * kThreads + threadIdx.x;
  if (q >= B * S * S) return;
  const int n = q / (S * S);
  const int rem = q - n * S * S;
  const int i = rem / S;
  const int j = rem - i * S;
  const uint8_t* frame = yuv + static_cast<size_t>(n) * frame_bytes;
  float acc_b = 0.0f, acc_g = 0.0f, acc_r = 0.0f;
  for (int t = 0; t < kc; ++t) {
    const int x = col_lo[j] + t;
    const float wc = col_w[j * kc + t];
    float sb = 0.0f, sg = 0.0f, sr = 0.0f;
    for (int s = 0; s < kr; ++s) {
      const int y = row_lo[i] + s;
      const float wr = row_w[i * kr + s];
      float b, g, r;
      decode(frame, H, W, y, x, b, g, r);
      sb = __fadd_rn(sb, __fmul_rn(wr, b));
      sg = __fadd_rn(sg, __fmul_rn(wr, g));
      sr = __fadd_rn(sr, __fmul_rn(wr, r));
    }
    acc_b = __fadd_rn(acc_b, __fmul_rn(sb, wc));
    acc_g = __fadd_rn(acc_g, __fmul_rn(sg, wc));
    acc_r = __fadd_rn(acc_r, __fmul_rn(sr, wc));
  }
  const size_t plane = static_cast<size_t>(S) * S;
  float* out = yolo + static_cast<size_t>(n) * 3 * plane + static_cast<size_t>(i) * S + j;
  out[0] = __fdiv_rn(acc_r, 255.0f);
  out[plane] = __fdiv_rn(acc_g, 255.0f);
  out[2 * plane] = __fdiv_rn(acc_b, 255.0f);
}

}  // namespace

// C entry point, loaded with ctypes. Pointers are device pointers; the
// launch goes on `stream` and does not synchronise. Returns cudaGetLastError().
extern "C" int fused_i420_inputs(const void* yuv, void* bgr, void* yolo, int B, int H, int W,
                                 int S, const void* row_lo, const void* row_w, int kr,
                                 const void* col_lo, const void* col_w, int kc, void* stream) {
  const int bgr_blocks = (B * H * W + kThreads - 1) / kThreads;
  const int yolo_blocks = (B * S * S + kThreads - 1) / kThreads;
  fused_i420_kernel<<<bgr_blocks + yolo_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(yuv), static_cast<float*>(bgr), static_cast<float*>(yolo), B, H,
      W, S, static_cast<const int*>(row_lo), static_cast<const float*>(row_w), kr,
      static_cast<const int*>(col_lo), static_cast<const float*>(col_w), kc, bgr_blocks);
  return static_cast<int>(cudaGetLastError());
}
