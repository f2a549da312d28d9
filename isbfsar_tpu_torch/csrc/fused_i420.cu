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
// 23.6 us at 3.35 TB/s. It does a few operations per byte. The BGR frame is
// three quarters of those bytes, so the design is about writing it at full
// rate and decoding every source pixel once.
//
// Design: the work items are (frame, band of G consecutive YOLO output rows).
// A host-side plan (ops/fused_input.py::band_plan) gives each band
//   load [lo, hi): the source rows its outputs' INTER_AREA taps touch, and
//   own  [lo, hi): the source rows whose BGR output it writes; the own
//                  ranges of a frame's bands tile [0, H) exactly once.
// The kernel is persistent: a block walks over the items with a stride of
// the grid. For each item one thread brings the band's Y rows and the
// matching U and V rows into shared memory with three 1-D bulk copies
// (cp.async.bulk, the TMA's non-tensor form; each plane's rows are
// contiguous) that complete on an mbarrier, and it issues the next item's
// copies into a second buffer before the block works on this one, so the
// loads overlap the work. The block decodes each loaded pixel once, four
// pixels a thread, into shared float32 BGR with 16-byte vector stores;
// one thread then writes the item's own rows to the BGR output with one
// bulk store (cp.async.bulk shared -> global; the rows are contiguous in
// shared memory and in the output), which runs while the block computes
// its YOLO outputs from shared memory, writing the planes coalesced along
// a row. Arithmetic uses round-to-nearest
// intrinsics, so nvcc's FMA contraction cannot move the decode away from
// the plain PyTorch version, and each output sums its taps rows first,
// then columns, as the first version of this kernel did.
//
// Tensor cores (wgmma) do not fit: an output takes at most kr * kc = 9
// multiply-adds per channel, parity with the plain version is held in full
// float32, and the bound is bytes, not operations.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kHeaderBytes = 32;  // two mbarriers, padded so what follows stays 16-byte aligned

__device__ __forceinline__ float clip255(float v) { return fminf(fmaxf(v, 0.0f), 255.0f); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :
      : "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Waits for the completion of the mbarrier's phase of parity `parity`. A
// copy that never lands (a plan that asks for more bytes than it loads)
// traps after 2^22 polls instead of hanging the card.
__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 22)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

struct Geometry {
  int H, W, S, G, n_bands, total, rows, crows, raw_bytes;
};

// One thread: the bulk copies of item `item`'s Y, U and V rows into `raw`.
__device__ __forceinline__ void load_item(const uint8_t* yuv, const int* plan, const Geometry& g,
                                          int item, uint8_t* raw, uint32_t bar) {
  const int n = item / g.n_bands, band = item - n * g.n_bands;
  const int load_lo = plan[band * 4 + 0], load_hi = plan[band * 4 + 1];
  const int c_lo = load_lo >> 1, c_rows = ((load_hi - 1) >> 1) - c_lo + 1;
  const int half_w = g.W >> 1, y_bytes = (load_hi - load_lo) * g.W, c_bytes = c_rows * half_w;
  const size_t hw = static_cast<size_t>(g.H) * g.W;
  const uint8_t* src = yuv + static_cast<size_t>(n) * (hw + (hw >> 1));
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // after the block's reads of raw
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(y_bytes + 2 * c_bytes)
               : "memory");
  bulk_load(raw, src + static_cast<size_t>(load_lo) * g.W, y_bytes, bar);
  bulk_load(raw + g.rows * g.W, src + hw + static_cast<size_t>(c_lo) * half_w, c_bytes, bar);
  bulk_load(raw + g.rows * g.W + g.crows * half_w,
            src + hw + (hw >> 2) + static_cast<size_t>(c_lo) * half_w, c_bytes, bar);
}

__global__ void __launch_bounds__(kThreads)
    fused_i420_kernel(const uint8_t* __restrict__ yuv, float* __restrict__ bgr,
                      float* __restrict__ yolo, Geometry g, const int* __restrict__ row_lo,
                      const float* __restrict__ row_w, int kr, const int* __restrict__ col_lo,
                      const float* __restrict__ col_w, int kc, const int* __restrict__ plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* frame = reinterpret_cast<float*>(smem + kHeaderBytes);  // (rows, W, 3) BGR
  // two raw buffers, each (rows, W) of Y, then (crows, W/2) of U and of V; buffer b
  // is at raw0 + b * raw_bytes and completes on the mbarrier at bar0 + 8 b
  uint8_t* raw0 = smem + kHeaderBytes + static_cast<size_t>(g.rows) * g.W * 12;
  const uint32_t bar0 = smem_addr(bars);
  const int tid = threadIdx.x, W = g.W, S = g.S, half_w = W >> 1, quads = W >> 2;

  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar0) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar0 + 8) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && static_cast<int>(blockIdx.x) < g.total)
    load_item(yuv, plan, g, blockIdx.x, raw0, bar0);

  int k = 0;
  for (int item = blockIdx.x; item < g.total; item += gridDim.x, ++k) {
    const int buf = k & 1, next = item + gridDim.x;
    // the other buffer was last read by the previous item's decode, before its barrier
    if (tid == 0 && next < g.total)
      load_item(yuv, plan, g, next, raw0 + (buf ^ 1) * g.raw_bytes, bar0 + 8 * (buf ^ 1));
    const int n = item / g.n_bands, band = item - n * g.n_bands;
    const int load_lo = plan[band * 4 + 0], load_hi = plan[band * 4 + 1];
    const int own_lo = plan[band * 4 + 2], own_hi = plan[band * 4 + 3];
    const int c_lo = load_lo >> 1;
    const uint8_t* raw_y = raw0 + buf * g.raw_bytes;
    const uint8_t* raw_u = raw_y + g.rows * W;
    const uint8_t* raw_v = raw_u + g.crows * half_w;
    wait_phase(bar0 + 8 * buf, (k >> 1) & 1);

    // decode each loaded pixel once, four a thread: one 4-byte Y load, two
    // 2-byte chroma loads, three 16-byte shared stores
    for (int q = tid; q < (load_hi - load_lo) * quads; q += kThreads) {
      const int r = q / quads, x4 = q - r * quads;
      const int c = (((load_lo + r) >> 1) - c_lo) * half_w + 2 * x4;
      const uint32_t y4 = *reinterpret_cast<const uint32_t*>(raw_y + static_cast<size_t>(q) * 4);
      float out[12];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float yy = __fmul_rn(static_cast<float>((y4 >> (8 * e)) & 0xff) - 16.0f, 1.164f);
        const float u = static_cast<float>(raw_u[c + (e >> 1)]) - 128.0f;
        const float v = static_cast<float>(raw_v[c + (e >> 1)]) - 128.0f;
        out[3 * e + 0] = clip255(__fadd_rn(yy, __fmul_rn(2.018f, u)));
        out[3 * e + 1] =
            clip255(__fsub_rn(__fsub_rn(yy, __fmul_rn(0.391f, u)), __fmul_rn(0.813f, v)));
        out[3 * e + 2] = clip255(__fadd_rn(yy, __fmul_rn(1.596f, v)));
      }
      float4* dst = reinterpret_cast<float4*>(frame + static_cast<size_t>(q) * 12);
      dst[0] = make_float4(out[0], out[1], out[2], out[3]);
      dst[1] = make_float4(out[4], out[5], out[6], out[7]);
      dst[2] = make_float4(out[8], out[9], out[10], out[11]);
    }
    // the decoded rows go to the async proxy (the bulk store) as well
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // the rows this item owns, contiguous in shared memory and in bgr: one
    // bulk store, which runs while the block computes its YOLO outputs
    if (tid == 0 && own_hi > own_lo) {
      const float* from = frame + static_cast<size_t>(own_lo - load_lo) * W * 3;
      float* to = bgr + (static_cast<size_t>(n) * g.H + own_lo) * static_cast<size_t>(W) * 3;
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(to),
                   "r"(smem_addr(from)), "r"((own_hi - own_lo) * W * 12)
                   : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }

    // yolo[c][i0 + i][j] = sum_t wc[j, t] * (sum_s wr[i, s] * frame[row_lo[i] + s][col_lo[j] + t]) / 255
    const int i0 = band * g.G, g_rows = min(g.G, S - i0);
    const size_t plane = static_cast<size_t>(S) * S;
    float* out = yolo + static_cast<size_t>(n) * 3 * plane + static_cast<size_t>(i0) * S;
    for (int p = tid; p < g_rows * S; p += kThreads) {
      const int i = p / S, j = p - i * S;
      const int base = row_lo[i0 + i] - load_lo, x0 = col_lo[j];
      float acc_b = 0.0f, acc_g = 0.0f, acc_r = 0.0f;
      for (int t = 0; t < kc; ++t) {
        float sb = 0.0f, sg = 0.0f, sr = 0.0f;
        for (int s = 0; s < kr; ++s) {
          const float wr = row_w[(i0 + i) * kr + s];
          const float* px = frame + (static_cast<size_t>(base + s) * W + x0 + t) * 3;
          sb = __fadd_rn(sb, __fmul_rn(wr, px[0]));
          sg = __fadd_rn(sg, __fmul_rn(wr, px[1]));
          sr = __fadd_rn(sr, __fmul_rn(wr, px[2]));
        }
        const float wc = col_w[j * kc + t];
        acc_b = __fadd_rn(acc_b, __fmul_rn(sb, wc));
        acc_g = __fadd_rn(acc_g, __fmul_rn(sg, wc));
        acc_r = __fadd_rn(acc_r, __fmul_rn(sr, wc));
      }
      out[p] = __fdiv_rn(acc_r, 255.0f);
      out[plane + p] = __fdiv_rn(acc_g, 255.0f);
      out[2 * plane + p] = __fdiv_rn(acc_b, 255.0f);
    }
    // the next item's decode overwrites frame: the bulk store must have read it
    if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    __syncthreads();
  }
  // the block's last bulk store must finish before the kernel completes
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace

// Raises the kernel's dynamic shared memory limit to `bytes`. Call once,
// before any launch and outside a CUDA graph capture. Returns the CUDA error.
extern "C" int fused_i420_init(int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      fused_i420_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// C entry point, loaded with ctypes. Pointers are device pointers; `plan` is
// (n_bands, 4) int32 as band_plan gives it, `raw_bytes` one buffer of raw
// rows and `grid` the number of persistent blocks. The launch goes on
// `stream` and does not synchronise. Returns cudaGetLastError().
extern "C" int fused_i420_inputs(const void* yuv, void* bgr, void* yolo, int B, int H, int W,
                                 int S, int G, int n_bands, int rows, int crows, int raw_bytes,
                                 int smem_bytes, int grid, const void* row_lo, const void* row_w,
                                 int kr, const void* col_lo, const void* col_w, int kc,
                                 const void* plan, void* stream) {
  const Geometry g{H, W, S, G, n_bands, B * n_bands, rows, crows, raw_bytes};
  fused_i420_kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(yuv), static_cast<float*>(bgr), static_cast<float*>(yolo), g,
      static_cast<const int*>(row_lo), static_cast<const float*>(row_w), kr,
      static_cast<const int*>(col_lo), static_cast<const float*>(col_w), kc,
      static_cast<const int*>(plan));
  return static_cast<int>(cudaGetLastError());
}
