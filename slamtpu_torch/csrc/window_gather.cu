// Per-point window gather: out[i, c, y, x] = src[c, y0_i + y, x0_i + x].
//
// Replaces the TPU kernel slamtpu/ops/dma_gather.py::_span_kernel (launched
// by dma_span_gather, finished by extract_windows[_mxu]). On the TPU the
// gather DMAs 256-lane spans aligned to the 128-lane tiling and extracts the
// window at the lane remainder in a second pass; that split exists only for
// the TPU's lane alignment and is not carried over.
//
// What bounds it on the H100: bytes. At the LK main path's shapes (the
// level-0 6-map stack, T = 19, N = 1024: 8.9 MB out; the image patches,
// P = 32, N = 1024: 4.2 MB) the kernel reads and writes a few MB, so it is a
// few microseconds of HBM time at 3.35 TB/s plus the launch. The windows of
// nearby points overlap, so most reads hit L2.
//
// Design: one block per point; the block's threads stride over the
// C * t1 * t2 window elements in output order, so consecutive threads read
// consecutive x of one source row (coalesced within a row) and write
// consecutive output addresses. Starts are clamped like lax.dynamic_slice
// on non-negative starts: into [0, H - t1] x [0, W - t2] (the wrapper
// rejects negative starts). cp.async / TMA staging is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void window_gather_kernel(const float* __restrict__ src,
                                     const int32_t* __restrict__ start,
                                     float* __restrict__ out,
                                     int C, int H, int W, int t1, int t2) {
  const int i = blockIdx.x;
  int y0 = start[2 * i];
  int x0 = start[2 * i + 1];
  y0 = min(max(y0, 0), H - t1);
  x0 = min(max(x0, 0), W - t2);
  const int win = t1 * t2;
  const int total = C * win;
  float* dst = out + static_cast<int64_t>(i) * total;
  for (int k = threadIdx.x; k < total; k += blockDim.x) {
    const int c = k / win;
    const int r = k - c * win;
    const int y = r / t2;
    const int x = r - y * t2;
    dst[k] = src[(static_cast<int64_t>(c) * H + y0 + y) * W + x0 + x];
  }
}

}  // namespace

extern "C" int slamtpu_window_gather(const float* src, const int32_t* start,
                                     float* out, int C, int H, int W, int N,
                                     int t1, int t2, void* stream) {
  window_gather_kernel<<<N, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      src, start, out, C, H, W, t1, t2);
  return static_cast<int>(cudaGetLastError());
}
