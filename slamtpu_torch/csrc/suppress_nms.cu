// Occupancy suppression + 3x3 NMS + threshold of a Shi-Tomasi response map.
//
// Replaces the TPU kernel slamtpu/ops/detect_pallas.py::_detect_kernel
// (launched by suppress_and_nms). In order, as there:
//   1. rasterize occupancy at the valid points, x-dilated to [x - r, x + r];
//   2. y-dilate it over [y - r, y + r], completing the exact (2r+1)^2
//      Chebyshev square, and zero the response inside it — suppression
//      comes BEFORE NMS (suppressing after NMS leaves maxima next to tracked
//      points and measurably hurt trajectory accuracy in the JAX package);
//   3. 3x3 NMS with -inf outside the image, keeping resp >= pooled (ties
//      survive), then keep values > min_response.
// Only max and compare are used, so the result is bit-exact with the plain
// PyTorch version in slamtpu_torch/ops/detect_suppress.py.
//
// What bounds it on the H100: bytes and launches. At 376 x 1241 the map is
// 1.9 MB of float32; pass 2 reads 2r+1 = 35 occupancy bytes per pixel, but
// neighbouring threads share them through L1/L2, so each pass is a few
// microseconds of traffic. Three launches on one stream (the TPU kernel's
// single VMEM-resident pass has no counterpart without a shared-memory
// tile with dilation + NMS halos, which is later work).
//
// Design: pass 1 is one thread per point and writes only 1s, so the
// overlapping stores of neighbouring points need no atomics. Passes 2 and 3
// are one thread per pixel, x fastest, so rows are read coalesced.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__global__ void rasterize_kernel(const int32_t* __restrict__ yx,
                                 const uint8_t* __restrict__ valid,
                                 uint8_t* __restrict__ occ, int N, int H,
                                 int W, int r) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N || !valid[i]) return;
  const int y = yx[2 * i];
  const int x = yx[2 * i + 1];
  if (y < 0 || y >= H || x < 0 || x >= W) return;
  const int lo = max(x - r, 0);
  const int hi = min(x + r, W - 1);
  uint8_t* row = occ + static_cast<int64_t>(y) * W;
  for (int xx = lo; xx <= hi; ++xx) row[xx] = 1;
}

__global__ void dilate_suppress_kernel(const float* __restrict__ resp,
                                       const uint8_t* __restrict__ occ,
                                       float* __restrict__ sup, int H, int W,
                                       int r) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= W) return;
  const int lo = max(y - r, 0);
  const int hi = min(y + r, H - 1);
  bool hit = false;
  for (int yy = lo; yy <= hi && !hit; ++yy) {
    hit = occ[static_cast<int64_t>(yy) * W + x] != 0;
  }
  const int64_t p = static_cast<int64_t>(y) * W + x;
  sup[p] = hit ? 0.0f : resp[p];
}

__global__ void nms_kernel(const float* __restrict__ sup,
                           float* __restrict__ out, int H, int W,
                           float min_response) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= W) return;
  const int64_t p = static_cast<int64_t>(y) * W + x;
  const float v = sup[p];
  float pooled = -INFINITY;
  for (int dy = -1; dy <= 1; ++dy) {
    const int yy = y + dy;
    if (yy < 0 || yy >= H) continue;
    for (int dx = -1; dx <= 1; ++dx) {
      const int xx = x + dx;
      if (xx < 0 || xx >= W) continue;
      pooled = fmaxf(pooled, sup[static_cast<int64_t>(yy) * W + xx]);
    }
  }
  out[p] = (v >= pooled && v > min_response) ? v : 0.0f;
}

}  // namespace

// occ: zero-filled (H, W) uint8 scratch; sup: (H, W) float32 scratch.
extern "C" int slamtpu_suppress_nms(const float* resp, const int32_t* yx,
                                    const uint8_t* valid, uint8_t* occ,
                                    float* sup, float* out, int H, int W,
                                    int N, int radius, float min_response,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N > 0) {
    rasterize_kernel<<<(N + 127) / 128, 128, 0, s>>>(yx, valid, occ, N, H, W,
                                                      radius);
  }
  const dim3 grid((W + 127) / 128, H);
  dilate_suppress_kernel<<<grid, 128, 0, s>>>(resp, occ, sup, H, W, radius);
  nms_kernel<<<grid, 128, 0, s>>>(sup, out, H, W, min_response);
  return static_cast<int>(cudaGetLastError());
}
