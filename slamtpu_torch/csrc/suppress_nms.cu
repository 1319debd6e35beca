// Occupancy suppression + 3x3 NMS + threshold of a Shi-Tomasi response map,
// in one tiled pass.
//
// Replaces the TPU kernel slamtpu/ops/detect_pallas.py::_detect_kernel
// (launched by suppress_and_nms). In order, as there:
//   1. zero the response inside the (2r+1)^2 Chebyshev square (clipped to
//      the image) around every valid in-image point — suppression comes
//      BEFORE NMS (suppressing after NMS leaves maxima next to tracked
//      points and measurably hurt trajectory accuracy in the JAX package);
//   2. 3x3 NMS with -inf outside the image, keeping resp >= pooled (ties
//      survive), then keep values > min_response.
// Only max and compare are used, so the result is bit-exact with the plain
// PyTorch version in slamtpu_torch/ops/detect_suppress.py.
//
// What bounds it on the H100: bytes. At 376 x 1241 the map is 1.87 MB of
// float32 read once and 1.87 MB written once (plus 12 bytes a point):
// ~1.1 us at 3.35 TB/s, so one launch is most of its time.
//
// Design: one block per kTileH x kTileW output tile. The block loads its
// tile with a 1-pixel halo into shared memory (-inf outside the image),
// scans the N points (blockDim.x at a time) and compacts into shared memory
// those whose square meets the halo'd tile (at ~700 valid points on
// 376 x 1241 with r = 17, about a dozen a tile), zeroes every tile pixel
// that lies in one of their squares (each thread tests its pixels against
// the short list), then applies NMS and the threshold and writes the tile.
// No scratch map, no memset, no atomics outside shared memory. The hit list
// holds one chunk of kMaxHits points at a time, so any N is taken in
// chunks.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 16;
constexpr int kTileW = 128;
constexpr int kThreads = 256;
constexpr int kMaxHits = 1024;

__global__ void __launch_bounds__(kThreads)
suppress_nms_kernel(const float* __restrict__ resp,
                    const int32_t* __restrict__ yx,
                    const uint8_t* __restrict__ valid,
                    float* __restrict__ out, int H, int W, int N, int r,
                    float min_response) {
  __shared__ float tile[kTileH + 2][kTileW + 2];
  __shared__ int2 hits[kMaxHits];
  __shared__ int n_hits;

  const int ty0 = blockIdx.y * kTileH;
  const int tx0 = blockIdx.x * kTileW;
  // The halo'd tile covers rows [ylo, yhi] and columns [xlo, xhi].
  const int ylo = ty0 - 1, yhi = ty0 + kTileH;
  const int xlo = tx0 - 1, xhi = tx0 + kTileW;
  for (int k = threadIdx.x; k < (kTileH + 2) * (kTileW + 2);
       k += blockDim.x) {
    const int ly = k / (kTileW + 2);
    const int lx = k - ly * (kTileW + 2);
    const int y = ylo + ly, x = xlo + lx;
    tile[ly][lx] = (y >= 0 && y < H && x >= 0 && x < W)
                       ? resp[static_cast<int64_t>(y) * W + x]
                       : -INFINITY;
  }

  for (int c0 = 0; c0 < N; c0 += kMaxHits) {
    if (threadIdx.x == 0) n_hits = 0;
    __syncthreads();
    const int c1 = min(N, c0 + kMaxHits);
    for (int i = c0 + threadIdx.x; i < c1; i += blockDim.x) {
      if (!valid[i]) continue;
      const int y = yx[2 * i];
      const int x = yx[2 * i + 1];
      if (y < 0 || y >= H || x < 0 || x >= W) continue;
      if (y + r < ylo || y - r > yhi || x + r < xlo || x - r > xhi) continue;
      hits[atomicAdd(&n_hits, 1)] = make_int2(y, x);
    }
    __syncthreads();
    // Each thread zeroes the in-image pixels of its share of the halo'd
    // tile that lie in some hit's square (pixels outside the image stay
    // -inf).
    for (int k = threadIdx.x; k < (kTileH + 2) * (kTileW + 2);
         k += blockDim.x) {
      const int ly = k / (kTileW + 2);
      const int lx = k - ly * (kTileW + 2);
      const int y = ylo + ly, x = xlo + lx;
      if (y < 0 || y >= H || x < 0 || x >= W) continue;
      bool hit = false;
      for (int q = 0; q < n_hits && !hit; ++q) {
        const int2 p = hits[q];  // (y, x)
        hit = abs(y - p.x) <= r && abs(x - p.y) <= r;
      }
      if (hit) tile[ly][lx] = 0.0f;
    }
    __syncthreads();  // before the next chunk resets n_hits
  }
  __syncthreads();  // the tile loads, when there is no point

  for (int k = threadIdx.x; k < kTileH * kTileW; k += blockDim.x) {
    const int ly = k / kTileW;
    const int lx = k - ly * kTileW;
    const int y = ty0 + ly, x = tx0 + lx;
    if (y >= H || x >= W) continue;
    const float v = tile[ly + 1][lx + 1];
    float pooled = -INFINITY;
    for (int dy = 0; dy < 3; ++dy) {
      for (int dx = 0; dx < 3; ++dx) {
        pooled = fmaxf(pooled, tile[ly + dy][lx + dx]);
      }
    }
    out[static_cast<int64_t>(y) * W + x] =
        (v >= pooled && v > min_response) ? v : 0.0f;
  }
}

}  // namespace

extern "C" int slamtpu_suppress_nms(const float* resp, const int32_t* yx,
                                    const uint8_t* valid, float* out, int H,
                                    int W, int N, int radius,
                                    float min_response, void* stream) {
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH);
  suppress_nms_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      resp, yx, valid, out, H, W, N, radius, min_response);
  return static_cast<int>(cudaGetLastError());
}
