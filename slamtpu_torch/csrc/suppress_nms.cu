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
// Only max, compare and integer bit masks are used, so the result is
// bit-exact with the plain PyTorch version in
// slamtpu_torch/ops/detect_suppress.py.
//
// What bounds it on the H100: bytes. At 376 x 1241 the map is 1.87 MB of
// float32 read once and 1.87 MB written once (plus 9 bytes a point):
// ~1.1 us at 3.35 TB/s, so the launch floor (scripts/k2_anatomy.py times a
// one-element add beside it) is most of the time a call can reach. The
// earlier one-pass design took ~13x the bound because each block ran one
// serial chain: the halo tile's DRAM round trip, then the point scan (a
// `valid` load and, behind a branch on it, the `yx` loads: up to 8
// dependent L2 round trips a thread, one shared atomic a hit), then each
// pixel walking the hit list until a square covered it (~13 dependent
// shared loads a pixel at r = 17), then NMS.
//
// Design, one block per TH x TW output tile, each part against that chain:
//   - The halo'd tile ((TH+2) x (TW+2), -inf outside the image) goes to
//     shared memory by cp.async, issued first; the block waits for it only
//     after the point scan, so the two memory round trips overlap. Four
//     bytes a copy: TMA (and 16-byte copies) need 16-byte aligned rows,
//     and a 1241-float row pitch (4964 bytes) is not.
//   - The scan issues every load a thread needs for its chunk up front
//     (`yx` as int2, `valid` as bytes), with no load behind a branch on
//     another. Hits are compacted with __ballot_sync / __popc and one
//     shared atomicAdd a warp. Any N is taken in chunks of THREADS x 4
//     points, the hit list's size.
//   - Suppression is by rows: each square is the column interval
//     [x-r, x+r] on the rows [y-r, y+r], so the block keeps a bit mask of
//     the halo'd tile's columns for each halo row (ceil((TW+2)/32) words),
//     and each (hit, row) pair, one a thread, ORs its clipped column range
//     in with one predicated atomicOr a word. Work is O(hits x rows), integer
//     only; a pixel's test is one bit. Squares are clipped to the image,
//     so no bit is set outside it.
//   - NMS is separable and sliding: each thread owns one column and
//     TH / (THREADS / TW) consecutive rows, takes the max of 3 suppressed
//     values along each halo row it passes, and the max of the last three
//     row maxima (fmaxf is exact, so the order does not change a bit).
//     Stores are coalesced along the row.
//   - Tile shape: 16 x 128 with 256 threads, 24 x 10 = 240 blocks at
//     376 x 1241, two resident on most SMs, one wave (chosen over 32 x 128
//     with 512 threads, 120 blocks, and 8 x 128 with 128 threads, 470
//     blocks, on their device times; PERF.md section 6).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TH = 16;         // output tile rows
constexpr int TW = 128;        // output tile columns
constexpr int THREADS = 256;
constexpr int kPointsPerThread = 4;

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__global__ void __launch_bounds__(THREADS)
suppress_nms_kernel(const float* __restrict__ resp,
                    const int32_t* __restrict__ yx,
                    const uint8_t* __restrict__ valid,
                    float* __restrict__ out, int H, int W, int N, int r,
                    float min_response, bool yx_int2) {
  constexpr int kRows = TH + 2;
  constexpr int kCols = TW + 2;
  constexpr int kWords = (kCols + 31) / 32;
  constexpr int kChunk = THREADS * kPointsPerThread;
  constexpr int kSplit = THREADS / TW;   // threads a column
  constexpr int kRun = TH / kSplit;      // output rows a thread
  static_assert(THREADS % TW == 0 && TH % kSplit == 0 && TW % 32 == 0,
                "tile shape");
  __shared__ float tile[kRows][kCols];
  __shared__ uint32_t sup[kRows][kWords];
  __shared__ int2 hits[kChunk];
  __shared__ int n_hits;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int ty0 = blockIdx.y * TH;
  const int tx0 = blockIdx.x * TW;
  // The halo'd tile covers rows [ylo, yhi] and columns [xlo, xhi]; its
  // in-image part rows [cy0, cy1] and columns [cx0, cx1].
  const int ylo = ty0 - 1, yhi = ty0 + TH;
  const int xlo = tx0 - 1, xhi = tx0 + TW;
  const int cy0 = max(ylo, 0), cy1 = min(yhi, H - 1);
  const int cx0 = max(xlo, 0), cx1 = min(xhi, W - 1);

  // 1. The halo'd tile, in flight through the scan.
  for (int k = tid; k < kRows * kCols; k += THREADS) {
    const int ly = k / kCols;
    const int lx = k - ly * kCols;
    const int y = ylo + ly, x = xlo + lx;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      cp_async4(&tile[ly][lx], resp + static_cast<int64_t>(y) * W + x);
    } else {
      tile[ly][lx] = -INFINITY;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int k = tid; k < kRows * kWords; k += THREADS) {
    (&sup[0][0])[k] = 0u;
  }

  // 2. Scan and row masks, one chunk of points at a time.
  for (int c0 = 0; c0 < N; c0 += kChunk) {
    if (tid == 0) n_hits = 0;
    int2 p[kPointsPerThread];
    uint8_t v[kPointsPerThread];
#pragma unroll
    for (int j = 0; j < kPointsPerThread; ++j) {
      const int i = c0 + j * THREADS + tid;
      p[j] = make_int2(0, 0);
      v[j] = 0;
      if (i < N) {
        v[j] = valid[i];
        p[j] = yx_int2 ? reinterpret_cast<const int2*>(yx)[i]
                       : make_int2(yx[2 * i], yx[2 * i + 1]);
      }
    }
    __syncthreads();  // n_hits reset, masks zeroed
    uint32_t m[kPointsPerThread];
    int count = 0;
#pragma unroll
    for (int j = 0; j < kPointsPerThread; ++j) {
      const int y = p[j].x, x = p[j].y;
      const bool hit = v[j] && y >= 0 && y < H && x >= 0 && x < W &&
                       y + r >= ylo && y - r <= yhi && x + r >= xlo &&
                       x - r <= xhi;
      m[j] = __ballot_sync(0xffffffffu, hit);
      count += __popc(m[j]);
    }
    int base = 0;
    if (lane == 0 && count > 0) base = atomicAdd(&n_hits, count);
    base = __shfl_sync(0xffffffffu, base, 0);
    const uint32_t below = (1u << lane) - 1u;
#pragma unroll
    for (int j = 0; j < kPointsPerThread; ++j) {
      if ((m[j] >> lane) & 1u) hits[base + __popc(m[j] & below)] = p[j];
      base += __popc(m[j]);
    }
    __syncthreads();
    // One (hit, halo row) pair a thread: OR the square's clipped column
    // range [x0, x1] into the row's mask, a predicated atomicOr for each of
    // the row's words that the range meets. A loop over just those words,
    // from x0 / 32 to x1 / 32, came out of ptxas 12.9 with W un-negated in
    // the three-input max (VIMNMX3) it built for x1, so the masks of its
    // rolled iterations were 0 and whole squares went unsuppressed; this
    // fixed, unrolled loop compiles right (the every-radius card test).
    const int pairs = n_hits * kRows;
    for (int q = tid; q < pairs; q += THREADS) {
      const int h = q / kRows;
      const int ly = q - h * kRows;
      const int y = ylo + ly;
      const int2 pt = hits[h];  // (y, x)
      if (y < cy0 || y > cy1 || abs(y - pt.x) > r) continue;
      const int x0 = max(pt.y - r, cx0) - xlo;
      const int x1 = min(pt.y + r, cx1) - xlo;
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        const int lo = max(x0 - 32 * w, 0);
        const int hi = min(x1 - 32 * w, 31);
        if (lo <= hi) {
          atomicOr(&sup[ly][w], (0xffffffffu >> (31 - hi)) & (~0u << lo));
        }
      }
    }
    __syncthreads();  // before the next chunk resets n_hits
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // 3. Sliding separable NMS and the threshold.
  const int lx = tid % TW;
  const int g = tid / TW;
  const int x = tx0 + lx;
  auto value = [&](int ly, int cx) -> float {
    return ((sup[ly][cx >> 5] >> (cx & 31)) & 1u) ? 0.0f : tile[ly][cx];
  };
  auto row_max = [&](int ly, float* mid) -> float {
    const float a = value(ly, lx), b = value(ly, lx + 1),
                c = value(ly, lx + 2);
    *mid = b;
    return fmaxf(fmaxf(a, b), c);
  };
  const int ly0 = g * kRun;  // halo row above this thread's first row
  float mid1, mid2;
  float m0 = row_max(ly0, &mid1);
  float m1 = row_max(ly0 + 1, &mid1);
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    const float m2 = row_max(ly0 + k + 2, &mid2);
    const float pooled = fmaxf(fmaxf(m0, m1), m2);
    const float v = mid1;
    const int y = ty0 + ly0 + k;
    if (y < H && x < W) {
      out[static_cast<int64_t>(y) * W + x] =
          (v >= pooled && v > min_response) ? v : 0.0f;
    }
    m0 = m1;
    m1 = m2;
    mid1 = mid2;
  }
}

}  // namespace

extern "C" int slamtpu_suppress_nms(const float* resp, const int32_t* yx,
                                    const uint8_t* valid, float* out, int H,
                                    int W, int N, int radius,
                                    float min_response, void* stream) {
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  const bool yx_int2 = (reinterpret_cast<uintptr_t>(yx) & 7u) == 0;
  suppress_nms_kernel<<<grid, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      resp, yx, valid, out, H, W, N, radius, min_response, yx_int2);
  return static_cast<int>(cudaGetLastError());
}
