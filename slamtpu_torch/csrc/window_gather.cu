// Per-point window gather: out[i, c, y, x] = src[c, y0_i + y, x0_i + x].
//
// Replaces the TPU kernel slamtpu/ops/dma_gather.py::_span_kernel (launched
// by dma_span_gather, finished by extract_windows[_mxu]). On the TPU the
// gather DMAs 256-lane spans aligned to the 128-lane tiling and extracts the
// window at the lane remainder in a second pass; that split exists only for
// the TPU's lane alignment and is not carried over.
//
// What bounds it on the H100: bytes. At the subpixel-refinement shape (3x3
// windows of a (1, 376, 1241) response, N = 3168) the function moves
// ~0.22 MB, 0.067 us at 3.35 TB/s, so the launch floor is what remains; at
// the LK shapes (C = 6, T = 19 and C = 1, P = 32, N = 1024) it writes
// 8.9 MB and 4.2 MB, a few microseconds.
//
// Design: one thread per output element over a flat grid of 256-thread
// blocks, in output order. The earlier one-block-per-point design kept 9 of
// 256 lanes busy at the subpixel shape and needed ~3 waves of 3,168 blocks;
// sized to the elements (28,512 threads, 112 blocks) the grid is one wave,
// and each thread's chain is its start load, its source load and its
// store. The element's point, channel, row and column come from
// multiply-high divisions by constants set at launch (FastDiv).
// Consecutive threads write consecutive addresses and read consecutive x
// of one source row; the threads of a warp that share a point read its
// start at one address, a broadcast. Starts are read as one
// int2 where the pointer allows and clamped into [0, H - t1] x
// [0, W - t2], a negative start to 0. A call of more than 2^31 - 1
// elements is refused (cudaErrorInvalidValue), not wrapped.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Division by a divisor fixed for the launch, as a multiply-high and a
// shift (the round-up method: exact for dividends in [0, 2^31)). The card
// has no divide instruction, and three software divisions an element made
// the flat grid ALU-bound at the LK shapes.
struct FastDiv {
  int d;
  unsigned mul;
  int shr;
};

FastDiv make_fast_div(int d) {
  if (d == 1) return {1, 0u, 0};
  int log2_ceil = 0;
  while ((1ll << log2_ceil) < d) ++log2_ceil;
  const int p = 31 + log2_ceil;
  const unsigned mul =
      static_cast<unsigned>(((1ull << p) + static_cast<unsigned>(d) - 1) /
                            static_cast<unsigned>(d));
  return {d, mul, p - 32};
}

__device__ __forceinline__ int fast_div(int n, FastDiv f) {
  return f.d == 1 ? n
                  : static_cast<int>(__umulhi(static_cast<unsigned>(n),
                                              f.mul) >> f.shr);
}

__global__ void __launch_bounds__(kThreads)
window_gather_kernel(const float* __restrict__ src,
                     const int32_t* __restrict__ start,
                     float* __restrict__ out, int H, int W, int t1, int t2,
                     int total, FastDiv per_point, FastDiv per_channel,
                     FastDiv per_row, bool start_int2) {
  const int64_t e64 = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (e64 >= total) return;
  const int e = static_cast<int>(e64);
  const int i = fast_div(e, per_point);
  const int2 s = start_int2 ? reinterpret_cast<const int2*>(start)[i]
                            : make_int2(start[2 * i], start[2 * i + 1]);
  const int k = e - i * per_point.d;
  const int c = fast_div(k, per_channel);
  const int rem = k - c * per_channel.d;
  const int y = fast_div(rem, per_row);
  const int x = rem - y * per_row.d;
  const int y0 = min(max(s.x, 0), H - t1);
  const int x0 = min(max(s.y, 0), W - t2);
  out[e] = src[(static_cast<int64_t>(c) * H + y0 + y) * W + x0 + x];
}

}  // namespace

extern "C" int slamtpu_window_gather(const float* src, const int32_t* start,
                                     float* out, int C, int H, int W, int N,
                                     int t1, int t2, void* stream) {
  const int64_t total = static_cast<int64_t>(N) * C * t1 * t2;
  if (total > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (total == 0) return static_cast<int>(cudaGetLastError());
  const int blocks = static_cast<int>((total + kThreads - 1) / kThreads);
  const bool start_int2 = (reinterpret_cast<uintptr_t>(start) & 7u) == 0;
  window_gather_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      src, start, out, H, W, t1, t2, static_cast<int>(total),
      make_fast_div(C * t1 * t2), make_fast_div(t1 * t2), make_fast_div(t2),
      start_int2);
  return static_cast<int>(cudaGetLastError());
}
