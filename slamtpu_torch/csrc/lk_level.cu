// One pyramid level of the Lucas-Kanade solver for all N points, in one
// cooperative launch: the window gather, the structure tensor, the
// eigenvalue gate and the whole Gauss-Newton loop with its global stop rule.
//
// Replaces the TPU kernel slamtpu/ops/dma_gather.py::_span_kernel as the
// main path uses it: the JAX package's level solver
// (slamtpu/ops/lucas_kanade.py::_lk_level_patch_lanes) gathers each point's
// 6-map window and second-image patch with that kernel and then runs its
// solver loop as one XLA while_loop on the device. In the port that loop was
// ~90 host-issued tensor ops and one host sync per iteration; here the
// gathers land in shared memory and the loop runs inside the kernel.
//
// Contract: exactly that of the plain version, lk_level_plain in
// slamtpu_torch/ops/lucas_kanade.py (the entry clamp q0_safe, the mask and
// structure tensor computed once per level, the eigenvalue gate, the
// patch-margin freeze, escape_fail, and the while_loop condition
// (it < iters) & (sum(running) > min(min_active, sum(ok) // 32)) checked
// before every iteration, the first one included). Built with -fmad=false,
// so each multiply and add rounds as PyTorch's separate elementwise ops do;
// only the order of the window sums differs from the plain version.
//
// What bounds it on the H100: bytes. At level 0, N = 1024 and window 9
// (T = 19, P = 32) the function must read each live point's 6 x T x T stack
// window and P x P patch once: ~13 MB, ~3.9 us at 3.35 TB/s; the solver's
// arithmetic (~13 T^2 flops a point and iteration, <= 30 iterations) stays
// below that. In practice the per-iteration grid barrier (one a solver
// iteration, the price of the global stop rule) sets the time.
//
// Design: one warp owns one point, kWarps points a block. Each warp stages
// its point's img1, Iy and Ix windows and its patch into dynamic shared
// memory with cp.async (4-byte copies: windows start at any column) while
// it reads Gyy, Gxx and Gyx once from global memory for the structure
// tensor (warp reductions), then applies pinv2x2_sym and the gate. Starts
// are clamped like lax.dynamic_slice. The stop rule stays on the device, in
// a grid barrier that carries the count: at check k each block adds
// (its running points << kArriveBits) + 1 to the zeroed word counts[k] with
// one atomic and spins until all blocks have arrived; the word's high bits
// are then the grid's running count, the same in every block. Every lane of
// a warp holds identical copies of its point's scalars (xor-butterfly sums
// are identical in every lane), so the loop condition is uniform across
// the grid. counts (iters + 1 words, zeroed by the wrapper): counts[k] for
// the check before iteration k (k = 0: the gated live count); a check that
// ran has nonzero arrival bits, so the words also record how many
// iterations ran. The cooperative launch refuses a grid whose blocks cannot
// all be resident (cudaErrorCooperativeLaunchTooLarge); the entry point
// refuses more blocks than the arrival bits count.
//
// 1-D mode (one_d != 0, lk_level_1d_kernel): the disparity-only level of
// rectified stereo, Params.stereo_klt_1d. It replaces the same TPU kernel
// where the JAX package's 1-D level (lucas_kanade.py::_lk_level_lanes_1d)
// gathers its stack window (:594) and its (T, P) patch (:632) with it; its
// contract is lk_level_1d_plain in slamtpu_torch/ops/lucas_kanade.py:
// flow_y pinned to 0, the scalar step inv_sxx * b_x, the gate
// sxx / count >= eig_thresh, the patch rows fixed at the template rows,
// 2-tap sampling, escape, convergence and bounds on x only, and the same
// stop rule. What bounds it: bytes, as in 2-D mode, with fewer of them (the
// img and Ix windows and a T x P patch; Gxx is read once). Design: the 2-D
// kernel's, one warp a point, cp.async staging into shared memory and the
// same count-carrying barrier, so the keyframe program's stereo cascade
// stays free of host syncs in either mode.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;   // points a block
constexpr int kMargin = 6;  // LK_PATCH_MARGIN
constexpr unsigned kFull = 0xffffffffu;
// Low bits of a barrier word count arrived blocks, high bits points.
constexpr int kArriveBits = 12;
constexpr int kArriveMask = (1 << kArriveBits) - 1;

struct LevelArgs {
  const float* stack;    // (6, Hp, Wp): img, Iy, Ix, Gyy, Gxx, Gyx
  const float* img2;     // (Hp, Wp)
  const int32_t* p_lvl;  // (N, 2) level coordinates (y, x)
  const float* flow_in;  // (N, 2)
  const uint8_t* ok_in;  // (N,)
  float* flow_out;
  uint8_t* ok_out;
  int32_t* counts;       // iters + 1 zeroed words
  int Hp, Wp, N, H, W, w, iters, pad, min_active, escape_fail;
  float eps, eig_thresh;
};

// Shared memory a warp needs in 2-D mode (img, Iy, Ix windows and the
// P x P patch); the 1-D mode uses less of the same slice.
__host__ __device__ __forceinline__ int warp_smem_floats(int window) {
  const int T = 2 * window + 1;
  const int P = T + 1 + 2 * kMargin;
  return 3 * T * T + P * P;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// Grid barrier at the zeroed word `slot` that also sums `flag` (one a warp)
// over the grid; every thread of every block returns the same total.
__device__ __forceinline__ int grid_count(int32_t* slot, bool flag,
                                          int* warp_flags, int* total) {
  if ((threadIdx.x & 31) == 0) warp_flags[threadIdx.x >> 5] = flag ? 1 : 0;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int k = 0; k < kWarps; ++k) s += warp_flags[k];
    atomicAdd(slot, (s << kArriveBits) + 1);
    int v;
    do {
      v = *reinterpret_cast<volatile int32_t*>(slot);
    } while ((v & kArriveMask) < static_cast<int>(gridDim.x));
    *total = v >> kArriveBits;
  }
  __syncthreads();
  return *total;
}

__global__ void __launch_bounds__(kWarps * 32)
lk_level_kernel(LevelArgs a) {
  extern __shared__ float smem[];
  __shared__ int warp_flags[kWarps];
  __shared__ int total_sh;

  const int T = 2 * a.w + 1;
  const int TT = T * T;
  const int P = T + 1 + 2 * kMargin;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + warp;
  const int64_t plane = static_cast<int64_t>(a.Hp) * a.Wp;
  float* img1 = smem + warp * warp_smem_floats(a.w);
  float* iy = img1 + TT;
  float* ix = iy + TT;
  float* patch = ix + TT;

  const float hmax = static_cast<float>(a.H - 1);
  const float wmax = static_cast<float>(a.W - 1);
  const float wf = static_cast<float>(a.w);
  int pyi = 0, pxi = 0;
  float fy = 0.f, fx = 0.f;
  bool ok = false;
  if (i < a.N) {
    pyi = a.p_lvl[2 * i];
    pxi = a.p_lvl[2 * i + 1];
    fy = a.flow_in[2 * i];
    fx = a.flow_in[2 * i + 1];
    ok = a.ok_in[i] != 0;
  }
  const float py = static_cast<float>(pyi);
  const float px = static_cast<float>(pxi);
  int base_y = 0, base_x = 0;
  float up = 0.f, down = 0.f, left = 0.f, right = 0.f;
  float ia = 0.f, ib = 0.f, ic = 0.f;
  if (ok) {
    const int sy = clampi(pyi - a.w + a.pad, 0, a.Hp - T);
    const int sx = clampi(pxi - a.w + a.pad, 0, a.Wp - T);
    const float qy = py + fy, qx = px + fx;
    const bool inb = qy >= 0.f && qy <= hmax && qx >= 0.f && qx <= wmax;
    const float q0y = inb ? qy : py;
    const float q0x = inb ? qx : px;
    base_y = static_cast<int>(floorf(q0y)) - a.w - kMargin + a.pad;
    base_x = static_cast<int>(floorf(q0x)) - a.w - kMargin + a.pad;
    const int gy = clampi(base_y, 0, a.Hp - P);
    const int gx = clampi(base_x, 0, a.Wp - P);
    for (int k = lane; k < TT; k += 32) {
      const int y = k / T;
      const float* src = a.stack + static_cast<int64_t>(sy + y) * a.Wp + sx +
                         (k - y * T);
      __pipeline_memcpy_async(img1 + k, src, 4);
      __pipeline_memcpy_async(iy + k, src + plane, 4);
      __pipeline_memcpy_async(ix + k, src + 2 * plane, 4);
    }
    for (int k = lane; k < P * P; k += 32) {
      const int y = k / P;
      __pipeline_memcpy_async(
          patch + k, a.img2 + static_cast<int64_t>(gy + y) * a.Wp + gx +
                         (k - y * P), 4);
    }
    __pipeline_commit();

    // Mask and structure tensor at the entry correspondence, while the
    // copies land.
    up = floorf(fminf(fminf(py, q0y), wf));
    down = floorf(fminf(hmax - fmaxf(py, q0y), wf));
    left = floorf(fminf(fminf(px, q0x), wf));
    right = floorf(fminf(wmax - fmaxf(px, q0x), wf));
    float syy = 0.f, sxx = 0.f, syx = 0.f, cnt = 0.f;
    for (int k = lane; k < TT; k += 32) {
      const int y = k / T;
      const int x = k - y * T;
      const float oy = static_cast<float>(y - a.w);
      const float ox = static_cast<float>(x - a.w);
      const float m = (oy >= -up && oy <= down && ox >= -left && ox <= right)
                          ? 1.f : 0.f;
      const float* g = a.stack + 3 * plane +
                       static_cast<int64_t>(sy + y) * a.Wp + sx + x;
      syy += __ldg(g) * m;
      sxx += __ldg(g + plane) * m;
      syx += __ldg(g + 2 * plane) * m;
      cnt += m;
    }
    syy = warp_sum(syy);
    sxx = warp_sum(sxx);
    syx = warp_sum(syx);
    cnt = warp_sum(cnt);
    // pinv2x2_sym(syy, syx, sxx), in the plain version's operation order.
    const float half_tr = 0.5f * (syy + sxx);
    const float hd = 0.5f * (syy - sxx);
    const float disc = sqrtf(hd * hd + syx * syx);
    const float s1 = half_tr + disc;
    const float s2 = half_tr - disc;
    const float theta = 0.5f * atan2f(2.0f * syx, syy - sxx);
    const float ct = cosf(theta);
    const float st = sinf(theta);
    const float tol = 1e-6f * fmaxf(fabsf(s1), fabsf(s2));
    const float inv1 = fabsf(s1) > tol ? 1.0f / s1 : 0.f;
    const float inv2 = fabsf(s2) > tol ? 1.0f / s2 : 0.f;
    ia = inv1 * ct * ct + inv2 * st * st;
    ib = (inv1 - inv2) * ct * st;
    ic = inv1 * st * st + inv2 * ct * ct;
    const float min_eig = s2 / fmaxf(cnt, 1.0f);
    ok = min_eig >= a.eig_thresh;
    __pipeline_wait_prior(0);
  }
  __syncwarp();

  // Global stop threshold from the gated live count (= running at it 0).
  int total = grid_count(a.counts, ok, warp_flags, &total_sh);
  const int stop = min(a.min_active, total / 32);

  bool running = ok;
  int it = 0;
  while (it < a.iters && total > stop) {
    if (running) {
      const float qy = py + fy, qx = px + fx;
      const bool inb = qy >= 0.f && qy <= hmax && qx >= 0.f && qx <= wmax;
      bool fail = !inb;
      const float sy_ = inb ? qy : py;
      const float sx_ = inb ? qx : px;
      const float fly = floorf(sy_), flx = floorf(sx_);
      const float fry = sy_ - fly, frx = sx_ - flx;
      int rely = static_cast<int>(fly) - a.w + a.pad - base_y;
      int relx = static_cast<int>(flx) - a.w + a.pad - base_x;
      const bool escaped = rely < 0 || rely > 2 * kMargin || relx < 0 ||
                           relx > 2 * kMargin;
      if (a.escape_fail) fail = fail || escaped;
      rely = clampi(rely, 0, 2 * kMargin);
      relx = clampi(relx, 0, 2 * kMargin);
      const float w00 = (1.0f - fry) * (1.0f - frx);
      const float w01 = (1.0f - fry) * frx;
      const float w10 = fry * (1.0f - frx);
      const float w11 = fry * frx;
      float by = 0.f, bx = 0.f;
      for (int k = lane; k < TT; k += 32) {
        const int y = k / T;
        const int x = k - y * T;
        const float* b = patch + (rely + y) * P + relx + x;
        const float img2_s = w00 * b[0] + w01 * b[1] + w10 * b[P] +
                             w11 * b[P + 1];
        const float oy = static_cast<float>(y - a.w);
        const float ox = static_cast<float>(x - a.w);
        const float m = (oy >= -up && oy <= down && ox >= -left &&
                         ox <= right) ? 1.f : 0.f;
        const float diff = (img1[k] - img2_s) * m;
        by += diff * iy[k];
        bx += diff * ix[k];
      }
      by = warp_sum(by);
      bx = warp_sum(bx);
      const float step_y = ia * by + ib * bx;
      const float step_x = ib * by + ic * bx;
      const bool converged = fabsf(step_y) < a.eps && fabsf(step_x) < a.eps;
      const float nfy = fy + step_y;
      const float nfx = fx + step_x;
      const float ny = py + nfy, nx = px + nfx;
      const bool new_inb = ny >= 0.f && ny <= hmax && nx >= 0.f && nx <= wmax;
      fail = fail || (!converged && !new_inb);
      if (!fail && !converged && !escaped) {
        fy = nfy;
        fx = nfx;
      }
      ok = !fail;
      running = ok && !converged && !escaped;
    }
    ++it;
    total = grid_count(a.counts + it, running, warp_flags, &total_sh);
  }

  if (i < a.N && lane == 0) {
    a.flow_out[2 * i] = fy;
    a.flow_out[2 * i + 1] = fx;
    a.ok_out[i] = ok ? 1 : 0;
  }
}

// The disparity-only level (see the note at the top): the same launch,
// barrier and per-warp layout as lk_level_kernel, on x alone.
__global__ void __launch_bounds__(kWarps * 32)
lk_level_1d_kernel(LevelArgs a) {
  extern __shared__ float smem[];
  __shared__ int warp_flags[kWarps];
  __shared__ int total_sh;

  const int T = 2 * a.w + 1;
  const int TT = T * T;
  const int P = T + 1 + 2 * kMargin;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + warp;
  const int64_t plane = static_cast<int64_t>(a.Hp) * a.Wp;
  float* img1 = smem + warp * warp_smem_floats(a.w);
  float* ix = img1 + TT;
  float* patch = ix + TT;  // T rows of P

  const float hmax = static_cast<float>(a.H - 1);
  const float wmax = static_cast<float>(a.W - 1);
  const float wf = static_cast<float>(a.w);
  int pyi = 0, pxi = 0;
  float fx = 0.f;
  bool ok = false;
  if (i < a.N) {
    pyi = a.p_lvl[2 * i];
    pxi = a.p_lvl[2 * i + 1];
    fx = a.flow_in[2 * i + 1];
    ok = a.ok_in[i] != 0;
  }
  const float py = static_cast<float>(pyi);
  const float px = static_cast<float>(pxi);
  int base_x = 0;
  float up = 0.f, down = 0.f, left = 0.f, right = 0.f;
  float inv_sxx = 0.f;
  if (ok) {
    const int sy = clampi(pyi - a.w + a.pad, 0, a.Hp - T);
    const int sx = clampi(pxi - a.w + a.pad, 0, a.Wp - T);
    const float qx = px + fx;
    const float q0x = (qx >= 0.f && qx <= wmax) ? qx : px;
    base_x = static_cast<int>(floorf(q0x)) - a.w - kMargin + a.pad;
    const int gx = clampi(base_x, 0, a.Wp - P);
    for (int k = lane; k < TT; k += 32) {
      const int y = k / T;
      const float* src = a.stack + static_cast<int64_t>(sy + y) * a.Wp + sx +
                         (k - y * T);
      __pipeline_memcpy_async(img1 + k, src, 4);
      __pipeline_memcpy_async(ix + k, src + 2 * plane, 4);
    }
    // Patch rows are the template rows (sy: the same clamp as the stack
    // window's start).
    for (int k = lane; k < T * P; k += 32) {
      const int y = k / P;
      __pipeline_memcpy_async(
          patch + k, a.img2 + static_cast<int64_t>(sy + y) * a.Wp + gx +
                         (k - y * P), 4);
    }
    __pipeline_commit();

    up = fminf(py, wf);
    down = fminf(hmax - py, wf);
    left = floorf(fminf(fminf(px, q0x), wf));
    right = floorf(fminf(wmax - fmaxf(px, q0x), wf));
    float sxx = 0.f, cnt = 0.f;
    for (int k = lane; k < TT; k += 32) {
      const int y = k / T;
      const int x = k - y * T;
      const float oy = static_cast<float>(y - a.w);
      const float ox = static_cast<float>(x - a.w);
      const float m = (oy >= -up && oy <= down && ox >= -left && ox <= right)
                          ? 1.f : 0.f;
      sxx += __ldg(a.stack + 4 * plane +
                   static_cast<int64_t>(sy + y) * a.Wp + sx + x) * m;
      cnt += m;
    }
    sxx = warp_sum(sxx);
    cnt = warp_sum(cnt);
    inv_sxx = sxx > 1e-12f ? 1.0f / fmaxf(sxx, 1e-12f) : 0.f;
    ok = sxx / fmaxf(cnt, 1.0f) >= a.eig_thresh;
    __pipeline_wait_prior(0);
  }
  __syncwarp();

  int total = grid_count(a.counts, ok, warp_flags, &total_sh);
  const int stop = min(a.min_active, total / 32);

  bool running = ok;
  int it = 0;
  while (it < a.iters && total > stop) {
    if (running) {
      const float qx = px + fx;
      const bool inb = qx >= 0.f && qx <= wmax;
      bool fail = !inb;
      const float sx_ = inb ? qx : px;
      const float flx = floorf(sx_);
      const float frx = sx_ - flx;
      int relx = static_cast<int>(flx) - a.w + a.pad - base_x;
      const bool escaped = relx < 0 || relx > 2 * kMargin;
      if (a.escape_fail) fail = fail || escaped;
      relx = clampi(relx, 0, 2 * kMargin);
      const float w0 = 1.0f - frx;
      float bx = 0.f;
      for (int k = lane; k < TT; k += 32) {
        const int y = k / T;
        const int x = k - y * T;
        const float* b = patch + y * P + relx + x;
        const float img2_s = w0 * b[0] + frx * b[1];
        const float oy = static_cast<float>(y - a.w);
        const float ox = static_cast<float>(x - a.w);
        const float m = (oy >= -up && oy <= down && ox >= -left &&
                         ox <= right) ? 1.f : 0.f;
        bx += (img1[k] - img2_s) * m * ix[k];
      }
      bx = warp_sum(bx);
      const float step_x = inv_sxx * bx;
      const bool converged = fabsf(step_x) < a.eps;
      const float nfx = fx + step_x;
      const float nx = px + nfx;
      fail = fail || (!converged && !(nx >= 0.f && nx <= wmax));
      if (!fail && !converged && !escaped) fx = nfx;
      ok = !fail;
      running = ok && !converged && !escaped;
    }
    ++it;
    total = grid_count(a.counts + it, running, warp_flags, &total_sh);
  }

  if (i < a.N && lane == 0) {
    a.flow_out[2 * i] = 0.f;
    a.flow_out[2 * i + 1] = fx;
    a.ok_out[i] = ok ? 1 : 0;
  }
}

size_t smem_bytes(int window) {
  return static_cast<size_t>(kWarps) * warp_smem_floats(window) *
         sizeof(float);
}

cudaError_t prepare(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

extern "C" int slamtpu_lk_level(const float* stack, const float* img2,
                                const int32_t* p_lvl, const float* flow_in,
                                const uint8_t* ok_in, float* flow_out,
                                uint8_t* ok_out, int32_t* counts, int Hp,
                                int Wp, int N, int H, int W, int window,
                                int iters, int pad, int min_active,
                                int escape_fail, int one_d, float eps,
                                float eig_thresh, void* stream) {
  if (N <= 0) return 0;
  LevelArgs a{stack, img2, p_lvl, flow_in, ok_in, flow_out, ok_out, counts,
              Hp, Wp, N, H, W, window, iters, pad, min_active, escape_fail,
              eps, eig_thresh};
  const int blocks = (N + kWarps - 1) / kWarps;
  if (blocks > kArriveMask) return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = one_d ? (const void*)lk_level_1d_kernel
                             : (const void*)lk_level_kernel;
  const size_t smem = smem_bytes(window);
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel(
      kernel, dim3(blocks), dim3(kWarps * 32), params, smem,
      static_cast<cudaStream_t>(stream));
  // A refused launch also sets the thread's last error: clear it, so that
  // no later launch check reports it.
  if (e != cudaSuccess) cudaGetLastError();
  else e = cudaGetLastError();
  return static_cast<int>(e);
}
