// One pyramid level of the Lucas-Kanade solver for all N points of each of
// B sequences, in one plain launch with no grid barrier: the window gather,
// the structure tensor, the eigenvalue gate, the whole Gauss-Newton loop,
// and each sequence's stop rule, resolved by the last of its blocks to
// finish.
//
// Replaces the TPU kernel slamtpu/ops/dma_gather.py::_span_kernel as the
// main path uses it: the JAX package's level solver
// (slamtpu/ops/lucas_kanade.py::_lk_level_patch_lanes) gathers each point's
// 6-map window and second-image patch with that kernel and then runs its
// solver loop as one XLA while_loop on the device. Here the gathers land in
// shared memory and the loop runs inside the kernel.
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
// Why the stop rule needs no barrier. Points interact only through that
// condition: a point's state after k iterations depends on its own inputs
// alone, and once it stops running (converged, escaped or failed) the loop
// body leaves its flow and ok as they are. So each warp runs its point to
// the point's own stop, or to `iters`, writing its flow after every
// iteration to hist[k] (k = 0: the entry flow) and the number of
// iterations it ran to steps (s; iters + 1 for a point still running after
// `iters`, 0 for a point that ok_in or the gate killed). Then
// counts[k] = #{s > k} is the loop's running count before iteration k
// (counts[0] = the gated live count, the sum(ok) of the threshold), and the
// while_loop runs exactly K iterations, K = the first k with k == iters or
// counts[k] <= min(min_active, counts[0] / 32). After K iterations a point
// with s <= K has stopped at iteration s and holds hist[s] and its final
// ok, which is what each warp writes out; a point with s > K is still
// running, so it holds hist[K] and ok is true (running implies ok). The
// last block rewrites those points. This is the while_loop's result, not
// an approximation. Edge cases: a point that fails at iteration j < K keeps
// hist[j] with ok false; a level with no live point has K = 0 and every s
// = 0, so flow and ok leave unchanged; the 1-D mode writes flow_y = 0 for
// every point, live or not, as lk_level_1d_plain does.
//
// Resolve without waiting: each block adds its points' s to a zeroed
// global histogram (bins[0 .. iters + 1], one atomic per distinct value),
// fences, and takes a ticket with one atomicAdd; the block that draws the
// last ticket fences again, sums the histogram into counts and K, and
// rewrites the points with s > K. No block ever waits on another, so the
// grid needs no residency and N has no cap.
//
// Batch axis: the grid is (blocks a sequence, B); blockIdx.y is the
// sequence. Every per-sequence array ((B, N, ...) points, flows and masks,
// (B, iters + 1, N) hist, (B, N) steps) and the sequence's own sync words
// (B blocks of 2 * iters + 5) are offset by it, and the stack and the
// second image by their batch strides, before anything else runs, so the
// code below sees one sequence, as the JAX package's vmapped while_loop
// does: a sequence has its own histogram, ticket, counts and K, its last
// block resolves its rule (the ticket against gridDim.x, its own block
// count), and no sequence waits for, or stops, another. B = 1 is the
// unbatched level.
//
// What bounds it on the H100. Bytes: at level 0, N = 1024 and window 9
// (T = 19, P = 32) the function must read each live point's 6 x T x T stack
// window and P x P patch once: ~7.4 MB of distinct pixels, ~2.2 us at 3.35
// TB/s. The floor in practice is one warp's serial chain, whatever N is
// below ~2,000 points: ~10 dependent memory round trips (point inputs,
// windows and patch, fences, ticket, histogram, resolve) and up to `iters`
// (30) iterations of ~12 window pixels a lane (4 patch taps, 2 products
// each) and one two-value 5-step shuffle reduction. Measured on an H100
// (scripts/lk_level_anatomy.py): ~13.6 us at iters = 0, then ~0.45 us an
// iteration, ~27 us at level 0. Speculative iterations past K are not
// work of the function; they run beside the others on their own warps.
// A batch of B sequences is B times the bytes and operations in one grid
// of B times the blocks: the per-warp chain stays, and more blocks than the
// SMs hold at once run in waves.
//
// TMA is not used: a tensor map needs row strides that are multiples of 16
// bytes, and the padded level widths at 1241 columns (1275, 655, 345 and
// 190 floats) are not. Padding the pyramid's pitch would change
// lk_pyramid_impl's layout for every caller and its CPU parity.
//
// Design: one warp owns one point, kWarps points a block (4: 256 blocks at
// N = 1024 spread over the 132 SMs). An iteration's chain is issue- and
// latency-bound, so each lane keeps its own window pixels (k = lane + 32 j,
// j < kPix: 12 up to window 9, 32 up to 15) in registers: img1, Iy and
// Ix values, read once from global memory beside Gyy, Gxx and Gyx for the
// structure tensor, and their offsets into the patch. The loop over them
// is unrolled, so an iteration issues its 4 kPix patch reads at once and
// carries no index arithmetic. Only the P x P patch, which every lane
// samples at a moving offset, is staged in shared memory (cp.async, 4-byte
// copies: patches start at any column), its rows padded to a pitch of
// T + 32 so that a warp's reads are free of bank conflicts (6.5 KB a warp
// at window 9). Then pinv2x2_sym and the gate. Starts are clamped like
// lax.dynamic_slice. The window mask is fixed for the level, so it is
// folded into the gradients once (a zero gradient adds the same zero the
// masked difference did; a lane's pixels past T x T hold zeros and add
// zeros). Every lane of a warp
// holds identical copies of its point's scalars (xor-butterfly sums are
// identical in every lane), so a warp's loop control is uniform. Windows
// up to 15 (T x T <= 32 x 32 pixels) are taken; the wrapper refuses
// larger ones.
//
// 1-D mode (one_d != 0, lk_level_1d_kernel): the disparity-only level of
// rectified stereo, Params.stereo_klt_1d. It replaces the same TPU kernel
// where the JAX package's 1-D level (lucas_kanade.py::_lk_level_lanes_1d)
// gathers its stack window (:594) and its (T, P) patch (:632) with it; its
// contract is lk_level_1d_plain in slamtpu_torch/ops/lucas_kanade.py:
// flow_y pinned to 0, the scalar step inv_sxx * b_x, the gate
// sxx / count >= eig_thresh, the patch rows fixed at the template rows,
// 2-tap sampling, escape, convergence and bounds on x only, and the same
// stop rule, resolved the same way. What bounds it: bytes, as in 2-D mode,
// with fewer of them (the img and Ix windows and a T x P patch; Gxx is read
// once), and the same per-point serial chain with 2 taps and one sum.
#include <algorithm>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;     // points a block
constexpr int kMargin = 6;    // LK_PATCH_MARGIN
constexpr int kMaxPix = 32;   // window pixels a lane: T x T <= 1024
constexpr unsigned kFull = 0xffffffffu;

struct LevelArgs {
  const float* stack;    // (6, Hp, Wp): img, Iy, Ix, Gyy, Gxx, Gyx
  const float* img2;     // (Hp, Wp)
  int64_t stack_bs, img_bs;  // batch strides of stack and img2, in floats
  const int32_t* p_lvl;  // (N, 2) level coordinates (y, x)
  const float* flow_in;  // (N, 2)
  const uint8_t* ok_in;  // (N,)
  float* flow_out;
  uint8_t* ok_out;
  float2* hist;          // (iters + 1, N): flow after k iterations
  int32_t* steps;        // (N,): iterations run; iters + 1: still running
  // 2 * iters + 5 words, zeroed: bins[iters + 2], ticket, then (written
  // by the last block) counts[iters + 1] and K.
  int32_t* sync;
  int Hp, Wp, N, H, W, w, iters, pad, min_active, escape_fail;
  float eps, eig_thresh;
};

// The arguments of sequence blockIdx.y: every pointer moved to its slice.
__device__ __forceinline__ LevelArgs sequence_args(LevelArgs a) {
  const int64_t b = blockIdx.y;
  const int64_t n = a.N;
  a.stack += b * a.stack_bs;
  a.img2 += b * a.img_bs;
  a.p_lvl += b * n * 2;
  a.flow_in += b * n * 2;
  a.ok_in += b * n;
  a.flow_out += b * n * 2;
  a.ok_out += b * n;
  a.hist += b * (a.iters + 1) * n;
  a.steps += b * n;
  a.sync += b * (2 * a.iters + 5);
  return a;
}

// Row pitch of a staged patch: T + 32 (P = T + 13 columns, then padding),
// so that pitch = T (mod 32) and the window pixel k = lane + 32 j lands in
// bank (k + const) mod 32: a warp's patch reads hit 32 distinct banks. (At
// pitch P = 32, window 9, rows alias and 13 lanes collide.)
__host__ __device__ __forceinline__ int patch_pitch(int window) {
  return 2 * window + 1 + 32;
}

// Shared memory a warp needs: the patch's P rows (the 1-D mode uses T).
__host__ __device__ __forceinline__ int warp_smem_floats(int window) {
  return (2 * window + 2 + 2 * kMargin) * patch_pitch(window);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Two independent xor-butterfly sums, interleaved.
__device__ __forceinline__ void warp_sum2(float& a, float& b) {
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(kFull, a, o);
    b += __shfl_xor_sync(kFull, b, o);
  }
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// Called by every thread of a block after its warps wrote flow_out, ok_out,
// steps and hist for their points (s: this warp's steps value). Adds the
// block's s values to the histogram, takes a ticket, and in the last block
// to finish resolves the stop rule (see the note at the top). `scratch`:
// the block's dynamic shared memory, free by then, >= iters + 2 words.
__device__ void finish_level(const LevelArgs& a, int s, bool one_d,
                             int* scratch) {
  __shared__ int steps_sh[kWarps];
  __shared__ int last_sh;
  __shared__ int k_sh;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + warp;
  int32_t* bins = a.sync;
  int32_t* ticket = bins + a.iters + 2;
  int32_t* counts = ticket + 1;
  if (lane == 0) {
    steps_sh[warp] = i < a.N ? s : -1;
    __threadfence();  // this warp's output writes, before the ticket
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int u = 0; u < kWarps; ++u) {
      const int v = steps_sh[u];
      bool seen = v < 0;
      for (int q = 0; q < u; ++q) seen = seen || steps_sh[q] == v;
      if (seen) continue;
      int mult = 1;
      for (int q = u + 1; q < kWarps; ++q) mult += steps_sh[q] == v ? 1 : 0;
      atomicAdd(bins + v, mult);
    }
    __threadfence();
    last_sh = atomicAdd(ticket, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!last_sh) return;
  __threadfence();
  for (int k = threadIdx.x; k < a.iters + 2; k += blockDim.x)
    scratch[k] = __ldcg(bins + k);
  __syncthreads();
  if (threadIdx.x == 0) {
    int live = 0;
    for (int k = 1; k <= a.iters + 1; ++k) live += scratch[k];
    const int stop = min(a.min_active, live / 32);
    int c = live;
    int K = -1;
    for (int k = 0; k <= a.iters; ++k) {
      if (k > 0) c -= scratch[k];
      counts[k] = c;
      if (K < 0 && (k == a.iters || c <= stop)) K = k;
    }
    counts[a.iters + 1] = K;
    k_sh = K;
  }
  __syncthreads();
  const int K = k_sh;
  const float2* row = a.hist + static_cast<int64_t>(K) * a.N;
  // kBatch steps values a thread in flight at once: one L2 round trip for
  // each kBatch * blockDim.x points, not one a point.
  constexpr int kBatch = 8;
  for (int j0 = threadIdx.x; j0 < a.N; j0 += kBatch * blockDim.x) {
    int sv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = j0 + u * blockDim.x;
      sv[u] = j < a.N ? __ldcg(a.steps + j) : 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (sv[u] > K) {
        const int j = j0 + u * blockDim.x;
        const float2 f = __ldcg(row + j);
        a.flow_out[2 * j] = one_d ? 0.f : f.x;
        a.flow_out[2 * j + 1] = f.y;
        a.ok_out[j] = 1;
      }
    }
  }
}

// kPix: window pixels a lane holds, >= ceil(T * T / 32).
template <int kPix>
__global__ void __launch_bounds__(kWarps * 32)
lk_level_kernel(LevelArgs args) {
  extern __shared__ float smem[];
  const LevelArgs a = sequence_args(args);

  const int T = 2 * a.w + 1;
  const int TT = T * T;
  const int P = T + 1 + 2 * kMargin;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + warp;
  const int64_t plane = static_cast<int64_t>(a.Hp) * a.Wp;
  const int S = patch_pitch(a.w);
  float* patch = smem + warp * warp_smem_floats(a.w);

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
  float ia = 0.f, ib = 0.f, ic = 0.f;
  // This lane's window pixels: img1, Iy and Ix (masked) and patch offsets.
  float v1[kPix], vy[kPix], vx[kPix];
  int off[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    v1[j] = vy[j] = vx[j] = 0.f;
    off[j] = 0;
  }
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
    for (int k = lane; k < P * P; k += 32) {
      const int y = k / P;
      const int x = k - y * P;
      __pipeline_memcpy_async(
          patch + y * S + x,
          a.img2 + static_cast<int64_t>(gy + y) * a.Wp + gx + x, 4);
    }
    __pipeline_commit();

    // Window values, mask and structure tensor at the entry
    // correspondence, while the patch lands.
    const float up = floorf(fminf(fminf(py, q0y), wf));
    const float down = floorf(fminf(hmax - fmaxf(py, q0y), wf));
    const float left = floorf(fminf(fminf(px, q0x), wf));
    const float right = floorf(fminf(wmax - fmaxf(px, q0x), wf));
    float syy = 0.f, sxx = 0.f, syx = 0.f, cnt = 0.f;
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const int k = lane + 32 * j;
      if (k < TT) {
        const int y = k / T;
        const int x = k - y * T;
        off[j] = y * S + x;
        const float oy = static_cast<float>(y - a.w);
        const float ox = static_cast<float>(x - a.w);
        const bool in = oy >= -up && oy <= down && ox >= -left && ox <= right;
        const float m = in ? 1.f : 0.f;
        const float* g = a.stack + static_cast<int64_t>(sy + y) * a.Wp + sx +
                         x;
        v1[j] = __ldg(g);
        vy[j] = in ? __ldg(g + plane) : 0.f;
        vx[j] = in ? __ldg(g + 2 * plane) : 0.f;
        syy += __ldg(g + 3 * plane) * m;
        sxx += __ldg(g + 4 * plane) * m;
        syx += __ldg(g + 5 * plane) * m;
        cnt += m;
      }
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

  int s = 0;
  if (ok) {
    if (lane == 0) a.hist[i] = make_float2(fy, fx);
    bool running = true;
    int it = 0;
    while (it < a.iters) {
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
      const float* pb = patch + rely * S + relx;
      float by = 0.f, bx = 0.f;
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        const float* b = pb + off[j];
        const float img2_s = w00 * b[0] + w01 * b[1] + w10 * b[S] +
                             w11 * b[S + 1];
        const float diff = v1[j] - img2_s;
        by += diff * vy[j];
        bx += diff * vx[j];
      }
      warp_sum2(by, bx);
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
      ++it;
      if (lane == 0)
        a.hist[static_cast<int64_t>(it) * a.N + i] = make_float2(fy, fx);
      if (!running) break;
    }
    s = running ? a.iters + 1 : it;
  }

  if (i < a.N && lane == 0) {
    a.flow_out[2 * i] = fy;
    a.flow_out[2 * i + 1] = fx;
    a.ok_out[i] = ok ? 1 : 0;
    a.steps[i] = s;
  }
  finish_level(a, s, false, reinterpret_cast<int*>(smem));
}

// The disparity-only level (see the note at the top): the same launch,
// per-warp layout and stop-rule resolve as lk_level_kernel, on x alone.
template <int kPix>
__global__ void __launch_bounds__(kWarps * 32)
lk_level_1d_kernel(LevelArgs args) {
  extern __shared__ float smem[];
  const LevelArgs a = sequence_args(args);

  const int T = 2 * a.w + 1;
  const int TT = T * T;
  const int P = T + 1 + 2 * kMargin;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + warp;
  const int64_t plane = static_cast<int64_t>(a.Hp) * a.Wp;
  const int S = patch_pitch(a.w);
  float* patch = smem + warp * warp_smem_floats(a.w);  // T rows of P

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
  float inv_sxx = 0.f;
  float v1[kPix], vx[kPix];
  int off[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    v1[j] = vx[j] = 0.f;
    off[j] = 0;
  }
  if (ok) {
    const int sy = clampi(pyi - a.w + a.pad, 0, a.Hp - T);
    const int sx = clampi(pxi - a.w + a.pad, 0, a.Wp - T);
    const float qx = px + fx;
    const float q0x = (qx >= 0.f && qx <= wmax) ? qx : px;
    base_x = static_cast<int>(floorf(q0x)) - a.w - kMargin + a.pad;
    const int gx = clampi(base_x, 0, a.Wp - P);
    // Patch rows are the template rows (sy: the same clamp as the stack
    // window's start).
    for (int k = lane; k < T * P; k += 32) {
      const int y = k / P;
      const int x = k - y * P;
      __pipeline_memcpy_async(
          patch + y * S + x,
          a.img2 + static_cast<int64_t>(sy + y) * a.Wp + gx + x, 4);
    }
    __pipeline_commit();

    const float up = fminf(py, wf);
    const float down = fminf(hmax - py, wf);
    const float left = floorf(fminf(fminf(px, q0x), wf));
    const float right = floorf(fminf(wmax - fmaxf(px, q0x), wf));
    float sxx = 0.f, cnt = 0.f;
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const int k = lane + 32 * j;
      if (k < TT) {
        const int y = k / T;
        const int x = k - y * T;
        off[j] = y * S + x;
        const float oy = static_cast<float>(y - a.w);
        const float ox = static_cast<float>(x - a.w);
        const bool in = oy >= -up && oy <= down && ox >= -left && ox <= right;
        const float m = in ? 1.f : 0.f;
        const float* g = a.stack + static_cast<int64_t>(sy + y) * a.Wp + sx +
                         x;
        v1[j] = __ldg(g);
        vx[j] = in ? __ldg(g + 2 * plane) : 0.f;
        sxx += __ldg(g + 4 * plane) * m;
        cnt += m;
      }
    }
    sxx = warp_sum(sxx);
    cnt = warp_sum(cnt);
    inv_sxx = sxx > 1e-12f ? 1.0f / fmaxf(sxx, 1e-12f) : 0.f;
    ok = sxx / fmaxf(cnt, 1.0f) >= a.eig_thresh;
    __pipeline_wait_prior(0);
  }
  __syncwarp();

  int s = 0;
  if (ok) {
    if (lane == 0) a.hist[i] = make_float2(0.f, fx);
    bool running = true;
    int it = 0;
    while (it < a.iters) {
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
      const float* pb = patch + relx;
      float bx = 0.f;
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        const float* b = pb + off[j];
        const float img2_s = w0 * b[0] + frx * b[1];
        bx += (v1[j] - img2_s) * vx[j];
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
      ++it;
      if (lane == 0)
        a.hist[static_cast<int64_t>(it) * a.N + i] = make_float2(0.f, fx);
      if (!running) break;
    }
    s = running ? a.iters + 1 : it;
  }

  if (i < a.N && lane == 0) {
    a.flow_out[2 * i] = 0.f;
    a.flow_out[2 * i + 1] = fx;
    a.ok_out[i] = ok ? 1 : 0;
    a.steps[i] = s;
  }
  finish_level(a, s, true, reinterpret_cast<int*>(smem));
}

// The patches, and room for the histogram in the last block.
size_t smem_bytes(int window, int iters) {
  const int words = std::max(kWarps * warp_smem_floats(window), iters + 2);
  return static_cast<size_t>(words) * sizeof(float);
}

template <int kPix>
cudaError_t launch(const LevelArgs& a, int batch, bool one_d,
                   cudaStream_t stream) {
  const dim3 blocks((a.N + kWarps - 1) / kWarps, batch);
  const size_t smem = smem_bytes(a.w, a.iters);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        one_d ? (const void*)lk_level_1d_kernel<kPix>
              : (const void*)lk_level_kernel<kPix>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  if (one_d)
    lk_level_1d_kernel<kPix><<<blocks, kWarps * 32, smem, stream>>>(a);
  else
    lk_level_kernel<kPix><<<blocks, kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// batch sequences of N points; stack_bs and img_bs: the batch strides of
// stack and img2 in floats (0 for one sequence). Every other array is
// contiguous (batch, ...).
extern "C" int slamtpu_lk_level(const float* stack, const float* img2,
                                const int32_t* p_lvl, const float* flow_in,
                                const uint8_t* ok_in, float* flow_out,
                                uint8_t* ok_out, float* hist, int32_t* steps,
                                int32_t* sync, int batch, int64_t stack_bs,
                                int64_t img_bs, int Hp, int Wp, int N, int H,
                                int W, int window, int iters, int pad,
                                int min_active, int escape_fail, int one_d,
                                float eps, float eig_thresh, void* stream) {
  if (N <= 0 || batch <= 0) return 0;
  if (batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  LevelArgs a{stack, img2, stack_bs, img_bs, p_lvl, flow_in, ok_in,
              flow_out, ok_out, reinterpret_cast<float2*>(hist), steps, sync,
              Hp, Wp, N, H, W, window, iters, pad, min_active, escape_fail,
              eps, eig_thresh};
  const int T = 2 * window + 1;
  const int pix = (T * T + 31) / 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (pix <= 12) e = launch<12>(a, batch, one_d, s);  // windows up to 9
  else if (pix <= kMaxPix) e = launch<kMaxPix>(a, batch, one_d, s);
  else e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
