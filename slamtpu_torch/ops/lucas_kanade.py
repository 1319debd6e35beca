"""Batched pyramidal Lucas-Kanade optical flow with forward-backward check.

Port of the parts of slamtpu/ops/lucas_kanade.py that the port's paths
run: `pinv2x2_sym`, the default level solver `_lk_level_patch_lanes`
(patch-cached: the first image's 6-map window and the second image's
(T+1+2R)^2 patch are gathered ONCE per level), the disparity-only level
`_lk_level_lanes_1d` of rectified stereo (`Params.stereo_klt_1d`), `lk_flow`,
the forward-backward `fb_track` of the multi-device step
(parallel/multi.py), and the compacted failed-prior retry cascade
`fb_retry_compact` (= `fb_cascade` = `fb_track_merged`, the names the JAX
package's callers use).

The level solvers are `lk_level` (2-D) and `lk_level_1d`: a CPU tensor
takes the plain version `lk_level_plain` / `lk_level_1d_plain` (tensor ops,
gathers by K1's plain version `gather_windows_plain`, one host sync per
solver iteration for the stop rule); a CUDA tensor launches the
hand-written level kernel slamtpu_torch/csrc/lk_level.cu in its 2-D or 1-D
mode (one plain launch per level, after one small memset: gathers into
registers and shared memory, the whole solver loop and its stop rule on
the device, with no grid barrier) or raises. On the card the cascade therefore issues no
host sync in either mode.

Batch axis. Every entry point also takes a leading batch of B sequences:
pyramid levels of (B, 6, Hp, Wp) stacks and (B, Hp, Wp) images (a batched
lk_pyramid_impl) with points, flows and masks (B, N, ...). On the card a
batched level is ONE launch over all B sequences, each with its own stop
rule, as the JAX package's `vmap` of its level while_loop gives; the plain
versions run one sequence after another. `fb_retry_compact` gives each
sequence its own RETRY_CAP retry lanes. The unbatched call is B = 1.

Semantics kept exactly, because results depend on them:
  - the level loop stops when at most min(lk_min_active, sum(ok) // 32)
    points still iterate (the JAX `lax.while_loop` condition, checked
    before every iteration);
  - a level entered with no live point leaves flow and ok unchanged (the
    gate only clears bits and 0 > min(min_active, 0) is false), which is
    what the JAX `lax.cond(any(ok))` skip gives, without a host branch;
    the 1-D level pins flow_y to 0 on every point even then, where the skip
    keeps it: only flows of dead points differ, which no caller reads;
  - the retry compaction scatters the non-retried rows into a dump row
    RETRY_CAP that is then dropped.

Layout: per-point windows are (N, T, T) (the JAX package's lane-major
(T, T, N) layout exists only for the TPU's 128 lanes). Window selection
inside the cached patch is an exact index gather where the JAX package
sums 2R + 1 masked shifts (each output is one input either way).
"""
from __future__ import annotations

import torch

from .. import kernels
from .image import pyramid_level_shape
from .window_gather import gather_windows_plain

LK_PATCH_MARGIN = 6

# Largest half-window the CUDA level kernel takes: each lane holds its
# T x T / 32 window pixels in registers, at most 32 of them.
LK_KERNEL_MAX_WINDOW = 15

# Lane budget of the compacted failed-prior retry cascade.
RETRY_CAP = 256


def lk_pad(window: int) -> int:
    """Image padding required by the LK level solver for a half-window."""
    return window + LK_PATCH_MARGIN + 2


def svd2x2_sym_eig(a, b, c):
    """Eigenvalues (descending) of the symmetric 2x2 [[a, b], [b, c]]."""
    half_tr = 0.5 * (a + c)
    disc = torch.sqrt(torch.square(0.5 * (a - c)) + torch.square(b))
    return half_tr + disc, half_tr - disc


def pinv2x2_sym(a, b, c, tol_scale: float = 1e-6):
    """Moore-Penrose pseudo-inverse of the symmetric 2x2 [[a, b], [b, c]]:
    singular values below tol_scale * s_max are zeroed, not inverted.
    Returns (ia, ib, ic, s1, s2)."""
    s1, s2 = svd2x2_sym_eig(a, b, c)
    theta = 0.5 * torch.atan2(2.0 * b, a - c)
    ct, st = torch.cos(theta), torch.sin(theta)
    tol = tol_scale * torch.maximum(torch.abs(s1), torch.abs(s2))
    zero = torch.zeros_like(s1)
    inv1 = torch.where(torch.abs(s1) > tol, 1.0 / s1, zero)
    inv2 = torch.where(torch.abs(s2) > tol, 1.0 / s2, zero)
    ia = inv1 * ct * ct + inv2 * st * st
    ib = (inv1 - inv2) * ct * st
    ic = inv1 * st * st + inv2 * ct * ct
    return ia, ib, ic, s1, s2


def _norm2(v):
    return torch.sqrt(torch.sum(v * v, dim=-1))


def lk_level_plain(d1, d2, p_lvl, flow, ok, *, hw, window, iters, eps,
                   eig_thresh, pad, min_active: int = 0,
                   escape_fail: bool = False):
    """Plain PyTorch version of one pyramid level for all N points (JAX
    `_lk_level_patch_lanes`): tensor ops, one host sync per iteration. No
    hand-written kernel runs in it, on any device.

    p_lvl: (N, 2) int32 level coordinates (y, x); flow: (N, 2) f32 at this
    level's scale; ok: (N,) bool. Returns (flow, ok). With a leading batch
    ((B, N, ...) and a batched level), one call a sequence, stacked.
    """
    if p_lvl.dim() == 3:
        return _per_sequence(lk_level_plain, d1, d2, p_lvl, flow, ok,
                             hw=hw, window=window, iters=iters, eps=eps,
                             eig_thresh=eig_thresh, pad=pad,
                             min_active=min_active, escape_fail=escape_fail)
    H, W = hw
    w = window
    T = 2 * w + 1
    R = LK_PATCH_MARGIN
    P = T + 1 + 2 * R
    n = p_lvl.shape[0]
    dev = flow.device

    offs = torch.arange(-w, w + 1, dtype=torch.float32, device=dev)
    oy = offs[None, :, None]            # (1, T, 1)
    ox = offs[None, None, :]            # (1, 1, T)

    start = p_lvl - w + pad
    stack_w = gather_windows_plain(d1["stack"], start, T, T)  # (N,6,T,T)
    img1_w, iy_w, ix_w = stack_w[:, 0], stack_w[:, 1], stack_w[:, 2]
    gyy_w, gxx_w, gyx_w = stack_w[:, 3], stack_w[:, 4], stack_w[:, 5]

    p_f = p_lvl.to(torch.float32)
    hmax, wmax = float(H - 1), float(W - 1)

    def in_bounds(q):
        return ((q[:, 0] >= 0.0) & (q[:, 0] <= hmax)
                & (q[:, 1] >= 0.0) & (q[:, 1] <= wmax))

    def window_mask(q):
        up = torch.floor(torch.clamp(torch.minimum(p_f[:, 0], q[:, 0]),
                                     max=float(w)))
        down = torch.floor(torch.clamp(
            hmax - torch.maximum(p_f[:, 0], q[:, 0]), max=float(w)))
        left = torch.floor(torch.clamp(torch.minimum(p_f[:, 1], q[:, 1]),
                                       max=float(w)))
        right = torch.floor(torch.clamp(
            wmax - torch.maximum(p_f[:, 1], q[:, 1]), max=float(w)))
        my = (oy >= -up[:, None, None]) & (oy <= down[:, None, None])
        mx = (ox >= -left[:, None, None]) & (ox <= right[:, None, None])
        return (my & mx).to(torch.float32)  # (N, T, T)

    def wsum(x):
        return torch.sum(x, dim=(1, 2))

    q0 = p_f + flow
    q0_safe = torch.where(in_bounds(q0)[:, None], q0, p_f)
    base = torch.floor(q0_safe).to(torch.int32) - w - R + pad
    patch = gather_windows_plain(d2["img"][None], base, P, P)[:, 0]

    # Mask + structure tensor once per level, clamped at the entry
    # correspondence (reference lucas_kanade.jl:58-72).
    mask = window_mask(q0_safe)
    ia, ib, ic, _, s2 = pinv2x2_sym(wsum(gyy_w * mask), wsum(gyx_w * mask),
                                    wsum(gxx_w * mask))
    min_eig = s2 / torch.clamp(wsum(mask), min=1.0)
    ok = ok & (min_eig >= eig_thresh)

    rows = torch.arange(n, device=dev)[:, None, None]
    steps = torch.arange(T + 1, device=dev)

    stop_thresh = min(min_active, int(ok.sum()) // 32)
    running = ok.clone()
    it = 0
    while it < iters and int(running.sum()) > stop_thresh:
        q = p_f + flow
        inb = in_bounds(q)
        fail = running & ~inb
        q_safe = torch.where(inb[:, None], q, p_f)
        q_floor = torch.floor(q_safe)
        frac = q_safe - q_floor
        rel = q_floor.to(torch.int32) - w + pad - base
        # A point drifting past the patch margin freezes (keeps its last
        # in-margin flow); in the backward pass it fails instead.
        escaped = ((rel[:, 0] < 0) | (rel[:, 0] > 2 * R)
                   | (rel[:, 1] < 0) | (rel[:, 1] > 2 * R))
        if escape_fail:
            fail = fail | (running & escaped)
        rel = torch.clamp(rel, 0, 2 * R).long()

        big = patch[rows, (rel[:, 0, None] + steps)[:, :, None],
                    (rel[:, 1, None] + steps)[:, None, :]]  # (N, T+1, T+1)
        fy = frac[:, 0][:, None, None]
        fx = frac[:, 1][:, None, None]
        img2_s = (
            (1.0 - fy) * (1.0 - fx) * big[:, :T, :T]
            + (1.0 - fy) * fx * big[:, :T, 1:]
            + fy * (1.0 - fx) * big[:, 1:, :T]
            + fy * fx * big[:, 1:, 1:]
        )

        diff = (img1_w - img2_s) * mask
        by = wsum(diff * iy_w)
        bx = wsum(diff * ix_w)
        step_y = ia * by + ib * bx
        step_x = ib * by + ic * bx

        converged = (torch.abs(step_y) < eps) & (torch.abs(step_x) < eps)
        new_flow = flow + torch.stack([step_y, step_x], dim=-1)
        fail = fail | (running & ~converged & ~in_bounds(p_f + new_flow))

        advance = running & ~fail & ~converged & ~escaped
        flow = torch.where(advance[:, None], new_flow, flow)
        ok = ok & ~fail
        running = running & ok & ~converged & ~escaped
        it += 1
    return flow, ok


def _per_sequence(level_fn, d1, d2, p_lvl, flow, ok, **kw):
    """A plain level over a leading batch: one call a sequence, stacked."""
    outs = [level_fn({"stack": d1["stack"][b]}, {"img": d2["img"][b]},
                     p_lvl[b], flow[b], ok[b], **kw)
            for b in range(p_lvl.shape[0])]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))


def _check_level(d1, d2, p_lvl, flow, ok, hw, window, pad):
    stack, img = d1["stack"], d2["img"]
    lead = tuple(p_lvl.shape[:-2])          # () or (B,)
    if p_lvl.dim() not in (2, 3) or stack.dim() != 3 + len(lead) \
            or tuple(stack.shape[:-3]) != lead or stack.shape[-3] != 6 \
            or tuple(img.shape) != lead + tuple(stack.shape[-2:]):
        raise ValueError(
            f"lk_level: stack ([B,] 6, Hp, Wp) and img ([B,] Hp, Wp) with "
            f"the points' batch expected, got {tuple(stack.shape)} and "
            f"{tuple(img.shape)} for p_lvl {tuple(p_lvl.shape)}")
    n = p_lvl.shape[-2]
    if tuple(p_lvl.shape) != lead + (n, 2) \
            or tuple(flow.shape) != lead + (n, 2) \
            or tuple(ok.shape) != lead + (n,):
        raise ValueError(
            f"lk_level: p_lvl ([B,] N, 2), flow ([B,] N, 2), ok ([B,] N) "
            f"expected, got {tuple(p_lvl.shape)}, {tuple(flow.shape)}, "
            f"{tuple(ok.shape)}")
    if stack.dtype != torch.float32 or img.dtype != torch.float32 \
            or flow.dtype != torch.float32 or p_lvl.dtype != torch.int32 \
            or ok.dtype != torch.bool:
        raise TypeError(
            "lk_level: float32 stack, img and flow, int32 p_lvl and bool ok "
            f"expected, got {stack.dtype}, {img.dtype}, {flow.dtype}, "
            f"{p_lvl.dtype}, {ok.dtype}")
    if not (stack.device == img.device == p_lvl.device == flow.device
            == ok.device):
        raise ValueError("lk_level: inputs on different devices")
    hp, wp = stack.shape[-2:]
    t = 2 * window + 1
    if tuple(hw) != (hp - 2 * pad, wp - 2 * pad) \
            or not t + 1 + 2 * LK_PATCH_MARGIN <= min(hp, wp):
        raise ValueError(
            f"lk_level: level {tuple(hw)} with pad {pad} and window {window} "
            f"does not fit a ({hp}, {wp}) padded map")


def lk_level_cuda(d1, d2, p_lvl, flow, ok, *, hw, window, iters, eps,
                  eig_thresh, pad, min_active: int = 0,
                  escape_fail: bool = False, return_counts: bool = False,
                  one_d: bool = False):
    """Launch the level kernel, in its 1-D mode with one_d (no checks
    beyond the wrapper's): one launch for N points, or for B sequences of
    N points each with (B, ...) inputs. With return_counts, also each
    sequence's stop-rule running counts before each iteration, counts
    ([B,] iters + 1) int32 (counts[..., 0]: the points alive after the
    gate), and K, the iterations the level ran ([B] int32), both on the
    device (see lk_level.cu)."""
    stack, img = d1["stack"], d2["img"]
    batched = p_lvl.dim() == 3
    bsz = p_lvl.shape[0] if batched else 1
    n = p_lvl.shape[-2]
    iters = int(iters)
    dev = flow.device
    flow_out = torch.empty_like(flow)
    ok_out = torch.empty_like(ok)
    # Per-point flow after each iteration and iterations run; each
    # sequence's zeroed words hold its histogram and ticket, then the
    # kernel's counts and K (one memset for the batch).
    hist = torch.empty(bsz * (iters + 1) * n * 2, dtype=torch.float32,
                       device=dev)
    steps = torch.empty(bsz * n, dtype=torch.int32, device=dev)
    sync = torch.zeros((bsz, 2 * iters + 5), dtype=torch.int32, device=dev)
    if n and bsz:
        lib = kernels.library()
        h, w = hw
        code = lib.slamtpu_lk_level(
            stack.data_ptr(), img.data_ptr(), p_lvl.data_ptr(),
            flow.data_ptr(), ok.data_ptr(), flow_out.data_ptr(),
            ok_out.data_ptr(), hist.data_ptr(), steps.data_ptr(),
            sync.data_ptr(), bsz, stack.stride(0) if batched else 0,
            img.stride(0) if batched else 0, stack.shape[-2],
            stack.shape[-1], n, int(h), int(w), int(window), iters,
            int(pad), int(min_active), int(bool(escape_fail)),
            int(bool(one_d)), float(eps), float(eig_thresh),
            kernels.stream_ptr(dev),
        )
        kernels.check(code, "slamtpu_lk_level")
        if one_d:
            kernels.count_launch(lk_level_1d)
        else:
            kernels.count_launch(lk_level)
    if return_counts:
        counts, k = sync[:, iters + 3:2 * iters + 4], sync[:, 2 * iters + 4]
        if not batched:
            counts, k = counts[0], k[0]
        return flow_out, ok_out, counts, k
    return flow_out, ok_out


def _planes_contiguous(x, dims: int) -> bool:
    """Whether x's last `dims` axes are laid out contiguously (its batch
    axis may have any stride)."""
    expect = 1
    for size, stride in zip(reversed(x.shape[-dims:]),
                            reversed(x.stride()[-dims:])):
        if size > 1 and stride != expect:
            return False
        expect *= size
    return True


def _route_level(d1, d2, p_lvl, flow, ok, hw, window, pad) -> str:
    """Check a level call's inputs; "cpu" for the plain version, "cuda" for
    the kernel, raise for anything else."""
    _check_level(d1, d2, p_lvl, flow, ok, hw, window, pad)
    if flow.device.type == "cpu":
        return "cpu"
    if flow.device.type != "cuda":
        raise RuntimeError(f"lk_level: unsupported device {flow.device}")
    if not (all(x.is_contiguous() for x in (p_lvl, flow, ok))
            and _planes_contiguous(d1["stack"], 3)
            and _planes_contiguous(d2["img"], 2)):
        raise ValueError("lk_level: inputs must be contiguous (a batched "
                         "stack and image in each sequence's planes)")
    if p_lvl.dim() == 3 and p_lvl.shape[0] > 65535:
        raise ValueError(f"lk_level: at most 65535 sequences a launch, got "
                         f"{p_lvl.shape[0]}")
    if window > LK_KERNEL_MAX_WINDOW:
        raise ValueError(f"lk_level: the level kernel takes windows up to "
                         f"{LK_KERNEL_MAX_WINDOW}, got {window}")
    return "cuda"


def lk_level(d1, d2, p_lvl, flow, ok, *, hw, window, iters, eps,
             eig_thresh, pad, min_active: int = 0, escape_fail: bool = False):
    """One pyramid level for all N points ([B,] N, ...) -> (flow, ok). CPU
    tensors take lk_level_plain; CUDA tensors launch the level kernel once
    (for the whole batch) or raise."""
    kw = dict(hw=hw, window=window, iters=iters, eps=eps,
              eig_thresh=eig_thresh, pad=pad, min_active=min_active,
              escape_fail=escape_fail)
    if _route_level(d1, d2, p_lvl, flow, ok, hw, window, pad) == "cpu":
        return lk_level_plain(d1, d2, p_lvl, flow, ok, **kw)
    return lk_level_cuda(d1, d2, p_lvl, flow, ok, **kw)


# Launches of the CUDA level kernel in this process; the CPU path never
# counts.
lk_level.launches = 0


def lk_level_1d_plain(d1, d2, p_lvl, flow, ok, *, hw, window, iters, eps,
                      eig_thresh, pad, min_active: int = 0,
                      escape_fail: bool = False):
    """Plain PyTorch version of the disparity-only level for rectified
    stereo (JAX `_lk_level_lanes_1d`): flow_y is pinned to 0, the step is
    the scalar inv_sxx * b_x, the gate sxx / count >= eig_thresh, the patch
    (T, P) keeps its rows at the template rows, sampling has 2 taps, and
    escape, convergence and bounds act on x only. Same stop rule as the 2-D
    level. No hand-written kernel runs in it, on any device.

    p_lvl: (N, 2) int32 (y, x); flow: (N, 2) f32; ok: (N,) bool. Returns
    (flow with flow_y = 0, ok). With a leading batch, one call a sequence.
    """
    if p_lvl.dim() == 3:
        return _per_sequence(lk_level_1d_plain, d1, d2, p_lvl, flow, ok,
                             hw=hw, window=window, iters=iters, eps=eps,
                             eig_thresh=eig_thresh, pad=pad,
                             min_active=min_active, escape_fail=escape_fail)
    H, W = hw
    w = window
    T = 2 * w + 1
    R = LK_PATCH_MARGIN
    P = T + 1 + 2 * R
    n = p_lvl.shape[0]
    dev = flow.device

    flow = flow * torch.tensor([0.0, 1.0], dtype=torch.float32, device=dev)
    start = p_lvl - w + pad
    stack_w = gather_windows_plain(d1["stack"], start, T, T)  # (N,6,T,T)
    img1_w, ix_w, gxx_w = stack_w[:, 0], stack_w[:, 2], stack_w[:, 4]

    p_f = p_lvl.to(torch.float32)
    px_f = p_f[:, 1]
    hmax, wmax = float(H - 1), float(W - 1)
    offs = torch.arange(-w, w + 1, dtype=torch.float32, device=dev)

    # The row clamp depends on p only (y never moves).
    up = torch.clamp(p_f[:, 0], max=float(w))
    down = torch.clamp(hmax - p_f[:, 0], max=float(w))
    my = ((offs[None, :] >= -up[:, None])
          & (offs[None, :] <= down[:, None]))[:, :, None]   # (N, T, 1)

    def window_mask(qx):
        left = torch.floor(torch.clamp(torch.minimum(px_f, qx), max=float(w)))
        right = torch.floor(torch.clamp(wmax - torch.maximum(px_f, qx),
                                        max=float(w)))
        mx = ((offs[None, :] >= -left[:, None])
              & (offs[None, :] <= right[:, None]))[:, None, :]  # (N, 1, T)
        return (my & mx).to(torch.float32)

    def in_bounds_x(qx):
        return (qx >= 0.0) & (qx <= wmax)

    def wsum(x):
        return torch.sum(x, dim=(1, 2))

    qx0 = px_f + flow[:, 1]
    qx0_safe = torch.where(in_bounds_x(qx0), qx0, px_f)
    base_x = torch.floor(qx0_safe).to(torch.int32) - w - R + pad
    patch = gather_windows_plain(
        d2["img"][None], torch.stack([start[:, 0], base_x], dim=-1), T, P,
    )[:, 0]                                                  # (N, T, P)

    mask = window_mask(qx0_safe)
    sxx = wsum(gxx_w * mask)
    count = wsum(mask)
    inv_sxx = torch.where(sxx > 1e-12, 1.0 / torch.clamp(sxx, min=1e-12),
                          torch.zeros_like(sxx))
    ok = ok & ((sxx / torch.clamp(count, min=1.0)) >= eig_thresh)

    rows = torch.arange(n, device=dev)[:, None, None]
    trow = torch.arange(T, device=dev)[None, :, None]
    steps = torch.arange(T + 1, device=dev)

    fx = flow[:, 1]
    stop_thresh = min(min_active, int(ok.sum()) // 32)
    running = ok.clone()
    it = 0
    while it < iters and int(running.sum()) > stop_thresh:
        qx = px_f + fx
        inb = in_bounds_x(qx)
        fail = running & ~inb
        qx_safe = torch.where(inb, qx, px_f)
        qx_floor = torch.floor(qx_safe)
        frac = (qx_safe - qx_floor)[:, None, None]
        rel = qx_floor.to(torch.int32) - w + pad - base_x
        escaped = (rel < 0) | (rel > 2 * R)
        if escape_fail:
            fail = fail | (running & escaped)
        rel = torch.clamp(rel, 0, 2 * R).long()

        big = patch[rows, trow, (rel[:, None] + steps)[:, None, :]]
        img2_s = (1.0 - frac) * big[:, :, :T] + frac * big[:, :, 1:]
        bx = wsum((img1_w - img2_s) * mask * ix_w)
        step_x = inv_sxx * bx

        converged = torch.abs(step_x) < eps
        new_fx = fx + step_x
        fail = fail | (running & ~converged & ~in_bounds_x(px_f + new_fx))

        advance = running & ~fail & ~converged & ~escaped
        fx = torch.where(advance, new_fx, fx)
        ok = ok & ~fail
        running = running & ok & ~converged & ~escaped
        it += 1
    return torch.stack([torch.zeros_like(fx), fx], dim=-1), ok


def lk_level_1d(d1, d2, p_lvl, flow, ok, *, hw, window, iters, eps,
                eig_thresh, pad, min_active: int = 0,
                escape_fail: bool = False):
    """One disparity-only pyramid level for all N points ([B,] N, ...) ->
    (flow, ok). CPU tensors take lk_level_1d_plain; CUDA tensors launch the
    level kernel's 1-D mode once or raise."""
    kw = dict(hw=hw, window=window, iters=iters, eps=eps,
              eig_thresh=eig_thresh, pad=pad, min_active=min_active,
              escape_fail=escape_fail)
    if _route_level(d1, d2, p_lvl, flow, ok, hw, window, pad) == "cpu":
        return lk_level_1d_plain(d1, d2, p_lvl, flow, ok, **kw)
    return lk_level_cuda(d1, d2, p_lvl, flow, ok, one_d=True, **kw)


# Launches of the level kernel's 1-D mode in this process; the CPU path
# never counts.
lk_level_1d.launches = 0


def lk_flow(pyr1, pyr2, points, displacement, valid, *, levels, window,
            iters, eps, eig_thresh, pad, min_active: int = 0,
            escape_fail: bool = False, one_d: bool = False):
    """Pyramidal LK for N points (reference lucas_kanade.jl:9-100).

    points: ([B,] N, 2) f32 full-resolution (y, x), with a pyramid of the
    same batch; displacement: ([B,] N, 2) prior in COARSEST-level units;
    one_d selects the disparity-only level. Returns (flow at level-0 scale,
    status).
    """
    level_fn = lk_level_1d if one_d else lk_level
    flow = displacement.to(torch.float32)
    ok = valid
    for level in range(levels, -1, -1):
        d1, d2 = pyr1[level], pyr2[level]
        p_lvl = torch.floor(points / (2.0 ** level)).to(torch.int32)
        flow, ok = level_fn(
            d1, d2, p_lvl, flow, ok, hw=pyramid_level_shape(d1, pad),
            window=window, iters=iters, eps=eps, eig_thresh=eig_thresh,
            pad=pad, min_active=min_active, escape_fail=escape_fail,
        )
        if level > 0:
            flow = flow * 2.0
    return flow, ok


def fb_track(pyr_prev, pyr_cur, points, displacement, valid, *, levels,
             window, iters=30, eps=1e-2, eig_thresh=1e-4, pad=11,
             max_distance=1.0, min_active=0):
    """Forward-backward KLT (reference src/tracker.jl:17-68).

    Forward over `levels` pyramid levels with the displacement prior, then
    backward at level 0 only (tracker.jl:34), keeping points whose round trip
    lands within `max_distance` of the original.

    Returns (new_points ([B,] N, 2), status ([B,] N)).
    """
    kw = dict(window=window, iters=iters, eps=eps, eig_thresh=eig_thresh,
              pad=pad, min_active=min_active)
    flow_f, status = lk_flow(pyr_prev, pyr_cur, points, displacement, valid,
                             levels=levels, **kw)
    new_points = points + flow_f
    flow_b, bstatus = lk_flow(pyr_cur, pyr_prev, new_points, -flow_f, status,
                              levels=0, escape_fail=True, **kw)
    dist = _norm2(points - (new_points + flow_b))
    return new_points, status & bstatus & (dist < max_distance)


def fb_retry_compact(pyr_prev, pyr_cur, px, prior_mask, disp_prior, valid,
                     *, levels, prior_level=1, window=9, iters=30, eps=1e-2,
                     eig_thresh=1e-4, pad=17, max_distance=1.0,
                     min_active=0, one_d=False, retry_base=None):
    """Forward-backward KLT for both tracking families + compacted retry.

    Plain points enter at the coarsest level; prior points are injected at
    `prior_level` with their displacement prior (map_manager.jl:458,466).
    Prior points whose forward-backward track failed are re-tracked as
    plain points in a RETRY_CAP-lane second cascade (map_manager.jl:
    534-537); overflowing points simply fail. one_d runs every level,
    backward pass included, as the disparity-only level (rectified stereo).

    `retry_base`: for one shard of a larger keypoint set, a function from
    the shard's count of failed priors to the count in the shards before
    it, so that the lanes go to the first RETRY_CAP failed priors of the
    whole set (parallel/multi.py); None for a whole set.

    Batched ((B, N, ...) points with batched pyramids): each sequence has
    its own RETRY_CAP lanes, and `retry_base` maps the (B,) counts to (B,).

    Returns (new_px, ok, tracked_with_prior).
    """
    level_fn = lk_level_1d if one_d else lk_level
    level_kw = dict(window=window, iters=iters, eps=eps,
                    eig_thresh=eig_thresh, pad=pad)

    def cascade(px_c, active0, inject_mask, inject_disp):
        flow = torch.zeros_like(px_c)
        ok = active0
        for level in range(levels, -1, -1):
            if inject_mask is not None and level == prior_level:
                flow = torch.where((inject_mask & ~active0)[..., None],
                                   inject_disp, flow)
                ok = ok | inject_mask
            d1, d2 = pyr_prev[level], pyr_cur[level]
            p_lvl = torch.floor(px_c / (2.0 ** level)).to(torch.int32)
            flow, ok = level_fn(
                d1, d2, p_lvl, flow, ok, hw=pyramid_level_shape(d1, pad),
                min_active=min_active, **level_kw,
            )
            if level > 0:
                flow = flow * 2.0
        return flow, ok

    def backward(px_c, flow_f, st):
        flow_b, bst = lk_flow(
            pyr_cur, pyr_prev, px_c + flow_f, -flow_f, st, levels=0,
            min_active=min_active, escape_fail=True, one_d=one_d, **level_kw,
        )
        return st & bst & (_norm2(flow_f + flow_b) < max_distance)

    plain = valid & ~prior_mask
    prior = valid & prior_mask

    flow_m, ok_m = cascade(px, plain, prior, disp_prior)
    okfb_m = backward(px, flow_m, ok_m)

    # Compact each sequence's failed priors into its RETRY_CAP lanes; every
    # other row scatters into the dump row RETRY_CAP, which is dropped.
    retry_mask = prior & ~okfb_m
    rank = torch.cumsum(retry_mask.to(torch.int64), -1) - retry_mask.long()
    if retry_base is not None:
        rank = rank + retry_base(retry_mask.sum(-1))[..., None]
    in_cap = retry_mask & (rank < RETRY_CAP)
    slot = torch.where(in_cap, rank, torch.full_like(rank, RETRY_CAP))
    lead = tuple(px.shape[:-2])
    seq = () if not lead else \
        (torch.arange(lead[0], device=px.device)[:, None],)
    px_r = torch.zeros(lead + (RETRY_CAP + 1, 2), dtype=px.dtype,
                       device=px.device)
    px_r[seq + (slot,)] = px
    valid_r = torch.zeros(lead + (RETRY_CAP + 1,), dtype=torch.bool,
                          device=px.device)
    valid_r[seq + (slot,)] = in_cap
    px_r = px_r[..., :RETRY_CAP, :].contiguous()
    valid_r = valid_r[..., :RETRY_CAP].contiguous()
    flow_r, ok_r = cascade(px_r, valid_r, None, None)
    okfb_r = backward(px_r, flow_r, ok_r)

    lanes = seq + (torch.clamp(rank, 0, RETRY_CAP - 1),)
    use_retry = in_cap & okfb_r[lanes]
    new_px = torch.where(use_retry[..., None], px + flow_r[lanes],
                         px + flow_m)
    ok = (okfb_m | use_retry) & valid
    return new_px, ok, prior & okfb_m


# The JAX package's production entry points for this cascade: `fb_cascade`
# (inside the fused programs) and the jitted `fb_track_merged`.
fb_cascade = fb_retry_compact
fb_track_merged = fb_retry_compact
