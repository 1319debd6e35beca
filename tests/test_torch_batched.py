"""The port's batch axis over sequences (the JAX package's `vmap` in
slamtpu/parallel/multi.py): the level solvers, the pyramid, the LK
cascades, the threefry twin's tensor keys and the two multi-device tracking
steps, each batched call against the same call on every sequence alone and,
where the JAX package has one, against the JAX package.

Sizes: B = 3 sequences of 48 x 64 images and N = 64 points
(tests/test_parallel.py's), levels 2, window 5. Tolerances:
  - level solvers, pyramid, fb_track, fb_retry_compact: bit-exact against
    the sequences alone (the plain level runs one sequence after another;
    every other op is elementwise or a gather);
  - threefry: bit-exact against per-key calls; bits, fold_in and uniform
    bit-exact against jax.random under vmap, gumbel within
    tests/test_torch_geometry.py's 1e-6 (the two logs differ by an ulp);
  - multi_sequence_step (tests/test_torch_parallel.py's): ok equal, points
    within 1e-3 px, theta within 1e-3;
  - frontend_mesh_step (tests/test_parallel.py:43-50's): ok equal, new_px
    within 1e-3 px, pnp_theta within 1e-2, P3P inlier counts equal.
"""
import functools

import numpy as np
import pytest
import torch

from slamtpu_torch import random as trandom
from slamtpu_torch.ops import lucas_kanade as lk
from slamtpu_torch.ops.image import lk_pyramid_impl, pyramid_level_shape
from slamtpu_torch.parallel import launch
from slamtpu_torch.parallel import multi

torch.set_num_threads(2)

B, N, H, W = 3, 64, 48, 64
LEVELS, WINDOW = 2, 5
PAD = lk.lk_pad(WINDOW)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@functools.lru_cache(maxsize=None)
def _frames(seed=3):
    """make_frontend_inputs' blob frames, the current one shifted 1 px up
    and 1 px left, and their points."""
    args = multi.make_frontend_inputs(B, N, H, W, seed=seed)
    img_prev = args[0]
    img_cur = np.roll(img_prev, (-1, -1), axis=(1, 2))
    return img_prev, img_cur, args[2]


@functools.lru_cache(maxsize=None)
def _pyramids():
    img_prev, img_cur, _ = _frames()
    return tuple(lk_pyramid_impl(_t(im), levels=LEVELS, pad=PAD)
                 for im in (img_prev, img_cur))


def _sequence(pyr, b):
    return tuple({k: v[b] for k, v in lvl.items()} for lvl in pyr)


def test_batched_pyramid_equals_single_ones():
    """Bit-exact, every level and every map, at two torch thread counts."""
    img_prev = _frames()[0]
    for threads in (1, 4):
        torch.set_num_threads(threads)
        try:
            batched = lk_pyramid_impl(_t(img_prev), levels=LEVELS, pad=PAD)
            for b in range(B):
                single = lk_pyramid_impl(_t(img_prev[b]), levels=LEVELS,
                                         pad=PAD)
                for lvl_b, lvl_1 in zip(batched, single):
                    assert lvl_b["stack"].shape[0] == B
                    for k in lvl_1:
                        assert torch.equal(lvl_b[k][b], lvl_1[k]), (b, k)
        finally:
            torch.set_num_threads(2)


def _level_case(level, seed):
    """(B, N) level inputs: sequence 0 mostly alive, sequence 1 all dead,
    sequence 2 a quarter alive."""
    rng = np.random.default_rng(seed)
    px = _frames()[2] + rng.normal(0.0, 0.5, (B, N, 2))
    p_lvl = np.floor(px / 2.0 ** level).astype(np.int32)
    flow = rng.normal(0.0, 0.6, (B, N, 2)).astype(np.float32)
    ok = np.stack([rng.uniform(size=N) < 0.9, np.zeros(N, bool),
                   rng.uniform(size=N) < 0.25])
    return _t(p_lvl), _t(flow), _t(ok)


@pytest.mark.parametrize("one_d", [False, True])
@pytest.mark.parametrize("level", [0, LEVELS])
@pytest.mark.parametrize("min_active", [0, 16])
def test_batched_plain_level_equals_per_sequence(one_d, level, min_active):
    """lk_level_plain / lk_level_1d_plain (and lk_level / lk_level_1d,
    which route a CPU tensor there) on (B, ...) inputs give, bit for bit,
    the calls on each sequence alone; the all-dead sequence keeps its
    flow (x in 1-D) and ok."""
    pyr1, pyr2 = _pyramids()
    d1, d2 = pyr1[level], pyr2[level]
    p_lvl, flow, ok = _level_case(level, seed=level + 10 * min_active)
    kw = dict(hw=pyramid_level_shape(d1, PAD), window=WINDOW, iters=30,
              eps=1e-2, eig_thresh=1e-4, pad=PAD, min_active=min_active)
    plain = lk.lk_level_1d_plain if one_d else lk.lk_level_plain
    routed = lk.lk_level_1d if one_d else lk.lk_level
    out = plain(d1, d2, p_lvl, flow, ok, **kw)
    assert torch.equal(out[0], routed(d1, d2, p_lvl, flow, ok, **kw)[0])
    for b in range(B):
        one = plain({"stack": d1["stack"][b]}, {"img": d2["img"][b]},
                    p_lvl[b], flow[b], ok[b], **kw)
        assert torch.equal(out[0][b], one[0]) and torch.equal(out[1][b],
                                                              one[1]), b
    assert out[1][0].sum() > 0 and not out[1][1].any()
    assert torch.equal(out[0][1, :, 1], flow[1, :, 1])


def test_level_refuses_a_mismatched_batch():
    pyr1, pyr2 = _pyramids()
    p_lvl, flow, ok = _level_case(0, seed=1)
    kw = dict(hw=pyramid_level_shape(pyr1[0], PAD), window=WINDOW, iters=30,
              eps=1e-2, eig_thresh=1e-4, pad=PAD)
    with pytest.raises(ValueError, match="points' batch"):
        lk.lk_level(pyr1[0], pyr2[0], p_lvl[:2], flow[:2], ok[:2], **kw)
    with pytest.raises(ValueError, match="expected"):
        lk.lk_level(pyr1[0], pyr2[0], p_lvl, flow[:, :5], ok, **kw)


RETRY_N = 640


def _cascade_inputs(seed=4):
    """(B, N) points with priors; sequence 1 has more than RETRY_CAP failed
    priors (RETRY_N points, each a prior 6 px off), sequence 0 a few bad
    priors, sequence 2 none."""
    n = RETRY_N
    rng = np.random.default_rng(seed)
    px = np.stack([rng.uniform(8, H - 8, (B, n)),
                   rng.uniform(8, W - 8, (B, n))], -1).astype(np.float32)
    prior = np.zeros((B, n), bool)
    prior[0, : n // 4] = True
    prior[1] = True
    disp = np.zeros((B, n, 2), np.float32)
    disp[0, : n // 8] = [0.5, -0.5]
    disp[0, n // 8: n // 4] = [5.0, 5.0]
    disp[1] = 6.0
    valid = rng.uniform(size=(B, n)) < 0.95
    return tuple(_t(a) for a in (px, prior, disp, valid))


def _retry_kw(**kw):
    return dict(levels=LEVELS, prior_level=1, window=WINDOW, pad=PAD,
                max_distance=1.0, min_active=0, **kw)


def test_batched_fb_track_equals_per_sequence():
    pyr1, pyr2 = _pyramids()
    px, _, _, valid = _cascade_inputs()
    kw = dict(levels=LEVELS, window=WINDOW, pad=PAD, max_distance=1.0,
              min_active=16)
    new_px, ok = lk.fb_track(pyr1, pyr2, px, torch.zeros_like(px), valid,
                             **kw)
    for b in range(B):
        one = lk.fb_track(_sequence(pyr1, b), _sequence(pyr2, b), px[b],
                          torch.zeros_like(px[b]), valid[b], **kw)
        assert torch.equal(new_px[b], one[0]) and torch.equal(ok[b], one[1])
    assert ok.sum() > 0.5 * valid.sum()


def test_batched_fb_retry_compact_equals_per_sequence():
    """Each sequence has its own RETRY_CAP lanes: sequence 1 overflows them
    and the batch still gives every sequence's bits alone."""
    pyr1, pyr2 = _pyramids()
    args = _cascade_inputs()
    out = lk.fb_retry_compact(pyr1, pyr2, *args, **_retry_kw())
    for b in range(B):
        one = lk.fb_retry_compact(_sequence(pyr1, b), _sequence(pyr2, b),
                                  *(a[b] for a in args), **_retry_kw())
        for got, want in zip(out, one):
            assert torch.equal(got[b], want), b
    failed = args[1][1] & ~out[2][1]
    assert failed.sum() > lk.RETRY_CAP
    retried = out[1][1] & failed
    assert retried.any()


def test_batched_retry_base_is_per_sequence():
    """Two halves of every sequence's keypoints, the second told how many
    failed priors precede it in each sequence ((B,) -> (B,)), give the
    bits of the whole batch."""
    pyr1, pyr2 = _pyramids()
    args = _cascade_inputs()
    whole = lk.fb_retry_compact(pyr1, pyr2, *args, **_retry_kw())
    half = RETRY_N // 2
    counts = []

    def first_base(n):
        assert n.shape == (B,)
        counts.append(n)
        return torch.zeros_like(n)

    first = lk.fb_retry_compact(pyr1, pyr2, *(a[:, :half] for a in args),
                                **_retry_kw(retry_base=first_base))
    second = lk.fb_retry_compact(pyr1, pyr2, *(a[:, half:] for a in args),
                                 **_retry_kw(retry_base=lambda n: counts[0]))
    for got, want in zip(zip(first, second), whole):
        assert torch.equal(torch.cat(got, dim=1), want)
    assert counts[0][1] > 0 and counts[0][1] != counts[0][2]


def test_level_calls_per_step_do_not_depend_on_batch(monkeypatch):
    """Both tracking steps call the level solver as often at B = 3 as at
    B = 1: one call (one launch on the card) a level for the whole batch."""
    calls = []
    level = lk.lk_level

    def counting(*a, **kw):
        calls.append(a[2].shape)
        return level(*a, **kw)

    monkeypatch.setattr(lk, "lk_level", counting)
    ms_args = _ms_inputs()
    fe_args = multi.make_frontend_inputs(B, N, H, W, seed=3)
    counts = {}
    with launch.one_rank("cpu"):
        mesh = multi.make_mesh(1)
        for name, build, args in (
                ("ms", multi.multi_sequence_step, ms_args),
                ("fe", multi.frontend_mesh_step, fe_args)):
            for bsz in (1, B):
                calls.clear()
                build(mesh)(*_batch_slice(args, slice(0, bsz)))
                counts[name, bsz] = len(calls)
                assert all(shape[0] == bsz for shape in calls)
    assert counts["ms", 1] == counts["ms", B] == 4    # 3 forward, 1 back
    assert counts["fe", 1] == counts["fe", B] == 8    # 3 + 1, twice


# -- the threefry twin's tensor keys -------------------------------------

KEYS = np.array([[0, 0], [0, 1], [0, 2], [7, 2 ** 32 - 1], [2 ** 31, 12345]],
                np.uint32)


def _jax_keys():
    import jax.numpy as jnp

    return jnp.asarray(KEYS)


def test_tensor_keys_equal_per_key_bits():
    keys = _t(KEYS.astype(np.int64))
    shape = (4, 5)
    for fn in (trandom.random_bits, trandom.uniform, trandom.gumbel):
        batched = fn(keys, shape, "cpu")
        assert batched.shape == (len(KEYS),) + shape
        for b, key in enumerate(KEYS):
            assert torch.equal(batched[b], fn(tuple(key), shape, "cpu"))
    folded = trandom.fold_in(keys, 1)
    for b, key in enumerate(KEYS):
        assert tuple(int(v) for v in folded[b]) == trandom.fold_in(key, 1)
    # Under torch.func.vmap a key is one (2,) slice of the batch.
    vm = torch.func.vmap(lambda k: trandom.gumbel(
        trandom.fold_in(k, 1), shape, "cpu"))(keys)
    assert torch.equal(vm, trandom.gumbel(folded, shape, "cpu"))


def test_tensor_keys_equal_jax_random_under_vmap():
    import jax

    keys, jkeys = _t(KEYS.astype(np.int64)), _jax_keys()
    shape = (3, 64)
    tiny = float(np.finfo(np.float32).tiny)
    for lo in (0.0, tiny):
        np.testing.assert_array_equal(
            trandom.uniform(keys, shape, "cpu", lo, 1.0).numpy(),
            np.asarray(jax.vmap(lambda k: jax.random.uniform(
                k, shape, minval=lo, maxval=1.0))(jkeys)))
    # test_torch_geometry.py's bound: the two logs differ by an ulp.
    np.testing.assert_allclose(
        trandom.gumbel(keys, shape, "cpu").numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, shape))(jkeys)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        trandom.fold_in(keys, 1).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.fold_in(k, 1))(jkeys))
        .astype(np.int64))
    np.testing.assert_array_equal(
        trandom.random_bits(keys, shape, "cpu").numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.bits(k, shape))(jkeys))
        .astype(np.int64))


# -- the two tracking steps over a batch ---------------------------------

def _ms_inputs(seed=1):
    """multi_sequence_step inputs (tests/test_torch_parallel.py's): the
    blob frames, the current one 1 px up, 3D points at the blob centres."""
    (img_prev, _, points, valid, _, _, points3d, _, _, _, _, _, theta, intr,
     _, _) = multi.make_frontend_inputs(B, N, H, W, seed=seed)
    valid = valid.copy()
    valid[:, ::7] = False
    return (img_prev, np.roll(img_prev, -1, axis=1), points, points3d, theta,
            valid, intr)


def _batch_slice(args, bs):
    """Every per-sequence argument of a step cut to the sequences `bs`
    (intrinsics and distortion are shared)."""
    return tuple(a if np.ndim(a) == 1 else a[bs] for a in args)


@pytest.fixture(scope="module")
def steps():
    """Both steps at B = 3 and on each sequence alone, on one gloo rank."""
    ms_args = _ms_inputs()
    fe_args = multi.make_frontend_inputs(B, N, H, W, seed=3)
    out = {}
    with launch.one_rank("cpu"):
        mesh = multi.make_mesh(1)
        for name, build, args in (
                ("ms", multi.multi_sequence_step, ms_args),
                ("fe", multi.frontend_mesh_step, fe_args)):
            step = build(mesh)
            out[name] = multi.to_host(step(*args))
            out[name, "alone"] = [
                multi.to_host(step(*_batch_slice(args, slice(b, b + 1))))
                for b in range(B)]
    return out, ms_args, fe_args


@pytest.fixture(scope="module")
def jax_steps(steps):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from slamtpu.parallel import multi as jmulti

    _, ms_args, fe_args = steps
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    return {name: jax.device_get(build(mesh)(*[jnp.asarray(a)
                                               for a in args]))
            for name, build, args in (
                ("ms", jmulti.multi_sequence_step, ms_args),
                ("fe", jmulti.frontend_mesh_step, fe_args))}


def _assert_ms(out, ref):
    np.testing.assert_array_equal(out[1], ref[1])
    ok = ref[1]
    np.testing.assert_allclose(out[0][ok], ref[0][ok], atol=1e-3)
    np.testing.assert_allclose(out[2], ref[2], atol=1e-3)


def _assert_fe(out, ref):
    np.testing.assert_array_equal(out[1], ref[1])
    ok = ref[1]
    np.testing.assert_allclose(out[0][ok], ref[0][ok], rtol=0, atol=1e-3)
    np.testing.assert_allclose(out[4], ref[4], atol=1e-2)
    np.testing.assert_array_equal(out[6], ref[6])


def _alone(outs):
    return tuple(np.concatenate(x) for x in zip(*outs))


def test_multi_sequence_step_batch_equals_sequences_alone(steps):
    out, ms_args, _ = steps
    assert out["ms"][1].sum() > 0.8 * ms_args[5].sum()
    _assert_ms(out["ms"], _alone(out["ms", "alone"]))
    assert np.all(np.isfinite(out["ms"][3]))


def test_frontend_mesh_step_batch_equals_sequences_alone(steps):
    """tests/test_parallel.py's bounds, and the median parallax within
    1e-3 px."""
    out, _, _ = steps
    alone = _alone(out["fe", "alone"])
    _assert_fe(out["fe"], alone)
    np.testing.assert_allclose(out["fe"][5], alone[5], rtol=0, atol=1e-3)
    assert (out["fe"][6] > 0).all()


def test_batched_steps_match_jax(steps, jax_steps):
    out, _, _ = steps
    _assert_ms(out["ms"], jax_steps["ms"])
    _assert_fe(out["fe"], jax_steps["fe"])
