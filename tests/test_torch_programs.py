"""The jitted steps' program wrapper (slamtpu_torch/programs.py) on the CPU.

On the card `track_step`, `keyframe_step_carry` and
`local_bundle_adjustment_packed` run as captured CUDA graphs
(tests/test_torch_cuda_programs.py holds each replay against its eager
call there). Here, on the CPU, they run eagerly; these tests hold what the
graphs rely on:

  (a) `dt` and the RANSAC key as device tensors (graph inputs) give the
      bits of the Python-scalar form, and the JAX package's track_step on
      the carries tests/test_torch_track_step.py captures, with that
      file's tolerances;
  (b) no output of a step shares storage with an input, at the default
      and the dense shapes (a graph's outputs are cloned, and a view of an
      input would be a view of a static buffer);
  (c) the cache key follows each static argument and each input shape,
      and nothing else;
  (d) a CPU call returns the eager function's output and captures nothing;
  (e) launch accounting: a capture records each wrapper's launches and
      every replay adds them;
and that the steps are capturable: no tensor built from host data (a
pageable host copy on the card) and no value read on the host (a sync),
outside the kernels' plain versions, which the card never runs.
"""
import threading
import traceback

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from slamtpu_torch import Params, kernels, programs
from slamtpu_torch.ops import ba
from slamtpu_torch.ops import keyframe_step as ks
from slamtpu_torch.ops import track_step as ts
from slamtpu_torch.parallel.multi import make_ba_inputs
from test_torch_cuda_programs import keyframe_inputs, tracking_inputs
from test_torch_track_step import capture_pipelined_run, torch_carry

torch.set_num_threads(2)

CONFIGS = {
    "default": dict(stereo=True),
    "dense": dict(stereo=True, max_nb_keypoints=2000, keypoint_capacity=2048,
                  pyramid_levels=4, max_distance=16, ba_window=30),
}
# The keyframe program's keys: the two configurations and the variant's
# options (the level kernel's 1-D mode, K1's subpixel refinement).
KEYFRAME_CONFIGS = dict(CONFIGS, stereo_1d_subpix=dict(
    stereo=True, stereo_klt_1d=True, subpixel_detect=True))
# A small city scene (the card tests use 376 x 1241).
SMALL = dict(height=120, width=192, n_points=1500)


@pytest.fixture(scope="module")
def captured():
    return capture_pipelined_run()


_leaves = programs.leaves


def _assert_bits_equal(got, want):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _assert_matches_jax(out, c):
    """tests/test_torch_track_step.py's tolerances."""
    carry_out, per_kp, scalars = out
    per_kp, scalars = per_kp.numpy(), scalars.numpy()
    rp, rs = c["per_kp"], c["scalars"]
    for col in range(7, 13):
        np.testing.assert_array_equal(per_kp[:, col], rp[:, col])
    ok = rp[:, 7] > 0
    d = np.abs(per_kp[ok, 0:2] - rp[ok, 0:2]).max(-1)
    assert (d <= 1e-3).mean() > 0.98 and d.max() <= 1e-2
    for i in (40, 41, 42, 43, 44, 47):
        assert scalars[i] == rs[i], i
    np.testing.assert_allclose(scalars[0:16], rs[0:16], atol=2e-2)
    np.testing.assert_allclose(scalars[16:32], rs[16:32], atol=5e-3)
    np.testing.assert_allclose(scalars[32:38], rs[32:38], atol=1e-4)
    np.testing.assert_allclose(scalars[48:54], rs[48:54], atol=1e-5)
    np.testing.assert_allclose(scalars[54:60], rs[54:60], atol=1e-4)
    kp, rkp = carry_out["kp"].numpy(), c["carry_out"]["kp"]
    np.testing.assert_array_equal(kp[:, ts.TK_FLAGS], rkp[:, ts.TK_FLAGS])
    misc, rmisc = carry_out["misc"].numpy(), c["carry_out"]["misc"]
    np.testing.assert_allclose(misc[ts.MS_WC], rmisc[ts.MS_WC], atol=1e-4)
    np.testing.assert_allclose(misc[ts.MS_VEL], rmisc[ts.MS_VEL], atol=1e-3)


@pytest.mark.parametrize("call", [0, 2])
def test_tensor_dt_and_key_give_the_scalar_bits_and_match_jax(captured,
                                                              call):
    """(a)"""
    c = captured["track"][call]
    carry = torch_carry(c["carry"])
    image = torch.from_numpy(np.array(c["image"]))
    scalar = ts.track_step_eager(carry, image, c["dt"], c["key"], **c["kw"])
    dt = torch.tensor(np.float32(c["dt"]))
    key = torch.tensor(c["key"], dtype=torch.int64)
    assert dt.dim() == 0 and key.shape == (2,)
    tensor = ts.track_step_eager(carry, image, dt, key, **c["kw"])
    _assert_bits_equal(tensor, scalar)
    # The public step (the graph's inputs made from host values) too.
    _assert_bits_equal(ts.track_step(carry, image, c["dt"], c["key"],
                                     **c["kw"]), scalar)
    _assert_matches_jax(tensor, c)


def test_step_inputs_are_the_graph_inputs():
    """(a) dt rounds to float32 and the key keeps its 32-bit words."""
    dt, key = ts.step_inputs(0.1, (0, 0xFFFFFFFF), "cpu")
    assert dt.dtype == torch.float32 and dt.shape == ()
    assert float(dt) == float(np.float32(0.1))
    assert key.dtype == torch.int64 and key.tolist() == [0, 0xFFFFFFFF]


def _storages(tree):
    return {t.untyped_storage().data_ptr() for t in _leaves(tree)}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_track_step_outputs_share_no_input_storage(config):
    """(b)"""
    carry, images, kw = tracking_inputs(Params(**CONFIGS[config]), "cpu",
                                        **SMALL)
    dt, key = ts.step_inputs(0.1, (0, 5), "cpu")
    inputs = (carry, images[0], dt, key)
    out = ts.track_step_eager(*inputs, **kw)
    assert not _storages(out) & _storages(inputs)
    assert (out[1][:, 7] > 0).sum() > 50


@pytest.mark.parametrize("config", list(CONFIGS))
def test_keyframe_step_carry_outputs_share_no_input_storage(config):
    """(b) The program's outputs (kp, misc, per_slot, n_new) are new
    tensors; the returned carry's pyramid is the caller's object."""
    carry, right, state, kw = keyframe_inputs(Params(**CONFIGS[config]),
                                              "cpu", **SMALL)
    inputs = (carry, right, state)
    out = ks.keyframe_step_carry_eager(*inputs, **kw)
    assert [t.shape for t in out[:3]] == [carry["kp"].shape,
                                          carry["misc"].shape,
                                          (carry["kp"].shape[0], 13)]
    assert not _storages(out) & _storages(inputs)
    new_carry, per_slot, n_new = ks.keyframe_step_carry(*inputs, **kw)
    assert new_carry["pyr"] is carry["pyr"]
    assert not _storages((new_carry["kp"], new_carry["misc"], per_slot,
                          n_new)) & _storages(inputs)
    assert int(n_new) > 0 and (per_slot[:, 4] > 0).sum() > 50


def _ba_buffer(n_poses, n_points, n_obs, n_free, P, X, O):
    args, _, _ = make_ba_inputs(n_poses, n_points, n_obs, seed=0,
                                n_free=n_free)
    return torch.from_numpy(ba.pack_ba_problem(*args, P=P, X=X, O=O)), \
        dict(P=P, X=X, O=O, iters1=5, iters2=10, repr_eps=5.0)


# The default path's bucket and the dense path's (P 16 / X 4096 /
# O 16384, PERF.md section 4).
BA_SHAPES = {"default": (10, 1500, 6000, 6, 16, 2048, 8192),
             "dense": (12, 3000, 12000, 6, 16, 4096, 16384)}


@pytest.mark.parametrize("shape", list(BA_SHAPES))
def test_ba_outputs_share_no_input_storage(shape):
    """(b)"""
    buf, kw = _ba_buffer(*BA_SHAPES[shape])
    out = ba.local_bundle_adjustment_packed_eager(buf, **kw)
    assert set(out) == {"poses", "points", "outliers", "final_cost"}
    assert not _storages(out) & _storages(buf)


def test_cache_key_follows_static_arguments_and_shapes():
    """(c) One key per (static arguments, input layouts): a change of any
    one static argument or input shape gives another key, new values in
    the same tensors do not."""
    carry, images, kw = tracking_inputs(Params(stereo=True), "cpu", **SMALL)
    dt, key = ts.step_inputs(0.1, (0, 5), "cpu")
    prog = ts._TRACK_STEP
    base = prog.key(carry, images[0], dt, key, **kw)
    dt2, key2 = ts.step_inputs(0.3, (7, 9), "cpu")
    same = {"kp": carry["kp"] + 1.0, "misc": carry["misc"] * 2.0,
            "pyr": carry["pyr"]}
    assert prog.key(same, images[1], dt2, key2, **kw) == base
    keys = {base}
    for name, value in kw.items():
        other = (not value if isinstance(value, bool)
                 else value + (1 if isinstance(value, int) else 0.5))
        k = prog.key(carry, images[0], dt, key, **dict(kw, **{name: other}))
        assert k not in keys, name
        keys.add(k)
    wider = dict(carry, kp=torch.zeros(carry["kp"].shape[0] * 2, 10))
    for args in [(wider, images[0], dt, key),
                 (carry, images[0][:-8], dt, key),
                 (carry, images[0], dt.reshape(1), key),
                 (carry, images[0].double(), dt, key)]:
        k = prog.key(*args, **kw)
        assert k not in keys
        keys.add(k)

    buf, bkw = _ba_buffer(*BA_SHAPES["default"])
    bprog = ba.local_bundle_adjustment_packed
    bbase = bprog.key(buf, **bkw)
    assert bprog.key(buf * 2.0, **bkw) == bbase
    bkeys = {bbase}
    for name in ("P", "X", "O", "iters1", "iters2", "repr_eps", "depth_eps",
                 "gross_eps"):
        k = bprog.key(buf, **dict(bkw, **{name: bkw.get(name, 1) * 2}))
        assert k not in bkeys, name
        bkeys.add(k)
    assert bprog.key(buf[:-4], **bkw) not in bkeys

    carry, right, state, kkw = keyframe_inputs(Params(stereo=True), "cpu",
                                               **SMALL)
    kprog = ks._KEYFRAME_STEP
    kbase = kprog.key(carry, right, state, **kkw)
    other = dict(carry, kp=carry["kp"] + 1.0)
    assert kprog.key(other, right * 0.5, state * 2.0, **kkw) == kbase
    kkeys = {kbase}
    for name, value in kkw.items():
        changed = (not value if isinstance(value, bool)
                   else value + (1 if isinstance(value, int) else 0.5))
        k = kprog.key(carry, right, state, **dict(kkw, **{name: changed}))
        assert k not in kkeys, name
        kkeys.add(k)
    dense, dright, dstate, dkw = keyframe_inputs(Params(**CONFIGS["dense"]),
                                                 "cpu", **SMALL)
    for args in [(dense, dright, dstate), (carry, right[:-8], state),
                 (carry, right, state[:-16])]:
        k = kprog.key(*args, **kkw)
        assert k not in kkeys
        kkeys.add(k)
    assert kprog.key(dense, dright, dstate, **dkw) not in kkeys


def test_cpu_call_is_the_eager_function_and_captures_nothing():
    """(d)"""
    carry, images, kw = tracking_inputs(Params(stereo=True), "cpu", **SMALL)
    entries = len(ts._TRACK_STEP.entries)
    got = ts.track_step(carry, images[0], 0.1, (0, 5), **kw)
    dt, key = ts.step_inputs(0.1, (0, 5), "cpu")
    _assert_bits_equal(got, ts.track_step_eager(carry, images[0], dt, key,
                                                **kw))
    assert len(ts._TRACK_STEP.entries) == entries

    buf, bkw = _ba_buffer(*BA_SHAPES["default"])
    bentries = len(ba.local_bundle_adjustment_packed.entries)
    _assert_bits_equal(ba.local_bundle_adjustment_packed(buf, **bkw),
                       ba.local_bundle_adjustment_packed_eager(buf, **bkw))
    assert len(ba.local_bundle_adjustment_packed.entries) == bentries
    with pytest.raises(TypeError, match="keyword"):
        ba.local_bundle_adjustment_packed(buf, 16, **bkw)

    carry, right, state, kkw = keyframe_inputs(Params(stereo=True), "cpu",
                                               **SMALL)
    kentries = len(ks._KEYFRAME_STEP.entries)
    before = ks.keyframe_step_carry.launches
    new_carry, per_slot, n_new = ks.keyframe_step_carry(carry, right, state,
                                                        **kkw)
    assert ks.keyframe_step_carry.launches == before + 1
    _assert_bits_equal((new_carry["kp"], new_carry["misc"], per_slot,
                        n_new),
                       ks.keyframe_step_carry_eager(carry, right, state,
                                                    **kkw))
    assert len(ks._KEYFRAME_STEP.entries) == kentries


def _counted():
    def fn():
        kernels.count_launch(fn)
    fn.launches = 0
    return fn


class _StubGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_replay_adds_the_launches_its_capture_recorded():
    """(e) Inside recording_launches a wrapper's launch is recorded, not
    counted (no kernel ran); every replay adds the record; launches on
    other threads meanwhile count as usual."""
    a, b = _counted(), _counted()
    with kernels.recording_launches() as record:
        for _ in range(3):
            a()
        b()
        other = threading.Thread(target=lambda: [a() for _ in range(5)])
        other.start()
        other.join()
    assert record == {a: 3, b: 1}
    assert (a.launches, b.launches) == (5, 0)
    graph = _StubGraph()
    entry = programs.Entry(graph, [], ((), ()), None, [], dict(record))
    for _ in range(4):
        entry.replay()
    assert graph.replays == entry.replays == 4
    assert (a.launches, b.launches) == (5 + 4 * 3, 4)
    a()
    assert a.launches == 18


def test_keyframe_program_counts_on_itself_under_a_spy(monkeypatch):
    """(e) A caller that replaces the module's attribute (a spy, a sync
    check) leaves the count on the program itself."""
    carry, right, state, kw = keyframe_inputs(Params(stereo=True), "cpu",
                                              **SMALL)
    program = ks.keyframe_step_carry
    calls = []

    def spy(*args, **static):
        calls.append(1)
        return program(*args, **static)

    monkeypatch.setattr(ks, "keyframe_step_carry", spy)
    before = program.launches
    ks.keyframe_step_carry(carry, right, state, **kw)
    assert calls == [1] and program.launches == before + 1
    assert not hasattr(spy, "launches")


def test_clone_keeps_views_of_one_storage():
    """Static buffers and returned clones keep a pyramid level's planes as
    views of its stack, so a carry's layout (and the key) is the same on
    every frame."""
    carry, _, _ = tracking_inputs(Params(stereo=True), "cpu", **SMALL)
    leaves = _leaves(carry)
    desc, sizes = programs.layout(leaves)
    assert len(sizes) == len(carry["pyr"]) + 2       # stacks, kp, misc
    twin = programs.clone_tree(carry)
    assert programs.layout(_leaves(twin)) == (desc, sizes)
    lv = twin["pyr"][1]
    assert lv["img"].untyped_storage().data_ptr() == \
        lv["stack"].untyped_storage().data_ptr()
    _assert_bits_equal(twin, carry)
    assert not _storages(twin) & _storages(carry)


def test_eager_is_per_thread():
    seen = []
    with programs.eager():
        assert programs.eager_active()
        th = threading.Thread(target=lambda: seen.append(
            programs.eager_active()))
        th.start()
        th.join()
    assert seen == [False] and not programs.eager_active()


class _CaptureHazards(TorchDispatchMode):
    """Records the ops that a CUDA graph capture refuses or that would make
    a replay differ from its eager call: a tensor lifted from host data
    (torch.tensor, a Python number written into a tensor: on the card a
    pageable copy), a value read on the host (.item(), int(t), a tensor
    used as a Python index: a sync), an output whose size depends on the
    data (nonzero, masked_select, a boolean mask index: a sync), and the
    generator's random numbers. Ops under a kernel's plain version (a
    function named *_plain, which runs only for CPU tensors) are left
    out."""

    HOST = ("aten.lift_fresh", "aten._local_scalar_dense", "aten.nonzero",
            "aten.masked_select", "aten.unique", "aten._unique",
            "aten.rand", "aten.normal", "aten.bernoulli", "aten.uniform",
            "aten.multinomial", "aten.randperm")

    def __init__(self):
        super().__init__()
        self.hits = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        bad = name.startswith(self.HOST) or (
            name.startswith("aten.index") and any(
                isinstance(a, (list, tuple)) and any(
                    torch.is_tensor(t) and t.dtype == torch.bool for t in a)
                for a in args))
        if bad:
            stack = traceback.extract_stack()
            if not any(f.name.endswith("_plain") for f in stack):
                mine = [f for f in stack if "slamtpu_torch" in f.filename]
                where = mine[-1] if mine else stack[-1]
                self.hits.append(f"{name} at {where.filename}:"
                                 f"{where.lineno}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("five_point", [False, True])
def test_track_step_is_capturable(five_point):
    carry, images, kw = tracking_inputs(Params(stereo=True), "cpu", **SMALL)
    dt, key = ts.step_inputs(0.1, (0, 5), "cpu")
    kw["five_point"] = five_point
    ts.track_step_eager(carry, images[0], dt, key, **kw)   # fill the caches
    mode = _CaptureHazards()
    with mode:
        ts.track_step_eager(carry, images[0], dt, key, **kw)
    assert mode.hits == []


@pytest.mark.parametrize("config", list(KEYFRAME_CONFIGS))
def test_keyframe_step_carry_is_capturable(config):
    carry, right, state, kw = keyframe_inputs(
        Params(**KEYFRAME_CONFIGS[config]), "cpu", **SMALL)
    ks.keyframe_step_carry_eager(carry, right, state, **kw)  # fill caches
    mode = _CaptureHazards()
    with mode:
        out = ks.keyframe_step_carry_eager(carry, right, state, **kw)
    assert mode.hits == []
    assert int(out[3]) > 0


def test_ba_is_capturable():
    buf, kw = _ba_buffer(*BA_SHAPES["default"])
    mode = _CaptureHazards()
    with mode:
        ba.local_bundle_adjustment_packed_eager(buf, **kw)
    assert mode.hits == []


def test_hazard_detector_sees_host_values():
    """The detector's controls: each hazard it names is seen."""
    x = torch.zeros(4, 4)
    for fn in (lambda: torch.tensor([1.0, 2.0]),
               lambda: x.__setitem__((0, 3), 1.0),
               lambda: x[torch.argmax(x[0])],
               lambda: float(x.sum()),
               lambda: x[x > 0],
               lambda: torch.rand(3)):
        mode = _CaptureHazards()
        with mode:
            fn()
        assert mode.hits, fn
