"""Threaded mode (`sequential=False`) of the port against the JAX package on
the CPU.

Both packages run the scene and `Params` of
`tests/test_pipeline_features.py::test_threaded_mode_runs` (8 frames,
160x224, seed 9), fed in the same lock step: after each frame, wait until
the image, keyframe and estimator queues are empty. A manager, a mapper and
an estimator thread race by design (the manager tracks the next frame while
the mapper still triangulates the last keyframe), so parity is by bounds,
not by equality. Three runs of each package, alone and beside six busy
processes, gave keyframes 1, 2 and 7 every time; per-frame positions
spread 0.0005 m within the port, 0 within the JAX package, and lay at most
0.0009 m from the JAX package's. Bounds: keyframe counts within 2, every
per-frame position within 0.02 m of the JAX package's.

A dead worker or a stall fails the run with a message before `wait()`,
which would otherwise wait forever on a queue that nobody drains.
"""
import time

import numpy as np
import pytest
import torch

from slamtpu import Params
from slamtpu.datasets.synthetic import make_scene
from slamtpu.io.saver import ReplaySaver
from slamtpu_torch.convert import camera_from_jax, params_from_jax

torch.set_num_threads(2)

DEADLINE_S = 60.0
POSITION_BOUND_M = 0.02


def _scene():
    return make_scene(n_frames=8, height=160, width=224, n_points=900,
                      stereo=True, baseline=0.5, seed=9)


def _manager(package, scene):
    params = Params(stereo=True, max_nb_keypoints=400, max_distance=24,
                    keypoint_capacity=512, initial_parallax=8.0,
                    sequential=False)
    if package == "torch":
        from slamtpu_torch import ReplaySaver as TorchSaver
        from slamtpu_torch import SlamManager

        saver = TorchSaver()
        sm = SlamManager(params_from_jax(params),
                         camera_from_jax(scene.camera),
                         right_camera=camera_from_jax(scene.right_camera),
                         slam_io=saver, device="cpu")
    else:
        from slamtpu.models.slam_manager import SlamManager

        saver = ReplaySaver()
        sm = SlamManager(params, scene.camera,
                         right_camera=scene.right_camera, slam_io=saver)
    return sm, saver


def _until(sm, done, what):
    """Poll `done()` while every worker thread is alive, up to the
    deadline; fail with a message on a dead worker or a stall."""
    deadline = time.time() + DEADLINE_S
    while not done():
        dead = [i for i, t in enumerate(sm._threads) if not t.is_alive()]
        assert not dead, f"worker thread(s) {dead} died waiting for {what}"
        assert time.time() < deadline, f"threaded pipeline stalled: {what}"
        time.sleep(0.01)


def _drained(sm):
    return not (sm.get_queue_size() > 0 or sm.mapper.keyframe_queue
                or sm.mapper.estimator.frame_queue)


def _feed_lock_step(sm, scene):
    for i in range(len(scene)):
        left, right = scene.frame(i)
        sm.add_stereo_image(left, right, float(scene.timestamps[i]))
        _until(sm, lambda: _drained(sm), f"frame {i}")


def _stop(sm):
    _until(sm, lambda: _drained(sm), "the last frame")
    sm.wait()
    alive = [i for i, t in enumerate(sm._threads) if t.is_alive()]
    assert not alive, f"worker thread(s) {alive} still running after wait()"


def _run(package):
    scene = _scene()
    sm, saver = _manager(package, scene)
    _feed_lock_step(sm, scene)
    _stop(sm)
    return sm, saver.trajectory_xyz().astype(np.float64)


@pytest.fixture(scope="module")
def runs():
    return {"jax": _run("jax"), "torch": _run("torch")}


def test_threaded_mode_matches_jax(runs):
    (jsm, jest), (tsm, test) = runs["jax"], runs["torch"]
    for sm, est in ((jsm, jest), (tsm, test)):
        assert len(est) == 8
        assert np.isfinite(est).all()
        assert sm.map_manager.nb_keyframes >= 2
        assert not sm.params.reset_required
    assert tsm.n_resets == 0
    n_t, n_j = tsm.map_manager.nb_keyframes, jsm.map_manager.nb_keyframes
    assert abs(n_t - n_j) <= 2, (n_t, n_j)
    dist = np.linalg.norm(test - jest, axis=1)
    assert dist.max() <= POSITION_BOUND_M, dist


def test_threaded_mode_never_pipelines(runs):
    """Threaded mode tracks every frame on the classic path, as the JAX
    package does: no pipelined dispatch, nothing in flight."""
    for package in ("jax", "torch"):
        fe = runs[package][0].front_end
        assert not fe.pipeline_active and not fe.inflight, package
    assert runs["torch"][0]._pending_kf is None


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_backpressure_holds_frames(package):
    """While the mapper holds an unprocessed keyframe, the manager thread
    takes up no frame: a fed image stays in the image queue."""
    scene = _scene()
    sm, _ = _manager(package, scene)
    mapper_get = sm.mapper.get_new_kf
    sm.mapper.get_new_kf = lambda: None      # the mapper takes nothing
    if package == "torch":
        from slamtpu_torch.models.mapper import KeyFrame
    else:
        from slamtpu.models.mapper import KeyFrame
    sm.mapper.add_new_kf(KeyFrame(0))
    left, right = scene.frame(0)
    sm.add_stereo_image(left, right, float(scene.timestamps[0]))
    time.sleep(0.2)
    assert sm.get_queue_size() == 1
    assert sm.frame_id == 0
    sm.mapper.keyframe_queue.clear()
    _until(sm, lambda: sm.get_queue_size() == 0, "the held frame")
    sm.mapper.get_new_kf = mapper_get
    _stop(sm)
    assert sm.frame_id == 1


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_wait_leaves_deferred_ba_pending(package):
    """Reference behaviour, pinned: in threaded mode wait() drains the
    queues and stops the threads but applies no deferred BA result
    (`finish()` does). The third keyframe (kfid 2) is the first that runs
    local BA; once its result is pending, wait() leaves it so."""
    scene = _scene()
    sm, _ = _manager(package, scene)
    _feed_lock_step(sm, scene)
    est = sm.mapper.estimator
    _until(sm, lambda: est._pending is not None, "a deferred BA result")
    _stop(sm)
    assert est._pending is not None
    assert sm.params.local_ba_on
    sm.finish()
    assert est._pending is None and not sm.params.local_ba_on
