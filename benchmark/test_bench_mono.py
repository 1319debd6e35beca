"""A monocular configuration on the CPU at a tiny size: test_bench_harness.py's
tiny checkout with one more configuration (`Params()`'s family: `stereo`
left false) and cell. Every frame goes in through `add_image`, every fed
frame is posed and a sound run is correct, a run whose initialisation
comes late is not, the controls still fail once each drive is aligned by
its similarity, a drive moved by a similarity judges to the same numbers,
and a stereo drive judges as it did before the monocular judge."""
import json

import numpy as np
import pytest
import torch

from test_bench_harness import TINY_LIMITS, tiny_root  # noqa: F401

CELL = "tiny_mono.tiny12"
# Params() with tests/test_torch_mono.py's sizes for a 256 x 192 image.
PARAMS = {"max_nb_keypoints": 400, "max_distance": 24,
          "keypoint_capacity": 512, "initial_parallax": 8.0}
SEED = 2_400_000_017
# Whole tiny drives on six scenes (this seed's, 7, 11-14) read the median
# aligned step 0.0021-0.0092 m sound, 0.015-0.024 under triangulation_deep
# (local BA repairs its map at this size: 0.12-0.20 either way) and
# 0.083-0.100 under pose_written_stale.
LIMITS = dict(TINY_LIMITS, step_p50_m=0.012)
# The tiny drives initialise within five frames of their start.
INIT_FRAMES_MAX = 6


@pytest.fixture(scope="module")
def mono_root(tiny_root):  # noqa: F811
    b = tiny_root / "benchmark"
    conf = json.loads((b / "configs" / "tiny.json").read_text())
    conf["params"] = PARAMS
    conf["init_frames_max"] = INIT_FRAMES_MAX
    (b / "configs" / "tiny_mono.json").write_text(json.dumps(conf))
    (b / "limits" / f"{CELL}.json").write_text(json.dumps(LIMITS))
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="tiny_mono",
                                file="benchmark/configs/tiny_mono.json"))
    spec["workloads"].append({"name": CELL, "config": "tiny_mono",
                              "traffic": "tiny12", "chips": 1, "why": "t"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    return tiny_root


def _run(root):
    """A window long enough for one whole tiny drive on a loaded CPU."""
    import harness
    torch.manual_seed(0)
    return harness.run_cell(root, CELL, SEED, 40.0, False, device="cpu")


@pytest.fixture(scope="module")
def sound(mono_root):
    """One sound monocular run, with a spy on both feed calls."""
    from slamtpu_torch.models import slam_manager
    cls = slam_manager.SlamManager
    calls = {"add_image": 0, "add_stereo_image": 0}

    def spy(name):
        orig = getattr(cls, name)

        def call(sm, *a):
            calls[name] += 1
            return orig(sm, *a)
        return call

    with pytest.MonkeyPatch.context() as mp:
        for name in calls:
            mp.setattr(cls, name, spy(name))
        out = _run(mono_root)
    return out, calls


def test_mono_cell_is_found_and_renders_left_images_only(mono_root):
    from harness import Runner, load_cell
    runner = Runner(load_cell(mono_root, CELL), 1, "cpu")
    assert not runner.stereo and runner.right is None
    assert all(right is None for _, right in runner.frames[0])
    stereo = Runner(load_cell(mono_root, "tiny.tiny12"), 1, "cpu")
    assert stereo.stereo and stereo.right is not None
    assert all(right is not None for _, right in stereo.frames[0])


def test_every_frame_goes_through_add_image(sound):
    out, calls = sound
    assert calls["add_stereo_image"] == 0
    # The warm-up drive's 12 frames and the window's.
    assert calls["add_image"] == 12 + out["attempted"]


def test_every_fed_frame_is_posed_and_a_sound_run_is_correct(sound):
    out, _ = sound
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["correct"] is True, out["checks"]
    info = out["info"]
    assert info["resets"] == [0] * info["drives"]
    # The drives initialise after a few frames, which are not judged.
    assert info["pre_init_each"]
    assert max(info["pre_init_each"]) < INIT_FRAMES_MAX
    assert info["numbers"]["pre_init_frames"] == max(info["pre_init_each"])


def test_a_run_whose_initialisation_comes_late_is_not_correct(mono_root):
    """Every drive's frames 2-10 carry the first frame's pose, as they
    would if the five-point initialisation came at frame 11 of 12: the
    three frames past `init_frames_max` count as unposed."""
    import harness
    orig = harness.Sink.set_frame_wc

    def late(sink, frame_id, wc):
        if 2 <= frame_id <= 10:
            wc = sink.tracked[1]
        return orig(sink, frame_id, wc)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(harness.Sink, "set_frame_wc", late)
        out = _run(mono_root)
    assert out["info"]["drives"] >= 1
    assert out["correct"] is False
    assert out["checks"]["unposed"]["value"] > 0, out["checks"]
    assert out["info"]["numbers"]["pre_init_frames"] == 9


def _drive(root, cell, sampled=None):
    """One whole drive of the cell's scene 0, with its runner; with a list
    `sampled`, every local BA solve of the drive is kept in it."""
    import harness
    from slamtpu_torch.models import estimator
    torch.manual_seed(0)
    runner = harness.Runner(harness.load_cell(root, cell), SEED, "cpu")
    with harness.BASample(estimator, SEED) as sample, runner.watching(), \
            harness.ba_writes_marked():
        sample.size = 10 ** 6
        sample.active = sampled is not None
        d = runner.drive(0)
    if sampled is not None:
        sampled += sample.kept
    return runner, d


@pytest.mark.parametrize("control", ["ba_answer_discarded",
                                     "pose_written_stale",
                                     "triangulation_deep"])
def test_controls_still_fail_after_the_alignment(mono_root, control):
    """A whole drive under each control, judged as a run judges it: each
    fails on the number it breaks."""
    from harness import judge
    from readings import CONTROLS
    sampled = []
    with CONTROLS[control]():
        runner, d = _drive(mono_root, CELL, sampled)
    checks = judge(runner.cell, runner, [d], sampled, "cpu")["checks"]
    number = {"ba_answer_discarded": "ba_grad_ratio_p50",
              "pose_written_stale": "step_p50_m",
              "triangulation_deep": "step_p50_m"}[control]
    assert checks[number]["value"] > checks[number]["limit"], checks


JUDGED = ("unposed", "step_p50_m", "map_depth_err_p50", "ate_m",
          "step_err_m")


def _numbers(runner, drives):
    from harness import judge
    return judge(runner.cell, runner, drives, [], "cpu")["info"]["numbers"]


def test_a_drive_moved_by_a_similarity_judges_the_same(mono_root):
    """The drive's poses (as tracked and as last written), its keyframes
    and its map scaled by 3.7 about an origin and turned: the numbers agree
    to 1e-9."""
    import copy
    runner, d = _drive(mono_root, CELL)
    before = _numbers(runner, [d])
    assert before["step_p50_m"] < LIMITS["step_p50_m"], before
    rng = np.random.default_rng(3)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    rot = q * np.sign(np.linalg.det(q))
    origin = rng.normal(size=3) * 5.0
    scale = 3.7

    def pose(wc):
        out = np.array(wc)
        out[:3, :3] = rot @ wc[:3, :3]
        out[:3, 3] = scale * rot @ (wc[:3, 3] - origin) + origin
        return out

    moved = copy.deepcopy(d)
    for poses in (moved.sink.latest, moved.sink.tracked, moved.kf_wc):
        for k in poses:
            poses[k] = pose(poses[k])
    moved.map_points = (scale * (d.map_points - origin) @ rot.T + origin)
    after = _numbers(runner, [moved])
    for k in JUDGED:
        assert after[k] == pytest.approx(before[k], abs=1e-9, rel=1e-9), k


def _parent_judge(runner, drives):
    """The numbers of a stereo drive as the judge computed them before the
    monocular judge: metric, no alignment but ATE's rigid one."""
    from reference import ate_rmse, map_depth_errors, step_errors
    out = {}
    for d in drives:
        scene = runner.scenes[d.scene]
        gt = scene.poses_wc
        ids = [i for i in range(len(d.fed)) if (i + 1) in d.sink.latest]
        est = np.stack([d.sink.latest[i + 1] for i in ids])
        tracked = np.stack([d.sink.tracked[i + 1] for i in ids])
        steps = step_errors(tracked, gt[ids])
        err = map_depth_errors(d.map_points, d.map_kf, d.kf_wc, scene,
                               "cpu")
        out = {"unposed": float(len(d.fed) - len(ids)),
               "step_p50_m": float(np.median(steps)),
               "map_depth_err_p50": float(np.median(err)),
               "ate_m": ate_rmse(est[:, :3, 3], gt[ids, :3, 3]),
               "step_err_m": float(steps.max())}
    return out


def test_a_stereo_drive_judges_as_before(mono_root):
    runner, d = _drive(mono_root, "tiny.tiny12")
    assert runner.stereo
    new = _numbers(runner, [d])
    old = _parent_judge(runner, [d])
    for k in JUDGED:
        assert new[k] == old[k], k


@pytest.mark.parametrize("cut", [False, True])
def test_a_drive_that_never_initialises(mono_root, cut):
    """Every frame left at the first frame's pose: a whole drive posed no
    frame up to a similarity (all but the first count as unposed); a drive
    that the window cut is not judged, and counts the frames that waited
    past `init_frames_max`."""
    import copy
    runner, d = _drive(mono_root, CELL)
    stuck = copy.deepcopy(d)
    stuck.cut = cut
    for poses in (stuck.sink.latest, stuck.sink.tracked):
        for k in poses:
            poses[k] = np.array(poses[1])
    numbers = _numbers(runner, [stuck])
    waiting = len(d.fed) - 1
    assert numbers["unposed"] == (waiting - INIT_FRAMES_MAX if cut
                                  else waiting)
    assert np.isnan(numbers["step_p50_m"])
