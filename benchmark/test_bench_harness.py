"""The harness on the CPU at a tiny size, in a temporary copy of the
benchmark with one more configuration, mix, cell, limits file and metric
reader added as files: found by name, the last line's schema, and the
reference's verdict on a sound run and on runs with the timed path broken
underneath (the chip check is skipped; the kernels' plain versions run)."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
TINY_LIMITS = {"unposed": 0, "step_p50_m": 0.03, "map_depth_err_p50": 0.3,
               "ba_grad_ratio_p50": 0.2}


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root)
    os.symlink(ROOT / "slamtpu_torch", root / "slamtpu_torch")
    b = root / "benchmark"
    conf = json.loads((b / "configs" / "kitti_stereo.json").read_text())
    # KITTI's intrinsics scaled to a 256 x 192 image.
    conf["rig"].update(height=192, width=256, fx=148.3, fy=148.3, cx=125.3,
                       cy=94.6)
    (b / "configs" / "tiny.json").write_text(json.dumps(conf))
    mix = json.loads((b / "traffic" / "city60.json").read_text())
    mix.update(scenes=1, n_points=1500, frames_per_drive=12)
    (b / "traffic" / "tiny12.json").write_text(json.dumps(mix))
    (b / "limits" / "tiny.tiny12.json").write_text(json.dumps(TINY_LIMITS))
    (b / "metrics" / "tiny.frames_fed.py").write_text(
        "def read(run):\n    return run.frames_fed\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="tiny",
                                file="benchmark/configs/tiny.json"))
    spec["workloads"].append({"name": "tiny.tiny12", "config": "tiny",
                              "traffic": "tiny12", "chips": 1, "why": "t"})
    spec["per_layer"].append({
        "name": "tiny.frames_fed", "unit": "count", "better": "higher",
        "source": "program_counter", "layer": "entry", "moves": "fps",
        "workloads": ["tiny.tiny12"]})
    for m in spec["per_layer"]:
        m["workloads"].append("tiny.tiny12")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def _run(root, trace=False, seconds=16.0, monkeypatch=None):
    """A window of one whole tiny drive (~8 s on a quiet CPU, twice that on
    a loaded one) and part of the next, so that local BA solves fall inside
    it; traced, frames 4-8 of the window's first drive."""
    import harness
    if trace:
        monkeypatch.setattr(harness, "TRACE_DRIVE", 0)
        monkeypatch.setattr(harness, "TRACE_FRAMES", (4, 8))
    torch.manual_seed(0)
    return harness.run_cell(root, "tiny.tiny12", 2_400_000_017, seconds,
                            trace, device="cpu")


def test_files_are_found_by_name(tiny_root):
    from harness import load_cell
    cell = load_cell(tiny_root, "tiny.tiny12")
    assert cell.config["rig"]["width"] == 256
    assert cell.traffic["frames_per_drive"] == 12
    assert cell.limits == TINY_LIMITS
    names = [m["name"] for m, _ in cell.per_layer]
    assert "tiny.frames_fed" in names and "device.idle_share" in names
    for name in ("kitti_stereo.city60", "kitti_stereo.slab60"):
        assert load_cell(ROOT, name).per_layer


def test_sound_run_and_result_schema(tiny_root, monkeypatch):
    out = _run(tiny_root, trace=True, monkeypatch=monkeypatch)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["checks"]) == set(TINY_LIMITS)
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    m = out["metrics"]
    assert m["tiny.frames_fed"]["value"] == out["attempted"]
    assert m["programs.captures"]["value"] == 0      # the CPU captures none
    assert "fps" not in m                            # --trace 1: per layer
    dev = out["device"]
    assert dev["platform"] == "cpu" and dev["count"] == 1
    assert dev["window_s"] > 0 and "breakdown" in out
    json.dumps(out)


def test_untraced_run_reports_the_end_to_end_metrics(tiny_root):
    out = _run(tiny_root, trace=False)
    assert set(out["metrics"]) == {"fps", "pose_latency_p95_ms", "setup_s"}
    assert all(v["value"] > 0 for v in out["metrics"].values())


def _ba_answer_altered(orig):
    def solve(buf, **kw):
        res = dict(orig(buf, **kw))
        poses = res["poses"].clone()
        poses[0, 3] += 0.05                  # the first free pose moved
        res["poses"] = poses
        return res
    return solve


def _ba_half_observations(orig):
    def solve(buf, *, P, X, O, **kw):
        half = buf.clone()
        lanes = half[P * 7 + X * 3 + O * 4:P * 7 + X * 3 + O * 5]
        lanes[1::2] = 0.0                    # every other observation out
        return orig(half, P=P, X=X, O=O, **kw)
    return solve


def _pose_write_half(orig):
    """A frame's pose setter that never reaches the sink on even ids."""
    def setter(self, pose, slam_io=None):
        return orig(self, pose, slam_io if self.id % 2 else None)
    return setter


@pytest.mark.parametrize("fault", ["ba_state_unchanged", "ba_answer_altered",
                                   "ba_half_observations",
                                   "half_the_frames_left_out",
                                   "pose_written_stale",
                                   "triangulation_deep"])
def test_a_broken_timed_path_is_not_correct(tiny_root, fault, monkeypatch):
    """Each fault under the timed path that this cell can have (one chip:
    no exchange between chips to leave out): in local BA, in the tracked
    frame's pose, in keyframe triangulation. Three are the controls."""
    from readings import CONTROLS
    from slamtpu_torch.models import estimator, frame
    orig = estimator.local_bundle_adjustment_packed
    control = {"ba_state_unchanged": "ba_answer_discarded"}.get(fault, fault)
    if control in CONTROLS:
        with CONTROLS[control]():
            out = _run(tiny_root)
        number, least = {
            "ba_answer_discarded": ("ba_grad_ratio_p50", 1.0),
            "pose_written_stale": ("step_p50_m", 0.1),
            "triangulation_deep": ("map_depth_err_p50", 0.2)}[control]
        assert out["info"]["numbers"][number] >= least - 1e-6, \
            out["info"]["numbers"]
    else:
        if fault == "ba_answer_altered":
            monkeypatch.setattr(estimator, "local_bundle_adjustment_packed",
                                _ba_answer_altered(orig))
        elif fault == "ba_half_observations":
            monkeypatch.setattr(estimator, "local_bundle_adjustment_packed",
                                _ba_half_observations(orig))
        else:
            for name in ("set_wc", "set_cw"):
                monkeypatch.setattr(frame.Frame, name, _pose_write_half(
                    getattr(frame.Frame, name)))
        out = _run(tiny_root)
    assert out["correct"] is False, out["checks"]


def test_run_refuses_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    p = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "kitti_stereo.city60", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_fails_without_the_program(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run(
        [sys.executable, str(tmp_path / "benchmark" / "run.py"),
         "--workload", "kitti_stereo.city60", "--seed", "1", "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
        timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_nothing_reached_from_run_imports_jax_or_the_jax_package():
    code = (
        "import sys, runpy, pathlib\n"
        f"sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]\n"
        "import run, harness, scene, reference, devtrace, readings\n"
        "import slamtpu_torch, slamtpu_torch.models.estimator\n"
        "from slamtpu_torch.ops import ba, track_step\n"
        "import torch.profiler\n"
        f"for f in pathlib.Path({str(BENCH / 'metrics')!r}).glob('*.py'):\n"
        "    harness.load_reader(f)\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=300,
                       env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode == 0, p.stderr
    top = set(p.stdout.split())
    assert "slamtpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "slamtpu"}
