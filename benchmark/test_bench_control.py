"""The controls at the cells' own size, on the card (marked `cuda`): each
breaks one guarantee that the configuration states, and the reference has
to find it not correct, on the number it breaks (PERF.md gives their
readings). The same controls at a tiny size on the CPU are cases of
test_bench_harness.py's faults."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# The numbers each control breaks.
BREAKS = {"ba_answer_discarded": ["ba_grad_ratio_p50"],
          "pose_written_stale": ["step_p50_m"],
          "triangulation_deep": ["map_depth_err_p50", "step_p50_m"]}
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
# A window of the mix's frames at this rate holds at least one whole drive
# of each sequential cell (PERF.md has their rates). A threaded cell runs
# at about a tenth of that rate: its control runs the cell's own window.
RATE = 15


@pytest.mark.cuda
@pytest.mark.parametrize("control", sorted(BREAKS))
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_control_at_the_cells_size_is_not_correct(workload, control):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's "
                    "size on the card")
    limits = json.loads((BENCH / "limits" / f"{workload}.json").read_text())
    compared = [n for n in BREAKS[control] if n in limits]
    if not compared:
        pytest.skip(f"{workload} compares none of {BREAKS[control]}: the "
                    "program's sound runs read as high (PERF.md)")
    w = {c["name"]: c for c in SPEC["workloads"]}[workload]
    mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                     .read_text())
    conf = {c["name"]: c for c in SPEC["configs"]}[w["config"]]
    params = json.loads((ROOT / conf["file"]).read_text())["params"]
    scenes = mix["scenes"]
    n = len(scenes) if isinstance(scenes, list) else scenes
    seconds = (n * mix["frames_per_drive"] / RATE
               if params.get("sequential", True) else SPEC["run_seconds"])
    p = subprocess.run(
        [sys.executable, str(BENCH / "readings.py"), "--workload", workload,
         "--seeds", "2700000901", "--seconds", str(seconds),
         "--control", control],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    print(workload, control, json.dumps(line["numbers"]))
    assert line["control"] == control
    assert any(line["numbers"][n] > limits[n] for n in compared), \
        line["numbers"]
    assert line["correct"] is False, line["numbers"]
