"""The port's KITTI odometry reader and KITTI example.

The reader runs on the fixture of `tests/test_kitti_reader.py` (a synthetic
on-disk sequence: calib, times, poses, 376x1241 PNGs) and against the JAX
package's reader on the same tree: K, Ti0, poses, timestamps and images
must be equal (both are the same numpy and PIL code). End to end,
`examples/kitty_torch.py` runs on the 8-frame 160x224 synthetic stereo
scene written as a KITTI tree, on the CPU, and must save a trajectory of 8
finite poses (and a plot with `--plot`).
"""
import importlib.util
import os
import pathlib

import numpy as np
import pytest
import torch

from slamtpu.datasets.kitti import load_kitti as jax_load_kitti
from slamtpu_torch.datasets.kitti import load_kitti

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def kitti_dir(tmp_path):
    seq = tmp_path / "sequences" / "07"
    (seq / "image_0").mkdir(parents=True)
    (seq / "image_1").mkdir(parents=True)
    (tmp_path / "poses").mkdir()

    fx = fy = 718.856
    cx, cy = 607.1928, 185.2157
    baseline_term = -386.1448  # = -fx * baseline (KITTI P1 convention)
    p0 = f"{fx} 0 {cx} 0 0 {fy} {cy} 0 0 0 1 0"
    p1 = f"{fx} 0 {cx} {baseline_term} 0 {fy} {cy} 0 0 0 1 0"
    (seq / "calib.txt").write_text(f"P0: {p0}\nP1: {p1}\n")
    (seq / "times.txt").write_text("0.0\n0.1\n")

    pose0 = "1 0 0 0 0 1 0 0 0 0 1 0"
    pose1 = "1 0 0 1.5 0 1 0 0 0 0 1 0.2"
    (tmp_path / "poses" / "07.txt").write_text(f"{pose0}\n{pose1}\n")

    from PIL import Image
    rng = np.random.default_rng(0)
    for d in ("image_0", "image_1"):
        for i in range(2):
            img = (rng.uniform(size=(376, 1241)) * 255).astype(np.uint8)
            Image.fromarray(img).save(seq / d / f"{i:06d}.png")
    return str(tmp_path)


def test_load_kitti(kitti_dir):
    ds = load_kitti(kitti_dir, "07", stereo=True)
    assert len(ds) == 2
    assert (ds.height, ds.width) == (376, 1241)
    assert np.isclose(ds.K[0, 0], 718.856)
    assert np.isclose(ds.K[0, 2], 607.1928)
    assert np.isclose(ds.K[1, 2], 185.2157)
    # Stereo extrinsic: Ti0 = K1^-1 @ KT2 -> x-translation = -baseline.
    assert np.isclose(ds.Ti0[0, 3], -386.1448 / 718.856, atol=1e-6)
    assert np.allclose(ds.Ti0[:3, :3], np.eye(3), atol=1e-9)
    assert np.isclose(ds.poses[1][0, 3], 1.5)
    assert np.isclose(ds.poses[1][2, 3], 0.2)
    left, right = ds[0]
    assert left.shape == (376, 1241) and left.dtype == np.float32
    assert 0.0 <= left.min() and left.max() <= 1.0
    assert right is not None
    assert np.allclose(ds.ground_truth_positions()[1], [1.5, 0.0, 0.2])


def test_load_kitti_matches_jax(kitti_dir):
    ds, ref = load_kitti(kitti_dir, "07"), jax_load_kitti(kitti_dir, "07")
    assert np.array_equal(ds.K, ref.K)
    assert np.array_equal(ds.Ti0, ref.Ti0)
    assert np.array_equal(ds.timestamps, ref.timestamps)
    assert len(ds.poses) == len(ref.poses)
    for a, b in zip(ds.poses, ref.poses):
        assert np.array_equal(a, b)
    assert (ds.height, ds.width) == (ref.height, ref.width)
    for i in range(len(ds)):
        for a, b in zip(ds[i], ref[i]):
            assert np.array_equal(a, b)
    mono = load_kitti(kitti_dir, "07", stereo=False)
    assert mono[0][1] is None


def _write_kitti_tree(root, scene, sequence):
    """The synthetic stereo scene as a KITTI odometry tree: P0 = [K | 0],
    P1 = K [I | t] with t the right camera's translation, 8-bit PNGs,
    times and the ground-truth world-from-camera poses."""
    from PIL import Image

    seq = root / "sequences" / sequence
    for d in ("image_0", "image_1"):
        (seq / d).mkdir(parents=True)
    (root / "poses").mkdir()
    cam = scene.camera
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1.0]])
    P0 = np.hstack([K, np.zeros((3, 1))])
    P1 = K @ scene.right_camera.Ti0[:3, :4]

    def row(m):
        return " ".join(repr(float(v)) for v in m.reshape(-1))

    (seq / "calib.txt").write_text(f"P0: {row(P0)}\nP1: {row(P1)}\n")
    (seq / "times.txt").write_text(
        "".join(f"{float(t)!r}\n" for t in scene.timestamps))
    (root / "poses" / f"{sequence}.txt").write_text(
        "".join(row(p[:3, :4]) + "\n" for p in scene.poses_wc))
    for i in range(len(scene)):
        for d, img in zip(("image_0", "image_1"), scene.frame(i)):
            u8 = np.clip(np.rint(img * 255.0), 0, 255).astype(np.uint8)
            Image.fromarray(u8).save(seq / d / f"{i:06d}.png")


def _load_example(name):
    path = REPO / "examples" / name
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_kitty_example_runs_on_a_synthetic_tree(tmp_path):
    from slamtpu_torch.datasets.synthetic import make_scene

    scene = make_scene(n_frames=8, height=160, width=224, n_points=900,
                       stereo=True, baseline=0.5, seed=9)
    _write_kitti_tree(tmp_path / "kitti", scene, "00")
    ds = load_kitti(str(tmp_path / "kitti"), "00")
    assert (ds.height, ds.width) == (160, 224)
    assert np.allclose(ds.Ti0, scene.right_camera.Ti0, atol=1e-9)

    out = tmp_path / "out"
    kitty = _load_example("kitty_torch.py")
    kitty.main(["--kitti-dir", str(tmp_path / "kitti"), "--sequence", "00",
                "--device", "cpu", "--save-dir", str(out), "--plot"])
    saved = np.load(out / "trajectory.npz")
    assert saved["positions"].shape == (8, 3)
    assert np.isfinite(saved["positions"]).all()
    assert os.path.getsize(out / "trajectory.png") > 1000


def test_kitty_example_defaults_to_the_card(tmp_path, monkeypatch):
    """Without --device the example asks for the card and, with none,
    fails: it never drops to the CPU on its own."""
    from slamtpu_torch.datasets.synthetic import make_scene

    scene = make_scene(n_frames=2, height=48, width=64, n_points=50,
                       stereo=True, seed=0)
    _write_kitti_tree(tmp_path / "kitti", scene, "00")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kitty = _load_example("kitty_torch.py")
    with pytest.raises(RuntimeError, match="cuda"):
        kitty.main(["--kitti-dir", str(tmp_path / "kitti"), "--sequence",
                    "00", "--save-dir", str(tmp_path / "out")])
