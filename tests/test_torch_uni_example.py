"""Video-frame iterator of the port's uni example against the JAX
package's (reference example/uni/main.jl: grayscale conversion, [0, 1]
floats): the same frames, equal, from the same gray and color gifs; and
the example end to end on a short clip, on the CPU."""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"


def _load(name):
    path = EXAMPLES / name
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shape", [(32, 48), (32, 48, 3)],
                         ids=["gray", "color"])
def test_iter_video_frames_matches_jax_example(tmp_path, shape):
    import imageio.v3 as iio

    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 255, shape, dtype=np.uint8) for _ in range(4)]
    path = str(tmp_path / "clip.gif")
    iio.imwrite(path, frames)

    out = list(_load("uni_torch.py").iter_video_frames(path))
    ref = list(_load("uni.py").iter_video_frames(path))
    assert len(out) == len(ref) == 4
    for f, r in zip(out, ref):
        assert f.shape == (32, 48) and f.dtype == np.float32
        assert 0.0 <= f.min() and f.max() <= 1.0
        assert np.array_equal(f, r)


def test_uni_example_runs_on_cpu(tmp_path):
    """Mono SLAM on a 6-frame clip of the synthetic scene, --device cpu:
    one saved position a frame."""
    import imageio.v3 as iio

    from slamtpu_torch.datasets.synthetic import make_scene

    scene = make_scene(n_frames=6, height=120, width=160, n_points=400,
                       seed=3)
    clip = [np.clip(np.rint(scene.frame(i)[0] * 255), 0, 255)
            .astype(np.uint8) for i in range(len(scene))]
    path = str(tmp_path / "clip.gif")
    iio.imwrite(path, clip)
    out = tmp_path / "out"
    _load("uni_torch.py").main(["--video", path, "--focal", "120",
                                "--device", "cpu", "--save-dir", str(out)])
    saved = np.load(out / "trajectory.npz")
    assert saved["positions"].shape == (6, 3)
    assert np.isfinite(saved["positions"]).all()
