"""The frozen scene against the port's make_scene, and the torch renderer
against the port's numpy renderer, on the CPU."""
import json
from pathlib import Path

import numpy as np
import pytest

import scene as S
from slamtpu_torch import Camera
from slamtpu_torch.datasets.synthetic import make_scene

SEED = 2_400_000_017        # past 31 bits, as the driver's seeds are
# The port's make_scene fixes fx = fy = 0.9 W with a centred principal
# point; the configurations hold KITTI's calibration.
PORT_RIG = dict(height=376, width=1241, fx=0.9 * 1241, fy=0.9 * 1241,
                cx=620.5, cy=188.0, baseline_m=0.54, hz=10)
KITTI_RIG = json.loads((Path(__file__).resolve().parent / "configs"
                        / "kitti_stereo.json").read_text())["rig"]
# The renderers composite in float64 in another order; the float32 images
# may differ by one rounding step of values near 1.
TOL = 1e-6


@pytest.mark.parametrize("layout,n_points", [("city", 6000), ("slab", 6000),
                                             ("city", 24000)])
def test_geometry_matches_the_ports_make_scene(layout, n_points):
    rig = S.make_rig(PORT_RIG)
    ref = make_scene(n_frames=12, height=376, width=1241, n_points=n_points,
                     stereo=True, baseline=0.54, seed=SEED, layout=layout)
    sc = S.make_scene(rig, n_frames=12, n_points=n_points, seed=SEED,
                      layout=layout)
    assert np.array_equal(sc.points, ref.points)
    assert np.array_equal(sc.amps, ref._point_amps)
    assert np.array_equal(sc.sigmas, ref._point_sigmas)
    assert np.array_equal(sc.poses_wc, np.stack(ref.poses_wc))
    assert np.allclose(sc.timestamps, ref.timestamps, rtol=0, atol=1e-15)
    cam, right = ref.camera, ref.right_camera
    assert (rig.fx, rig.fy, rig.cx, rig.cy, rig.height, rig.width) == (
        cam.fx, cam.fy, cam.cx, cam.cy, cam.height, cam.width)
    assert right.Ti0[0, 3] == -rig.baseline


@pytest.mark.parametrize("layout,frame", [("city", 0), ("city", 9),
                                          ("slab", 5)])
def test_torch_renderer_matches_numpy(layout, frame):
    """At KITTI's intrinsics: the port's numpy renderer given the frozen
    scene's points and the configuration's cameras."""
    rig = S.make_rig(KITTI_RIG)
    sc = S.make_scene(rig, n_frames=10, n_points=6000, seed=SEED,
                      layout=layout)
    ref = make_scene(n_frames=10, height=376, width=1241, n_points=6000,
                     stereo=True, baseline=0.54, seed=SEED, layout=layout)
    ti0 = np.eye(4)
    ti0[0, 3] = -rig.baseline
    ref.camera = Camera(rig.fx, rig.fy, rig.cx, rig.cy, rig.height,
                        rig.width)
    ref.right_camera = Camera(rig.fx, rig.fy, rig.cx, rig.cy, rig.height,
                              rig.width, Ti0=ti0)
    ref.points, ref._point_amps, ref._point_sigmas = (sc.points, sc.amps,
                                                      sc.sigmas)
    left, right = ref.frame(frame)
    got_l = S.render(sc, sc.poses_wc[frame], False, "cpu").numpy()
    got_r = S.render(sc, sc.poses_wc[frame], True, "cpu").numpy()
    assert got_l.dtype == np.float32 and got_l.shape == (376, 1241)
    assert np.abs(got_l - left).max() <= TOL
    assert np.abs(got_r - right).max() <= TOL
    assert left.std() > 0.05          # the image is not empty


def test_a_blob_on_a_pixel_centre_renders_its_amplitude():
    rig = S.Rig(32, 32, 20.0, 20.0, 16.0, 16.0, 0.5, 10.0)
    sc = S.Scene(np.array([[0.0, 0.0, 5.0], [0.0, 0.0, 9.0]]),
                 np.array([0.8, 0.3]), np.array([1.0, 1.0]),
                 np.eye(4)[None], np.zeros(1), rig)
    img = S.render(sc, np.eye(4), False, "cpu").numpy()
    # The near blob, exactly on pixel (16, 16), hides the far one there.
    assert img[16, 16] == pytest.approx(0.8, abs=1e-6)
