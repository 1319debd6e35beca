"""BRIEF-256 descriptors and local-map matching (`do_local_matching=True`)
of the port against the JAX package.

Per function, on the same numpy inputs:
  - `brief_pattern`: bit for bit (both draw it from numpy's
    default_rng(123));
  - `gaussian_blur(img, 2.0)`: within 1e-6 of the image's range (float32
    sums in another order);
  - `brief_describe`: the in-bounds mask equal; the bits of in-bounds
    keypoints agree on >= 99.9% (a comparison of two smoothed pixels whose
    float32 values tie to ~1e-7 may flip);
  - `pack_descriptor_bits`, `hamming_distance`: equal;
  - `Extractor.describe`: the same keypoints get no descriptor, the others
    agree on >= 99.9% of their bits.
Whole path: tests/test_torch_pipelined.py's 12-frame scene with
`do_local_matching=True` (BRIEF at every classic keyframe, then local-map
matching and merges in Mapper.process): tests/test_torch_nocarry.py's
bounds (0 resets, the same keyframe ids, per-frame positions within
0.05 m, the ATE bounds), the same schedule, map points with a descriptor
within 5% of the JAX package's and `merge_mappoints` calls within 1 or 20%
of its count, whichever is more.
"""
import numpy as np
import pytest
import torch

import slamtpu.ops.features as jfeat
import slamtpu.ops.image as jimage
import slamtpu.utils.profiling as jax_profiling
import slamtpu_torch.utils.profiling as torch_profiling
from slamtpu.datasets.synthetic import make_scene
from slamtpu.models.map_manager import MapManager as JMapManager
from slamtpu_torch.models.map_manager import MapManager as TMapManager
from slamtpu_torch.ops import features as tfeat
from slamtpu_torch.ops import image as timage
from test_torch_nocarry import assert_paths_match, stage_calls
from test_torch_pipelined import _run

torch.set_num_threads(2)


def _image_and_keypoints():
    """Frame 0 of the 160x224 test scene, and 300 keypoints: its
    detections, random points, and points on and past the patch border."""
    scene = make_scene(n_frames=1, height=160, width=224, n_points=900,
                       stereo=True, baseline=0.5, seed=9)
    img = scene.frame(0)[0].astype(np.float32)
    rng = np.random.default_rng(5)
    kp = np.stack([rng.uniform(-3, 163, 300), rng.uniform(-3, 227, 300)],
                  -1).astype(np.float32)
    kp[:8] = [[16, 16], [15.5, 40], [16.5, 40], [143, 100], [144, 100],
              [80, 207], [80, 208], [80.5, 15.5]]
    valid = rng.uniform(size=300) < 0.95
    return img, kp, valid


def test_brief_pattern_is_bit_exact():
    for seed in (123, 7):
        np.testing.assert_array_equal(tfeat.brief_pattern(seed=seed),
                                      jfeat.brief_pattern(seed=seed))


def test_gaussian_blur_matches_jax():
    img, _, _ = _image_and_keypoints()
    ref = np.asarray(jimage.gaussian_blur(img, 2.0))
    out = timage.gaussian_blur(torch.from_numpy(img), 2.0).numpy()
    assert np.abs(out - ref).max() <= 1e-6 * (img.max() - img.min())


def test_brief_describe_matches_jax():
    import jax.numpy as jnp

    img, kp, valid = _image_and_keypoints()
    pattern = jfeat.brief_pattern()
    jbits, jinb = jfeat.brief_describe(jnp.asarray(img), jnp.asarray(kp),
                                       jnp.asarray(valid),
                                       jnp.asarray(pattern))
    tbits, tinb = tfeat.brief_describe(torch.from_numpy(img),
                                       torch.from_numpy(kp),
                                       torch.from_numpy(valid),
                                       torch.from_numpy(pattern))
    jbits, jinb = np.asarray(jbits), np.asarray(jinb)
    tbits, tinb = tbits.numpy(), tinb.numpy()
    np.testing.assert_array_equal(tinb, jinb)
    assert 100 < jinb.sum() < 300
    assert tbits.dtype == np.uint8 and tbits.shape == (300, 256)
    agree = (tbits[jinb] == jbits[jinb]).mean()
    assert agree >= 0.999, agree


def test_pack_and_hamming_match_jax():
    rng = np.random.default_rng(3)
    bits = (rng.uniform(size=(40, 256)) < 0.5).astype(np.uint8)
    packed = tfeat.pack_descriptor_bits(bits)
    np.testing.assert_array_equal(packed, jfeat.pack_descriptor_bits(bits))
    assert packed.shape == (40, 32)
    np.testing.assert_array_equal(
        tfeat.hamming_distance(packed[:, None], packed[None]),
        jfeat.hamming_distance(packed[:, None], packed[None]))


def test_extractor_describe_matches_jax():
    import jax.numpy as jnp
    from slamtpu.models.extractor import Extractor as JExtractor
    from slamtpu_torch.models.extractor import Extractor as TExtractor

    img, kp, _ = _image_and_keypoints()
    args = (400, 12, (7, 10), 24)
    jdesc = JExtractor(*args, capacity=512).describe(jnp.asarray(img), kp)
    tdesc = TExtractor(*args, capacity=512, device="cpu").describe(
        torch.from_numpy(img), kp)
    assert len(tdesc) == len(jdesc) == 300
    assert [d is None for d in tdesc] == [d is None for d in jdesc]
    pairs = [(t, j) for t, j in zip(tdesc, jdesc) if j is not None]
    assert len(pairs) > 100
    diff = sum(int(np.unpackbits(t ^ j).sum()) for t, j in pairs)
    assert diff <= 0.001 * 256 * len(pairs), diff


def test_extractor_brief_seed_matches_jax():
    """The port's Extractor takes the JAX package's parameters in the same
    positional order (brief_seed before subpix), and a non-default seed
    given positionally draws the JAX package's pattern and descriptors."""
    import inspect

    import jax.numpy as jnp
    from slamtpu.models.extractor import Extractor as JExtractor
    from slamtpu_torch.models.extractor import Extractor as TExtractor

    def positional(cls):
        return [p.name for p in inspect.signature(cls).parameters.values()
                if p.kind == p.POSITIONAL_OR_KEYWORD]

    assert positional(TExtractor) == positional(JExtractor)
    img, kp, _ = _image_and_keypoints()
    args = (400, 12, (7, 10), 24, 1e-4, 512, 7)
    jex = JExtractor(*args)
    tex = TExtractor(*args, device="cpu")
    assert not tex.subpix
    np.testing.assert_array_equal(tex.pattern.numpy(),
                                  np.asarray(jex.pattern))
    assert not np.array_equal(tex.pattern.numpy(), tfeat.brief_pattern())
    jdesc = jex.describe(jnp.asarray(img), kp)
    tdesc = tex.describe(torch.from_numpy(img), kp)
    assert [d is None for d in tdesc] == [d is None for d in jdesc]
    pairs = [(t, j) for t, j in zip(tdesc, jdesc) if j is not None]
    assert len(pairs) > 100
    diff = sum(int(np.unpackbits(t ^ j).sum()) for t, j in pairs)
    assert diff <= 0.001 * 256 * len(pairs), diff


@pytest.fixture(scope="module")
def runs():
    merges = {"jax": 0, "torch": 0}
    mp = pytest.MonkeyPatch()
    for name, cls in (("jax", JMapManager), ("torch", TMapManager)):
        orig = cls.merge_mappoints

        def counted(self, prev_id, new_id, _orig=orig, _name=name):
            merges[_name] += 1
            _orig(self, prev_id, new_id)

        mp.setattr(cls, "merge_mappoints", counted)
    try:
        j = _run("jax", do_local_matching=True)
        j["summary"] = jax_profiling.TIMERS.summary()
        t = _run("torch", do_local_matching=True)
        t["summary"] = torch_profiling.TIMERS.summary()
    finally:
        mp.undo()
    return {"jax": j, "torch": t, "merges": merges}


def _descriptors(sm):
    return sum(1 for mp in sm.map_manager.map_points.values()
               if mp.descriptor is not None)


def test_brief_path_matches_jax(runs):
    j, t = runs["jax"], runs["torch"]
    assert_paths_match(j, t)
    calls = stage_calls(t["summary"])
    assert calls == stage_calls(j["summary"]), calls
    # BRIEF keyframes take the classic keyframe: no keyframe program.
    assert calls["mp.kf_async.dispatch"] == 0 and calls["mp.kf_fused"] == 0
    assert calls["fe.pipe.dispatch"] >= 5
    n_j, n_t = _descriptors(j["sm"]), _descriptors(t["sm"])
    assert n_j > 50 and abs(n_t - n_j) <= 0.05 * n_j, (n_t, n_j)
    m_j, m_t = runs["merges"]["jax"], runs["merges"]["torch"]
    assert m_j >= 1 and abs(m_t - m_j) <= max(1, 0.2 * m_j), (m_t, m_j)
