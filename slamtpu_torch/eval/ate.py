"""Trajectory evaluation: absolute trajectory error with Umeyama alignment.

The reference loads KITTI ground-truth poses but never compares in code
(SURVEY.md section 4); this harness closes that gap for regression testing.

The port's own copy of slamtpu/eval/ate.py: slamtpu_torch imports nothing of
the JAX package, so its host modules live here too.
"""
from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = True):
    """Least-squares similarity transform aligning src -> dst.

    src, dst: (N, 3). Returns (s, R, t) with dst ~= s * R @ src + t.
    """
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var_s = (xs ** 2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var_s) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(estimated: np.ndarray, ground_truth: np.ndarray,
             align_scale: bool = True) -> float:
    """RMSE of aligned trajectory positions. (N, 3) each, same length."""
    assert estimated.shape == ground_truth.shape
    if len(estimated) < 3:
        return float("nan")
    s, R, t = umeyama_alignment(estimated, ground_truth,
                                with_scale=align_scale)
    aligned = (s * (R @ estimated.T)).T + t
    return float(np.sqrt(np.mean(np.sum((aligned - ground_truth) ** 2,
                                        axis=-1))))
