"""The port's motion-only BA (``optim.ba.pose_optimization``) against the
JAX reference on the same matched inputs: 400 points, 10 % gross
outliers, half-pixel noise, a perturbed start pose; once with 60 % stereo
observations and once monocular only.

Tolerances: R and t within 1e-4 (the 6x6 normal equations sum in another
order than XLA), inlier masks agree on >= 99 %.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_detailed_comments_kor_tpu.optim import ba as jba
from orb_slam3_detailed_comments_kor_tpu_torch.optim import ba as tba

FX, BF = 230.0, 0.11 * 230.0
CAM = np.array([FX, FX, 188.0, 120.0], np.float32)


def _pose_problem(stereo_frac, seed=0, n=400):
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(2, 8, n)], -1)
    ang = 0.05
    R_true = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
    t_true = np.array([0.1, -0.05, 0.2])
    pc = X @ R_true.T + t_true
    uv = FX * pc[:, :2] / pc[:, 2:] + CAM[2:]
    uv += rng.normal(scale=0.5, size=uv.shape)
    u_right = np.where(rng.random(n) < stereo_frac, uv[:, 0] - BF / pc[:, 2], -1.0)
    out = rng.random(n) < 0.1  # gross outliers
    uv[out] += rng.uniform(20, 40, size=(out.sum(), 2))
    level = rng.integers(0, 4, n)
    inv_sigma2 = 1.0 / (1.2 ** (2.0 * level))
    valid = rng.random(n) < 0.95
    R0 = np.eye(3)
    t0 = t_true + np.array([0.03, -0.02, 0.04])
    f32 = lambda a: np.asarray(a, np.float32)
    return tuple(map(f32, (R0, t0, X, uv, u_right, inv_sigma2))) + (valid,)


@pytest.mark.parametrize("stereo_frac", [0.6, 0.0])
def test_pose_optimization_agrees(stereo_frac):
    args = _pose_problem(stereo_frac)
    rj = jba.pose_optimization(*map(jnp.asarray, args), jnp.asarray(CAM), BF)
    rt = tba.pose_optimization(*map(torch.from_numpy, args), torch.from_numpy(CAM), BF)
    np.testing.assert_allclose(np.asarray(rj.R_cw), rt.R_cw.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(np.asarray(rj.t_cw), rt.t_cw.numpy(), rtol=0, atol=1e-4)
    inl_j = np.asarray(rj.inlier)
    assert (inl_j == rt.inlier.numpy()).mean() >= 0.99
    assert 300 < inl_j.sum() < 360  # the outliers were rejected
