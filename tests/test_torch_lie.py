"""The port's SO(3)/SE(3) functions against the JAX reference on 64 random
rotations and poses, within 1e-5 (float32 transcendental functions and
matmul order differ between the two libraries).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from orb_slam3_detailed_comments_kor_tpu.utils import lie as jlie
from orb_slam3_detailed_comments_kor_tpu_torch.utils import lie as tlie


def _rotvecs(seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(64, 3)).astype(np.float32) * np.float32(0.8)
    w[:4] *= 1e-6  # small-angle branches
    return rng, w


def _so3_suite(L, w, wpi, Rn):
    R = L.so3_exp(w)
    return dict(
        hat=L.hat(w), vee=L.vee(L.hat(w)), exp=R, log=L.so3_log(R),
        log_pi=L.so3_log(L.so3_exp(wpi)), jl=L.so3_left_jacobian(w),
        proj=L.project_to_so3(Rn),
    )


def _se3_suite(L, xi):
    Rx, tx = L.se3_exp(xi)
    Ri, ti = L.se3_inverse(Rx, tx)
    Rc, tc = L.se3_compose(Rx, tx, Ri, ti + 1.0)
    return dict(se3_R=Rx, se3_t=tx, inv_R=Ri, inv_t=ti, comp_R=Rc, comp_t=tc)


def _compare(suite, *args):
    ref = jax.jit(lambda *a: suite(jlie, *a))(*map(jnp.asarray, args))
    got = suite(tlie, *map(torch.from_numpy, args))
    for k in ref:
        np.testing.assert_allclose(np.asarray(ref[k]), got[k].numpy(), rtol=0, atol=1e-5, err_msg=k)


def test_so3_functions():
    rng, w = _rotvecs(0)
    # near-pi rotations take the diagonal branch of so3_log
    wpi = (w / np.linalg.norm(w, axis=1, keepdims=True) * 3.1).astype(np.float32)
    # perturbed rotations to project back onto SO(3)
    R = np.asarray(jlie.so3_exp(w))
    Rn = (R + 1e-3 * rng.normal(size=R.shape)).astype(np.float32)
    _compare(_so3_suite, w, wpi, Rn)


def test_se3_functions():
    rng, w = _rotvecs(1)
    xi = np.concatenate([rng.normal(size=(64, 3)), w], axis=1).astype(np.float32)
    _compare(_se3_suite, xi)
