"""The port's Schur-complement bundle adjustment against the JAX reference
on the CPU: ``bundle_adjust``, ``_build_normal_blocks`` and
``_eval_weights`` on synthetic windows made from a numpy seed.

A window: 6 keyframes along a 0.5 m strafe (the first fixed), 300 points
at 1.5-4 m, 4 observations each at pyramid levels 0-3 (sigma 1.2^level,
0.5 px noise), 60 % stereo rows, 10 % outliers displaced by up to 40 px,
5 % invalid rows, 5 % fixed points; every point keeps two valid stereo
inlier rows, so no point is unobservable. The initial guess is off by
3 mrad, 1 cm and 3 cm.

Tolerances (10 LM iterations): poses within 1e-4 rad and 1e-4 m, points
within 1e-3 m, final chi2 within rtol 1e-3 (plus 1e-4 absolute, for rows
whose chi2 is near 0), inlier masks >= 99.5 % equal. The normal blocks and
weights of one linearization: rtol 1e-5. The port sums in another order
than XLA, so nothing here is bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_detailed_comments_kor_tpu.optim import ba as jba
from orb_slam3_detailed_comments_kor_tpu.optim import factors as jf
from orb_slam3_detailed_comments_kor_tpu_torch.optim import ba as tba
from orb_slam3_detailed_comments_kor_tpu_torch.optim import factors as tf
from orb_slam3_detailed_comments_kor_tpu_torch.utils import lie as tlie

CAM = np.array([230.0, 230.0, 188.0, 120.0], np.float32)
BF = 0.11 * 230.0


def _rot(rng, sigma):
    w = torch.from_numpy(rng.normal(0.0, sigma, 3).astype(np.float32))
    return tlie.so3_exp(w).numpy()


def make_window(seed, K=6, L=300, per=4):
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-2, 2, L), rng.uniform(-1.5, 1.5, L), rng.uniform(1.5, 4, L)], 1)
    centres = np.stack([np.linspace(0, 0.5, K), rng.normal(0, 0.02, K), rng.normal(0, 0.02, K)], 1)
    R = np.stack([_rot(rng, 0.02) for _ in range(K)])
    t = -np.einsum("kij,kj->ki", R, centres)
    kf = np.concatenate([rng.choice(K, size=per, replace=False) for _ in range(L)])
    lm = np.repeat(np.arange(L), per)
    O = kf.size
    pc = np.einsum("oij,oj->oi", R[kf], X[lm]) + t[kf]
    u = CAM[0] * pc[:, 0] / pc[:, 2] + CAM[2]
    v = CAM[1] * pc[:, 1] / pc[:, 2] + CAM[3]
    sig = 1.2 ** rng.integers(0, 4, O)
    keep = np.zeros(O, bool)
    keep[0::per] = keep[1::per] = True  # two valid stereo inlier rows a point
    stereo = (rng.random(O) < 0.6) | keep
    outlier = (rng.random(O) < 0.1) & ~keep
    valid = (rng.random(O) < 0.95) | keep
    uv = np.stack([u, v], 1) + rng.normal(0, 0.5, (O, 2)) * sig[:, None]
    uv[outlier] += rng.uniform(-40, 40, (outlier.sum(), 2))
    ur = np.where(stereo, u - BF / pc[:, 2] + rng.normal(0, 0.5, O) * sig, -1.0)
    R0 = np.einsum("kij,kjl->kil", np.stack([_rot(rng, 0.003) for _ in range(K)]), R)
    fixed_pose = np.zeros(K, bool)
    fixed_pose[0] = True
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        R=f32(R0), t=f32(t + rng.normal(0, 0.01, (K, 3))), X=f32(X + rng.normal(0, 0.03, X.shape)),
        kf=kf, lm=lm, uv=f32(uv), ur=f32(ur), inv_s2=f32(1.0 / sig ** 2), valid=valid,
        fixed_pose=fixed_pose, fixed_point=rng.random(L) < 0.05,
    )


def jax_obs(w):
    return jf.Observations(
        kf=jnp.asarray(w["kf"], jnp.int32), lm=jnp.asarray(w["lm"], jnp.int32),
        uv=jnp.asarray(w["uv"]), u_right=jnp.asarray(w["ur"]),
        inv_sigma2=jnp.asarray(w["inv_s2"]), valid=jnp.asarray(w["valid"]),
    )


def torch_obs(w):
    T = torch.from_numpy
    return tf.Observations(
        kf=T(w["kf"]).long(), lm=T(w["lm"]).long(), uv=T(w["uv"]), u_right=T(w["ur"]),
        inv_sigma2=T(w["inv_s2"]), valid=T(w["valid"]),
    )


def rotation_angles(Ra, Rb):
    M = np.einsum("kji,kjl->kil", Ra.astype(np.float64), Rb.astype(np.float64))
    skew = np.stack([M[:, 2, 1] - M[:, 1, 2], M[:, 0, 2] - M[:, 2, 0], M[:, 1, 0] - M[:, 0, 1]], -1)
    return np.arcsin(np.clip(np.linalg.norm(skew, axis=1) / 2.0, 0.0, 1.0))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bundle_adjust_matches_reference(seed):
    w = make_window(seed)
    j = jba.bundle_adjust(
        jnp.asarray(w["R"]), jnp.asarray(w["t"]), jnp.asarray(w["X"]), jax_obs(w),
        jnp.asarray(w["fixed_pose"]), jnp.asarray(w["fixed_point"]), jnp.asarray(CAM), BF, iters=10,
    )
    T = torch.from_numpy
    t = tba.bundle_adjust(
        T(w["R"]), T(w["t"]), T(w["X"]), torch_obs(w), T(w["fixed_pose"]), T(w["fixed_point"]),
        T(CAM), BF, iters=10,
    )
    j = [np.asarray(x) for x in j]
    t = [x.numpy() for x in t]
    # the solve moved the window: a no-op would pass the comparisons too
    assert np.abs(j[1] - w["t"]).max() > 5e-3
    assert rotation_angles(j[0], t[0]).max() <= 1e-4
    assert np.abs(j[1] - t[1]).max() <= 1e-4
    assert np.abs(j[2] - t[2]).max() <= 1e-3
    np.testing.assert_allclose(t[3], j[3], rtol=1e-3, atol=1e-4)
    assert (j[4] == t[4]).mean() >= 0.995
    assert 0 < t[4].sum() < t[4].size  # the gate kept inliers and dropped outliers


def test_normal_blocks_match_reference():
    w = make_window(3)
    K, L = w["R"].shape[0], w["X"].shape[0]
    jo, to = jax_obs(w), torch_obs(w)
    rj, mj, _ = jf.reproj_residuals(jnp.asarray(w["R"]), jnp.asarray(w["t"]), jnp.asarray(w["X"]), jo,
                                    jnp.asarray(CAM), BF)
    _, wj, _ = jba._eval_weights(rj, jo, True)
    wj = jo.inv_sigma2 * wj * jo.valid
    blocks_j = jba._build_normal_blocks(jnp.asarray(w["R"]), jnp.asarray(w["t"]), jnp.asarray(w["X"]),
                                        jo, jnp.asarray(CAM), BF, wj, mj)
    T = torch.from_numpy
    rt, mt, _ = tf.reproj_residuals(T(w["R"]), T(w["t"]), T(w["X"]), to, T(CAM), BF)
    _, wt, _ = tba._eval_weights(rt, to, True)
    wt = to.inv_sigma2 * wt * to.valid
    blocks_t = tba._build_normal_blocks(T(w["R"]), T(w["t"]), T(w["X"]), to, T(CAM), BF, wt, mt)
    shapes = [(K, 6, 6), (L, 3, 3), (K, 6), (L, 3), (K, 6, L, 3)]
    for bj, bt, shape in zip(blocks_j, blocks_t, shapes):
        assert tuple(bt.shape) == shape
        bj = np.asarray(bj)
        np.testing.assert_allclose(bt.numpy(), bj, rtol=1e-5, atol=1e-5 * np.abs(bj).max())


def test_normal_blocks_segmented_scan_match_reference():
    # the card's form of the sums (segmented scans over the sorted rows,
    # run here on the CPU) against the reference, at the same tolerance
    w = make_window(6)
    K, L = w["R"].shape[0], w["X"].shape[0]
    jo, to = jax_obs(w), torch_obs(w)
    rj, mj, _ = jf.reproj_residuals(jnp.asarray(w["R"]), jnp.asarray(w["t"]), jnp.asarray(w["X"]), jo,
                                    jnp.asarray(CAM), BF)
    _, wj, _ = jba._eval_weights(rj, jo, True)
    blocks_j = jba._build_normal_blocks(jnp.asarray(w["R"]), jnp.asarray(w["t"]), jnp.asarray(w["X"]),
                                        jo, jnp.asarray(CAM), BF, jo.inv_sigma2 * wj * jo.valid, mj)
    T = torch.from_numpy
    rt, mt, _ = tf.reproj_residuals(T(w["R"]), T(w["t"]), T(w["X"]), to, T(CAM), BF)
    _, wt, _ = tba._eval_weights(rt, to, True)
    segs = (tba._segments(to.kf, K), tba._segments(to.lm, L), tba._segments(to.kf * L + to.lm, K * L))
    assert tba._normal_segments(to, K, L) is None  # the CPU path keeps index_add_
    blocks_t = tba._build_normal_blocks(T(w["R"]), T(w["t"]), T(w["X"]), to, T(CAM), BF,
                                        to.inv_sigma2 * wt * to.valid, mt, segs=segs)
    for bj, bt in zip(blocks_j, blocks_t):
        bj = np.asarray(bj)
        np.testing.assert_allclose(bt.numpy(), bj, rtol=1e-5, atol=1e-5 * np.abs(bj).max())


@pytest.mark.parametrize("use_huber", [True, False])
def test_eval_weights_match_reference(use_huber):
    w = make_window(4)
    jo, to = jax_obs(w), torch_obs(w)
    r = np.random.default_rng(5).normal(0.0, 3.0, (w["kf"].size, 3)).astype(np.float32)
    out_j = jba._eval_weights(jnp.asarray(r), jo, use_huber)
    out_t = tba._eval_weights(torch.from_numpy(r), to, use_huber)
    for a, b in zip(out_j, out_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5)
    assert (out_t[1].numpy() < 1.0).any() == use_huber
