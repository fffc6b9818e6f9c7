"""The port's RGB-D path against the JAX reference on the CPU.

One module fixture runs both packages' RGB-D ``SlamSystem``s, one after
the other, on the same numpy images and depth maps:
``chip_smoke.sensor_config("rgbd", small=True)``, which is
``tests/test_slam_e2e.small_config()`` (240x376, 600 features) with an
RGBD sensor and synchronous decisions, over the strafe of
``tests/test_rgbd_reloc.py:17-36`` (0.03 m/frame) cut to 16 frames, loop
closing on. The reference's ``full_rgbd_step`` calls are captured with
their inputs and outputs.

Tolerances: the keyframe frames and the lifecycle counters exactly;
per-frame camera centres within 2e-3 m and rotations within 1e-3 rad;
landmarks within 2 %. ``process_rgbd`` (without and with radial-tangential
distortion): levels, descriptors, validity and the depth mask exactly,
keypoints within 1e-4 px, depths within 1e-6 m and the synthetic right u
within 1e-3 px. ``full_rgbd_step`` on the reference's captured inputs: the
track association and the inlier count exactly, the pose within 1e-4.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_slam_e2e import small_config
from test_torch_system import to_jax_config
from orb_slam3_detailed_comments_kor_tpu import config as jcfg
from orb_slam3_detailed_comments_kor_tpu.slam import frontend as jfe
from orb_slam3_detailed_comments_kor_tpu.slam import tracking as jtr
from orb_slam3_detailed_comments_kor_tpu.slam.system import SlamSystem as JaxSlam
from orb_slam3_detailed_comments_kor_tpu_torch.config import SensorType
from orb_slam3_detailed_comments_kor_tpu_torch.slam import frontend as tfe
from orb_slam3_detailed_comments_kor_tpu_torch.slam import map_state as tms
from orb_slam3_detailed_comments_kor_tpu_torch.slam import tracking as ttr
from orb_slam3_detailed_comments_kor_tpu_torch.slam.system import SlamSystem as TorchSlam

FRAMES = 16
DIST = (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05)


def npy(x):
    """numpy copies of a (nested) NamedTuple, dict, tuple or array."""
    if hasattr(x, "_asdict"):
        return {k: npy(v) for k, v in x._asdict().items()}
    if isinstance(x, dict):
        return {k: npy(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(npy(v) for v in x)
    return np.array(x) if hasattr(x, "shape") else x


def T(a):
    return torch.from_numpy(np.array(a))


def close(ref, got, tol, rtol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=tol)


def rgbd_config():
    return chip_smoke.sensor_config("rgbd", small=True)


def run(system, frames):
    """Feed the (image, depth) frames; record the keyframe frames."""
    kf_at = []
    for i, (img, depth) in enumerate(frames):
        n0 = system.stats["kf_inserted"]
        system.track_rgbd(img, depth, i / chip_smoke.FPS)
        if system.stats["kf_inserted"] != n0:
            kf_at.append(i)
    system.flush_decisions()
    return dict(system=system, kf_at=kf_at, traj=system.trajectory_arrays(), stats=dict(system.stats),
                state=system.state, n_landmarks=int(np.asarray(system.ms.lm_valid).sum()))


@pytest.fixture(scope="module")
def rgbd():
    cfg = rgbd_config()
    ts, frames, _ = chip_smoke.render_sensor_sequence("rgbd", cfg, FRAMES, "cpu")
    frames = [(img.numpy(), depth.numpy()) for img, depth in frames]
    captured = []
    saved = jtr.full_rgbd_step

    def capture(*a, **k):
        args = (npy(a), npy(k))  # before the call: the step donates its map
        out = saved(*a, **k)
        captured.append(args + (npy(out),))
        return out

    jtr.full_rgbd_step = capture
    try:
        out = dict(j=run(JaxSlam(to_jax_config(cfg)), frames))
    finally:
        jtr.full_rgbd_step = saved
    out["t"] = run(TorchSlam(cfg, device="cpu"), frames)
    out.update(cfg=cfg, ts=ts, frames=frames, captured=captured)
    return out


def test_small_rgbd_config():
    """The small RGB-D configuration is small_config() (240x376, 600
    features) with an RGBD sensor and synchronous decisions."""
    assert to_jax_config(rgbd_config()) == dataclasses.replace(
        small_config(), sensor=SensorType.RGBD,
        tracking=jcfg.TrackingConfig(max_frames_between_kf=10, decision_batch=1))


def test_rgbd_keyframes_and_stats(rgbd):
    j, t = rgbd["j"], rgbd["t"]
    assert t["kf_at"] == j["kf_at"] and len(j["kf_at"]) >= 2
    assert t["stats"] == j["stats"]
    assert t["state"] == j["state"] == 1


def test_rgbd_per_frame_poses(rgbd):
    d_centre, d_rot = chip_smoke.trajectory_diff(rgbd["j"]["traj"], rgbd["t"]["traj"])
    assert len(d_centre) == FRAMES
    assert d_centre.max() <= 2e-3, np.round(d_centre * 1e3, 3).tolist()
    assert d_rot.max() <= 1e-3


def test_rgbd_map_and_ate(rgbd):
    from orb_slam3_detailed_comments_kor_tpu_torch.eval import ate

    j, t = rgbd["j"], rgbd["t"]
    assert abs(t["n_landmarks"] - j["n_landmarks"]) <= 0.02 * j["n_landmarks"]
    ate_j = ate.ate_rmse(j["traj"][1], rgbd["ts"])
    ate_t = ate.ate_rmse(t["traj"][1], rgbd["ts"])
    assert ate_t <= ate_j + 2e-3 and ate_j < 0.02


@pytest.mark.parametrize("dist", [None, DIST])
def test_process_rgbd(rgbd, dist):
    cfg = rgbd["cfg"]
    c, orb = cfg.camera, cfg.orb
    cam = np.array([c.fx, c.fy, c.cx, c.cy], np.float32)
    img, depth = rgbd["frames"][3]
    kw = dict(n_features=orb.n_features, n_levels=orb.n_levels, scale=orb.scale_factor, cell=orb.cell_size,
              dist=dist)
    ref = npy(jfe.process_rgbd(jnp.asarray(img), jnp.asarray(depth), c.bf, cam_params=jnp.asarray(cam), **kw))
    got = tfe.process_rgbd(T(img), T(depth), c.bf, cam_params=T(cam), **kw)
    for f in ("level", "desc", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), ref[f], err_msg=f)
    np.testing.assert_array_equal(got.depth.numpy() > 0, ref["depth"] > 0)
    assert (ref["depth"] > 0).sum() > 200
    close(ref["xy"], got.xy, 1e-4)
    close(ref["depth"], got.depth, 1e-6)
    close(ref["u_right"], got.u_right, 1e-3)
    assert got.uv_r is None and ref["uv_r"] is None


def test_full_rgbd_step_captured(rgbd):
    """The first tracked frame and the last frame of the run."""
    calls = rgbd["captured"]
    assert len(calls) == FRAMES - 1
    for a, kw, ref in (calls[0], calls[-1]):
        got = ttr.full_rgbd_step(tms.map_state_from_numpy(a[0], "cpu"), T(a[1]), T(a[2]),
                                 *(T(x) for x in a[3:9]), **kw)
        ms, frame, tr, R, t, vR, vt, ok = got
        for f in ("level", "desc", "valid"):
            np.testing.assert_array_equal(getattr(frame, f).numpy(), ref[1][f], err_msg=f)
        np.testing.assert_array_equal(tr.lm_feat.numpy(), ref[2]["lm_feat"])
        assert int(tr.n_inliers) == int(ref[2]["n_inliers"]) > 100 and bool(ok) == bool(ref[7])
        close(ref[3], R, 1e-4)
        close(ref[4], t, 1e-4)
        np.testing.assert_array_equal(tms.map_state_to_numpy(ms)["lm_found"], ref[0]["lm_found"])
