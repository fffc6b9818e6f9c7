"""The port's stereo SLAM loop (``slam.system.SlamSystem``, loop closing
off on both sides) against the JAX reference's on the CPU: both systems take the same
16 numpy stereo pairs of the strafe sequence at the 240x376 / 600-feature
geometry of ``tests/test_slam_e2e.py`` (``chip_smoke.loop_config(small=
True)``: 8 keyframe slots, so capacity reclaim runs; a keyframe every
second frame, ``kf_ref_ratio`` 0.5 so the frame gap decides every
insertion; ``decision_batch`` 1, so the decisions land at fixed frames).

Tolerances: the same keyframe frames and lifecycle counters exactly;
per-frame camera centres within 2e-3 m and rotations within 1e-3 rad
(the final trajectories, keyframe-relative records composed with the
final keyframe poses); |n_inliers difference| <= max(3, 2 %) per
decision; landmark counts within 2 %; the port's ATE at most the
reference's plus 2 mm.
"""

import concurrent.futures
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import chip_smoke  # noqa: E402
import test_slam_e2e as e2e  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu import config as jcfg  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu.eval import ate  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu.io import synthetic as jsyn  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu.slam.system import SlamSystem as JaxSlam  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu_torch.slam.system import SlamSystem as TorchSlam  # noqa: E402

N_FRAMES = chip_smoke.SMALL_LOOP_FRAMES


def to_jax_config(cfg):
    """The reference's config dataclasses with the port config's values."""
    if dataclasses.is_dataclass(cfg):
        cls = getattr(jcfg, type(cfg).__name__)
        return cls(**{f.name: to_jax_config(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)})
    return cfg


def run(system, imgs):
    """Feed the pairs; record the frames that insert a keyframe, each
    decision's (dispatch index, n_inliers) and each keyframe test's
    (gap, n_inliers, inliers at the last keyframe, verdict)."""
    decisions, tests, kf_at = [], [], []
    decide, need = system._decide, system._need_new_keyframe

    def spy_decide(frame, tr, t, n_inliers=None, dispatch_idx=None):
        decisions.append((dispatch_idx, n_inliers))
        return decide(frame, tr, t, n_inliers=n_inliers, dispatch_idx=dispatch_idx)

    def spy_need(frame, n_inliers, gap=None):
        verdict = need(frame, n_inliers, gap)
        tests.append((gap, n_inliers, system.inliers_at_last_kf, verdict))
        return verdict

    system._decide, system._need_new_keyframe = spy_decide, spy_need
    for i, (il, ir) in enumerate(imgs):
        n0 = system.stats["kf_inserted"]
        system.track_stereo(il, ir, i / chip_smoke.FPS)
        if system.stats["kf_inserted"] != n0:
            kf_at.append(i)
    return dict(
        system=system, kf_at=kf_at, decisions=decisions, tests=tests, traj=system.trajectory_arrays(),
        stats=dict(system.stats), state=system.state, n_landmarks=system.map_stats()["n_landmarks"],
    )


@pytest.fixture(scope="module")
def loops():
    cfg = chip_smoke.loop_config(small=True)
    jax_cfg = to_jax_config(cfg)
    ref = e2e.small_config()
    assert (jax_cfg.camera, jax_cfg.orb) == (ref.camera, ref.orb)  # the e2e test's geometry
    cam = cfg.camera
    params = jnp.array([cam.fx, cam.fy, cam.cx, cam.cy])
    scene = jsyn.default_scene()
    Rs, ts = jsyn.make_trajectory(N_FRAMES, motion="strafe", speed=chip_smoke.SPEED)
    imgs = []
    for i in range(N_FRAMES):
        il, ir, _ = jsyn.stereo_pair(params, jnp.asarray(Rs[i]), jnp.asarray(ts[i]), chip_smoke.BASELINE,
                                     scene, h=cam.height, w=cam.width)
        imgs.append((np.array(il), np.array(ir)))
    jax_system = JaxSlam(jax_cfg)
    jax_system.enable_loop_closing = False
    torch_system = TorchSlam(cfg, device="cpu")
    torch_system.enable_loop_closing = False
    # the two runs are independent: overlap them (each is deterministic)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        j = pool.submit(run, jax_system, imgs)
        t = pool.submit(run, torch_system, imgs)
        return j.result(), t.result(), ts, cfg


def test_same_keyframes_and_lifecycle(loops):
    j, t, _, cfg = loops
    assert t["kf_at"] == j["kf_at"]
    assert t["stats"] == j["stats"]
    assert t["state"] == j["state"] == 1
    assert t["stats"]["reclaims"] >= 1 and j["stats"]["reclaims"] >= 1
    assert len(t["traj"][0]) == len(j["traj"][0]) == N_FRAMES


def test_frame_gap_decides_every_insertion(loops):
    j, t, _, cfg = loops
    tc = cfg.tracking
    for run_ in (j, t):
        inserted = [(gap, n, last) for gap, n, last, verdict in run_["tests"] if verdict]
        assert len(inserted) == run_["stats"]["kf_inserted"] - 1  # all but the initial keyframe
        for gap, n, last in inserted:
            assert gap == tc.max_frames_between_kf
            # the other two rules would not have inserted it
            assert n >= tc.kf_ref_ratio * max(last, 1) and n >= 2 * tc.min_inliers_local_map


def test_per_frame_poses(loops):
    j, t, _, _ = loops
    d_centre, d_rot = chip_smoke.trajectory_diff(j["traj"], t["traj"])
    assert d_centre.max() <= 2e-3, np.round(d_centre * 1e3, 3).tolist()
    assert d_rot.max() <= 1e-3, d_rot.tolist()


def test_inliers_per_decision(loops):
    j, t, _, _ = loops
    assert [d[0] for d in j["decisions"]] == [d[0] for d in t["decisions"]]
    for (_, nj), (_, nt) in zip(j["decisions"], t["decisions"]):
        assert abs(nj - nt) <= max(3, 0.02 * nj)


def test_landmark_count(loops):
    j, t, _, _ = loops
    assert abs(t["n_landmarks"] - j["n_landmarks"]) <= 0.02 * j["n_landmarks"]


def test_ate(loops):
    j, t, ts, _ = loops
    ate_j = ate.ate_rmse(j["traj"][1], ts[:N_FRAMES])
    ate_t = ate.ate_rmse(t["traj"][1], ts[:N_FRAMES])
    assert ate_t <= ate_j + 2e-3 and ate_j < 0.05
