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

After those, both systems' maps go through checkpoints (``save_map`` /
``load_map``, the reference's ``.npz`` layout): a map that either package
saves loads in the other with every array, scalar and shelved map exactly
as written, and each snapshot, loaded by both packages, tracks two more
frames with poses within 2e-3 m / 1e-3 rad of each other; a capacity
mismatch raises. Then localization mode: both systems track four more
frames with no keyframe inserted, poses within 2e-3 m / 1e-3 rad; and the
localization-mode VO fallback on one frame pair of that run, within 1e-4.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import test_slam_e2e as e2e
from orb_slam3_detailed_comments_kor_tpu import config as jcfg
from orb_slam3_detailed_comments_kor_tpu.eval import ate
from orb_slam3_detailed_comments_kor_tpu.io import synthetic as jsyn
from orb_slam3_detailed_comments_kor_tpu.slam.system import SlamSystem as JaxSlam
from orb_slam3_detailed_comments_kor_tpu_torch.slam import frontend as tfe
from orb_slam3_detailed_comments_kor_tpu_torch.slam import map_state as tms
from orb_slam3_detailed_comments_kor_tpu_torch.slam.system import SlamSystem as TorchSlam

N_FRAMES = chip_smoke.SMALL_LOOP_FRAMES
# frames after the fixture's: four in localization mode (the first two
# also resume each checkpoint)
N_EXTRA = 4
# the reference's localization-mode stashes (last tracked frame, pose), in order
LOC_STASHES = []


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
    return run(jax_system, imgs), run(torch_system, imgs), ts, cfg


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


@pytest.fixture(scope="module")
def extra(loops):
    """The strafe sequence's next N_EXTRA pairs (numpy) and their frames as
    the reference extracts them."""
    cam = loops[3].camera
    params = jnp.array([cam.fx, cam.fy, cam.cx, cam.cy])
    scene = jsyn.default_scene()
    Rs, ts = jsyn.make_trajectory(N_FRAMES + N_EXTRA, motion="strafe", speed=chip_smoke.SPEED)
    imgs = []
    for i in range(N_FRAMES, N_FRAMES + N_EXTRA):
        il, ir, _ = jsyn.stereo_pair(params, jnp.asarray(Rs[i]), jnp.asarray(ts[i]), chip_smoke.BASELINE,
                                     scene, h=cam.height, w=cam.width)
        imgs.append((np.array(il), np.array(ir)))
    return imgs


def new_system(package, cfg):
    system = JaxSlam(to_jax_config(cfg)) if package == "jax" else TorchSlam(cfg, device="cpu")
    system.enable_loop_closing = False
    return system


def system_arrays(system):
    """Everything a checkpoint holds, as numpy, from either package."""
    if isinstance(system, TorchSlam):
        ms = lambda m: tms.map_state_to_numpy(m)
    else:
        ms = lambda m: {k: np.asarray(v) for k, v in m._asdict().items()}
    out = {f"ms_{k}": v for k, v in ms(system.ms).items()}
    for name in ("R_cw", "t_cw", "vel_R", "vel_t"):
        out[name] = np.asarray(getattr(system, name))
    out["lc_bow_words"] = np.asarray(system.loop_closer.db_words)
    out["lc_bow_wts"] = np.asarray(system.loop_closer.db_wts)
    for i, m in enumerate(system.atlas_maps):
        out.update({f"atlas{i}_ms_{k}": v for k, v in ms(m["ms"]).items()})
        out[f"atlas{i}_bow_words"] = np.asarray(m["loop_closer"].db_words)
        out[f"atlas{i}_bow_wts"] = np.asarray(m["loop_closer"].db_wts)
    scalars = dict(state=int(system.state), n_kf=system.n_kf, frames_since_kf=system.frames_since_kf,
                   inliers_at_last_kf=system.inliers_at_last_kf, n_frames=system.n_frames,
                   has_velocity=bool(system.has_velocity), kf_times_host=list(system._kf_times_host),
                   kf_lowq_host=list(system._kf_lowq_host), n_loops=system.loop_closer.n_loops_closed,
                   atlas=[(m["n_kf"], m["traj_end"], m["gen"], list(m["kf_times"]), list(m["kf_lowq"]),
                           [np.asarray(x, np.float64).tolist() for x in m["merge_prior"][:2]]
                           + list(m["merge_prior"][2:])) for m in system.atlas_maps])
    return out, scalars


def assert_same_arrays(written, loaded):
    """Two ``system_arrays`` results are equal, array for array."""
    (a, sa), (b, sb) = written, loaded
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert sa == sb


def assert_loaded(written, loaded):
    """``loaded`` (a system after load_map) holds exactly what ``written``
    (the system that saved) held."""
    assert_same_arrays(system_arrays(written), system_arrays(loaded))


def track(system, imgs, t0, stashes=None):
    for i, (il, ir) in enumerate(imgs):
        system.track_stereo(il, ir, t0 + i / chip_smoke.FPS)
        if stashes is not None and getattr(system, "_loc_prev", None) is not None:
            if not stashes or stashes[-1] is not system._loc_prev:
                stashes.append(system._loc_prev)
    system.flush_decisions()
    return system.trajectory_arrays()


def test_checkpoints_cross_packages(loops, extra, tmp_path):
    """A map that either package saves loads in the other exactly, with a
    shelved Atlas map and its merge prior; each snapshot, loaded by both
    packages, tracks two more frames alike; a v1 snapshot's dense BoW
    databases load as the rows that were saved; other capacities raise."""
    cfg = loops[3]
    t_next = N_FRAMES / chip_smoke.FPS
    for name, written in (("jax", loops[0]["system"]), ("port", loops[1]["system"])):
        path = str(tmp_path / f"{name}.npz")
        written.save_map(path)
        both = {pkg: new_system(pkg, cfg) for pkg in ("jax", "port")}
        for pkg, system in both.items():
            system.load_map(path)
            assert_loaded(written, system)
        trajs = [track(system, extra[:2], t_next) for system in both.values()]
        d_centre, d_rot = chip_smoke.trajectory_diff(*trajs)
        assert len(d_centre) == 2 and d_centre.max() <= 2e-3 and d_rot.max() <= 1e-3, (d_centre, d_rot)
        # a shelved map with its merge prior crosses over too: each resumed
        # system shelves its map and the other package loads it
        for pkg, system in both.items():
            system._create_map_in_atlas()
            shelf_path = str(tmp_path / f"{name}_{pkg}_shelved.npz")
            system.save_map(shelf_path)
            other = new_system("port" if pkg == "jax" else "jax", cfg)
            other.load_map(shelf_path)
            assert len(other.atlas_maps) == 1
            assert_loaded(system, other)
    # a v1 snapshot carried dense [K, n_words] databases: both packages
    # take the same top rows from them, the rows that were saved
    z = dict(np.load(shelf_path))
    n_words = loops[1]["system"].loop_closer.vocab.n_words
    for prefix in ("lc_bow", "atlas0_bow"):
        words, wts = z.pop(f"{prefix}_words"), z.pop(f"{prefix}_wts")
        dense = np.zeros((words.shape[0], n_words), np.float32)
        rows = np.nonzero(words >= 0)
        dense[rows[0], words[rows]] = wts[rows]
        z[f"{prefix}_db"] = dense
    v1_path = str(tmp_path / "v1.npz")
    np.savez_compressed(v1_path, **z)
    for pkg in ("jax", "port"):
        system = new_system(pkg, cfg)
        system.load_map(v1_path)
        for lc, key in ((system.loop_closer, "lc_bow"), (system.atlas_maps[0]["loop_closer"], "atlas0_bow")):
            saved = np.load(shelf_path)
            np.testing.assert_array_equal(np.asarray(lc.db_words), saved[f"{key}_words"])
            np.testing.assert_array_equal(np.asarray(lc.db_wts), saved[f"{key}_wts"])
    small = dataclasses.replace(cfg, capacity=dataclasses.replace(cfg.capacity, max_landmarks=2048))
    with pytest.raises(ValueError, match="capacity mismatch"):
        new_system("port", small).load_map(str(tmp_path / "jax.npz"))


def test_localization_mode(loops, extra):
    """Localization mode in both packages: four more frames tracked with
    no keyframe inserted and no map change, poses within 2e-3 m / 1e-3
    rad."""
    systems = [loops[0]["system"], loops[1]["system"]]
    for s in systems:
        s.activate_localization_mode()  # decides what is pending first
        assert s.localization_only
    before = [(dict(s.stats), s.n_kf, np.asarray(s.ms.obs_lm).copy()) for s in systems]
    trajs = [track(s, extra, N_FRAMES / chip_smoke.FPS, LOC_STASHES if s is systems[0] else None)
             for s in systems]
    for s, (stats, n_kf, obs) in zip(systems, before):
        assert s.stats == stats and s.n_kf == n_kf and s.state == 1
        np.testing.assert_array_equal(np.asarray(s.ms.obs_lm), obs)
    d_centre, d_rot = chip_smoke.trajectory_diff(*(tuple(a[-4:] for a in tr) for tr in trajs))
    assert d_centre.max() <= 2e-3 and d_rot.max() <= 1e-3, (d_centre, d_rot)


def test_loc_vo_fallback(loops, extra):
    """The localization-mode VO fallback on one pair of the reference's
    localization run: its stash (a tracked frame and its pose) and the
    frame it stashed two frames later; the same verdict, pose and velocity
    within 1e-4 (rotation entries) and 1e-4 m."""
    j = loops[0]["system"]
    assert j.localization_only and len(LOC_STASHES) >= 3
    cfg = loops[3]
    (prev, (R_p, t_p)), (cur, _) = LOC_STASHES[0], LOC_STASHES[2]
    to_t = lambda f: tfe.frame_from_numpy({k: None if v is None else np.asarray(v) for k, v in f._asdict().items()},
                                          "cpu")
    port = new_system("port", cfg)
    port.activate_localization_mode()
    port._loc_prev = (to_t(prev), (torch.from_numpy(np.asarray(R_p)), torch.from_numpy(np.asarray(t_p))))
    ok_t = port._loc_vo_fallback(to_t(cur))
    j._loc_prev = (prev, (R_p, t_p))
    ok_j = j._loc_vo_fallback(cur)
    assert ok_t is ok_j is True
    for name in ("R_cw", "t_cw", "vel_R", "vel_t"):
        np.testing.assert_allclose(getattr(port, name).numpy(), np.asarray(getattr(j, name)), rtol=0, atol=1e-4,
                                   err_msg=name)
    assert port.has_velocity and port._loc_prev[0] is not None
