"""The port's stereo-fisheye rig (two Kannala-Brandt cameras and their
right-camera rows) against the JAX reference on the CPU (the KB8 camera,
its render and the monocular KB8 path: ``tests/test_torch_fisheye_mono.py``).

One module fixture runs both packages' stereo-fisheye systems
(``chip_smoke.sensor_config("fisheye", small=True)``, the rig of
``tests/test_fisheye.py:100-138``: two 256x256 KB8 cameras, fx 95,
``Tlr`` a 0.10 m x-offset, 500 features, synchronous decisions) over 16
strafe frames (0.04 m/frame) on the same numpy images, the reference's
first; then each package's map, saved, is loaded in both packages and
resumed over two more frames. The reference's ``process_stereo_fisheye``
(frame 0, the identity pose: the scene of
``tests/test_fisheye_rig.py:36-50``), rig ``local_ba_step`` and
``full_fisheye_step`` calls in its run are captured. The rig branches of
the inertial programs (``vio_frame_step``, the dense and PCG VI-BA, the
init-FIBA) and of the whole-map BA run on the reference's stereo map as
its first rig local-BA slice leaves it, with an inertial block made from
one constant IMU batch per keyframe; the reference's sides of those and
of the module-level tests run in the fixture right after its run.

Tolerances: ``process_stereo_fisheye`` levels, descriptors, validity and
the depth and right-pixel masks exactly, right pixels within 1e-4 and
depths within 1e-3 relative (the midpoint's aa*bb - ab^2 cancels in
float32 over a 0.10 m baseline, and the KB8 rays agree within ~1e-6);
``with_rig_rows`` exactly; rig residuals and Jacobians within 1e-5
(relative to the pixel coordinates and to the largest entry); the run's
keyframe frames and counters exactly, camera centres within 2e-3 m and
rotations within 1e-3 rad per frame; ``pose_optimization`` with a rig:
inliers exactly, poses within 1e-5; the rig ``bundle_adjust`` (local BA)
and ``bundle_adjust_cg`` (whole-map BA), the VIO step, the dense VI-BA,
the init-FIBA and the PCG VI-BA: poses within 1e-4, velocities within
1e-3, points within 1e-3 (dense) and 5e-3 (PCG: two LM iterations of 24
unconverged CG steps); ``map_observations(with_rig=True)`` exactly;
checkpoints: every array exactly both ways, two resumed frames within 2e-3
m / 1e-3 rad.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_system import assert_same_arrays, system_arrays, to_jax_config
from orb_slam3_detailed_comments_kor_tpu.models import camera as jcam
from orb_slam3_detailed_comments_kor_tpu.ops import imu as jimu
from orb_slam3_detailed_comments_kor_tpu.optim import ba as jba
from orb_slam3_detailed_comments_kor_tpu.optim import factors as jf
from orb_slam3_detailed_comments_kor_tpu.optim import vio as jvio
from orb_slam3_detailed_comments_kor_tpu.slam import frontend as jfe
from orb_slam3_detailed_comments_kor_tpu.slam import inertial as jin
from orb_slam3_detailed_comments_kor_tpu.slam import loop_closing as jlc
from orb_slam3_detailed_comments_kor_tpu.slam import tracking as jtr
from orb_slam3_detailed_comments_kor_tpu.slam.system import SlamSystem as JaxSlam
from orb_slam3_detailed_comments_kor_tpu.utils import lie as jlie
from orb_slam3_detailed_comments_kor_tpu_torch.io import synthetic as tsyn
from orb_slam3_detailed_comments_kor_tpu_torch.models import camera as tcam
from orb_slam3_detailed_comments_kor_tpu_torch.ops import imu as timu
from orb_slam3_detailed_comments_kor_tpu_torch.optim import ba as tba
from orb_slam3_detailed_comments_kor_tpu_torch.optim import factors as tf
from orb_slam3_detailed_comments_kor_tpu_torch.optim import vio as tvio
from orb_slam3_detailed_comments_kor_tpu_torch.slam import frontend as tfe
from orb_slam3_detailed_comments_kor_tpu_torch.slam import inertial as tin
from orb_slam3_detailed_comments_kor_tpu_torch.slam import loop_closing as tlc
from orb_slam3_detailed_comments_kor_tpu_torch.slam import map_state as tms
from orb_slam3_detailed_comments_kor_tpu_torch.slam import tracking as ttr
from orb_slam3_detailed_comments_kor_tpu_torch.slam.system import SlamSystem as TorchSlam

KB8 = "kannala_brandt8"
STEREO = dict(frames=16, speed=0.04)
SMALL_KB8 = np.array([95.0, 95.0, 128.0, 128.0, 0.0034, 0.00077, -0.0039, 0.00095], np.float32)
BASE = chip_smoke.FISH_BASE
R_RL, T_RL = np.eye(3, dtype=np.float32), np.array([-BASE, 0.0, 0.0], np.float32)
GRAVITY = np.array([0.0, 9.81, 0.0], np.float32)


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


def J(a):
    return jnp.asarray(a)


def close(ref, got, tol, rtol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=tol)


def rig(f):
    return (f(R_RL), f(T_RL), f(SMALL_KB8))


def ms_t(d):
    return tms.map_state_from_numpy(d, "cpu")


def ikf_t(d):
    return tin.InertialKF(**{k: T(v) for k, v in d.items()})


def run(system, frames, kind, on_frame=None, first=0):
    """Feed the frames from ``first`` on; record the keyframe frames."""
    kf_at = []
    for i, f in enumerate(frames):
        if i < first:
            continue
        n0 = system.stats["kf_inserted"]
        if kind == "mono":
            system.track_mono(f, i / chip_smoke.FPS)
        else:
            system.track_stereo(f[0], f[1], i / chip_smoke.FPS)
        if system.stats["kf_inserted"] != n0:
            kf_at.append(i)
        if on_frame:
            on_frame(i, system)
    system.flush_decisions()
    return dict(system=system, kf_at=kf_at, traj=system.trajectory_arrays(), stats=dict(system.stats),
                state=system.state)


def inertial_block(ms, n_kf):
    """The reference's inertial block for a visual map: each keyframe after
    the first carries the preintegration of one constant IMU batch (gravity
    reaction and a small turn), velocities from the keyframe centres."""
    K = ms["kf_R_cw"].shape[0]
    ikf = jin.empty_inertial(K)
    centres = -np.einsum("kji,kj->ki", ms["kf_R_cw"], ms["kf_t_cw"])
    m = 10
    batch = jimu.ImuBatch(acc=J(np.tile([0.05, 9.81, -0.02], (m, 1)).astype(np.float32)),
                          gyro=J(np.tile([0.01, -0.02, 0.005], (m, 1)).astype(np.float32)),
                          dt=J(np.full((m,), 0.02, np.float32)), valid=J(np.ones((m,), bool)))
    pre = jimu.integrate(batch, jnp.zeros(3), jnp.zeros(3), 1.7e-4 * np.sqrt(200.0), 2e-3 * np.sqrt(200.0))
    for k in range(1, n_kf):
        vel = (centres[k] - centres[k - 1]) / 0.2
        ikf = jin.store_preintegration(ikf, k, pre, J(vel.astype(np.float32)))
    return npy(ikf), npy(pre)


def resume(make, path, extra):
    """A fresh system (``make()``) loads the map at ``path``: its arrays
    right after the load, and its trajectory over the ``extra`` frames."""
    system = make()
    system.load_map(path)
    arrays = system_arrays(system)
    t_next = STEREO["frames"] / chip_smoke.FPS
    for i, (il, ir) in enumerate(extra):
        system.track_stereo(il, ir, t_next + i / chip_smoke.FPS)
    system.flush_decisions()
    return arrays, system.trajectory_arrays()


@pytest.fixture(scope="module")
def fish(tmp_path_factory):
    cfg_s = chip_smoke.sensor_config("fisheye", small=True)
    _, st, _ = chip_smoke.render_sensor_sequence("fisheye", cfg_s, STEREO["frames"] + 2, "cpu",
                                                 speed=STEREO["speed"])
    st = [(a.numpy(), b.numpy()) for a, b in st]
    captured = {"local_ba_step": [], "full_fisheye_step": [], "process_stereo_fisheye": []}
    saved = {(jtr, "local_ba_step"): jtr.local_ba_step, (jtr, "full_fisheye_step"): jtr.full_fisheye_step,
             (jfe, "process_stereo_fisheye"): jfe.process_stereo_fisheye}
    steps_before_lba = []  # the fused steps captured when the first local-BA slice ended

    def capture(name, fn):
        def wrapper(*a, **k):
            args = (npy(a), npy(k))  # before the call: the fused step donates its map
            out = fn(*a, **k)
            captured[name].append(("stereo",) + args + (npy(out),))
            if name == "local_ba_step" and not steps_before_lba:
                steps_before_lba.append(len(captured["full_fisheye_step"]))
            return out
        if hasattr(fn, "__wrapped__"):  # the fused step traces the front end's unjitted body
            wrapper.__wrapped__ = fn.__wrapped__
        return wrapper

    saved_devices = jax.devices
    jax.devices = lambda *a: saved_devices(*a)[:1]  # the reference's one-device branches
    folder = str(tmp_path_factory.mktemp("fish"))
    paths = {name: os.path.join(folder, f"{name}.npz") for name in ("jax", "port")}
    try:
        for (mod, name), fn in saved.items():
            setattr(mod, name, capture(name, fn))
        try:
            j = run(JaxSlam(to_jax_config(cfg_s)), st[:-2], "stereo")
        finally:
            for (mod, name), fn in saved.items():
                setattr(mod, name, fn)
        # the map-level programs take the reference's map as its first rig
        # local-BA slice leaves it (two keyframes)
        lba_out = captured["local_ba_step"][0][3]
        step_out = captured["full_fisheye_step"][steps_before_lba[0] - 1][3]
        n_kf = int(np.asarray(lba_out["kf_valid"]).sum())
        map_in = map_inputs(lba_out, n_kf, step_out, cfg_s.camera.bf)
        refs = {name: npy(f()) for name, f in {**STANDALONE_REFS, **map_refs(map_in)}.items()}
        t = run(TorchSlam(cfg_s, device="cpu"), st[:-2], "stereo")
        t["kf_uvr"] = t["system"].ms.kf_uvr[:t["system"].n_kf].numpy()
        # each package's map, saved, loaded in both and resumed over the
        # last two frames
        makers = (lambda: JaxSlam(to_jax_config(cfg_s)), lambda: TorchSlam(cfg_s, device="cpu"))
        checkpoints = {}
        for name, out in (("jax", j), ("port", t)):
            out["system"].save_map(paths[name])
            checkpoints[name] = dict(written=system_arrays(out["system"]),
                                     right_rows=int((np.load(paths[name])["ms_kf_uvr"][..., 0] >= 0).sum()),
                                     loaded=[resume(make, paths[name], st[-2:]) for make in makers])
    finally:
        jax.devices = saved_devices
    return dict(j=j, t=t, refs=refs, checkpoints=checkpoints, cfg_s=cfg_s, st=st, captured=captured, map=map_in)


# ---------------------------------------------------------------------------
# the front end and the rig rows
# ---------------------------------------------------------------------------

def stereo_fisheye_pair():
    """The scene of the JAX package's tests/test_fisheye_rig.py:36-50, as
    numpy images (the port renders them; both packages take them)."""
    scene = tsyn.default_scene("cpu")
    img_l, _ = tsyn.render(T(SMALL_KB8), torch.eye(3), torch.zeros(3), scene, h=256, w=256, model=KB8)
    img_r, _ = tsyn.render(T(SMALL_KB8), torch.eye(3), torch.tensor([BASE, 0.0, 0.0]), scene, h=256, w=256,
                           model=KB8)
    return img_l.numpy(), img_r.numpy()


def test_process_stereo_fisheye(fish):
    """The stereo-fisheye front end on the reference's first call in its
    run: frame 0 of the strafe, the identity pose, which is the scene of
    tests/test_fisheye_rig.py:36-50."""
    (tag, args, kw, ref), = fish["captured"]["process_stereo_fisheye"]
    il, ir = stereo_fisheye_pair()
    assert tag == "stereo" and np.array_equal(args[0], il) and np.array_equal(args[1], ir)
    got = tfe.process_stereo_fisheye(*(T(x) for x in args), **kw)
    for f in ("level", "desc", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), ref[f], err_msg=f)
    np.testing.assert_array_equal(got.depth.numpy() > 0, ref["depth"] > 0)
    np.testing.assert_array_equal(got.uv_r[:, 0].numpy() >= 0, ref["uv_r"][:, 0] >= 0)
    assert ((ref["depth"] > 0) & ref["valid"]).sum() > 100
    close(ref["xy"], got.xy, 1e-4)
    # midpoint triangulation over a 0.10 m baseline at 2-5 m: aa*bb - ab^2
    # cancels in float32, so the rays' ~1e-6 relative differences show
    close(ref["depth"], got.depth, 1e-4, 1e-3)
    close(ref["uv_r"], got.uv_r, 1e-4)
    np.testing.assert_array_equal(got.u_right.numpy(), ref["u_right"])


def rig_problem(seed, n=64):
    rng = np.random.default_rng(seed)
    X = rng.uniform([-1.5, -1.5, 2.0], [1.5, 1.5, 5.0], (n, 3)).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.array([0.03, -0.05, 0.02])))
    t = np.array([0.1, -0.2, 0.3], np.float32)
    pc = X @ R.T + t
    uv_l = np.asarray(jcam.kb8_project(J(SMALL_KB8), J(pc))) + rng.normal(0, 0.5, (n, 2)).astype(np.float32)
    uv_r = np.array(jcam.kb8_project(J(SMALL_KB8), J(pc @ R_RL.T + T_RL)))
    uv_r[::7] = -1.0  # features without a right match
    lvl = rng.integers(0, 4, n)
    obs = dict(kf=np.zeros(n, np.int32), lm=np.arange(n, dtype=np.int32), uv=uv_l, u_right=-np.ones(n, np.float32),
               inv_sigma2=(1.2 ** (-2.0 * lvl)).astype(np.float32), valid=rng.random(n) > 0.1)
    return X, R, t, obs, uv_r


T_OFFSETS = (np.zeros(3, np.float32), np.array([0.05, 0.0, 0.0], np.float32))


def ref_rig_rows():
    X, R, t, obs, uv_r = rig_problem(0)
    jo = jf.with_rig_rows(jf.Observations(**{k: J(v) for k, v in obs.items()}), J(uv_r))
    out = []
    for t_off in T_OFFSETS:
        pose = (J(R[None]), J((t + t_off)[None]), J(X), jo, J(SMALL_KB8), 0.0, KB8)
        out.append((npy(jf.reproj_residuals(*pose, rig=rig(J))), npy(jf.reproj_jacobians(*pose, rig=rig(J)))))
    return npy(jo), out


def test_with_rig_rows_and_residuals(fish):
    X, R, t, obs, uv_r = rig_problem(0)
    ref_obs, ref = fish["refs"]["rig_rows"]
    to = tf.with_rig_rows(tf.Observations(**{k: T(v.astype(np.int64) if v.dtype == np.int32 else v)
                                             for k, v in obs.items()}), T(uv_r))
    for k, v in ref_obs.items():
        np.testing.assert_array_equal(getattr(to, k).numpy(), v, err_msg=k)
    for t_off, (ref_r, ref_j) in zip(T_OFFSETS, ref):
        pose = (T(R[None]), T((t + t_off)[None]), T(X), to, T(SMALL_KB8), 0.0, KB8)
        for a, b in zip(ref_r, tf.reproj_residuals(*pose, rig=rig(T))):  # to 1e-5 of the pixel coordinates
            if a.dtype == bool:
                np.testing.assert_array_equal(b.numpy(), a)
            else:
                close(a, b, 1e-5 * np.abs(obs["uv"]).max())
        for a, b in zip(ref_j, tf.reproj_jacobians(*pose, rig=rig(T))):
            assert (np.abs(b.numpy() - a) / (np.abs(a).max() + 1e-30)).max() <= 1e-5
    # the right rows are live: near zero at the true pose on the right pixels
    uv_r_true = tcam.kb8_project(T(SMALL_KB8), T((X @ R.T + t) @ R_RL.T + T_RL))
    to_true = to._replace(uv=torch.cat([to.uv[:64], torch.where(to.uv[64:, :1] >= 0, uv_r_true, to.uv[64:])]))
    r_true = tf.reproj_residuals(T(R[None]), T(t[None]), T(X), to_true, T(SMALL_KB8), 0.0, KB8, rig=rig(T))[0]
    right = (to.cam == 1) & to.valid
    assert r_true.shape == (128, 3) and r_true[right].abs().max() < 1e-2


POSE_CASES = ("converges", "rescues_degenerate_left", "left_only")


def pose_problem(case):
    """The scenarios of the JAX package's tests/test_fisheye_rig.py:102-159:
    (args, kwargs, t_gt)."""
    rng = np.random.default_rng(1 if case == "converges" else 2)
    n = 96
    X = rng.uniform([-1.5, -1.5, 2.0], [1.5, 1.5, 5.0], (n, 3)).astype(np.float32)
    if case == "converges":
        R_gt = np.asarray(jlie.so3_exp(jnp.array([0.02, 0.04, -0.03])))
        t_gt = np.array([-0.1, 0.15, 0.2], np.float32)
        R0 = np.asarray(jlie.so3_exp(jnp.array([0.05, -0.03, 0.04]))) @ R_gt
        t0 = t_gt + np.array([0.15, -0.1, 0.1], np.float32)
        valid = np.ones(n, bool)
    else:
        R_gt, t_gt = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
        R0 = np.asarray(jlie.so3_exp(jnp.array([0.03, 0.02, -0.02])))
        t0 = np.array([0.08, -0.06, 0.05], np.float32)
        valid = np.arange(n) < 8  # only 8 left rows survive
    pc = X @ R_gt.T + t_gt
    uv_l = np.asarray(jcam.kb8_project(J(SMALL_KB8), J(pc)))
    uv_r = np.asarray(jcam.kb8_project(J(SMALL_KB8), J(pc @ R_RL.T + T_RL)))
    args = (R0, t0, X, uv_l, -np.ones(n, np.float32), np.ones(n, np.float32), valid, SMALL_KB8, 0.0)
    kw = dict(cam_model=KB8)
    if case != "left_only":
        kw.update(uv_r=uv_r)
    return args, kw, t_gt


def ref_pose_optimization(case):
    args, kw, _ = pose_problem(case)
    return npy(jba.pose_optimization(*(J(a) if isinstance(a, np.ndarray) else a for a in args),
                                     **{k: J(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()},
                                     rig=rig(J) if case != "left_only" else None))


@pytest.mark.parametrize("case", POSE_CASES)
def test_pose_optimization_rig(fish, case):
    """The scenarios of the JAX package's tests/test_fisheye_rig.py:102-159."""
    args, kw, t_gt = pose_problem(case)
    n = args[2].shape[0]
    ref = fish["refs"][f"pose_{case}"]
    got = tba.pose_optimization(*(T(a) if isinstance(a, np.ndarray) else a for a in args),
                                **{k: T(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()},
                                rig=rig(T) if case != "left_only" else None)
    np.testing.assert_array_equal(got.inlier.numpy(), np.asarray(ref["inlier"]))
    assert got.inlier.shape == (n,) and int(got.n_inliers) == int(ref["n_inliers"])
    close(ref["R_cw"], got.R_cw, 1e-5)
    close(ref["t_cw"], got.t_cw, 1e-5)
    if case != "left_only":
        assert np.linalg.norm(got.t_cw.numpy() - t_gt) < 5e-3


# the reference computations of the tests above, run in the module
# fixture
STANDALONE_REFS = dict(rig_rows=ref_rig_rows, **{f"pose_{c}": (lambda c=c: ref_pose_optimization(c))
                                                 for c in POSE_CASES})


# ---------------------------------------------------------------------------
# the runs
# ---------------------------------------------------------------------------

def test_stereo_fisheye_keyframes_and_stats(fish):
    j, t = fish["j"], fish["t"]
    assert t["kf_at"] == j["kf_at"] and len(j["kf_at"]) >= 3
    assert t["stats"] == j["stats"]
    assert t["state"] == j["state"] == 1


def test_stereo_fisheye_per_frame_poses(fish):
    d_centre, d_rot = chip_smoke.trajectory_diff(fish["j"]["traj"], fish["t"]["traj"])
    assert len(d_centre) == STEREO["frames"]
    assert d_centre.max() <= 2e-3, np.round(d_centre * 1e3, 3).tolist()
    assert d_rot.max() <= 1e-3


def test_stereo_fisheye_rig_rows_in_the_map(fish):
    """Right-camera rows are stored with the keyframes (kf_uvr) and agree."""
    j, ut = fish["j"]["system"], fish["t"]["kf_uvr"]
    n = j.n_kf
    uj = np.asarray(j.ms.kf_uvr[:n])
    assert ut.shape == uj.shape
    np.testing.assert_array_equal(ut[..., 0] >= 0, uj[..., 0] >= 0)
    assert ((uj[..., 0] >= 0) & np.asarray(j.ms.kf_feat_valid[:n])).sum() > 200
    close(uj, ut, 2e-3)


def test_checkpoints_cross_packages(fish):
    """A stereo-fisheye map (kf_uvr, both cameras) that either package saves
    loads in the other exactly, and both resume two frames alike."""
    for name, case in fish["checkpoints"].items():
        assert case["right_rows"] > 200, name
        for arrays, _ in case["loaded"]:
            assert_same_arrays(case["written"], arrays)
        trajs = [traj for _, traj in case["loaded"]]
        d_centre, d_rot = chip_smoke.trajectory_diff(*trajs)
        assert len(d_centre) == 2 and d_centre.max() <= 2e-3 and d_rot.max() <= 1e-3, (name, d_centre, d_rot)


# ---------------------------------------------------------------------------
# the rig branches of the solvers, on captured inputs
# ---------------------------------------------------------------------------

def test_local_ba_rig_captured(fish):
    """``local_ba_step`` with the rig (``bundle_adjust``'s rig rows) on the
    reference's captured calls: the first and the last of the run."""
    calls = [c for c in fish["captured"]["local_ba_step"] if c[0] == "stereo" and c[2].get("rig") is not None]
    assert len(calls) >= 2
    for _, a, kw, ref in (calls[0], calls[-1]):
        kw = dict(kw, rig=tuple(T(x) for x in kw["rig"]))
        got = tms.map_state_to_numpy(ttr.local_ba_step(ms_t(a[0]), int(a[1]), T(a[2]), float(a[3]), **kw))
        np.testing.assert_array_equal(got["obs_lm"], ref["obs_lm"])
        close(ref["kf_t_cw"], got["kf_t_cw"], 1e-4)
        close(ref["kf_R_cw"], got["kf_R_cw"], 1e-4)
        close(ref["lm_pos"], got["lm_pos"], 1e-3)


def map_inputs(ms, n_kf, step_out, bf):
    """The inputs of the map-level rig programs, from the stereo run's
    final map (numpy) and its last fused step's output: the inertial block,
    one frame's preintegration, the keyframe prior and the VIO step's
    arguments."""
    ikf, pre = inertial_block(ms, n_kf)
    k = n_kf - 1
    eye, zero = jnp.eye(3), jnp.zeros(3)
    prior = npy(jvio.kf_prior(J(ms["kf_R_cw"][k]), J(ms["kf_t_cw"][k]), J(ikf["vel"][k]), J(ikf["bg"][k]),
                              J(ikf["ba"][k]), eye, zero))
    frame, tr_ = step_out[1], step_out[2]
    vio_args = (ms["lm_pos"], tr_["lm_feat"], tr_["lm_inlier"], frame["xy"], frame["u_right"], frame["level"],
                frame["uv_r"], tr_["R_cw"], tr_["t_cw"])
    return dict(ms=ms, ikf=ikf, pre=pre, k=k, bf=bf, prior=prior, vio_args=vio_args,
                vio_kw=dict(bf=0.0, scale=1.2, cam_model=KB8, min_inliers=15))


def map_refs(d):
    """The reference's programs on ``map_inputs``: ``map_observations``
    (jitted, as its global BA runs it: XLA writes 1 / 1.2 ** (2 level) as
    1.2 ** (-2 level), as the port does), the whole-map PCG BA, the VIO
    step, the init-FIBA, a VI local-BA slice and the PCG VI-BA, each with
    the rig, as callables."""
    jms = jtr.msx.MapState(**{k: J(v) for k, v in d["ms"].items()})
    jikf = jin.InertialKF(**{k: J(v) for k, v in d["ikf"].items()})
    eye, zero, k, bf = jnp.eye(3), jnp.zeros(3), d["k"], d["bf"]
    lba = dict(lm_cap=2048, iters=2, cam_model=KB8, rig=rig(J))
    p = d["prior"]
    prior = jvio.VioPrior(H=J(p["H"]), state=jvio.VioState(**{kk: J(v) for kk, v in p["state"].items()}))
    pre = jimu.Preintegrated(**{kk: J(v) for kk, v in d["pre"].items()})
    return {
        "map_observations": lambda: jax.jit(jlc.map_observations, static_argnames=("with_rig",))(jms, with_rig=True),
        "global_ba": lambda: jlc._global_ba_core(jms, J(SMALL_KB8), jnp.float32(bf), iters=2, cam_model=KB8,
                                                 rig=rig(J)),
        "vio": lambda: jvio.vio_frame_step(*(J(x) for x in d["vio_args"]), prior, pre, J(SMALL_KB8), eye, zero,
                                           J(GRAVITY), rig(J), **d["vio_kw"]),
        "init_fiba": lambda: jin.local_vi_ba_step(jms, jikf, jnp.int32(k), J(GRAVITY), J(SMALL_KB8), eye, zero, bf,
                                                  window=16, prior_bg_info=jnp.float32(1e2),
                                                  prior_ba_info=jnp.float32(1e5), **lba),
        "vi_local_ba": lambda: jin.local_vi_ba_step(jms, jikf, jnp.int32(k), J(GRAVITY), J(SMALL_KB8), eye, zero, bf,
                                                    window=16, **lba),
        "full_inertial_ba": lambda: jin.full_inertial_ba(jms, jikf, J(GRAVITY), J(SMALL_KB8), eye, zero, bf,
                                                         iters=2, cam_model=KB8, rig=rig(J)),
    }


def test_map_observations_with_rig(fish):
    ms = fish["map"]["ms"]
    ref = fish["refs"]["map_observations"]
    got = tlc.map_observations(ms_t(ms), with_rig=True)
    for a, b in zip(ref, got):
        if isinstance(a, dict):
            for k, v in a.items():
                bv = getattr(b, k).numpy()
                np.testing.assert_array_equal(bv.astype(v.dtype) if k in ("kf", "lm", "cam") else bv, v, err_msg=k)
        else:
            np.testing.assert_array_equal(b.numpy(), a)


def test_global_ba_rig(fish):
    """The whole-map PCG BA (``bundle_adjust_cg``) with the rig rows."""
    d = fish["map"]
    ref_ms, ref_cost = fish["refs"]["global_ba"]
    got_ms, got_cost = tlc._global_ba_core(ms_t(d["ms"]), T(SMALL_KB8), d["bf"], iters=2, cam_model=KB8, rig=rig(T))
    close(ref_ms["kf_t_cw"], got_ms.kf_t_cw, 1e-4)
    close(ref_ms["kf_R_cw"], got_ms.kf_R_cw, 1e-4)
    close(ref_ms["lm_pos"], got_ms.lm_pos, 5e-3)
    assert abs(float(got_cost) / float(ref_cost) - 1.0) <= 1e-3


@pytest.fixture(scope="module")
def inertial(fish):
    """The stereo run's final map with an inertial block (``map_inputs``)
    and the reference's rig programs on it."""
    return dict(fish["map"], refs=fish["refs"])


def test_vio_frame_step_rig(inertial):
    d = inertial
    p = d["prior"]
    prior = tvio.VioPrior(H=T(p["H"]), state=tvio.VioState(**{k: T(v) for k, v in p["state"].items()}))
    pre = timu.Preintegrated(**{k: T(v) for k, v in d["pre"].items()})
    args = [T(x.astype(np.int64)) if x.dtype == np.int32 else T(x) for x in d["vio_args"]]
    eye, zero = torch.eye(3), torch.zeros(3)
    got = tvio.vio_frame_step(*args, prior, pre, T(SMALL_KB8), eye, zero, T(GRAVITY), rig(T), **d["vio_kw"])
    R, t, cur, nxt, n_in = d["refs"]["vio"]
    assert int(got[4]) == int(n_in) > 50
    close(t, got[1], 1e-4)
    close(R, got[0], 1e-4)
    close(cur["v"], got[2].v, 1e-3)
    close(nxt["H"], got[3].H, 1e-3 * np.abs(nxt["H"]).max())


@pytest.mark.parametrize("name", ["init_fiba", "vi_local_ba", "full_inertial_ba"])
def test_vi_ba_rig(inertial, name):
    """The dense VI-BA (init-FIBA with bias priors, VI local BA) and the PCG
    VI-BA (``full_inertial_ba``) with the rig rows."""
    d = inertial
    ms, ikf = ms_t(d["ms"]), ikf_t(d["ikf"])
    eye, zero = torch.eye(3), torch.zeros(3)
    lba = dict(lm_cap=2048, iters=2, cam_model=KB8, rig=rig(T))
    if name == "full_inertial_ba":
        got = tin.full_inertial_ba(ms, ikf, T(GRAVITY), T(SMALL_KB8), eye, zero, d["bf"], iters=2, cam_model=KB8,
                                   rig=rig(T))
    else:
        priors = dict(prior_bg_info=1e2, prior_ba_info=1e5) if name == "init_fiba" else {}
        got = tin.local_vi_ba_step(ms, ikf, d["k"], T(GRAVITY), T(SMALL_KB8), eye, zero, d["bf"], window=16,
                                   **priors, **lba)
    ref_ms, ref_ikf, ref_cost = d["refs"][name]
    got_ms = tms.map_state_to_numpy(got[0])
    close(ref_ms["kf_t_cw"], got_ms["kf_t_cw"], 1e-4)
    close(ref_ms["kf_R_cw"], got_ms["kf_R_cw"], 1e-4)
    close(ref_ms["lm_pos"], got_ms["lm_pos"], 5e-3 if name == "full_inertial_ba" else 1e-3)
    close(ref_ikf["vel"], got[1].vel, 1e-3)
    moved = np.abs(ref_ms["kf_t_cw"] - d["ms"]["kf_t_cw"]).max()
    assert moved > 1e-6, name
