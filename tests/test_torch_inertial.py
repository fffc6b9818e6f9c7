"""The port's stereo-inertial path against the JAX reference on the CPU.

One module fixture runs both ``SlamSystem``s (``IMU_STEREO``, loop closing
on, their defaults) over the same numpy stereo pairs and IMU samples: 22
frames of ``synthetic.AnalyticTrajectory`` at 10 fps with 200 Hz IMU
samples, at ``chip_smoke.si_config(small=True)``'s 240x376 / 600-feature
geometry with a keyframe every second frame, so that the IMU initializes
at frame 15 (8 keyframes over 1.5 s), after which the per-frame VIO, the
init-FIBA and VI local-BA slices and loop detection run. The reference's inertial device programs are captured with
their inputs and outputs there, and the port's counterparts are held to
them on those inputs.

Tolerances: the keyframe frames, the IMU-init frame and keyframe count and
the lifecycle counters exactly; per-frame camera centres within 2e-3 m and
rotations within 1e-3 rad; keyframe velocities within 1e-2 m/s, biases
within 1e-3, gravity within 1e-3 rad. On captured inputs: ``integrate``,
``compose`` and ``predict_state`` rtol 1e-5 / atol 1e-6 over a padded
window (bit-identical padding); ``AnalyticTrajectory`` 1e-5;
``make_edges`` and ``eval_inertial`` 1e-5 (the edges' information 1e-4
relative); ``vi_bundle_adjust`` and ``vi_bundle_adjust_cg`` on
``tests/test_vi_ba.py``'s problem (n_kf=6) body positions within 1e-4 m;
``inertial_optimization`` gravity within 1e-4 rad and biases within 1e-4;
``vio_frame_step`` pose 1e-4 m / 1e-4 rad, velocity 1e-3, the marginal
prior's information 1e-3 relative; ``local_vi_ba_step`` (init-FIBA, VI
local-BA and the inertial GBA sweep) poses 1e-4, landmarks 1e-3 m (the
sweep: 5e-3 m), velocities 1e-3, biases 1e-4; ``full_inertial_ba``
poses 1e-4; ``store_preintegration`` exactly; ``merge_and_compact`` slots
and masks exactly, composed windows 1e-5; the 4-DoF correction poses 1e-4
and velocities 1e-4; the pose prior 1e-5. The forward-mode Jacobians are
taken in float64 (``jacfwd64``) against the reference's float32, which the
tolerances above cover. Checkpoints: every array exactly, both ways, for
the active map and a shelved one; the inertial weld on the reference's
state: the inertial arrays exactly.
"""

import copy
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import test_vi_ba
from test_torch_system import to_jax_config
from orb_slam3_detailed_comments_kor_tpu.io import synthetic as jsyn
from orb_slam3_detailed_comments_kor_tpu.ops import imu as jimu
from orb_slam3_detailed_comments_kor_tpu.optim import ba as jba
from orb_slam3_detailed_comments_kor_tpu.optim import vi_ba as jvb
from orb_slam3_detailed_comments_kor_tpu.optim import vio as jvio
from orb_slam3_detailed_comments_kor_tpu.slam import inertial as jin
from orb_slam3_detailed_comments_kor_tpu.slam import loop_closing as jlc
from orb_slam3_detailed_comments_kor_tpu.slam import map_merging as jmm
from orb_slam3_detailed_comments_kor_tpu.slam.system import SlamSystem as JaxSlam
from orb_slam3_detailed_comments_kor_tpu.utils import lie as jlie
from orb_slam3_detailed_comments_kor_tpu_torch.io import synthetic as tsyn
from orb_slam3_detailed_comments_kor_tpu_torch.ops import imu as timu
from orb_slam3_detailed_comments_kor_tpu_torch.optim import ba as tba
from orb_slam3_detailed_comments_kor_tpu_torch.optim import factors as tfac
from orb_slam3_detailed_comments_kor_tpu_torch.optim import vi_ba as tvb
from orb_slam3_detailed_comments_kor_tpu_torch.optim import vio as tvio
from orb_slam3_detailed_comments_kor_tpu_torch.parallel import dist_vi_ba as tdvb
from orb_slam3_detailed_comments_kor_tpu_torch.slam import inertial as tin
from orb_slam3_detailed_comments_kor_tpu_torch.slam import loop_closing as tlc
from orb_slam3_detailed_comments_kor_tpu_torch.slam import map_merging as tmm
from orb_slam3_detailed_comments_kor_tpu_torch.slam import map_state as tms
from orb_slam3_detailed_comments_kor_tpu_torch.slam.system import SlamSystem as TorchSlam

SI = chip_smoke.SMALL_SI
CAPTURED = ("local_vi_ba_step", "initialize_imu", "store_preintegration", "advance_imu")


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
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a.copy())


def tt(cls, d):
    """A port NamedTuple from the reference's fields (as numpy); a field
    the reference leaves None (an Observations table's rig ``cam``) keeps
    the port's default."""
    return cls(**{f: T(d[f]) for f in cls._fields if d.get(f) is not None})


def pre_t(d):
    return tt(timu.Preintegrated, d)


def ikf_t(d):
    return tt(tin.InertialKF, d)


def vio_prior_t(d):
    return tvio.VioPrior(H=T(d["H"]), state=tt(tvio.VioState, d["state"]))


def close(ref, got, tol, rtol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=tol)


def angle(a, b):
    return chip_smoke.gravity_angle(np.asarray(a), np.asarray(b))


def rot_angle(Ra, Rb):
    return chip_smoke.rotation_angle(torch.from_numpy(np.asarray(Ra, np.float32)),
                                     torch.from_numpy(np.asarray(Rb, np.float32)))


def sequence(cfg):
    """The pairs and IMU samples (numpy), as bench.py makes them, at 10 fps
    (``chip_smoke.render_si_sequence``; both systems take the same ones)."""
    gt, frames, imu = chip_smoke.render_si_sequence(cfg, SI["frames"], "cpu", fps=SI["fps"])
    return [(a.numpy(), b.numpy()) for a, b in frames], imu, gt


def run(system, imgs, imu):
    kf_at, init = [], None
    for i, (il, ir) in enumerate(imgs):
        n0 = system.stats["kf_inserted"]
        system.track_stereo_inertial(il, ir, i / SI["fps"], imu[i])
        if system.stats["kf_inserted"] != n0:
            kf_at.append(i)
        if init is None and system.imu_initialized:
            init = (i, system.n_kf)
    system.flush_decisions()
    n = system.n_kf
    return dict(system=system, kf_at=kf_at, init=init, traj=system.trajectory_arrays(),
                stats=dict(system.stats), state=system.state, n_kf=n,
                vel=np.array(system.ikf.vel[:n]), bg=np.array(system.ikf.bg[:n]), ba=np.array(system.ikf.ba[:n]),
                gravity=np.array(system.gravity))


def vi_problem():
    """tests/test_vi_ba.py's problem (n_kf=6), perturbed as its recovery
    test perturbs it."""
    st, X, obs, edges = test_vi_ba.build_vi_problem()
    key = jax.random.PRNGKey(8)
    xi = 0.02 * jax.random.normal(key, (6, 6)).at[0].set(0.0)
    dR, dt = jlie.se3_exp(xi)
    dv = 0.05 * jax.random.normal(key, st.v.shape).at[0].set(0.0)
    st0 = st._replace(R_bw=dR @ st.R_bw, t_bw=jnp.einsum("kij,kj->ki", dR, st.t_bw) + dt, v=st.v + dv)
    X0 = X + 0.03 * jax.random.normal(key, X.shape)
    fixed_kf = jnp.zeros((6,), bool).at[0].set(True)
    return st0, X0, obs, edges, fixed_kf, jnp.zeros((X0.shape[0],), bool)


VI_BA_KW = dict(gyro_walk_info=jvb.WALK_INFO_CAP, acc_walk_info=jvb.WALK_INFO_CAP, prior_bg_info=1e2,
                prior_ba_info=1e5, iters=6)


def pose_prior_problem():
    rng = np.random.RandomState(11)
    n = 120
    X = np.c_[rng.uniform(-2, 2, n), rng.uniform(-1, 1, n), rng.uniform(2, 6, n)].astype(np.float32)
    cam = np.array([230.0, 230.0, 188.0, 120.0], np.float32)
    uv = (cam[:2] * X[:, :2] / X[:, 2:] + cam[2:] + rng.randn(n, 2)).astype(np.float32)
    ur = np.where(rng.rand(n) < 0.5, uv[:, 0] - 25.3 / X[:, 2], -1.0).astype(np.float32)
    s2, valid = np.ones(n, np.float32), rng.rand(n) < 0.9
    R0 = np.asarray(jlie.so3_exp(jnp.array([0.02, -0.01, 0.03])))
    t0 = np.array([0.05, -0.02, 0.04], np.float32)
    Rp = np.asarray(jlie.so3_exp(jnp.array([0.01, 0.0, -0.01])))
    prior = (Rp, np.array([0.02, 0.0, 0.01], np.float32), np.float32(1 / 0.02 ** 2), np.float32(1 / 0.02 ** 2))
    return (R0, t0, X, uv, ur, s2, valid, cam, 25.3), prior


def standalone_references(prob):
    """The reference's programs on seeded inputs (no system state)."""
    st0, X0, obs, edges, fixed_kf, fixed_point = prob
    solvers = {name: npy(getattr(jvb, name)(st0, X0, obs, edges, fixed_kf, fixed_point, test_vi_ba.CAM,
                                            jnp.eye(3), jnp.zeros(3), test_vi_ba.BF, test_vi_ba.G, **VI_BA_KW))
               for name in ("vi_bundle_adjust", "vi_bundle_adjust_cg")}
    args, prior = pose_prior_problem()
    pose = jba.pose_optimization(*args, prior=tuple(jnp.asarray(p) for p in prior))
    return dict(vi_problem=npy(prob), solvers=solvers, pose_prior=npy(pose))


def ref_full_inertial_ba(j, cfg):
    s = j["system"]
    return npy(jin.full_inertial_ba(s.ms, s.ikf, s.gravity, s.cam_params, s.R_cb, s.t_cb, s.cfg.camera.bf,
                                    iters=2))


#: the 4-DoF correction: a loop between the newest keyframe and keyframe 2
CORRECTION = dict(cand=2, xi=(0.05, -0.03, 0.02, 0.0, 0.02, 0.0))


def ref_correction_4dof(j, cfg):
    s = j["system"]
    n = s.n_kf
    R_d, t_d = jlie.se3_exp(jnp.array(CORRECTION["xi"]))
    ms, dR_w, s_new = jlc._correct_core(s.ms, jnp.int32(n), jnp.int32(n - 1), jnp.int32(CORRECTION["cand"]), R_d,
                                        t_d, jnp.float32(1.0), s.cam_params, jnp.float32(s.cfg.camera.bf),
                                        s.gravity, False, "4dof")
    return dict(ms=npy(ms), vel=np.array(jnp.einsum("kij,kj->ki", dR_w, s.ikf.vel) / s_new[:, None]),
                R_d=np.array(R_d), t_d=np.array(t_d))


#: keyframes culled before the chain merge (their windows flow on)
CULLED = (3, 4, 9)


def ref_merge_and_compact(j, cfg):
    ikf = j["system"].ikf
    keep = np.zeros(ikf.vel.shape[0], bool)
    keep[: j["n_kf"]] = True
    keep[list(CULLED)] = False
    return dict(keep=keep, out=npy(jin.merge_and_compact(ikf, jnp.asarray(keep))))


def ref_gba_sweep(j, cfg):
    """The inertial GBA sweep's first window (window 16, no priors) on the
    final map: the program the init-FIBA slices compiled."""
    s = j["system"]
    center = min(15, s.n_kf - 1)
    out = jin.local_vi_ba_step(s.ms, s.ikf, jnp.int32(center), s.gravity, s.cam_params, s.R_cb, s.t_cb,
                               s.cfg.camera.bf, window=16, lm_cap=s.cfg.capacity.max_local_landmarks, iters=2,
                               prior_bg_info=jnp.float32(0.0), prior_ba_info=jnp.float32(0.0))
    return dict(center=center, out=npy(out))


def weld_system(slam, j, R_d, t_d, to):
    """``slam`` set up to weld the reference's final map into a shelved
    copy of itself: the shelf has the map and its inertial block (IMU not
    initialized, so that the weld ends with its scatters; full_inertial_ba
    is held to the reference in its own test), the active map the same map
    with doubled velocities. ``to`` converts the reference's arrays."""
    s = j["system"]
    slam.ms, slam.ikf, slam.n_kf = to("ms", s.ms), to("ikf", s.ikf), s.n_kf
    slam.loop_closer.db_words = to(None, s.loop_closer.db_words)
    slam.loop_closer.db_wts = to(None, s.loop_closer.db_wts)
    slam._kf_times_host = list(np.asarray(s.ms.kf_time[: s.n_kf]))
    slam._kf_lowq_host = [False] * s.n_kf
    slam.imu_initialized = False
    slam.atlas_maps = [dict(ms=slam.ms, n_kf=slam.n_kf, loop_closer=slam.loop_closer, traj_end=0, gen=-1,
                            ikf=slam.ikf, gravity=slam.gravity, imu_initialized=False, kf_times=[], kf_lowq=[])]
    slam.ikf = slam.ikf._replace(vel=slam.ikf.vel * 2.0)
    return slam, to(None, R_d), to(None, t_d)


WELD_DELTA = (0.0, 0.0, 0.0, 0.0, 0.02, 0.0)


def ref_weld(j, cfg):
    R_d, t_d = jlie.se3_exp(jnp.array(WELD_DELTA))
    slam, R, t = weld_system(JaxSlam(to_jax_config(cfg)), j, R_d, t_d, lambda kind, x: x)
    ok = jmm.merge_into_shelved(slam, 0, j["n_kf"] - 1, j["n_kf"] - 2, R, t)
    return dict(ok=ok, n_kf=slam.n_kf, maps=len(slam.atlas_maps), ikf=npy(slam.ikf))


FINAL_STATE_REFERENCES = dict(full_inertial_ba=ref_full_inertial_ba, correction_4dof=ref_correction_4dof,
                              merge_and_compact=ref_merge_and_compact, gba_sweep=ref_gba_sweep, weld=ref_weld)


@pytest.fixture(scope="module")
def si():
    cfg = chip_smoke.si_config(small=True)
    imgs, imu, gt = sequence(cfg)
    jax_system = JaxSlam(to_jax_config(cfg))
    torch_system = TorchSlam(cfg, device="cpu")
    captured = {name: [] for name in CAPTURED + ("vio_frame_step",)}
    saved = {name: getattr(jin, name) for name in CAPTURED}
    saved_vio = jvio.vio_frame_step

    def capture(name, fn, store):
        def wrapper(*a, **k):
            out = fn(*a, **k)
            store.append(([npy(x) for x in a], npy(k), npy(out)))
            return out
        return wrapper

    for name in CAPTURED:
        setattr(jin, name, capture(name, saved[name], captured[name]))
    jvio.vio_frame_step = capture("vio_frame_step", saved_vio, captured["vio_frame_step"])
    # the tests' JAX runtime has 8 virtual devices: hold the reference to
    # its one-device inertial GBA (system.py:1281)
    saved_devices = jax.devices
    jax.devices = lambda *a: saved_devices(*a)[:1]
    try:
        # the two runs, then the reference's programs on seeded inputs and
        # on its final state
        j, t = run(jax_system, imgs, imu), run(torch_system, imgs, imu)
        ref = standalone_references(vi_problem())
        ref.update({name: fn(j, cfg) for name, fn in FINAL_STATE_REFERENCES.items()})
        return j, t, gt, cfg, captured, ref
    finally:
        for name in CAPTURED:
            setattr(jin, name, saved[name])
        jvio.vio_frame_step = saved_vio
        jax.devices = saved_devices


def test_same_keyframes_init_and_stats(si):
    j, t = si[0], si[1]
    assert t["kf_at"] == j["kf_at"]
    assert t["init"] == j["init"] == (15, 8)
    assert t["stats"] == j["stats"]
    assert t["state"] == j["state"] == 1
    assert len(si[4]["vio_frame_step"]) == SI["frames"] - 1 - t["init"][0]  # VIO on every frame after init


def test_per_frame_poses_and_inertial_state(si):
    j, t = si[0], si[1]
    d_centre, d_rot = chip_smoke.trajectory_diff(j["traj"], t["traj"])
    assert len(d_centre) == SI["frames"]
    assert d_centre.max() <= 2e-3, np.round(d_centre * 1e3, 3).tolist()
    assert d_rot.max() <= 1e-3
    close(j["vel"], t["vel"], 1e-2)
    close(j["bg"], t["bg"], 1e-3)
    close(j["ba"], t["ba"], 1e-3)
    assert angle(j["gravity"], t["gravity"]) <= 1e-3


@pytest.mark.parametrize("n_valid", [64, 37, 0])
def test_integrate_compose_predict(n_valid):
    rng = np.random.RandomState(n_valid)
    M = 64
    acc = (rng.randn(M, 3) + [0.0, 9.8, 0.0]).astype(np.float32)
    gyro = (0.5 * rng.randn(M, 3)).astype(np.float32)
    dt = np.full(M, 0.005, np.float32)
    valid = np.arange(M) < n_valid
    bg, ba = (0.01 * rng.randn(3)).astype(np.float32), (0.05 * rng.randn(3)).astype(np.float32)
    sg, sa = 1.7e-4 * np.sqrt(200.0), 2e-3 * np.sqrt(200.0)
    jb = jimu.ImuBatch(*(jnp.asarray(a) for a in (acc, gyro, dt, valid)))
    tb = timu.ImuBatch(*(T(a) for a in (acc, gyro, dt, valid)))
    pj = jimu.integrate_j(jb, jnp.asarray(bg), jnp.asarray(ba), sg, sa)
    pt = timu.integrate(tb, T(bg), T(ba), sg, sa)
    for f in timu.Preintegrated._fields:
        close(getattr(pj, f), getattr(pt, f), 1e-6, 1e-5)
    if n_valid == 0:  # padded samples leave the identity bit for bit
        ident = timu.identity_preintegrated("cpu")
        for f in ("dt", "dR", "dV", "dP", "cov", "JRg"):
            assert torch.equal(getattr(pt, f), getattr(ident, f)), f
    cj, ct = jimu.compose(pj, pj), timu.compose(pt, pt)
    for f in timu.Preintegrated._fields:
        close(getattr(cj, f), getattr(ct, f), 1e-6, 1e-5)
    R = np.asarray(jlie.so3_exp(jnp.array([0.1, -0.2, 0.3])))
    p, v, g = np.array([1.0, 2.0, 3.0], np.float32), np.array([0.3, -0.1, 0.2], np.float32), np.array([0, 9.81, 0])
    ref = jimu.predict_state(cj, R, p, v, jnp.asarray(bg) + 0.01, jnp.asarray(ba) - 0.02, g.astype(np.float32))
    got = timu.predict_state(ct, T(R), T(p), T(v), T(bg) + 0.01, T(ba) - 0.02, T(g.astype(np.float32)))
    for a, b in zip(ref, got):
        close(a, b, 1e-6, 1e-5)


def test_analytic_trajectory_samples():
    jt, tt_ = jsyn.AnalyticTrajectory(), tsyn.AnalyticTrajectory(device="cpu")
    for t in (0.37, 6.4):
        for a, b in zip(jt.pose(t) + (jt.velocity(t),), tt_.pose(t) + (tt_.velocity(t),)):
            close(a, b, 1e-5)
    # imu_batch's ten midpoint samples of (0.1, 0.15] at 200 Hz, padded to 64
    mids = 0.1 + (np.arange(10) + 0.5) * 0.005
    acc, gyro = jax.vmap(jt.imu_at)(jnp.asarray(mids, jnp.float32))
    tb = tt_.imu_batch(0.1, 0.15, 200.0, 64)
    close(acc, tb.acc[:10], 1e-5)
    close(gyro, tb.gyro[:10], 1e-5)
    close(acc, tt_.imu_at(mids)[0], 1e-5)
    np.testing.assert_array_equal(tb.valid.numpy(), np.arange(64) < 10)
    np.testing.assert_array_equal(tb.dt.numpy(), np.where(np.arange(64) < 10, np.float32(0.05 / 10), 0.0))


def test_make_edges_and_eval_inertial(si):
    """make_edges over four windows the system stored, then eval_inertial
    at a perturbed state of the window's keyframes (the reference's
    eval_inertial, jitted)."""
    pres = [c[0][2] for c in si[4]["store_preintegration"][2:6]]
    ej = jvb.make_edges([jimu.Preintegrated(**{k: jnp.asarray(v) for k, v in p.items()}) for p in pres],
                        jnp.arange(4), jnp.arange(1, 5))
    et = tvb.make_edges([pre_t(p) for p in pres], [0, 1, 2, 3], [1, 2, 3, 4])
    for f in tvb.InertialEdges._fields:
        close(getattr(ej, f), getattr(et, f), 1e-6, 1e-4 if f == "info9" else 0.0)
    s = si[0]["system"]
    st = dict(R_bw=np.asarray(s.ms.kf_R_cw[2:7]), t_bw=np.asarray(s.ms.kf_t_cw[2:7]), v=si[0]["vel"][2:7] + 0.1,
              bg=si[0]["bg"][2:7] + 0.01, ba=si[0]["ba"][2:7] - 0.03)  # T_cb = I: body poses are camera poses
    st = {k: np.asarray(v, np.float32) for k, v in st.items()}
    rj, Jj = jax.jit(jvb.eval_inertial)(jvb.VIState(**{k: jnp.asarray(v) for k, v in st.items()}), ej,
                                        jnp.asarray(si[0]["gravity"]))
    rt, Jt = tvb.eval_inertial(tt(tvb.VIState, st), et, T(si[0]["gravity"]))
    close(rj, rt, 1e-5, 1e-5)
    close(Jj, Jt, 1e-5, 1e-4)


@pytest.mark.parametrize("solver", ["vi_bundle_adjust", "vi_bundle_adjust_cg"])
def test_vi_bundle_adjust(si, solver):
    st0, X0, obs, edges, fixed_kf, fixed_point = si[5]["vi_problem"]
    ref = si[5]["solvers"][solver]
    got = getattr(tvb, solver)(tt(tvb.VIState, st0), T(X0), tt(tfac.Observations, obs),
                               tt(tvb.InertialEdges, edges), T(fixed_kf), T(fixed_point), T(test_vi_ba.CAM),
                               torch.eye(3), torch.zeros(3), test_vi_ba.BF, T(test_vi_ba.G), **VI_BA_KW)
    body = lambda R, t: -np.einsum("kji,kj->ki", np.asarray(R), np.asarray(t))
    close(body(ref[0]["R_bw"], ref[0]["t_bw"]), body(got[0].R_bw, got[0].t_bw), 1e-4)
    close(ref[0]["v"], got[0].v, 1e-4)
    close(ref[1], got[1], 1e-3)
    # the costs, down 9 decades to sums at float32 rounding: rtol 1e-3 + 1e-5
    close(ref[2], got[2], 1e-5, 1e-3)


def test_inertial_optimization(si):
    args, kw, out = si[4]["initialize_imu"][0]
    ms, ikf, n_kf, g0, R_cb, t_cb = args[:6]
    ikf2, g2, s2 = tin.initialize_imu(tms.map_state_from_numpy(ms, "cpu"), ikf_t(ikf), int(n_kf), T(g0),
                                      T(R_cb), T(t_cb))
    assert angle(out[1], g2) <= 1e-4
    n = int(n_kf)
    close(out[0]["bg"][:n], ikf2.bg[:n], 1e-4)
    close(out[0]["ba"][:n], ikf2.ba[:n], 1e-4)
    close(out[0]["vel"][:n], ikf2.vel[:n], 1e-3)
    close(out[2], s2, 0.0)


@pytest.mark.parametrize("call", [0, 1, -1])
def test_vio_frame_step(si, call):
    args, kw, out = si[4]["vio_frame_step"][call]
    (lm_pos, lm_feat, lm_inl, xy, ur, lvl, _, R_vis, t_vis, prior, pre, cam, R_cb, t_cb, g, _) = args
    got = tvio.vio_frame_step(T(lm_pos), T(lm_feat), T(lm_inl), T(xy), T(ur), T(lvl), None, T(R_vis), T(t_vis),
                              vio_prior_t(prior), pre_t(pre), T(cam), T(R_cb), T(t_cb), T(g), None, **kw)
    R, t, cur, nxt, n_in = out
    assert int(got[4]) == int(n_in)
    close(t, got[1], 1e-4)
    assert rot_angle(R, got[0]) <= 1e-4
    close(cur["v"], got[2].v, 1e-3)
    close(cur["bg"], got[2].bg, 1e-4)
    close(nxt["H"], got[3].H, 1e-3 * np.abs(nxt["H"]).max())


def test_advance_imu(si):
    args, kw, out = si[4]["advance_imu"][-1]
    batch, bg, ba, sg, sa, pre_run = args[:6]
    got = tin.advance_imu(tt(timu.ImuBatch, batch), T(bg), T(ba), sg, sa, pre_t(pre_run),
                          *(T(a) for a in args[6:]))
    for f in timu.Preintegrated._fields:
        close(out[0][f], getattr(got[0], f), 1e-6, 1e-5)
        close(out[1][f], getattr(got[1], f), 1e-6, 1e-5)
    for a, b in zip(out[2:], got[2:]):
        close(a, b, 1e-5, 1e-5)


def _lvba_call(si, kind):
    if kind == "gba_sweep":
        args, kw, _ = [c for c in si[4]["local_vi_ba_step"] if c[1].get("window") == 10][-1]
        ref = si[5]["gba_sweep"]
        s = si[0]["system"]
        kw = dict(kw, window=16, prior_bg_info=0.0, prior_ba_info=0.0)
        return [npy(s.ms), npy(s.ikf), ref["center"]] + list(args[3:]), kw, ref["out"]
    window, priors = {"init_fiba": (16, True), "vi_local_ba": (10, False)}[kind]
    calls = [c for c in si[4]["local_vi_ba_step"]
             if c[1].get("window") == window and (float(c[1].get("prior_ba_info", 0.0)) > 0) == priors]
    assert calls, kind
    return calls[0]


@pytest.mark.parametrize("kind", ["init_fiba", "vi_local_ba", "gba_sweep"])
def test_local_vi_ba_step(si, kind):
    args, kw, out = _lvba_call(si, kind)
    ms, ikf, center, g, cam, R_cb, t_cb, bf = args
    tkw = {k: (float(v) if k.startswith("prior") else v) for k, v in kw.items() if k != "rig"}
    ms2, ikf2, cost = tin.local_vi_ba_step(tms.map_state_from_numpy(ms, "cpu"), ikf_t(ikf), int(center), T(g),
                                           T(cam), T(R_cb), T(t_cb), float(bf), **tkw)
    close(out[0]["kf_t_cw"], ms2.kf_t_cw, 1e-4)
    close(out[0]["kf_R_cw"], ms2.kf_R_cw, 1e-4)
    # landmarks: 1e-3 m; the sweep's window holds every keyframe and no bias
    # prior, and a few weakly observed landmarks 4-5 m out move 5e-3 m
    close(out[0]["lm_pos"], ms2.lm_pos, 5e-3 if kind == "gba_sweep" else 1e-3)
    close(out[1]["vel"], ikf2.vel, 1e-3)
    close(out[1]["bg"], ikf2.bg, 1e-4)


def test_full_inertial_ba(si):
    out, s = si[5]["full_inertial_ba"], si[0]["system"]
    t = si[1]["system"]
    got = tin.full_inertial_ba(tms.map_state_from_numpy(npy(s.ms), "cpu"), ikf_t(npy(s.ikf)), T(s.gravity),
                               t.cam_params, t.R_cb, t.t_cb, t.cfg.camera.bf, iters=2)
    close(out[0]["kf_t_cw"], got[0].kf_t_cw, 1e-4)
    close(out[0]["kf_R_cw"], got[0].kf_R_cw, 1e-4)
    close(out[1]["vel"], got[1].vel, 1e-3)
    close(out[2], got[2], 0.0, 1e-3)


def _without_far_landmarks(ms, far_m=10.0):
    """``ms`` with the landmarks farther than ``far_m`` from every valid
    keyframe centre dropped as ``tracking.cull_landmarks`` drops a landmark
    (invalid, its observation rows cleared)."""
    C = -torch.einsum("kji,kj->ki", ms.kf_R_cw, ms.kf_t_cw)[ms.kf_valid]
    far = ms.lm_valid & (torch.cdist(ms.lm_pos, C).min(dim=1).values > far_m)
    stale = (ms.obs_lm >= 0) & far[ms.obs_lm.clamp(min=0).long()]
    return ms._replace(lm_valid=ms.lm_valid & ~far, obs_lm=torch.where(stale, -1, ms.obs_lm))


@pytest.mark.parametrize("shards", [1, 8])
def test_distributed_full_inertial_ba(si, shards, monkeypatch):
    """The sharded FullInertialBA on the reference's final state against
    the port's ``full_inertial_ba`` (iters=2; the reference's two
    functions call the same solver with the same walk and prior weights):
    one shard gives its bits; eight stay within tests/test_dist_ba.py's
    distributed-versus-single bounds (poses 2e-3 m, velocities and biases
    2e-2, every landmark 5e-3 m).
    The state: the fixture's map without its landmarks farther than 10 m
    from every keyframe centre. That drops one landmark of 1,394, 20.4 m
    out (the next lies 9.5 m out) with two stereo observations of about
    1.2 px disparity (bf 25.3 px m), which the two iterations move 8.3 m:
    its back-substitution turns the 1e-7 m by which eight shards' ordered
    keyframe sums move the poses into 6.0e-3 m (2.0e-3 m on four shards;
    two shards, whose one boundary falls between keyframes, give the
    one-device bits). Without it the largest landmark gap is 5.3e-5 m on
    eight shards (9.7e-5 m on four)."""
    s, t = si[0]["system"], si[1]["system"]

    def args():
        return (_without_far_landmarks(tms.map_state_from_numpy(npy(s.ms), "cpu")), ikf_t(npy(s.ikf)),
                T(s.gravity), t.cam_params, t.R_cb, t.t_cb, t.cfg.camera.bf)
    ms0 = args()[0]
    assert int(ms0.lm_valid.sum()) == int(np.asarray(s.ms.lm_valid).sum()) - 1
    one = tin.full_inertial_ba(*args(), iters=2)
    monkeypatch.setattr(tdvb, "_VI_GBA_MESH", [torch.device("cpu")] * shards)
    got = tdvb.distributed_full_inertial_ba(*args(), iters=2)
    assert got[2] is None
    valid = ms0.lm_valid
    fields = {"t_cw": (one[0].kf_t_cw, got[0].kf_t_cw, 2e-3), "R_cw": (one[0].kf_R_cw, got[0].kf_R_cw, 2e-3),
              "vel": (one[1].vel, got[1].vel, 2e-2), "bg": (one[1].bg, got[1].bg, 2e-2),
              "ba": (one[1].ba, got[1].ba, 2e-2), "points": (one[0].lm_pos[valid], got[0].lm_pos[valid], 5e-3)}
    if shards == 1:
        assert all(torch.equal(a, b) for a, b, _ in fields.values())
    else:
        for name, (a, b, tol) in fields.items():
            assert float((a - b).abs().max()) <= tol, name
    assert float((got[0].kf_t_cw - ms0.kf_t_cw).abs().max()) > 1e-5  # the solve moved the map


def test_service_gba_routes_to_the_sharded_fiba(si, monkeypatch):
    """With a mesh of more than one shard, a GBA slice of an initialized
    inertial map with K <= 128 is the sharded whole-map FIBA (iters=2),
    not the window sweep, and its cost None leaves the budget fixed."""
    t = copy.copy(si[1]["system"])  # the slice rebinds the map and the counters on the copy
    assert t.imu_initialized and t.ms.K <= 128
    calls, real = [], tdvb.distributed_full_inertial_ba

    def spy(*a, **k):
        calls.append(k)
        return real(*a, **k)

    def sweep(*a, **k):
        raise AssertionError("the window sweep ran")
    monkeypatch.setattr(tdvb, "_VI_GBA_MESH", [torch.device("cpu")] * 8)
    monkeypatch.setattr(tdvb, "distributed_full_inertial_ba", spy)
    monkeypatch.setattr(tin, "local_vi_ba_step", sweep)
    t._gba_chunks_left, t._gba_chunks_run, t._gba_prev_cost = 1, 0, None
    ms0 = t.ms
    t._service_gba()
    assert [k["iters"] for k in calls] == [2]
    assert t._gba_chunks_left == 0 and t._gba_chunks_run == 1 and t._gba_prev_cost is None
    assert t.ms is not ms0


def test_store_preintegration_exact(si):
    for args, kw, out in si[4]["store_preintegration"]:
        ikf, kf_idx, pre, vel = args
        got = tin.store_preintegration(ikf_t(ikf), int(kf_idx), pre_t(pre), T(vel))
        for f in tin.InertialKF._fields:
            np.testing.assert_array_equal(getattr(got, f).numpy(), out[f], err_msg=f)


def test_merge_and_compact(si):
    ref = si[5]["merge_and_compact"]
    got = tin.merge_and_compact(ikf_t(npy(si[0]["system"].ikf)), T(ref["keep"]))
    np.testing.assert_array_equal(got.pre_valid.numpy(), ref["out"]["pre_valid"])
    for f in tin.InertialKF._fields:
        close(ref["out"][f], getattr(got, f), 1e-5, 1e-5)
    # the kept keyframes move down; a culled one's window flows into the next
    assert int(got.pre_valid.sum()) == si[0]["n_kf"] - len(CULLED) - 1
    assert float(got.pre_dt[CULLED[0]]) > 2.5 / SI["fps"]


def test_correction_4dof(si):
    """The 4-DoF correction (``_correct_core`` in "4dof" mode, then the
    velocities turned with each keyframe's correction) on the reference's
    final map."""
    ref, s, t = si[5]["correction_4dof"], si[0]["system"], si[1]["system"]
    n = s.n_kf
    lc = tlc.LoopCloser(max_kf=t.ms.K, vocab=None)
    ms, ikf = lc.correct(tms.map_state_from_numpy(npy(s.ms), "cpu"), n, n - 1, CORRECTION["cand"], T(ref["R_d"]),
                         T(ref["t_d"]), t.cam_params, t.cfg.camera.bf, run_gba=False, mode="4dof",
                         gravity=T(s.gravity), s_delta=torch.ones(()), ikf=ikf_t(npy(s.ikf)))
    close(ref["ms"]["kf_t_cw"], ms.kf_t_cw, 1e-4)
    close(ref["ms"]["kf_R_cw"], ms.kf_R_cw, 1e-4)
    close(ref["vel"], ikf.vel, 1e-4)
    valid = ref["ms"]["lm_valid"]
    close(ref["ms"]["lm_pos"][valid], ms.lm_pos.numpy()[valid], 1e-3)
    assert np.abs(ref["ms"]["kf_t_cw"][:n] - np.asarray(s.ms.kf_t_cw)[:n]).max() > 1e-3  # it moved the map


def test_pose_prior(si):
    """pose_optimization with an IMU pose prior (the prior of the
    reference's ``_track_with_frame``) on a seeded problem."""
    ref = si[5]["pose_prior"]
    args, prior = pose_prior_problem()
    got = tba.pose_optimization(*(T(a) if isinstance(a, np.ndarray) else a for a in args),
                                prior=(T(prior[0]), T(prior[1]), float(prior[2]), float(prior[3])))
    close(ref["t_cw"], got.t_cw, 1e-5)
    close(ref["R_cw"], got.R_cw, 1e-5)
    np.testing.assert_array_equal(ref["inlier"], got.inlier.numpy())


@pytest.fixture(scope="module")
def checkpoints(si):
    """Each system's map saved with its IMU state live."""
    tmp = tempfile.mkdtemp()
    paths = {}
    for name, r in (("jax", si[0]), ("torch", si[1])):
        paths[name] = os.path.join(tmp, f"{name}_active.npz")
        r["system"].save_map(paths[name])
    yield paths, tmp
    for p in paths.values():
        os.remove(p)
    os.rmdir(tmp)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_inertial_checkpoints_cross_packages(si, checkpoints, direction):
    """A snapshot that either package saves loads in the other with every
    inertial array as written; shelved by the loading system and saved
    again, the shelf's inertial block comes back in the first package."""
    cfg = si[3]
    paths, tmp = checkpoints
    src = "jax" if direction == "jax_to_torch" else "torch"
    new = {"jax": lambda: JaxSlam(to_jax_config(cfg)), "torch": lambda: TorchSlam(cfg, device="cpu")}
    src_sys = si[0 if src == "jax" else 1]["system"]
    other = "torch" if src == "jax" else "jax"
    sys_ = new[other]()
    sys_.load_map(paths[src])
    for f in tin.InertialKF._fields:
        np.testing.assert_array_equal(np.asarray(getattr(sys_.ikf, f)), np.asarray(getattr(src_sys.ikf, f)), f)
    np.testing.assert_array_equal(np.asarray(sys_.gravity), np.asarray(src_sys.gravity))
    np.testing.assert_array_equal(np.asarray(sys_.frame_vel), np.asarray(src_sys.frame_vel))
    assert sys_.imu_initialized and sys_._last_kf_time == src_sys._last_kf_time
    assert sys_._last_frame_time == src_sys._last_frame_time
    # shelve the loaded map (what a timestamp gap does) and carry the shelf back
    sys_._create_map_in_atlas()
    assert len(sys_.atlas_maps) == 1 and "ikf" in sys_.atlas_maps[0] and not sys_.imu_initialized
    path = os.path.join(tmp, f"{other}_shelved.npz")
    sys_.save_map(path)
    back = new[src]()
    back.load_map(path)
    os.remove(path)
    shelf = back.atlas_maps[0]
    for f in tin.InertialKF._fields:
        np.testing.assert_array_equal(np.asarray(getattr(shelf["ikf"], f)), np.asarray(getattr(src_sys.ikf, f)), f)
        np.testing.assert_array_equal(np.asarray(getattr(back.ikf, f)), np.asarray(getattr(sys_.ikf, f)), f)
    np.testing.assert_array_equal(np.asarray(shelf["gravity"]), np.asarray(src_sys.gravity))
    assert shelf["imu_initialized"] is True and not back.imu_initialized


def test_inertial_weld_exact(si):
    """merge_into_shelved with an inertial shelf, on the reference's final
    state (``weld_system``): the inertial arrays come out exactly as the
    reference's."""
    ref, j, cfg = si[5]["weld"], si[0], si[3]

    def to(kind, x):
        if kind == "ms":
            return tms.map_state_from_numpy(npy(x), "cpu")
        if kind == "ikf":
            return ikf_t(npy(x))
        return T(np.asarray(x))

    R_d, t_d = jlie.se3_exp(jnp.array(WELD_DELTA))
    slam, R, t = weld_system(TorchSlam(cfg, device="cpu"), j, R_d, t_d, to)
    ok = tmm.merge_into_shelved(slam, 0, j["n_kf"] - 1, j["n_kf"] - 2, R, t)
    assert ok and ref["ok"] and not slam.atlas_maps and ref["maps"] == 0
    assert slam.n_kf == ref["n_kf"] == 2 * j["n_kf"]
    for f in tin.InertialKF._fields:
        np.testing.assert_array_equal(getattr(slam.ikf, f).numpy(), ref["ikf"][f], err_msg=f)
