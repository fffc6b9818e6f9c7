"""The port's monocular and monocular-inertial paths against the JAX
reference on the CPU.

One module fixture runs four ``SlamSystem``s, the reference's two first,
both packages on the same numpy images:

- ``MONOCULAR``: ``chip_smoke.mono_config(small=True)``, which is
  ``tests/test_slam_e2e.small_config()`` (240x376, 600 features) with a
  keyframe at least every 3 frames and synchronous decisions, over the 20
  strafe frames of ``tests/test_mono.py`` (0.05 m/frame), loop closing on:
  two-view initialization at frame 3, then keyframes with neighbour
  triangulation;
- ``IMU_MONOCULAR``: ``chip_smoke.mi_config(small=True)`` over 25 frames
  of ``AnalyticTrajectory(excitation=3.0)`` at 10 fps with 200 Hz IMU
  samples: two-view initialization at frame 1, the IMU and the metric
  scale initialized at frame 22 with 12 keyframes over 2.1 s, then the
  init-FIBA slices and two VIO frames.

The port's front end is handed the reference's extracted frames (its own
``process_mono`` is held to the reference below): the reference's
batch-of-one extraction program rounds keypoint coordinates and angles in
another order than its stereo batch of two, which the port reproduces bit
for bit (1 ulp on ~2 % of the keypoints), and over a monocular map built
from low-parallax triangulations such differences grow to millimetres.

The reference's ``reconstruct_two_views_hf``, ``triangulate_with_neighbor``,
``add_triangulated_landmarks``, ``full_mono_step``, ``initialize_imu`` and
``local_vi_ba_step`` calls are captured with their inputs and outputs, and
the port's functions are held to them on those inputs; the reference's
``_correct_core(mode="sim3")`` runs on its final mono map.

Tolerances: the init frames, the keyframe frames, the IMU-init frame and
keyframe count and the lifecycle counters exactly; per-frame camera
centres within 2e-3 m and rotations within 1e-3 rad (monocular: every
frame, in the map's gauge, median depth 2 at initialization;
mono-inertial: every frame through the IMU-init frame, as the trajectory
stands right after the scale solve re-gauged it); final landmarks within 2
%; gravity within 1e-3 rad and the recovered scale within 1e-3 relative.
After the mono-inertial init-FIBA slices (2-iteration LM steps of ~3 cm on
the just re-gauged map, which on the reference's inputs agree within 1e-4
but carry the runs' 0.3 mm differences ~20-fold) every frame within 1e-2 m
and 1e-2 rad. On captured inputs: ``full_mono_step``'s keypoint levels,
descriptors, validity, track association and inlier count exactly, its
keypoints within 1e-4 px and its pose within 1e-4;
``triangulate_with_neighbor``'s masks, matches and neighbours exactly, its
points within 5e-3 + 2e-3 relative (midpoint triangulation at 0.4 degrees
of parallax cancels in float32, so the reference's own points carry that
rounding); ``add_triangulated_landmarks``' slots, observations and
counters exactly, its points and bands within 1e-6; for
``reconstruct_two_views_hf`` the verdict, the point count and the inlier
set exactly and, where it accepts, the rotation and unit translation
within 1e-4 and the points within 5e-3 + 2e-3 relative (the reference's
8x9 and 3x3 SVDs are float32 LAPACK, the port's a float64 QR and Jacobi
solve); the scale-estimating ``initialize_imu`` gravity within 1e-4 rad,
scale 1e-4 relative, biases 1e-4, velocities 1e-3; the init-FIBA slices'
poses 1e-4 and velocities 1e-3; the Sim(3) correction's poses and scales
1e-4 and landmarks 1e-3. Standalone: the radial-tangential model 1e-6;
``process_mono`` (with and without distortion) levels, descriptors and
validity exactly, keypoints and angles within 1e-4; ``apply_scale``
exactly; the two-view problems of ``tests/test_mono.py`` with their keys
as the captured calls; a mono map's checkpoint: every array exactly, both
ways, and one frame tracked after it within 2e-3 m / 1e-3 rad.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_slam_e2e import FX, H, W, small_config
from test_torch_system import assert_loaded, to_jax_config
from orb_slam3_detailed_comments_kor_tpu import config as jcfg
from orb_slam3_detailed_comments_kor_tpu.models import camera as jcam
from orb_slam3_detailed_comments_kor_tpu.ops import twoview as jtv
from orb_slam3_detailed_comments_kor_tpu.slam import frontend as jfe
from orb_slam3_detailed_comments_kor_tpu.slam import inertial as jin
from orb_slam3_detailed_comments_kor_tpu.slam import loop_closing as jlc
from orb_slam3_detailed_comments_kor_tpu.slam import map_merging as jmm
from orb_slam3_detailed_comments_kor_tpu.slam import map_state as jms
from orb_slam3_detailed_comments_kor_tpu.slam import tracking as jtr
from orb_slam3_detailed_comments_kor_tpu.slam.system import SlamSystem as JaxSlam
from orb_slam3_detailed_comments_kor_tpu.utils import lie as jlie
from orb_slam3_detailed_comments_kor_tpu_torch.config import SensorType
from orb_slam3_detailed_comments_kor_tpu_torch.models import camera as tcam
from orb_slam3_detailed_comments_kor_tpu_torch.ops import twoview as ttv
from orb_slam3_detailed_comments_kor_tpu_torch.slam import frontend as tfe
from orb_slam3_detailed_comments_kor_tpu_torch.slam import inertial as tin
from orb_slam3_detailed_comments_kor_tpu_torch.slam import loop_closing as tlc
from orb_slam3_detailed_comments_kor_tpu_torch.slam import map_merging as tmm
from orb_slam3_detailed_comments_kor_tpu_torch.slam import map_state as tms
from orb_slam3_detailed_comments_kor_tpu_torch.slam import tracking as ttr
from orb_slam3_detailed_comments_kor_tpu_torch.slam.system import SlamSystem as TorchSlam

MONO = dict(chip_smoke.SMALL_MONO, fps=chip_smoke.FPS)
MI = chip_smoke.SMALL_MI
CAPTURED = {jtv: ("reconstruct_two_views_hf",),
            jtr: ("triangulate_with_neighbor", "add_triangulated_landmarks", "full_mono_step"),
            jin: ("initialize_imu", "local_vi_ba_step")}


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


def ms_t(d):
    return tms.map_state_from_numpy(d, "cpu")


def close(ref, got, tol, rtol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=tol)


def mono_config():
    return chip_smoke.mono_config(small=True)


def mono_images(n):
    """The strafe's images (numpy) and ground-truth centres."""
    ts, imgs = chip_smoke.render_mono_sequence(mono_config(), n, "cpu", speed=MONO["speed"])
    return [m.numpy() for m in imgs], ts


def test_small_mono_config():
    """The small monocular configuration is small_config() (240x376, 600
    features) with a MONOCULAR sensor, a keyframe at least every 3 frames
    and synchronous decisions."""
    assert to_jax_config(mono_config()) == dataclasses.replace(
        small_config(), sensor=SensorType.MONOCULAR,
        tracking=jcfg.TrackingConfig(max_frames_between_kf=3, decision_batch=1))


def run(system, imgs, imu=None, fps=MONO["fps"]):
    """Feed the frames; record the init frame, the keyframe frames and
    (inertial) the IMU-init frame and keyframe count."""
    kf_at, init, imu_init = [], None, None
    for i, img in enumerate(imgs):
        n0 = system.stats["kf_inserted"]
        if imu is None:
            system.track_mono(img, i / fps)
        else:
            system.track_mono_inertial(img, i / fps, imu[i])
        if system.stats["kf_inserted"] != n0:
            kf_at.append(i)
        if init is None and system.state == 1:
            init = i
        if imu is not None and imu_init is None and system.imu_initialized:
            imu_init = (i, system.n_kf)
            traj_at_init = system.trajectory_arrays()
    system.flush_decisions()
    out = dict(system=system, kf_at=kf_at, init=init, imu_init=imu_init, traj=system.trajectory_arrays(),
               stats=dict(system.stats), state=system.state, n_kf=system.n_kf,
               n_landmarks=int(np.asarray(system.ms.lm_valid).sum()))
    if imu is not None:
        out.update(gravity=np.array(system.gravity), traj_at_init=traj_at_init)
    return out


def ref_correction_sim3(j):
    """The reference's Sim(3) correction on its final mono map: a loop
    between the newest keyframe and keyframe 1 with a 5 % scale drift."""
    s = j["system"]
    n = s.n_kf
    R_d, t_d = jlie.se3_exp(jnp.array(SIM3_DELTA))
    ms, _, s_new = jlc._correct_core(s.ms, jnp.int32(n), jnp.int32(n - 1), jnp.int32(1), R_d, t_d,
                                     jnp.float32(SIM3_SCALE), s.cam_params, jnp.float32(s.cfg.camera.bf), None,
                                     False, "sim3")
    return dict(ms_in=npy(s.ms), ms=npy(ms), s_new=np.array(s_new), R_d=np.array(R_d), t_d=np.array(t_d))


SIM3_DELTA, SIM3_SCALE = (0.02, -0.01, 0.03, 0.01, -0.02, 0.015), 1.05


@pytest.fixture(scope="module")
def mono():
    cfg, mcfg = mono_config(), chip_smoke.mi_config(small=True)
    imgs, ts = mono_images(MONO["frames"])
    gt, frames, imu = chip_smoke.render_si_sequence(mcfg, MI["frames"], "cpu", fps=MI["fps"], mono=True,
                                                    excitation=3.0)
    mi_imgs = [f.numpy() for f in frames]
    # the reference's frames for the port's front end, by image buffer
    ref_frames = {}

    def extract(images):
        out = {}
        for img in images:
            f = jfe.process_mono(jnp.asarray(img), n_features=cfg.orb.n_features, cell=cfg.orb.cell_size)
            out[img.__array_interface__["data"][0]] = tfe.frame_from_numpy(
                {k: None if v is None else np.asarray(v) for k, v in f._asdict().items()}, "cpu")
        return out
    saved_fe = tfe.process_mono

    def port_frontend(img, **kw):
        f = ref_frames.get(img.data_ptr())
        return saved_fe(img, **kw) if f is None else f
    captured = {name: [] for names in CAPTURED.values() for name in names}
    saved = {(mod, name): getattr(mod, name) for mod, names in CAPTURED.items() for name in names}
    which = {"run": None}

    def capture(name, fn):
        def wrapper(*a, **k):
            args = (npy(a), npy(k))  # before the call: full_mono_step donates its map
            out = fn(*a, **k)
            captured[name].append((which["run"],) + args + (npy(out),))
            return out
        return wrapper

    def tagged(tag, fn, *a, **k):
        which["run"] = tag
        try:
            return fn(*a, **k)
        finally:
            which["run"] = None

    for (mod, name), fn in saved.items():
        setattr(mod, name, capture(name, fn))
    tfe.process_mono = port_frontend
    # the tests' JAX runtime has 8 virtual devices: the reference's inertial
    # GBA takes its one-device branch, as on the card
    saved_devices = jax.devices
    jax.devices = lambda *a: saved_devices(*a)[:1]
    try:
        # the reference's runs, then the port's on the reference's frames
        out = dict(j_mi=tagged("mi", run, JaxSlam(to_jax_config(mcfg)), mi_imgs, imu, MI["fps"]),
                   j=tagged("mono", run, JaxSlam(to_jax_config(cfg)), imgs))
        for x in (mi_imgs, imgs):
            ref_frames.update(extract(x))
        out["t_mi"] = run(TorchSlam(mcfg, device="cpu"), mi_imgs, imu, MI["fps"])
        # the monocular map carries the order of float additions to
        # millimetres (F24), and the port's sums follow torch's thread count:
        # this run keeps the two threads its tolerances were set at
        threads = torch.get_num_threads()
        torch.set_num_threads(2)
        try:
            out["t"] = run(TorchSlam(cfg, device="cpu"), imgs)
        finally:
            torch.set_num_threads(threads)
        out["correction_sim3"] = ref_correction_sim3(out["j"])
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
        tfe.process_mono = saved_fe
        jax.devices = saved_devices
    out.update(cfg=cfg, mcfg=mcfg, ts=ts, gt=gt, captured=captured, imgs=imgs)
    return out


# ---------------------------------------------------------------------------
# the two runs
# ---------------------------------------------------------------------------

def test_mono_init_keyframes_and_stats(mono):
    j, t = mono["j"], mono["t"]
    assert t["init"] == j["init"] == 3
    assert t["kf_at"] == j["kf_at"]
    assert t["stats"] == j["stats"] and j["stats"]["kf_inserted"] >= 6
    assert t["state"] == j["state"] == 1


def test_mono_per_frame_poses(mono):
    d_centre, d_rot = chip_smoke.trajectory_diff(mono["j"]["traj"], mono["t"]["traj"])
    assert len(d_centre) == MONO["frames"]
    assert d_centre.max() <= 2e-3, np.round(d_centre * 1e3, 3).tolist()
    assert d_rot.max() <= 1e-3


def test_mono_map(mono):
    j, t = mono["j"], mono["t"]
    assert abs(t["n_landmarks"] - j["n_landmarks"]) <= 0.02 * j["n_landmarks"]
    n = j["n_kf"]
    close(np.asarray(j["system"].ms.kf_t_cw[:n]), t["system"].ms.kf_t_cw[:n], 2e-3)


def test_mono_scale_aligned_ate(mono):
    from orb_slam3_detailed_comments_kor_tpu_torch.eval import ate

    ts = mono["ts"]
    ate_j = ate.ate_rmse(mono["j"]["traj"][1], ts, with_scale=True)
    ate_t = ate.ate_rmse(mono["t"]["traj"][1], ts, with_scale=True)
    assert ate_t <= ate_j + 2e-3 and ate_j < 0.05


def test_mi_init_keyframes_and_stats(mono):
    j, t = mono["j_mi"], mono["t_mi"]
    assert t["init"] == j["init"]
    assert t["imu_init"] == j["imu_init"] and j["imu_init"][1] >= 8
    assert t["kf_at"] == j["kf_at"]
    assert t["stats"] == j["stats"]
    assert t["state"] == j["state"] == 1
    assert t["system"].imu_initialized


def test_mi_per_frame_poses_through_imu_init(mono):
    """Every frame through the IMU-init frame, as the trajectory stands
    right after the scale solve re-gauged the map."""
    j, t = mono["j_mi"], mono["t_mi"]
    d_centre, d_rot = chip_smoke.trajectory_diff(j["traj_at_init"], t["traj_at_init"])
    assert len(d_centre) == j["imu_init"][0] + 1
    assert d_centre.max() <= 2e-3, np.round(d_centre * 1e3, 3).tolist()
    assert d_rot.max() <= 1e-3


def test_mi_final_poses_and_gravity(mono):
    """After the init-FIBA slices (unconverged 2-iteration LM steps of ~3
    cm on the just re-gauged map, held to 1e-4 on the reference's inputs
    below) the runs stay within 1e-2 m and 1e-2 rad; gravity within 1e-3
    rad."""
    j, t = mono["j_mi"], mono["t_mi"]
    d_centre, d_rot = chip_smoke.trajectory_diff(j["traj"], t["traj"])
    assert len(d_centre) == MI["frames"]
    assert d_centre.max() <= 1e-2, np.round(d_centre * 1e3, 3).tolist()
    assert d_rot.max() <= 1e-2
    assert chip_smoke.gravity_angle(j["gravity"], t["gravity"]) <= 1e-3


def test_mi_metric_scale(mono):
    """The map is metric after the scale solve: the stride-10 path length
    of both runs agrees, and the recovered scale agrees within 1e-3."""
    (ref_call,) = [c for c in mono["captured"]["initialize_imu"] if c[2].get("estimate_scale")][:1]
    s_ref = float(ref_call[3][2])
    j, t = mono["j_mi"], mono["t_mi"]
    got = tin.initialize_imu(ms_t(ref_call[1][0]), tin.InertialKF(**{k: T(v) for k, v in ref_call[1][1].items()}),
                             int(ref_call[1][2]), T(ref_call[1][3]), T(ref_call[1][4]), T(ref_call[1][5]),
                             estimate_scale=True)
    assert abs(float(got[2]) / s_ref - 1.0) <= 1e-3
    c_j, c_t = j["traj"][1][::10], t["traj"][1][::10]
    len_j = np.linalg.norm(np.diff(c_j, axis=0), axis=1).sum()
    len_t = np.linalg.norm(np.diff(c_t, axis=0), axis=1).sum()
    assert abs(len_t / len_j - 1.0) <= 1e-2


# ---------------------------------------------------------------------------
# the port's modules on the reference's captured inputs
# ---------------------------------------------------------------------------

def test_reconstruct_two_views_hf_captured(mono):
    calls = mono["captured"]["reconstruct_two_views_hf"]
    assert {c[0] for c in calls if c[3]["ok"]} == {"mono", "mi"}
    for _, (ra, rb, valid, key), kw, ref in calls:
        got = ttv.reconstruct_two_views_hf(T(ra), T(rb), T(valid), T(key.astype(np.int64)), **kw)
        assert bool(got.ok) == bool(ref["ok"])
        assert int(got.n_good) == int(ref["n_good"])
        np.testing.assert_array_equal(got.inlier.numpy(), ref["inlier"])
        if not ref["ok"]:
            continue  # a refused reconstruction's motion and points go unused
        close(ref["R_ba"], got.R_ba, 1e-4)
        close(ref["t_ba"], got.t_ba, 1e-4)
        close(ref["X"][ref["inlier"]], got.X.numpy()[ref["inlier"]], 5e-3, rtol=2e-3)


def test_triangulate_with_neighbor_captured(mono):
    calls = mono["captured"]["triangulate_with_neighbor"]
    assert len(calls) >= 4 and {c[0] for c in calls} == {"mono", "mi"}
    for _, (ms, kf, cam), kw, (fb, Xw, want, nb) in calls:
        got = ttr.triangulate_with_neighbor(ms_t(ms), int(kf), T(cam), **kw)
        np.testing.assert_array_equal(got[2].numpy(), want)
        np.testing.assert_array_equal(got[0].numpy(), fb)
        np.testing.assert_array_equal(got[3].numpy(), nb)
        close(Xw[want], got[1].numpy()[want], 5e-3, rtol=2e-3)
        assert want.sum() > 20


def test_add_triangulated_landmarks_captured(mono):
    calls = mono["captured"]["add_triangulated_landmarks"]
    assert len(calls) >= 6
    for _, (ms, kf_a, kf_b, feat_b, X_w, want, cam), kw, ref in calls:
        kf_b = int(kf_b) if np.ndim(kf_b) == 0 else T(kf_b)
        got = tms.map_state_to_numpy(ttr.add_triangulated_landmarks(ms_t(ms), int(kf_a), kf_b, T(feat_b), T(X_w),
                                                                    T(want), T(cam), **kw))
        for f in ("lm_valid", "obs_lm", "lm_found", "lm_visible", "lm_first_kf", "lm_desc"):
            np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
        for f in ("lm_pos", "lm_normal", "lm_min_dist", "lm_max_dist"):
            close(ref[f], got[f], 1e-6, rtol=1e-6)


def test_full_mono_step_captured(mono):
    """The first tracked mono frame, the first mono-inertial frame tracked
    without and the first with the IMU pose prior."""
    calls = mono["captured"]["full_mono_step"]
    mono_calls = [c for c in calls if c[0] == "mono"]
    mi_calls = [c for c in calls if c[0] == "mi"]
    with_prior = [c for c in mi_calls if float(c[1][8][2]) > 0]
    assert mono_calls and mi_calls and with_prior
    for _, a, kw, ref in (mono_calls[0], mi_calls[0], with_prior[0]):
        prior = tuple(T(p) for p in a[8])
        got = ttr.full_mono_step(ms_t(a[0]), T(a[1]), *(T(x) for x in a[2:8]), prior, **kw)
        ms, frame, tr, R, t, vR, vt, ok = got
        for f in ("level", "desc", "valid"):
            np.testing.assert_array_equal(getattr(frame, f).numpy(), ref[1][f], err_msg=f)
        close(ref[1]["xy"], frame.xy, 1e-4)
        np.testing.assert_array_equal(frame.desc_packed.numpy().view(np.uint32), ref[1]["desc_packed"])
        np.testing.assert_array_equal(tr.lm_feat.numpy(), ref[2]["lm_feat"])
        assert int(tr.n_inliers) == int(ref[2]["n_inliers"]) and bool(ok) == bool(ref[7])
        close(ref[3], R, 1e-4)
        close(ref[4], t, 1e-4)
        np.testing.assert_array_equal(tms.map_state_to_numpy(ms)["lm_found"], ref[0]["lm_found"])


def test_initialize_imu_with_scale_captured(mono):
    calls = [c for c in mono["captured"]["initialize_imu"] if c[2].get("estimate_scale")]
    assert calls
    for _, a, kw, (ikf_ref, g_ref, s_ref) in calls:
        ikf, g, s = tin.initialize_imu(ms_t(a[0]), tin.InertialKF(**{k: T(v) for k, v in a[1].items()}), int(a[2]),
                                       T(a[3]), T(a[4]), T(a[5]), **kw)
        assert chip_smoke.gravity_angle(g_ref, g.numpy()) <= 1e-4
        assert abs(float(s) / float(s_ref) - 1.0) <= 1e-4
        n = int(a[2])
        close(ikf_ref["bg"][:n], ikf.bg[:n], 1e-4)
        close(ikf_ref["ba"][:n], ikf.ba[:n], 1e-4)
        close(ikf_ref["vel"][:n], ikf.vel[:n], 1e-3)


def test_init_fiba_slices_captured(mono):
    """The post-init FIBA slices of the mono-inertial run (window 16, bias
    priors) on the reference's inputs."""
    calls = [c for c in mono["captured"]["local_vi_ba_step"] if c[0] == "mi"]
    assert len(calls) >= 3
    for _, a, kw, ref in calls[:3]:
        kw = {k: float(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
        ms, ikf, _ = tin.local_vi_ba_step(ms_t(a[0]), tin.InertialKF(**{k: T(v) for k, v in a[1].items()}),
                                          int(a[2]), T(a[3]), T(a[4]), T(a[5]), T(a[6]), float(a[7]), **kw)
        close(ref[0]["kf_t_cw"], ms.kf_t_cw, 1e-4)
        close(ref[0]["kf_R_cw"], ms.kf_R_cw, 1e-4)
        close(ref[1]["vel"], ikf.vel, 1e-3)
        assert np.abs(ref[0]["kf_t_cw"] - a[0]["kf_t_cw"]).max() > 1e-3  # the slice moved the map


def test_correction_sim3(mono):
    """``_correct_core`` in Sim(3) mode (the monocular loop correction) on
    the reference's final mono map."""
    ref = mono["correction_sim3"]
    n = mono["j"]["n_kf"]
    ms, _, s_new = tlc._correct_core(ms_t(ref["ms_in"]), n, n - 1, 1, T(ref["R_d"]), T(ref["t_d"]),
                                     torch.tensor(SIM3_SCALE), mono["t"]["system"].cam_params, 0.0, False, "sim3")
    close(ref["s_new"], s_new, 1e-4)
    close(ref["ms"]["kf_t_cw"], ms.kf_t_cw, 1e-4)
    close(ref["ms"]["kf_R_cw"], ms.kf_R_cw, 1e-4)
    valid = ref["ms"]["lm_valid"]
    close(ref["ms"]["lm_pos"][valid], ms.lm_pos.numpy()[valid], 1e-3)
    assert np.abs(ref["s_new"][:n] - 1.0).max() > 1e-3  # the scale moved


# ---------------------------------------------------------------------------
# standalone
# ---------------------------------------------------------------------------

DIST = (-0.28, 0.07, 2e-4, -1e-4, 0.01)


@pytest.mark.parametrize("dist", [DIST[:4], DIST])
def test_radtan_distortion(dist):
    rng = np.random.RandomState(5)
    xn = rng.uniform(-0.6, 0.6, (300, 2)).astype(np.float32)
    xd_ref = np.array(jcam.distort_radtan(jnp.asarray(dist, jnp.float32), jnp.asarray(xn)))
    xd = tcam.distort_radtan(torch.tensor(dist, dtype=torch.float32), T(xn))
    close(xd_ref, xd, 1e-6)
    xu_ref = np.array(jcam.undistort_radtan(jnp.asarray(dist, jnp.float32), jnp.asarray(xd_ref)))
    xu = tcam.undistort_radtan(torch.tensor(dist, dtype=torch.float32), T(xd_ref))
    close(xu_ref, xu, 1e-6)


@pytest.mark.parametrize("dist", [None, DIST[:4]])
def test_process_mono(dist):
    imgs, _ = mono_images(1)
    cam = np.array([FX, FX, W / 2.0, H / 2.0], np.float32)
    ref = jfe.process_mono(jnp.asarray(imgs[0]), n_features=600, cell=24, dist=dist, cam_params=jnp.asarray(cam))
    got = tfe.process_mono(T(imgs[0]), n_features=600, cell=24, dist=dist, cam_params=T(cam))
    for f in ("level", "desc", "valid", "u_right", "depth"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_array_equal(got.desc_packed.numpy().view(np.uint32), np.asarray(ref.desc_packed))
    close(ref.angle, got.angle, 1e-4)
    close(ref.xy, got.xy, 1e-4)
    if dist is not None:
        assert np.abs(np.asarray(ref.xy) - np.asarray(jfe.process_mono(jnp.asarray(imgs[0]), n_features=600,
                                                                       cell=24).xy)).max() > 1.0


def test_apply_scale():
    rng = np.random.RandomState(2)
    ms = jms.empty_map(8, 40, 64)
    ms = ms._replace(lm_pos=jnp.asarray(rng.randn(64, 3), jnp.float32),
                     kf_t_cw=jnp.asarray(rng.randn(8, 3), jnp.float32),
                     lm_min_dist=jnp.asarray(rng.rand(64), jnp.float32),
                     lm_max_dist=jnp.asarray(rng.rand(64) + 1, jnp.float32))
    ref = npy(jms.apply_scale(ms, jnp.float32(1.37)))
    got = tms.map_state_to_numpy(tms.apply_scale(ms_t(npy(ms)), torch.tensor(1.37)))
    for f in got:
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)


def known_motion(planar):
    """tests/test_mono.py's problems with their keys: (rays_a, rays_b, key)."""
    if planar:
        key = jax.random.PRNGKey(3)
        uv = jax.random.uniform(key, (300, 2), minval=-1.5, maxval=1.5)
        X = jnp.stack([uv[:, 0] * 2.0, uv[:, 1] * 1.5, 4.0 + 0.3 * uv[:, 0] + 0.2 * uv[:, 1]], axis=-1)
        R_gt, t_gt = jlie.so3_exp(jnp.array([0.03, -0.06, 0.02])), jnp.array([0.4, 0.1, 0.05])
    else:
        key = jax.random.PRNGKey(13)
        X = jax.random.uniform(key, (200, 3), minval=jnp.array([-2.0, -1.5, 2.0]),
                               maxval=jnp.array([2.0, 1.5, 6.0]))
        R_gt, t_gt = jlie.so3_exp(jnp.array([0.02, -0.05, 0.01])), jnp.array([0.3, 0.05, 0.1])
    rays_a = X / X[:, 2:3]
    Xb = X @ R_gt.T + t_gt
    rays_b = Xb / Xb[:, 2:3]
    return rays_a, rays_b, key


TWO_VIEW_PROBLEMS = ("known_motion_outliers", "known_motion_outliers_hf", "planar_hf", "general_hf")


def two_view_problem(problem):
    """(function name, rays_a, rays_b, valid, key) of one problem."""
    ra, rb, key = known_motion(planar=problem.startswith("planar"))
    if problem.startswith("known_motion_outliers"):
        out = jax.random.uniform(key, (200,)) < 0.2
        rb = jnp.where(out[:, None], rb + 0.05, rb)
    name = "reconstruct_two_views" if problem == "known_motion_outliers" else "reconstruct_two_views_hf"
    return name, ra, rb, jnp.ones((ra.shape[0],), bool), key


@pytest.fixture(scope="module")
def two_view_refs():
    """The reference's answers to the two-view problems."""
    def solve(problem):
        name, ra, rb, valid, key = two_view_problem(problem)
        return getattr(jtv, name)(ra, rb, valid, key, inlier_th=1e-8)

    return {problem: solve(problem) for problem in TWO_VIEW_PROBLEMS}


@pytest.mark.parametrize("problem", TWO_VIEW_PROBLEMS)
def test_two_view_problems(two_view_refs, problem):
    """The two-view problems of tests/test_mono.py: known motion with 20 %
    outliers through E (and through the H/E selection), the planar scene
    through the selection, the general scene through the selection."""
    name, ra, rb, valid, key = two_view_problem(problem)
    ref = two_view_refs[problem]
    got = getattr(ttv, name)(T(ra), T(rb), T(valid), T(np.asarray(key).astype(np.int64)), inlier_th=1e-8)
    assert bool(got.ok) == bool(ref.ok)
    assert int(got.n_good) == int(ref.n_good)
    np.testing.assert_array_equal(got.inlier.numpy(), np.asarray(ref.inlier))
    close(ref.R_ba, got.R_ba, 1e-4)
    close(ref.t_ba, got.t_ba, 1e-4)
    inl = np.asarray(ref.inlier)
    close(np.asarray(ref.X)[inl], got.X.numpy()[inl], 5e-3, rtol=2e-3)


@pytest.fixture(scope="module")
def mono_maps():
    """Both packages' systems after the strafe's two-view initialization
    and one tracked frame."""
    cfg = mono_config()
    imgs, _ = mono_images(6)
    j, t = run(JaxSlam(to_jax_config(cfg)), imgs[:5]), run(TorchSlam(cfg, device="cpu"), imgs[:5])
    return dict(jax=j["system"], port=t["system"], cfg=cfg, next=imgs[5])


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_mono_checkpoint_cross_packages(mono_maps, direction, tmp_path):
    """A mono map that either package saves loads in the other exactly, and
    both then track the next frame alike."""
    src, dst = direction.split("_to_")
    written = mono_maps[src]
    assert written.state == 1 and written.n_kf >= 2
    path = str(tmp_path / f"{src}.npz")
    written.save_map(path)
    cfg = mono_maps["cfg"]
    loaded = JaxSlam(to_jax_config(cfg)) if dst == "jax" else TorchSlam(cfg, device="cpu")
    loaded.load_map(path)
    assert_loaded(written, loaded)
    t_next = 5 / MONO["fps"]
    same = TorchSlam(cfg, device="cpu") if dst == "jax" else JaxSlam(to_jax_config(cfg))
    same.load_map(path)
    for system in (loaded, same):
        system.track_mono(mono_maps["next"], t_next)
        system.flush_decisions()
    d_centre, d_rot = chip_smoke.trajectory_diff(loaded.trajectory_arrays(), same.trajectory_arrays())
    assert d_centre.max() <= 2e-3 and d_rot.max() <= 1e-3


@pytest.mark.parametrize("sensor", ["MONOCULAR", "STEREO"])
def test_merge_gate_on_monocular_maps(mono_maps, sensor):
    """The Atlas merge gate lets a monocular map's merge through (its scale
    drifts, so the prior bounds nothing) and, on the same map read as a
    stereo one, refuses a transform 86 degrees and 5 m from the prior; in
    both packages."""
    shelf = {"merge_prior": (np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 0.0, 0.0)}
    R_d = np.asarray(jlie.so3_exp(jnp.array([0.0, 1.5, 0.0])))
    t_d = np.array([5.0, 0.0, 0.0], np.float32)
    got = []
    for pkg, gate, to in (("jax", jmm._merge_gate_allows, jnp.asarray), ("port", tmm._merge_gate_allows, T)):
        system = mono_maps[pkg]
        cfg = system.cfg
        system.cfg = dataclasses.replace(cfg, sensor=getattr(SensorType, sensor))
        try:
            got.append(bool(gate(system, shelf, to(R_d), to(t_d))))
        finally:
            system.cfg = cfg
    assert got == [sensor == "MONOCULAR"] * 2
