"""The port's Kannala-Brandt (KB8) camera, its fisheye render, the
monocular KB8 path, loop verification on KB8 and the stereo matcher's
branch without left patches, against the JAX reference on the CPU (the
stereo-fisheye rig: ``tests/test_torch_fisheye.py``).

One module fixture runs both packages' monocular KB8 systems
(``chip_smoke.sensor_config("mono", small=True)``, the camera of
``tests/test_fisheye.py:44-60``) over 20 strafe frames (0.05 m/frame) on
the same numpy images, the reference's first, and then both packages'
sides of the module-level tests. The two-view initialization's
10-iteration BA leaves the map's scale undamped once LM's lambda has
fallen (ROADMAP F24): on this scene the
reference's own result moves with the order of float additions (median
point depth 2.35-4.97 at one cost between CPU thread counts in the port,
and a map whose scale band no longer holds its points loses track). So the
port resumes from the reference's checkpoint right after the initializing
frame and is handed the reference's extracted frames (its batch-of-one
program rounds keypoints by 1 ulp against the port's, ROADMAP F15); the
initialization itself is held on the reference's captured
``reconstruct_two_views_hf`` calls.

Tolerances: KB8 project and unproject within 1e-6 relative, its Jacobian
within 1e-5 relative (zero on the optical axis, as the reference's);
``render``: unit rays within 1e-6 at every pixel, and every pixel's depth
and image within what a ray moved by that much can change
(``test_kb8_render``: the conditioning of tan theta past pi/2, the hit
plane's incidence and the texture's slope); the run's keyframe frames
after the resume exactly, camera centres (in the map's gauge) within 2e-3
m and rotations within 1e-3 rad per frame; the two-view initialization on
KB8 rays: verdict, point count and inliers exactly, motion within 1e-4;
``sim3_ransac_reproj`` with KB8: the inliers exactly and both warps within
the reference test's bounds of the drift (a degenerate sample wins in the
port, ROADMAP F25); the stereo matcher without left patches exactly
(matches) and within 1e-4 (right u, depth).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_fisheye import KB8, SMALL_KB8, J, T, close, npy, run
from test_torch_system import to_jax_config
from orb_slam3_detailed_comments_kor_tpu.io import synthetic as jsyn
from orb_slam3_detailed_comments_kor_tpu.models import camera as jcam
from orb_slam3_detailed_comments_kor_tpu.ops import orb as jorb
from orb_slam3_detailed_comments_kor_tpu.ops import pyramid as jpyr
from orb_slam3_detailed_comments_kor_tpu.ops import ransac as jr
from orb_slam3_detailed_comments_kor_tpu.ops import stereo as jst
from orb_slam3_detailed_comments_kor_tpu.ops import twoview as jtv
from orb_slam3_detailed_comments_kor_tpu.slam import frontend as jfe
from orb_slam3_detailed_comments_kor_tpu.slam.system import SlamSystem as JaxSlam
from orb_slam3_detailed_comments_kor_tpu.utils import lie as jlie
from orb_slam3_detailed_comments_kor_tpu_torch.io import synthetic as tsyn
from orb_slam3_detailed_comments_kor_tpu_torch.models import camera as tcam
from orb_slam3_detailed_comments_kor_tpu_torch.ops import orb as torb
from orb_slam3_detailed_comments_kor_tpu_torch.ops import ransac as tr
from orb_slam3_detailed_comments_kor_tpu_torch.ops import stereo as tst
from orb_slam3_detailed_comments_kor_tpu_torch.ops import twoview as ttv
from orb_slam3_detailed_comments_kor_tpu_torch.slam import frontend as tfe
from orb_slam3_detailed_comments_kor_tpu_torch.slam.system import SlamSystem as TorchSlam
from orb_slam3_detailed_comments_kor_tpu_torch.utils import prng

MONO = dict(frames=20, speed=0.05)
TUMVI_KB8 = np.array(chip_smoke.KB8_TUMVI, np.float32)


def port_run(cfg, imgs, init_path, start):
    """The port's run: it resumes from the reference's checkpoint right
    after the initializing frame (``init_path``; ``start`` is the next
    frame) and runs the rest of the images on the reference's extracted
    frames."""
    orb = cfg.orb
    frames = {img.__array_interface__["data"][0]: tfe.frame_from_numpy(npy(jfe.process_mono(
        J(img), n_features=orb.n_features, n_levels=orb.n_levels, scale=orb.scale_factor, cell=orb.cell_size)),
        "cpu") for img in imgs}
    saved_fe = tfe.process_mono

    def reference_frame(img, **kw):
        f = frames.get(img.data_ptr())
        return saved_fe(img, **kw) if f is None else f
    tfe.process_mono = reference_frame
    try:
        system = TorchSlam(cfg, device="cpu")
        system.load_map(init_path)
        return dict(run(system, imgs, "mono", first=start), start=start)
    finally:
        tfe.process_mono = saved_fe


@pytest.fixture(scope="module")
def kb8(tmp_path_factory):
    cfg = chip_smoke.sensor_config("mono", small=True)
    _, mo, _ = chip_smoke.render_sensor_sequence("mono", cfg, MONO["frames"], "cpu", speed=MONO["speed"])
    mo = [m.numpy() for m in mo]
    init_path = os.path.join(str(tmp_path_factory.mktemp("kb8")), "init.npz")
    captured, saved, init_at = [], jtv.reconstruct_two_views_hf, []

    def capture(*a, **k):
        args = (npy(a), npy(k))
        out = saved(*a, **k)
        captured.append(args + (npy(out),))
        return out

    def saver(i, system):
        if system.state == 1 and not init_at:
            system.save_map(init_path)
            init_at.append(i)

    jtv.reconstruct_two_views_hf = capture
    saved_devices = jax.devices
    jax.devices = lambda *a: saved_devices(*a)[:1]  # the reference's one-device branches
    try:
        j_m = run(JaxSlam(to_jax_config(cfg)), mo, "mono", saver)
    finally:
        jtv.reconstruct_two_views_hf = saved
        jax.devices = saved_devices
    return dict(j_m=j_m, t_m=port_run(cfg, mo, init_path, init_at[0] + 1), t_sim3=port_sim3(),
                refs={name: npy(f()) for name, f in REFS.items()}, captured=captured)


# ---------------------------------------------------------------------------
# the KB8 camera
# ---------------------------------------------------------------------------

def rand_points(seed, n=256):
    x = np.random.default_rng(seed).uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    x[:, 2] = np.abs(x[:, 2]) * 4 + 0.5
    return x


@pytest.mark.parametrize("params", [SMALL_KB8, TUMVI_KB8], ids=["test_fisheye", "tum_vi"])
def test_kb8_project_unproject(params):
    """Projection of points in front of the camera and unprojection of
    their pixels (theta up to ~1.2 rad) within 1e-6 relative."""
    xyz = rand_points(1)
    xyz[:3, :2] = 0.0  # on the optical axis
    uv_j = np.asarray(jcam.kb8_project(J(params), J(xyz)))
    uv_t = tcam.kb8_project(T(params), T(xyz))
    close(uv_j, uv_t, 0.0, 1e-6)
    ray_j = np.asarray(jcam.kb8_unproject(J(params), J(uv_j)))
    ray_t = tcam.kb8_unproject(T(params), T(uv_j))
    np.testing.assert_allclose(ray_t.numpy(), ray_j, rtol=1e-6, atol=1e-6)
    close(xyz, ray_t * T(xyz[:, 2:3]), 1e-3, 1e-3)  # the round trip


@pytest.mark.parametrize("params", [SMALL_KB8, TUMVI_KB8], ids=["test_fisheye", "tum_vi"])
def test_kb8_jacobian(params):
    """The analytic Jacobian against the reference's forward-mode one,
    points on the optical axis included (both zero there)."""
    xyz = rand_points(2)
    xyz[:4, :2] = 0.0
    xyz[4, :2] = (1e-5, -2e-5)
    Jj = np.asarray(jcam.kb8_project_jac(J(params), J(xyz)))
    Jt = tcam.kb8_project_jac(T(params), T(xyz)).numpy()
    assert (Jj[:4] == 0).all() and (Jt[:4] == 0).all()
    scale = np.abs(Jj).max(axis=(1, 2), keepdims=True) + 1e-30
    assert (np.abs(Jt - Jj) / scale).max() <= 1e-5
    close(np.asarray(jcam.project_jac(J(params), J(xyz), KB8)), tcam.project_jac(T(params), T(xyz), KB8), 1e-3)


RENDER_POSE = (np.array([0.02, -0.03, 0.01], np.float32), np.array([0.1, -0.05, 0.2], np.float32))
RENDERS = {"test_fisheye": (SMALL_KB8, 256), "tum_vi": (TUMVI_KB8, 512)}


def ref_render(name):
    params, hw = RENDERS[name]
    R = jlie.so3_exp(J(RENDER_POSE[0]))
    vv, uu = np.mgrid[0:hw, 0:hw]
    uv = np.stack([uu + 0.5, vv + 0.5], -1).astype(np.float32).reshape(-1, 2)
    img, depth = jsyn.render(J(params), R, J(RENDER_POSE[1]), jsyn.default_scene(), h=hw, w=hw, model=KB8)
    return npy((img, depth, R, jcam.kb8_unproject(J(params), J(uv))))


RAY_TOL = 1e-6  # the unit rays of the two packages, every pixel


@pytest.mark.parametrize("name", sorted(RENDERS))
def test_kb8_render(kb8, name):
    """The synthetic fisheye render, every pixel, flipped rays past
    theta = pi/2 in the corners included, as the reference renders it.

    The rays agree within RAY_TOL as unit vectors (their sign past pi/2
    included), not bit for bit, so each pixel is held to what a unit ray
    moved by RAY_TOL can change, from the reference's own geometry (float64
    numpy): the depth along the unit-depth ray, ``tan(theta)``'s
    conditioning |ray| = 1/|cos theta| and the hit plane's incidence
    1/|n.u|, within depth x RAY_TOL x (1 + |ray| + 1/|n.u|); the image
    within 1e-4 plus the texture's Lipschitz bound times the hit point's
    move (the ray's, and float32 rounding of the point and of the texture
    coordinates), plus the blocky term's jump where its cell edge lies
    within that move. Pixels whose s = 0.05 near-plane cut falls within the
    ray's error may hit another plane: their depth is one plane's."""
    params, hw = RENDERS[name]
    img_j, dep_j, R, ray_j = kb8["refs"][f"render_{name}"]
    img_t, dep_t = tsyn.render(T(params), T(R), T(RENDER_POSE[1]), tsyn.default_scene("cpu"), h=hw, w=hw, model=KB8)
    img_j, dep_j, img_t, dep_t = (np.asarray(x, np.float64).reshape(-1) for x in (img_j, dep_j, img_t, dep_t))
    vv, uu = np.mgrid[0:hw, 0:hw]
    uv = np.stack([uu + 0.5, vv + 0.5], -1).astype(np.float32).reshape(-1, 2)
    ray_t = tcam.kb8_unproject(T(params), T(uv)).numpy().astype(np.float64)
    ray_j = ray_j.astype(np.float64)
    norm = np.linalg.norm(ray_j, axis=1)
    unit_j, unit_t = ray_j / norm[:, None], ray_t / np.linalg.norm(ray_t, axis=1)[:, None]
    np.testing.assert_allclose(unit_t, unit_j, rtol=0, atol=RAY_TOL)
    assert (norm > 50).sum() > 100 and (np.einsum("ij,ij->i", ray_j[:, :2], uv - params[2:4]) < 0).sum() > 4000
    scene = jsyn.default_scene()
    normals, ds, u_ax, v_ax, offsets = (np.asarray(x, np.float64) for x in scene)
    t = RENDER_POSE[1].astype(np.float64)
    ray_w = ray_j @ np.asarray(R, np.float64).T
    n_dot = ray_w @ normals.T
    s_all = (ds - normals @ t)[None] / np.where(np.abs(n_dot) < 1e-6, 1e-6, n_dot)
    at_cut = (np.abs(s_all - 0.05) < 0.05 * RAY_TOL * (2 + norm)[:, None]).any(1)
    s_hit = np.where(s_all > 0.05, s_all, np.inf)
    plane, s = s_hit.argmin(1), s_hit.min(1)
    hit = dep_j > 0
    np.testing.assert_array_equal(dep_t > 0, hit)
    incidence = np.abs(n_dot[np.arange(len(plane)), plane]) / norm
    dep_tol = dep_j * RAY_TOL * (1 + norm + 1 / incidence)
    held = hit & ~at_cut
    assert (np.abs(dep_t - dep_j) <= dep_tol)[held].all()
    assert at_cut.sum() <= 4
    for i in np.flatnonzero(hit & at_cut):  # one plane's depth
        assert (np.abs(s_all[i] - dep_t[i]) <= 2 * dep_tol[i]).any(), i
    point = t[None] + s[:, None] * ray_w
    moved = (s * norm * RAY_TOL * (1 + 1 / incidence)
             + 2.0 ** -21 * (np.abs(point).max(1) + np.abs(offsets[plane]).max(1)))
    tu = (point * u_ax[plane]).sum(1) + offsets[plane, 0]
    tv = (point * v_ax[plane]).sum(1) + offsets[plane, 1]
    to_edge = lambda x: np.abs(x - np.round(x))
    blocky_edge = (to_edge(4.0 * tu) < 4.0 * moved) | (to_edge(4.0 * tv) < 4.0 * moved)
    # synthetic.texture: 255 (0.55 blocky(4x) + 0.25 bilinear(29.2x) + 0.20 bilinear(1.48x))
    img_tol = 1e-4 + 255.0 * (0.25 * 29.2 + 0.20 * 1.48) * 2.0 * moved + np.where(blocky_edge, 255.0 * 0.55, 0.0)
    assert (np.abs(img_t - img_j) <= img_tol)[held].all()
    assert (img_t == 0)[~hit].all() and (img_j == 0)[~hit].all()
    assert blocky_edge[held].mean() < 0.01


# ---------------------------------------------------------------------------
# loop verification on KB8 and the stereo matcher without left patches
# ---------------------------------------------------------------------------

SIM3_DRIFT = (np.array([0.0, 0.04, 0.0], np.float32), np.array([0.3, -0.1, 0.05], np.float32))


def sim3_problem():
    """The loop-verification scenario of test_fisheye_rig.py:176: the
    arguments of ``sim3_ransac_reproj`` (numpy) and the drift R_d."""
    rng = np.random.default_rng(3)
    m = 128
    X_true = rng.uniform([-2, -2, 2.5], [2, 2, 6.0], (m, 3)).astype(np.float32)
    R_d = np.asarray(jlie.so3_exp(J(SIM3_DRIFT[0])))
    X_drift = ((X_true - SIM3_DRIFT[1]) @ R_d).astype(np.float32)
    Ra, ta = np.eye(3, dtype=np.float32), np.array([0.0, 0.0, 0.5], np.float32)
    Rb, tb = np.asarray(jlie.so3_exp(jnp.array([0.02, -0.01, 0.0]))), np.zeros(3, np.float32)
    uv_a = np.asarray(jcam.kb8_project(J(SMALL_KB8), J(X_drift @ Ra.T + ta)))
    uv_b = np.asarray(jcam.kb8_project(J(SMALL_KB8), J(X_true @ Rb.T + tb)))
    out = rng.random(m) < 0.2
    uv_b = np.where(out[:, None], uv_b + rng.normal(0, 40, (m, 2)).astype(np.float32), uv_b).astype(np.float32)
    s2 = np.ones(m, np.float32)
    return [X_drift, X_true, uv_a, uv_b, s2, s2, (Ra, ta), (Rb, tb), SMALL_KB8, np.ones(m, bool)], R_d


def conv(args, f):
    return [tuple(f(x) for x in a) if isinstance(a, tuple) else f(a) for a in args]


def sim3_key():
    """The reference's key for the draw, split as the system splits it, and
    its drawn sample indices."""
    args, _ = sim3_problem()
    m = args[0].shape[0]
    _, sj = jax.random.split(jnp.asarray(np.frombuffer(b"loopseed", dtype=np.uint32)[:2]))
    return sj, np.asarray(jax.random.choice(sj, m, shape=(192, 3), p=jnp.full((m,), 1.0 / m, jnp.float32)))


def ref_sim3():
    args, _ = sim3_problem()
    return npy(jr.sim3_ransac_reproj(*conv(args, J), sim3_key()[0], n_hyp=192, fix_scale=True, cam_model=KB8))


def port_sim3():
    """The port's side: its own draw from the same key, and the draw handed
    the reference's indices."""
    args, _ = sim3_problem()
    key = prng.split(prng.key_from_bytes(b"loopseed", "cpu"))[1]
    got = tr.sim3_ransac_reproj(*conv(args, T), key, n_hyp=192, fix_scale=True, cam_model=KB8)
    by_idx = tr.sim3_ransac_reproj(*conv(args, T), None, n_hyp=192, fix_scale=True, cam_model=KB8,
                                   idx=T(sim3_key()[1]))
    return npy(got._asdict()), npy(by_idx._asdict())


def test_sim3_ransac_reproj_kb8(kb8):
    """Loop verification's pixel gate on KB8 (test_fisheye_rig.py:176), the
    reference's key split as the system splits it: the final inlier set
    exactly, and both warps at the drift (the reference test's bounds).
    The two warps differ by ~6e-3: the draw includes the degenerate sample
    [67, 82, 82] (samples are drawn with replacement), whose Horn rotation
    about the line through its two points is arbitrary; the reference's
    float32 LAPACK picks a member of that family that scores 7 inliers, the
    port's float64 Jacobi one that scores 100 (with one outlier 1.6 px
    inside the selection gate), and that hypothesis wins (ROADMAP F25)."""
    args, R_d = sim3_problem()
    ref = kb8["refs"]["sim3"]
    got, by_idx = kb8["t_sim3"]  # the port's side, computed in the fixture
    np.testing.assert_array_equal(got["inliers"], ref["inliers"])
    assert int(got["n_inliers"]) == int(ref["n_inliers"]) > 0.6 * args[0].shape[0]
    for R, t in ((ref["R"], ref["t"]), (got["R"], got["t"])):
        assert np.linalg.norm(t - SIM3_DRIFT[1]) < 0.02
        assert np.linalg.norm(np.asarray(jlie.so3_log(J(R @ R_d.T)))) < 0.01
    # the port's draws are the reference's: handed the reference's drawn
    # indices, it returns the same
    np.testing.assert_array_equal(by_idx["inliers"], got["inliers"])
    close(got["t"], by_idx["t"], 0.0)


def stereo_images():
    cfg = chip_smoke.loop_config(small=True)
    _, frames = chip_smoke.render_loop_sequence(cfg, 1, "cpu")
    return cfg, [x.numpy() for x in frames[0]]


def ref_stereo_matches():
    cfg, (il, ir) = stereo_images()
    c = cfg.camera
    kw = dict(n_features=cfg.orb.n_features, n_levels=8, scale=1.2, cell=cfg.orb.cell_size)
    feats, stack, _ = jorb.extract_orb_batch(jnp.stack([J(il), J(ir)]), return_stack=True, **kw)
    view = [jax.tree.map(lambda a: a[i], feats) for i in (0, 1)]
    hw = jpyr.level_shapes(c.height, c.width, 8, 1.2)
    return npy(jst.compute_stereo_matches(view[0], view[1], stack[0], stack[1], c.bf, 1.2, level_hw=hw))


def test_stereo_matches_without_left_patches(kb8):
    """``ops/stereo``'s branch that cuts both windows from the atlases."""
    cfg, (il, ir) = stereo_images()
    c = cfg.camera
    kw = dict(n_features=cfg.orb.n_features, n_levels=8, scale=1.2, cell=cfg.orb.cell_size)
    feats, stack, _ = torb.extract_orb_batch(torch.stack([T(il), T(ir)]), return_stack=True, **kw)
    view = [torb.Features(*(a[i] for a in feats)) for i in (0, 1)]
    hw = jpyr.level_shapes(c.height, c.width, 8, 1.2)
    ref = kb8["refs"]["stereo_matches"]
    got = tst.compute_stereo_matches(view[0], view[1], stack[0], stack[1], c.bf, 1.2, level_hw=hw)
    np.testing.assert_array_equal(got.valid.numpy(), ref["valid"])
    assert int(got.valid.sum()) > 200
    close(ref["u_right"], got.u_right, 1e-4)
    close(ref["depth"], got.depth, 1e-4, 1e-4)


# the reference computations of the tests above, run in the module
# fixture
REFS = dict(**{f"render_{n}": (lambda n=n: ref_render(n)) for n in RENDERS}, sim3=ref_sim3,
            stereo_matches=ref_stereo_matches)


# ---------------------------------------------------------------------------
# the monocular KB8 run
# ---------------------------------------------------------------------------

def test_mono_kb8_run(kb8):
    """The port resumes from the reference's map right after the
    two-view initialization; keyframes after it exactly, per-frame centres
    in the map's gauge within 2e-3 and rotations within 1e-3 rad."""
    j, t = kb8["j_m"], kb8["t_m"]
    start = t["start"]
    assert start >= 2 and t["state"] == j["state"] == 1
    assert t["kf_at"] == [k for k in j["kf_at"] if k >= start] and len(t["kf_at"]) >= 2
    n = MONO["frames"] - start
    tj = tuple(a[-n:] for a in j["traj"])
    tt_ = tuple(a[-n:] for a in t["traj"])
    d_centre, d_rot = chip_smoke.trajectory_diff(tj, tt_)
    assert d_centre.max() <= 2e-3, np.round(d_centre * 1e3, 3).tolist()
    assert d_rot.max() <= 1e-3


def test_mono_kb8_initialization_captured(kb8):
    """The two-view reconstruction on the reference's KB8 rays."""
    calls = kb8["captured"]
    assert any(c[2]["ok"] for c in calls)
    for (ra, rb, valid, key), kw, ref in calls:
        got = ttv.reconstruct_two_views_hf(T(ra), T(rb), T(valid), T(key.astype(np.int64)), **kw)
        assert bool(got.ok) == bool(ref["ok"]) and int(got.n_good) == int(ref["n_good"])
        np.testing.assert_array_equal(got.inlier.numpy(), ref["inlier"])
        if ref["ok"]:
            close(ref["R_ba"], got.R_ba, 1e-4)
            close(ref["t_ba"], got.t_ba, 1e-4)
