"""The port's stereo tracking step end to end against the JAX reference on
the CPU, at the small setup of ``__graft_entry__`` (240x376, 600 features,
4096 landmarks).

JAX builds the map from frame 0 (its stereo front end + make_keyframe);
both packages then track the same three rendered strafe frames
(0.03 m/frame) with ``full_frame_step``, each from that map and the same
pose.

Tolerances per frame: rotation <= 1e-3 rad, translation <= 2e-3 m,
|n_inliers difference| <= max(3, 2% of JAX's), equal ``ok``. The pose
solve sums in another order than XLA and accept/reject decisions of the
62 LM iterations can flip on near-equal costs, so poses are not bitwise
equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from orb_slam3_detailed_comments_kor_tpu.io import synthetic as jsyn
from orb_slam3_detailed_comments_kor_tpu.models import camera as jcam
from orb_slam3_detailed_comments_kor_tpu.ops import orb as jorb
from orb_slam3_detailed_comments_kor_tpu.slam import map_state as jms
from orb_slam3_detailed_comments_kor_tpu.slam import tracking as jtr
from orb_slam3_detailed_comments_kor_tpu_torch.io import synthetic as tsyn
from orb_slam3_detailed_comments_kor_tpu_torch.slam import frontend as tfe
from orb_slam3_detailed_comments_kor_tpu_torch.slam import map_state as tms
from orb_slam3_detailed_comments_kor_tpu_torch.slam import tracking as ttr
from orb_slam3_detailed_comments_kor_tpu_torch.utils import lie as tlie

N_TRACKED = 3
SPEED = 0.03


@pytest.fixture(scope="module")
def slice_run():
    cfg, H, W = graft._small_setup()
    cam = cfg.camera
    params = np.array([cam.fx, cam.fy, cam.cx, cam.cy], np.float32)
    cam_params = jcam.camera_params_from_config(cam)
    kw = dict(n_features=cfg.orb.n_features, cell=cfg.orb.cell_size)
    scene = jsyn.default_scene()
    Rs, ts = jsyn.make_trajectory(N_TRACKED + 1, "strafe", speed=SPEED)
    imgs = []
    for i in range(N_TRACKED + 1):
        il, ir, _ = jsyn.stereo_pair(
            jnp.asarray(params), jnp.asarray(Rs[i]), jnp.asarray(ts[i]), 0.11, scene, h=H, w=W
        )
        imgs.append((np.array(il), np.array(ir)))

    def step(ms, il, ir, state):
        return jtr.full_frame_step(
            ms, jnp.asarray(il), jnp.asarray(ir), *state, cam_params, bf=cam.bf,
            w=W, h=H, min_inliers=30, **kw,
        )

    # frame 0's features come out of the same compiled step (run on an
    # empty map, where it finds nothing to track): one XLA compile, not two
    n_feat = sum(jorb.level_budgets(cfg.orb.n_features, cfg.orb.n_levels, cfg.orb.scale_factor))
    shape = (cfg.capacity.max_keyframes, n_feat, cfg.capacity.max_landmarks)
    state = (jnp.eye(3), jnp.zeros(3), jnp.eye(3), jnp.zeros(3), jnp.bool_(False))
    frame0 = step(jms.empty_map(*shape), *imgs[0], state)[1]
    ms = jtr.make_keyframe(
        jms.empty_map(*shape), frame0, jnp.eye(3), jnp.zeros(3), jnp.float32(0.0), jnp.int32(0),
        -jnp.ones((shape[2],), jnp.int32), cam_params, float("inf"),
    )
    # copy out BEFORE full_frame_step, which donates its map argument
    ms0 = {k: np.array(v) for k, v in ms._asdict().items()}
    frame0_np = {k: (None if v is None else np.array(v)) for k, v in frame0._asdict().items()}

    jax_steps = []
    for il, ir in imgs[1:]:
        out = step(ms, il, ir, state)
        ms = out[0]
        state = (out[3], out[4], out[5], out[6], jnp.bool_(True))
        jax_steps.append((np.array(out[3]), np.array(out[4]), int(out[2].n_inliers), bool(out[7])))

    tmap = tms.map_state_from_numpy(ms0, "cpu")
    tcam = torch.from_numpy(np.array(cam_params))
    tstate = (torch.eye(3), torch.zeros(3), torch.eye(3), torch.zeros(3), torch.tensor(False))
    port_steps = []
    for il, ir in imgs[1:]:
        out = ttr.full_frame_step(
            tmap, torch.from_numpy(il), torch.from_numpy(ir), *tstate, tcam, cam.bf,
            W, H, min_inliers=30, **kw,
        )
        tmap = out[0]
        tstate = (out[3], out[4], out[5], out[6], torch.tensor(True))
        port_steps.append((out[3], out[4], int(out[2].n_inliers), bool(out[7])))
    return dict(cfg=cfg, H=H, W=W, params=params, imgs=imgs, Rs=Rs, ts=ts, ms0=ms0,
                frame0=frame0_np, jax_steps=jax_steps, port_steps=port_steps)


@pytest.mark.parametrize("i", range(N_TRACKED))
def test_tracked_frame_agrees(slice_run, i):
    Rj, tj, nj, okj = slice_run["jax_steps"][i]
    Rt, tt, nt, okt = slice_run["port_steps"][i]
    assert okj and okt == okj
    d_rot = float(torch.linalg.vector_norm(tlie.so3_log(torch.from_numpy(Rj.T) @ Rt)))
    assert d_rot <= 1e-3
    assert np.abs(tj - tt.numpy()).max() <= 2e-3
    assert abs(nj - nt) <= max(3, 0.02 * nj)


def test_map_state_round_trip(slice_run):
    ms0 = slice_run["ms0"]
    back = tms.map_state_to_numpy(tms.map_state_from_numpy(ms0, "cpu"))
    assert back.keys() == ms0.keys()
    for k, v in ms0.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k


def test_make_keyframe_agrees(slice_run):
    """The port's make_keyframe on JAX's frame 0 builds JAX's map."""
    cfg, ms0 = slice_run["cfg"], slice_run["ms0"]
    frame = tfe.frame_from_numpy(slice_run["frame0"], "cpu")
    assert tfe.frame_to_numpy(frame)["desc_packed"].dtype == np.uint32
    ms = tms.empty_map(cfg.capacity.max_keyframes, frame.n, cfg.capacity.max_landmarks,
                       device="cpu")
    ms = ttr.make_keyframe(
        ms, frame, torch.eye(3), torch.zeros(3), 0.0, 0,
        torch.full((ms.L,), -1, dtype=torch.int32),
        torch.from_numpy(slice_run["params"]), float("inf"),
    )
    got = tms.map_state_to_numpy(ms)
    assert ms0["lm_valid"].sum() > 300
    for k, v in ms0.items():
        if v.dtype.kind == "f":
            np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-6, err_msg=k)
        else:
            assert np.array_equal(got[k], v), k


def test_port_renderer_matches(slice_run):
    """io/synthetic: the port renders the reference's frames (texture
    lookups can round across a lattice cell edge on a few pixels)."""
    H, W, params = slice_run["H"], slice_run["W"], slice_run["params"]
    il, ir, _ = tsyn.stereo_pair(
        torch.from_numpy(params), torch.from_numpy(slice_run["Rs"][1]),
        torch.from_numpy(slice_run["ts"][1]), 0.11, tsyn.default_scene("cpu"), h=H, w=W,
    )
    for got, ref in ((il, slice_run["imgs"][1][0]), (ir, slice_run["imgs"][1][1])):
        diff = np.abs(got.numpy() - ref)
        assert (diff <= 1e-2).mean() >= 0.999
        assert diff.mean() <= 0.05
