"""The slice as a whole: the port's ``examples/run_dataset.py`` against the
JAX package's ``examples/run_dataset.py`` on the same recorded sequence.

One small stereo-inertial sequence (``chip_smoke.si_config(small=True)``'s
240x376 / 600-feature pinhole pair on ``synthetic.AnalyticTrajectory`` at
20 fps with its 200 Hz samples, 14 frames) is written once in the EuRoC MAV
layout by ``chip_smoke.write_euroc_sequence``: 8-bit PNGs, ``imu0/
data.csv``, the ground truth and a settings YAML in the reference's format
with rectification blocks, with absolute EuRoC-like stamps (ROADMAP F29).
Both runners read the same PNGs through their native decoders (the
reference's libpng build, the port's zlib-only one, bit-equal on these
files) and rectify them with the same maps, so they get the same float
images; both
build their configuration from the settings file (the capacity and
tracking defaults). The reference's runner runs first, with one JAX
device and every deferred read counted as ready once computed, so that
every deferred decision read is ready at its first chance, as the port's
CPU reads are (F16); then the port's, with ``device="cpu"``.
The port's runner also runs once in ``rgbd`` mode on a TUM RGB-D layout
of RGBD_FRAMES strafe frames (8-bit images, 16-bit depth maps at 5000 per
metre, absolute TUM stamps).

Tolerances: the same trajectory rows and stamps, the same keyframe frames
and final state; camera centres within 2e-3 m and rotations within 1e-3
rad per frame; the written trajectory files agree within their 7 printed
decimals plus those tolerances; the RGB-D run's ATE below the reference's
own runner test's bound, 0.05 m (``tests/test_run_dataset.py``).
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke

SMALL = chip_smoke.SMALL_EUROC
TUM_T0, RGBD_FRAMES = 1305031102.175304, 8


def _summary(rec, out_path):
    slam = rec["slam"]
    slam.flush_decisions()
    ts, centers, R_wc = slam.trajectory_arrays()
    return dict(kf_at=rec["kf_at"], state=int(slam.state), n_kf=slam.n_kf, times=np.asarray(ts),
                centers=np.asarray(centers), R_wc=np.asarray(R_wc),
                rows=np.loadtxt(out_path, delimiter=",", ndmin=2))


def jax_runner(argv, out_path):
    """The JAX package's runner with one device and every deferred read
    counted as ready once computed (under load a batched decision read was
    otherwise found not ready at its first chance, so the reference's
    keyframes came a frame late; tools/jax_sensor_ref.py's
    ``first_chance_reads``)."""
    import jax
    from jax._src import array as jarray

    from examples import run_dataset
    from orb_slam3_detailed_comments_kor_tpu.slam import system as jsys

    saved_ready, saved_devices = jarray.ArrayImpl.is_ready, jax.devices
    jarray.ArrayImpl.is_ready = lambda self: self.block_until_ready() is not None
    jax.devices = lambda *a: saved_devices(*a)[:1]
    try:
        with chip_smoke.keyframes_recorded(jsys.SlamSystem, "track_stereo", {}) as rec:
            run_dataset.main(argv + ["--out", out_path])
        return _summary(rec, out_path)
    finally:
        jarray.ArrayImpl.is_ready, jax.devices = saved_ready, saved_devices


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from orb_slam3_detailed_comments_kor_tpu_torch.examples import run_dataset
    from orb_slam3_detailed_comments_kor_tpu_torch.slam import system as tsys

    root = str(tmp_path_factory.mktemp("run_dataset"))
    seq, settings, gt_path, _ = chip_smoke.small_euroc_sequence(os.path.join(root, "euroc"))
    argv = ["--mode", "stereo", "--dataset", "euroc", "--seq", seq, "--settings", settings, "--gt", gt_path]
    jax_out = jax_runner(argv, os.path.join(root, "jax_traj.csv"))
    out_path = os.path.join(root, "port_traj.csv")
    with chip_smoke.keyframes_recorded(tsys.SlamSystem, "track_stereo", {}) as rec:
        res = run_dataset.main(argv + ["--out", out_path], device="cpu")
    port = _summary(rec, out_path)
    port.update(decoder=res["decoder"], ate_m=res["ate_m"], device=res["slam"].device.type,
                **{k: res[k] for k in ("frame_ms", "feed_ms", "track_ms")})
    return port, jax_out, rgbd_run(root)


def rgbd_run(root):
    """The port's runner in ``rgbd`` mode on a TUM RGB-D layout: the left
    camera's images and rendered depth (16-bit PNG, 5000 per metre) at
    absolute TUM stamps, and a TUM ground-truth file. Returns the runner's
    summary without the system, and the trajectory file's rows."""
    from orb_slam3_detailed_comments_kor_tpu_torch.examples import run_dataset
    from orb_slam3_detailed_comments_kor_tpu_torch.io import synthetic
    from orb_slam3_detailed_comments_kor_tpu_torch.io import trajectory as traj_io
    from orb_slam3_detailed_comments_kor_tpu_torch.models import camera as cam_mod

    cfg = chip_smoke.si_config(small=True)
    tum = os.path.join(root, "tum")
    os.makedirs(os.path.join(tum, "rgb"))
    os.makedirs(os.path.join(tum, "depth"))
    cam = cam_mod.camera_params_from_config(cfg.camera, device="cpu")
    scene = synthetic.default_scene("cpu")
    Rs, ts = synthetic.make_trajectory(RGBD_FRAMES, motion="strafe", speed=0.03)
    rgb, dep, gt = ["# color images"], ["# depth maps"], ["# timestamp tx ty tz qx qy qz qw"]
    q = traj_io._quats_wxyz(Rs.astype(np.float64))
    for i in range(RGBD_FRAMES):
        t = TUM_T0 + i / SMALL["fps"]
        img, depth = synthetic.render(cam, torch.from_numpy(Rs[i]), torch.from_numpy(ts[i]), scene,
                                      h=cfg.camera.height, w=cfg.camera.width)
        chip_smoke.write_png_gray(os.path.join(tum, "rgb", f"{t:.6f}.png"), img.numpy())
        chip_smoke.write_png_gray(os.path.join(tum, "depth", f"{t:.6f}.png"),
                                  np.where(depth.numpy() > 0, depth.numpy() * 5000.0, 0.0), bits=16)
        rgb.append(f"{t:.6f} rgb/{t:.6f}.png")
        dep.append(f"{t:.6f} depth/{t:.6f}.png")
        gt.append(f"{t:.6f} " + " ".join(f"{v:.9f}" for v in (*ts[i], *q[i, 1:], q[i, 0])))
    for name, lines in (("rgb.txt", rgb), ("depth.txt", dep), ("groundtruth.txt", gt)):
        with open(os.path.join(tum, name), "w") as f:
            f.write("\n".join(lines) + "\n")
    settings = os.path.join(tum, "settings.yaml")
    with open(settings, "w") as f:
        f.write(chip_smoke.euroc_settings(cfg))
    out = os.path.join(root, "rgbd_traj.txt")
    res = run_dataset.main(["--mode", "rgbd", "--dataset", "tum_rgbd", "--seq", tum, "--settings", settings,
                            "--out", out, "--gt", os.path.join(tum, "groundtruth.txt")], device="cpu")
    slam = res.pop("slam")
    return dict(res, rows=np.loadtxt(out, ndmin=2), state=int(slam.state), n_kf=slam.n_kf)


def test_runner_on_the_cpu(runs):
    """The port's runner ran where it was told, through the native
    decode-and-rectify feeder, and scored its ATE."""
    port, _, _ = runs
    assert port["device"] == "cpu" and port["decoder"] == "native"
    assert port["ate_m"] is not None and port["ate_m"] < 0.05
    _check_split(port, SMALL["frames"])


def _check_split(res, n):
    """Each frame's wall time is its feeder wait plus its track call."""
    frame, feed, track = (np.array(res[k]) for k in ("frame_ms", "feed_ms", "track_ms"))
    assert frame.shape == feed.shape == track.shape == (n,)
    assert (feed >= 0).all() and (track > 0).all()
    np.testing.assert_allclose(frame, feed + track, rtol=1e-9, atol=1e-6)


def test_same_frames_and_keyframes(runs):
    port, ref, _ = runs
    assert len(port["times"]) == len(ref["times"]) == SMALL["frames"]
    assert np.array_equal(port["times"], ref["times"])
    assert port["times"][0] > 1.4e9  # absolute EuRoC-like stamps
    assert port["kf_at"] == ref["kf_at"] and port["n_kf"] == ref["n_kf"] >= 2
    assert port["state"] == ref["state"] == 1


def test_trajectories_agree(runs):
    port, ref, _ = runs
    dc = np.linalg.norm(port["centers"] - ref["centers"], axis=1)
    dr = [float(chip_smoke.rotation_angle(torch.from_numpy(a.astype(np.float32)),
                                          torch.from_numpy(b.astype(np.float32))))
          for a, b in zip(port["R_wc"], ref["R_wc"])]
    assert dc.max() <= chip_smoke.TRANS_TOL, dc
    assert max(dr) <= chip_smoke.ROT_TOL, dr
    # the written files: the same stamps, poses within the tolerances
    pr, rr = port["rows"], ref["rows"]
    assert pr.shape == rr.shape == (SMALL["frames"], 8) and np.array_equal(pr[:, 0], rr[:, 0])
    assert np.abs(pr[:, 1:4] - rr[:, 1:4]).max() <= chip_smoke.TRANS_TOL + 1e-7


def test_rgbd_runner(runs):
    """The port's runner in RGB-D mode on a TUM RGB-D layout: every frame
    recorded, tracked, within the reference's runner test's ATE bound."""
    _, _, rgbd = runs
    assert rgbd["frames"] == RGBD_FRAMES == rgbd["rows"].shape[0] and rgbd["rows"].shape[1] == 8
    assert rgbd["state"] == 1 and rgbd["n_kf"] >= 1 and rgbd["decoder"] == "native"
    _check_split(rgbd, RGBD_FRAMES)
    assert rgbd["ate_m"] < 0.05, rgbd["ate_m"]
    assert abs(rgbd["rows"][0, 0] - TUM_T0) < 1e-5


def test_run_synthetic_on_the_cpu(tmp_path):
    """The port's synthetic runner renders on the system's device, tracks
    and writes its TUM trajectory where it is told."""
    from orb_slam3_detailed_comments_kor_tpu_torch.examples import run_synthetic

    out = tmp_path / "traj.txt"
    rmse = run_synthetic.main(3, "strafe", device="cpu", out=str(out))
    rows = np.loadtxt(out, ndmin=2)
    assert rows.shape == (3, 8) and rmse < 0.05
