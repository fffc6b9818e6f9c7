"""Run the SLAM engine on a recorded dataset sequence, on the card.

Port of the repository's ``examples/run_dataset.py``, the counterpart of
the reference's per-dataset example mains
(``Examples/Stereo-Inertial/stereo_inertial_euroc.cc:42-290``,
``Examples/Monocular/mono_tum.cc``, ``Examples/Stereo/stereo_kitti.cc``,
``Examples/RGB-D/rgbd_tum.cc``): load images (+IMU), rectify, feed the
system at sensor order, save the trajectory, optionally score ATE.

Usage:
  python -m orb_slam3_detailed_comments_kor_tpu_torch.examples.run_dataset \\
      --mode stereo_inertial --dataset euroc --seq /data/MH_01_easy \\
      --settings settings/EuRoC.yaml --timestamps ts/MH01.txt \\
      --out traj.csv --gt gt.csv

Modes: mono | stereo | rgbd | mono_inertial | stereo_inertial
Datasets: euroc (also TUM-VI's euroc-style layout) | tum_rgbd | kitti

The system runs on the card; a caller such as a test names another device
with ``main(argv, device="cpu")``. ``main`` returns a summary of the run,
with each frame's wall time split into the wait for its decoded (and
rectified) images, ``feed_ms``, and the track call, ``track_ms``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from orb_slam3_detailed_comments_kor_tpu_torch import config as cfgm  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu_torch.io import datasets as ds  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu_torch.io import trajectory as traj_io  # noqa: E402


MODE_TO_SENSOR = {
    "mono": cfgm.SensorType.MONOCULAR,
    "stereo": cfgm.SensorType.STEREO,
    "rgbd": cfgm.SensorType.RGBD,
    "mono_inertial": cfgm.SensorType.IMU_MONOCULAR,
    "stereo_inertial": cfgm.SensorType.IMU_STEREO,
}


def build_feeder(seq, settings, mode: str):
    """Prefetching decode(+rectify) pipeline via the native host runtime."""
    from orb_slam3_detailed_comments_kor_tpu_torch.io import native_host

    cam = settings.config.camera
    maps_l = maps_r = None
    if settings.rectify is not None and mode != "mono":
        r = settings.rectify
        maps_l = ds.undistort_rectify_map(
            r.k_l, r.d_l, r.r_l, r.p_l, r.width, r.height
        )
        maps_r = ds.undistort_rectify_map(
            r.k_r, r.d_r, r.r_r, r.p_r, r.width, r.height
        )
    lefts = [f.left for f in seq.frames]
    rights = None
    if mode.startswith("stereo") and seq.frames and seq.frames[0].right:
        rights = [f.right for f in seq.frames]
    return native_host.StereoFeeder(
        lefts, rights, cam.height, cam.width, maps_l=maps_l, maps_r=maps_r
    )


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", required=True, choices=sorted(MODE_TO_SENSOR))
    ap.add_argument("--dataset", required=True,
                    choices=["euroc", "tum_rgbd", "kitti"])
    ap.add_argument("--seq", required=True, help="sequence directory")
    ap.add_argument("--settings", required=True, help="settings YAML")
    ap.add_argument("--timestamps", default=None,
                    help="EuRoC timestamp list (optional)")
    ap.add_argument("--out", default="trajectory.txt")
    ap.add_argument("--format", default=None,
                    choices=[None, "tum", "euroc", "kitti"])
    ap.add_argument("--gt", default=None, help="ground-truth file for ATE")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--depth-factor", type=float, default=5000.0)
    args = ap.parse_args(argv)

    sensor = MODE_TO_SENSOR[args.mode]
    settings = ds.load_settings(args.settings, sensor)
    cfg = settings.config

    if args.dataset == "euroc":
        seq = ds.EurocSequence(args.seq, timestamps=args.timestamps)
    elif args.dataset == "tum_rgbd":
        seq = ds.TumRgbdSequence(args.seq, depth_factor=args.depth_factor)
    else:
        seq = ds.KittiSequence(args.seq)
    if args.max_frames:
        seq.frames = seq.frames[: args.max_frames]
    print(f"[run_dataset] {len(seq)} frames, mode={args.mode}", flush=True)

    from orb_slam3_detailed_comments_kor_tpu_torch.slam.system import SlamSystem

    slam = SlamSystem(cfg, device=device)
    frame_ms, feed_ms, track_ms = [], [], []
    decoder = "python"
    t_start = time.perf_counter()

    if args.mode == "rgbd":
        from orb_slam3_detailed_comments_kor_tpu_torch.io import native_host

        try:  # load_gray decodes with the native library when it builds
            native_host.load()
            decoder = "native"
        except Exception:
            pass
        for i, fr in enumerate(seq.frames):
            t0 = time.perf_counter()
            img = ds.load_gray(fr.left)
            depth = ds.load_depth_tum(fr.depth, args.depth_factor)
            t1 = time.perf_counter()
            slam.track_rgbd(img, depth, fr.t)
            t2 = time.perf_counter()
            feed_ms.append((t1 - t0) * 1e3)
            track_ms.append((t2 - t1) * 1e3)
            frame_ms.append((t2 - t0) * 1e3)
    else:
        feeder = build_feeder(seq, settings, args.mode)
        decoder = "native" if feeder.native else "python"
        inertial = args.mode.endswith("inertial")
        t_prev = None
        t0 = time.perf_counter()
        for i, (img_l, img_r) in enumerate(feeder):
            t1 = time.perf_counter()  # t1 - t0: the wait in next(feeder)
            fr = seq.frames[i]
            if inertial and seq.imu is not None:
                t_lo = t_prev if t_prev is not None else fr.t - 1.0
                tt, gg, aa = seq.imu.between(t_lo, fr.t)
                samples = [
                    (float(tt[k]), aa[k], gg[k]) for k in range(len(tt))
                ]
            else:
                samples = None
            if args.mode == "mono":
                slam.track_mono(img_l, fr.t)
            elif args.mode == "mono_inertial":
                slam.track_mono_inertial(img_l, fr.t, samples)
            elif args.mode == "stereo":
                slam.track_stereo(img_l, img_r, fr.t)
            else:
                slam.track_stereo_inertial(img_l, img_r, fr.t, samples)
            t_prev = fr.t
            t2 = time.perf_counter()
            feed_ms.append((t1 - t0) * 1e3)
            track_ms.append((t2 - t1) * 1e3)
            frame_ms.append((t2 - t0) * 1e3)  # decode wait included
            t0 = t2
    slam.flush_decisions()
    wall = time.perf_counter() - t_start
    fps = len(seq) / wall if wall > 0 else 0.0
    print(f"[run_dataset] {wall:.1f}s ({fps:.1f} fps)", flush=True)

    ts, centers, R_wc = slam.trajectory_arrays()
    fmt = args.format or {
        "euroc": "euroc", "tum_rgbd": "tum", "kitti": "kitti"
    }[args.dataset]
    getattr(traj_io, f"save_{fmt}")(args.out, ts, centers, R_wc)
    print(f"[run_dataset] trajectory -> {args.out}", flush=True)

    err = None
    if args.gt:
        from orb_slam3_detailed_comments_kor_tpu_torch.eval import ate as ate_mod

        gt = np.loadtxt(args.gt, delimiter="," if args.gt.endswith(".csv")
                        else None, comments="#")
        gt_t = gt[:, 0] * (1e-9 if gt[0, 0] > 1e14 else 1.0)
        i_est, i_gt = ate_mod.associate_timestamps(ts, gt_t, max_dt=0.05)
        err = ate_mod.ate_rmse(
            centers[i_est], gt[i_gt, 1:4],
            with_scale=(args.mode.startswith("mono")),
        )
        print(f"[run_dataset] ATE RMSE: {err:.4f} m", flush=True)
    return dict(slam=slam, frames=len(seq), wall_s=wall, frames_per_s=fps, frame_ms=frame_ms,
                feed_ms=feed_ms, track_ms=track_ms, decoder=decoder, ate_m=err, out=args.out, format=fmt)


if __name__ == "__main__":
    main()
