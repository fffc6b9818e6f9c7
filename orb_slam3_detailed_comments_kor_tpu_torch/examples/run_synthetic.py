"""Run stereo SLAM on a synthetic rendered sequence and score ATE.

Port of the repository's ``examples/run_synthetic.py``, the synthetic
analog of the reference's dataset drivers
(``Examples/Stereo/stereo_euroc.cc``): render frames on the system's
device, feed the system, write the trajectory in TUM format, evaluate RMS
ATE against ground truth. The system runs on the card unless the caller
names another device.

Usage:  python -m orb_slam3_detailed_comments_kor_tpu_torch.examples.run_synthetic [n_frames] [motion]
"""

import os
import sys
import tempfile
import time

import torch

from orb_slam3_detailed_comments_kor_tpu_torch.config import (
    CameraConfig, CapacityConfig, ORBConfig, SLAMConfig, SensorType,
    TrackingConfig,
)
from orb_slam3_detailed_comments_kor_tpu_torch.eval import ate
from orb_slam3_detailed_comments_kor_tpu_torch.io import synthetic, trajectory
from orb_slam3_detailed_comments_kor_tpu_torch.slam.system import SlamSystem


def main(n_frames: int = 60, motion: str = "strafe", device="cuda", out=None) -> float:
    H, W, FX, BASELINE = 240, 376, 230.0, 0.11
    cfg = SLAMConfig(
        sensor=SensorType.STEREO,
        camera=CameraConfig(
            width=W, height=H, fx=FX, fy=FX, cx=W / 2.0, cy=H / 2.0,
            bf=BASELINE * FX,
        ),
        orb=ORBConfig(n_features=600, cell_size=24),
        capacity=CapacityConfig(
            max_keyframes=64, max_landmarks=8192, max_local_landmarks=2048
        ),
        tracking=TrackingConfig(max_frames_between_kf=10),
    )
    slam = SlamSystem(cfg, device=device)
    dev = slam.device
    params = torch.tensor([FX, FX, W / 2.0, H / 2.0], device=dev)
    scene = synthetic.default_scene(dev)
    Rs, ts = synthetic.make_trajectory(n_frames, motion=motion, speed=0.03)

    t0 = time.time()
    for i in range(n_frames):
        img_l, img_r, _ = synthetic.stereo_pair(
            params, torch.as_tensor(Rs[i], device=dev), torch.as_tensor(ts[i], device=dev),
            BASELINE, scene, h=H, w=W,
        )
        state = slam.track_stereo(img_l, img_r, i / 20.0)
    wall = time.time() - t0

    times, centers, R_wc = slam.trajectory_arrays()
    out = out or os.path.join(tempfile.gettempdir(), "synthetic_traj.txt")
    trajectory.save_tum(out, times, centers, R_wc)
    rmse = ate.ate_rmse(centers, ts)
    stats = slam.map_stats()
    print(
        f"frames={n_frames} state={state} kf={stats['n_keyframes']} "
        f"lm={stats['n_landmarks']} fps={n_frames / wall:.1f} "
        f"ATE={rmse * 1000:.1f}mm"
    )
    print(f"trajectory written to {out}")
    return rmse


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 60
    motion = sys.argv[2] if len(sys.argv) > 2 else "strafe"
    main(n, motion)
