"""Long-sequence run of the port: 3,000 frames (150 s at 20 fps) of
stereo-inertial SLAM at EuRoC resolution with bounded keyframe capacity.

Port of ``tools/run_long_synthetic.py``: keyframe culling, slot
compaction and eviction, the merge of inertial preintegrations and loop
closing over a MH01-length sequence, 752x480, 1,200 features, 64
keyframes and 16,384 landmarks, a 200 Hz IMU. Two trajectories:

- ``loop``: the excited sinusoid over the lattice scene (steady
  covisibility, continuous revisits);
- ``corridor``: 12 m out and back through non-repeating texture, so that
  early keyframes leave covisibility, capacity pressure reclaims
  mid-corridor slots and the return leg must close the loop against the
  start.

Ground-truth poses and the ideal IMU samples are made up front; each frame
is rendered on the device outside the timed track call, as the reference
tool keeps rendering out of its tracking rate. Writes the EuRoC-format
trajectory to ``<out_prefix>_traj.txt`` and the result (RMS ATE by the
port's ``eval.ate``, over the whole run and its last 1,000 frames) to
``<out_prefix>_result.json``.

Run (on the card):
    python3 tools/torch_run_long_synthetic.py n_frames out_prefix [loop|corridor] [--max-wall-s S]
(3,000 frames is the reference's length; ``out_prefix`` has no default,
so that two runs never write over each other's files.) ``--max-wall-s`` ends the run after the frame that passes S seconds and
scores the frames tracked so far; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from orb_slam3_detailed_comments_kor_tpu_torch.config import (  # noqa: E402
    CameraConfig, CapacityConfig, IMUConfig, ORBConfig, SLAMConfig, SensorType, TrackingConfig,
)
from orb_slam3_detailed_comments_kor_tpu_torch.eval import ate  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu_torch.io import synthetic, trajectory  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu_torch.slam.system import SlamSystem  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu_torch.utils import lie  # noqa: E402

H, W = 480, 752
FX, BASELINE = 458.0, 0.11
FPS, IMU_RATE = 20.0, 200.0


def config(h=H, w=W, fx=FX, n_features=1200, cell=32) -> SLAMConfig:
    return SLAMConfig(
        sensor=SensorType.IMU_STEREO,
        camera=CameraConfig(width=w, height=h, fx=fx, fy=fx, cx=w / 2.0, cy=h / 2.0, bf=BASELINE * fx),
        orb=ORBConfig(n_features=n_features, cell_size=cell),
        imu=IMUConfig(frequency=IMU_RATE),
        capacity=CapacityConfig(max_keyframes=64, max_landmarks=16384, max_local_landmarks=4096),
        tracking=TrackingConfig(max_frames_between_kf=10),
    )


def precompute_gt_and_imu(traj, n_frames):
    """Every frame's pose (R_wb [T,3,3], p_wb [T,3] on the trajectory's
    device) and, for each gap (i-1, i], its midpoint-sampled IMU
    measurements stamped at the end of their interval (numpy)."""
    ts_f = torch.as_tensor(np.arange(n_frames, dtype=np.float32) / FPS, device=traj.device).to(torch.float64)
    R_all = torch.func.vmap(lambda t: lie.so3_exp(traj._rotvec(t)))(ts_f).to(torch.float32)
    p_all = torch.func.vmap(traj._pos)(ts_f).to(torch.float32)
    spf = int(round(IMU_RATE / FPS))
    dt = (1.0 / FPS) / spf
    base = (np.arange(1, n_frames, dtype=np.float32) - 1.0)[:, None] / FPS
    tm = base + (np.arange(spf, dtype=np.float32)[None, :] + 0.5) * dt
    acc, gyro = (a.cpu().numpy().reshape(n_frames - 1, spf, 3) for a in traj.imu_at(tm.reshape(-1)))
    t_end = base + (np.arange(spf, dtype=np.float32)[None, :] + 1.0) * dt
    return R_all, p_all, acc, gyro, t_end, spf


def main(n_frames, out_prefix, traj_kind="loop", device="cuda", max_wall_s=None, cfg=None, log=print) -> dict:
    cfg = cfg or config()
    slam = SlamSystem(cfg, device=device)
    dev = slam.device
    c = cfg.camera
    params = torch.tensor([c.fx, c.fy, c.cx, c.cy], device=dev)
    if traj_kind == "corridor":
        scene = synthetic.corridor_scene(dev)
        traj = synthetic.CorridorTrajectory(length=12.0, duration=n_frames / FPS, device=dev)
    else:
        scene = synthetic.default_scene(dev)
        traj = synthetic.AnalyticTrajectory(device=dev)
    R_all, p_all, acc_all, gyro_all, t_end, spf = precompute_gt_and_imu(traj, n_frames)
    gt = p_all.cpu().numpy()
    centers0 = None
    t0 = time.time()
    track_s = 0.0
    n_run = n_frames
    for i in range(n_frames):
        if max_wall_s is not None and time.time() - t0 > max_wall_s:
            n_run = i
            log(f"  wall budget {max_wall_s} s spent: stopped after {i} frames")
            break
        t = i / FPS
        il, ir, _ = synthetic.stereo_pair(params, R_all[i], p_all[i], BASELINE, scene, h=c.height, w=c.width)
        samples = [(float(t_end[i - 1, k]), acc_all[i - 1, k], gyro_all[i - 1, k]) for k in range(spf)] if i else []
        prev_state, prev_loops = slam.state, slam.loop_closer.n_loops_closed
        tt = time.time()
        slam.track_stereo_inertial(il, ir, t, samples)
        track_s += time.time() - tt
        if slam.state != prev_state:
            log(f"  state {prev_state}->{slam.state} at frame {i} (t={t:.1f}s kf={slam.n_kf})")
        if slam.loop_closer.n_loops_closed != prev_loops:
            log(f"  LOOP #{slam.loop_closer.n_loops_closed} closed at frame {i} (t={t:.1f}s kf={slam.n_kf} "
                f"ends={getattr(slam.loop_closer, 'last_closure', None)})")
        if centers0 is None and slam.state == 1:
            centers0 = -(slam.R_cw.T @ slam.t_cw).cpu().numpy()
        if (i + 1) % 100 == 0:
            # the live pose error against the ground truth: one read per 100 frames
            c_now = -(slam.R_cw.T @ slam.t_cw).cpu().numpy()
            err = float(np.linalg.norm((c_now - centers0) - (gt[i] - gt[0]))) if centers0 is not None else -1.0
            log(f"frame {i + 1}/{n_frames} kf={slam.n_kf} lm={int(slam.ms.lm_valid.sum())} state={slam.state} "
                f"loops={slam.loop_closer.n_loops_closed} err={err:.3f} stats={slam.stats} "
                f"t={time.time() - t0:.0f}s")
    tt = time.time()
    slam.flush_decisions()
    slam.t_cw.cpu()
    track_s += time.time() - tt
    wall = time.time() - t0
    ts, centers, R_wc = slam.trajectory_arrays()
    trajectory.save_euroc(out_prefix + "_traj.txt", ts, centers, R_wc)
    n = min(len(centers), n_run)
    lo = max(n - 1000, 0)
    result = {
        "trajectory": traj_kind,
        "n_frames": n_run,
        "duration_s": n_run / FPS,
        "wall_s": round(wall, 1),
        "fps_wall": round(n_run / wall, 2),
        "fps_tracking": round(n_run / track_s, 2),
        "ate_m": round(float(ate.ate_rmse(centers[:n], gt[:n])), 4),
        "ate_last50s_m": round(float(ate.ate_rmse(centers[lo:n], gt[lo:n])), 4),
        "state": slam.state,
        "n_kf": slam.n_kf,
        "imu_initialized": bool(slam.imu_initialized),
        "n_loops_closed": slam.loop_closer.n_loops_closed,
        "stats": dict(slam.stats),
        "platform": dev.type,
    }
    print(json.dumps(result), flush=True)
    with open(out_prefix + "_result.json", "w") as f:
        json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_frames", type=int, help="frames to run (the reference runs 3000)")
    ap.add_argument("out_prefix", help="the trajectory and result files' path prefix")
    ap.add_argument("traj", nargs="?", default="loop", choices=("loop", "corridor"))
    ap.add_argument("--max-wall-s", type=float, default=None)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.n_frames, a.out_prefix, a.traj, a.device, a.max_wall_s, log=lambda s: print(s, flush=True))
