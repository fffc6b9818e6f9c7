"""Traffic generator: a stereo (and IMU) sequence through the lattice-scene
box room along ``AnalyticTrajectory``, made from the seed.

Reads a traffic mix's parameters (``traffic/<mix>.json``) and the
configuration's camera and IMU. The seed sets where along the trajectory
the sequence starts (uniform in [0, ``start_span_s``), to the millisecond);
everything else (frame rate, excitation, sample rate, length) is the same
for every seed. Images are rendered on ``device`` in batched chunks and kept on the
host as 8-bit gray arrays, as a decoder or camera driver hands them over.
IMU samples are the trajectory's exact ones: ``samples_per_frame`` per
frame, each the value at the middle of its interval, stamped at its end.

System timestamps start at 0 (frame i at i / fps); the trajectory is
evaluated at start + i / fps.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from slam_bench.reference import synthetic

RENDER_CHUNK = 16  # frames rendered in one batched pass


@dataclass
class Sequence:
    fps: float
    start_s: float               # trajectory time of frame 0
    times: np.ndarray            # [n] system timestamps (s)
    images: np.ndarray           # [n, 2, h, w] uint8 (left, right)
    R_wc: np.ndarray             # [n, 3, 3] ground-truth camera-to-world rotation
    t_wc: np.ndarray             # [n, 3]   ground-truth camera centre
    imu_t: Optional[np.ndarray]  # [n, k] sample stamps (system time), frame 0 unused
    imu_acc: Optional[np.ndarray]   # [n, k, 3] float32
    imu_gyro: Optional[np.ndarray]  # [n, k, 3] float32

    @property
    def n(self) -> int:
        return len(self.times)

    def imu_samples(self, i: int) -> List[tuple]:
        """Frame i's samples since frame i-1 as (t, acc[3], gyro[3])."""
        if self.imu_t is None or i == 0:
            return []
        return [(float(self.imu_t[i, j]), self.imu_acc[i, j], self.imu_gyro[i, j])
                for j in range(self.imu_t.shape[1])]


def start_time(seed: int, span_s: float) -> float:
    rng = np.random.default_rng(int(seed) & ((1 << 64) - 1))
    return float(np.floor(rng.uniform(0.0, span_s) * 1e3) / 1e3)


def generate(config: dict, traffic: dict, seed: int, n_frames: int, device) -> Sequence:
    cam = config["camera"]
    h, w = cam["height"], cam["width"]
    fps = float(traffic["fps"])
    t0 = start_time(seed, float(traffic["start_span_s"]))
    traj = synthetic.AnalyticTrajectory(excitation=float(traffic["excitation"]), device=device)
    times = np.arange(n_frames, dtype=np.float64) / fps
    R, t = traj.poses(t0 + times)
    params = torch.tensor([cam["fx"], cam["fy"], cam["cx"], cam["cy"]], dtype=torch.float32, device=device)
    scene = synthetic.default_scene(device)
    baseline = cam["bf"] / cam["fx"]
    images = np.empty((n_frames, 2, h, w), np.uint8)
    for c0 in range(0, n_frames, RENDER_CHUNK):
        c1 = min(c0 + RENDER_CHUNK, n_frames)
        pairs = synthetic.stereo_many(params, R[c0:c1], t[c0:c1], baseline, scene, h, w)
        images[c0:c1] = torch.clamp(torch.round(pairs), 0, 255).to(torch.uint8).cpu().numpy()
    imu_t = imu_acc = imu_gyro = None
    if config.get("imu"):
        k = int(traffic["samples_per_frame"])
        dt = 1.0 / fps / k
        j = np.arange(k, dtype=np.float64)
        # the last stamp of frame i is exactly its timestamp
        imu_t = times[:, None] - (k - 1.0 - j) * dt
        acc, gyro = traj.imu_at((t0 + imu_t - 0.5 * dt).reshape(-1))
        imu_acc = acc.cpu().numpy().reshape(n_frames, k, 3)
        imu_gyro = gyro.cpu().numpy().reshape(n_frames, k, 3)
    return Sequence(fps=fps, start_s=t0, times=times, images=images, R_wc=R.cpu().numpy(),
                    t_wc=t.cpu().numpy(), imu_t=imu_t, imu_acc=imu_acc, imu_gyro=imu_gyro)
