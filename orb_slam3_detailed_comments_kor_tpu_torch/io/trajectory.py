"""Trajectory writers: TUM / EuRoC / KITTI formats.

Counterpart of the reference's ``System::SaveTrajectoryTUM`` /
``SaveTrajectoryEuRoC`` / ``SaveTrajectoryKITTI`` (``src/System.cc:410-842``).
Input is (times [T], R_wc [T,3,3], centers t_wc [T,3]) — the camera-to-world
trajectory the evaluator consumes. numpy only: the port's own copy of
``orb_slam3_detailed_comments_kor_tpu/io/trajectory.py``, with the
quaternion conversion (``utils/lie.py: rotmat_to_quat``) in numpy.
"""

from __future__ import annotations

import numpy as np


def _quats_wxyz(R_wc: np.ndarray) -> np.ndarray:
    """[T,3,3] -> [T,4] (w,x,y,z), Shepperd's method (branchless blend)."""
    R = np.asarray(R_wc)
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = np.sqrt(np.maximum(1.0 + tr, 0.0)) * 0.5
    qx = np.copysign(np.sqrt(np.maximum(1.0 + m00 - m11 - m22, 0.0)) * 0.5, m21 - m12)
    qy = np.copysign(np.sqrt(np.maximum(1.0 - m00 + m11 - m22, 0.0)) * 0.5, m02 - m20)
    qz = np.copysign(np.sqrt(np.maximum(1.0 - m00 - m11 + m22, 0.0)) * 0.5, m10 - m01)
    q = np.stack([qw, qx, qy, qz], axis=-1)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def save_tum(path: str, times, centers, R_wc) -> None:
    """TUM format: `time x y z qx qy qz qw` (System::SaveTrajectoryTUM)."""
    q = _quats_wxyz(R_wc)  # (w,x,y,z)
    with open(path, "w") as f:
        for i in range(len(times)):
            f.write(
                f"{times[i]:.6f} {centers[i,0]:.7f} {centers[i,1]:.7f} "
                f"{centers[i,2]:.7f} {q[i,1]:.7f} {q[i,2]:.7f} {q[i,3]:.7f} "
                f"{q[i,0]:.7f}\n"
            )


def save_euroc(path: str, times, centers, R_wc) -> None:
    """EuRoC format: `time_ns, x, y, z, qw, qx, qy, qz`
    (System::SaveTrajectoryEuRoC, ``System.cc:503``)."""
    q = _quats_wxyz(R_wc)
    with open(path, "w") as f:
        for i in range(len(times)):
            f.write(
                f"{int(times[i]*1e9)},{centers[i,0]:.7f},{centers[i,1]:.7f},"
                f"{centers[i,2]:.7f},{q[i,0]:.7f},{q[i,1]:.7f},{q[i,2]:.7f},"
                f"{q[i,3]:.7f}\n"
            )


def save_kitti(path: str, times, centers, R_wc) -> None:
    """KITTI format: 12 numbers per row, row-major [R|t]
    (System::SaveTrajectoryKITTI)."""
    with open(path, "w") as f:
        for i in range(len(times)):
            T = np.concatenate([R_wc[i], centers[i][:, None]], axis=1)
            f.write(" ".join(f"{v:.7e}" for v in T.reshape(-1)) + "\n")


def load_tum(path: str):
    """Load a TUM-format trajectory -> (times [T], centers [T,3], quat_xyzw)."""
    data = np.loadtxt(path)
    return data[:, 0], data[:, 1:4], data[:, 4:8]
