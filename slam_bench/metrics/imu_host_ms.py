"""Host ms per window frame in the per-frame IMU pipeline (``track/imu``:
integrate, compose, predict)."""

from slam_bench.metrics._spans import ms_per_frame

NAME = "imu_host_ms"
UNIT = "ms"
SOURCE = "program_span"
LAYER = "inertial: slam/inertial, ops/imu, optim/vio"
MOVES = "frames_per_s"
READS = "StageTimer span track/imu over the window"


def read(run):
    return ms_per_frame(run, names=("track/imu",))
