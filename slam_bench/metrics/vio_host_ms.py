"""Host ms per window frame in the VIO refinement (``track/vio``)."""

from slam_bench.metrics._spans import ms_per_frame

NAME = "vio_host_ms"
UNIT = "ms"
SOURCE = "program_span"
LAYER = "inertial: slam/inertial, ops/imu, optim/vio"
MOVES = "frames_per_s"
READS = "StageTimer span track/vio over the window"


def read(run):
    return ms_per_frame(run, names=("track/vio",))
