"""Host ms per window frame in the mapping slices: every top-level
``mapping/*`` span (keyframe insertion, local BA, fusion, culling, loop,
IMU initialisation, GBA chunks)."""

from slam_bench.metrics._spans import ms_per_frame

NAME = "mapping_host_ms"
UNIT = "ms"
SOURCE = "program_span"
LAYER = "mapping slices: background FIFO -> optim/ba, slam/map_merging fusion, culling, slam/loop_closing"
MOVES = "frames_per_s"
READS = "StageTimer spans mapping/* (not nested) over the window"


def read(run):
    return ms_per_frame(run, prefix="mapping/")
