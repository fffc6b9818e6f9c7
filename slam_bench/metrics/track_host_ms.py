"""Host ms per window frame in tracking: the step's dispatch and the
batched decision read (``track/dispatch`` + ``track/decide_sync``)."""

from slam_bench.metrics._spans import ms_per_frame

NAME = "track_host_ms"
UNIT = "ms"
SOURCE = "program_span"
LAYER = "tracking: slam/system.track_* -> slam/tracking, slam/frontend"
MOVES = "frames_per_s"
READS = "StageTimer spans track/dispatch and track/decide_sync over the window"


def read(run):
    return ms_per_frame(run, names=("track/dispatch", "track/decide_sync"))
