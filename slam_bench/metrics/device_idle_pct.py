"""100 × (1 − the union of device-activity intervals ÷ the traced
sub-window's wall)."""

from slam_bench.reference import devtrace

NAME = "device_idle_pct"
UNIT = "%"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "frames_per_s"
READS = "the traced sub-window's device events and its wall seconds"


def read(run):
    if not run.trace_events or run.trace_wall_s <= 0:
        return None
    return devtrace.idle_pct(run.trace_events, run.trace_wall_s * 1e6)
