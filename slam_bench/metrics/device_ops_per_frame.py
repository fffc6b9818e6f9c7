"""Kernels, copies and fills per frame, from torch.profiler's CUDA activity
over the traced sub-window of whole frames."""

NAME = "device_ops_per_frame"
UNIT = "ops/frame"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "frames_per_s"
READS = "the traced sub-window's device events"


def read(run):
    if not run.trace_events or not run.trace_frames:
        return None
    return len(run.trace_events) / run.trace_frames
