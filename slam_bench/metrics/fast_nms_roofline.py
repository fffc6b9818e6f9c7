"""The FAST + NMS kernel's share of its roofline: the least time of one
frame's FAST + NMS work (``reference/fast_nms_bytes.py``, counted from the
configuration's image size, scale factor and levels) over the kernel's
device time per frame in the traced sub-window. No kernel in the trace:
no reading."""

from slam_bench.reference import fast_nms_bytes

NAME = "fast_nms_roofline"
UNIT = "%"
SOURCE = "device_trace"
LAYER = "kernels: csrc/fast_nms.cu via ops/cuda_fast"
MOVES = "frames_per_s"
READS = "device events named fast_nms_kernel in the traced sub-window"
KERNEL = "fast_nms_kernel"


def read(run):
    if not run.trace_events or not run.trace_frames:
        return None
    us = sum(d for _, name, d in run.trace_events if KERNEL in name)
    if us <= 0:
        return None
    cam, orb = run.config["camera"], run.config["orb"]
    least = fast_nms_bytes.least_seconds(cam["height"], cam["width"], orb["n_levels"], orb["scale_factor"])
    return 100.0 * least / (us * 1e-6 / run.trace_frames)
