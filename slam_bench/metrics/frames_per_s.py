"""Frames the system tracked in the window over the window's seconds. The
window ends with a synchronize and a host read of the last pose, so a
frame counts only once its pose exists."""

NAME = "frames_per_s"
UNIT = "frames/s"
SOURCE = "host_clock"
READS = "the window's frame count and its wall seconds"


def read(run):
    return run.window_frames / run.window_s if run.window_s > 0 else None
