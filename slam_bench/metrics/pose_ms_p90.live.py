"""90th percentile, over all frames of the window, of the wall from
handing a frame to the system to its pose being readable on the host
(blocking feeds only). A per-layer metric: between runs it spreads by
5.6-7.2 %, and five times that is over the 25 % an end-to-end bound may
have (PERF.md)."""

import numpy as np

NAME = "pose_ms_p90.live"
UNIT = "ms"
SOURCE = "host_clock"
LAYER = "tracking: slam/system.track_* -> slam/tracking, slam/frontend"
MOVES = "frames_per_s"
READS = "each window frame's wall from the track call to the pose's host read"


def read(run):
    if not run.latencies_ms:
        return None
    return float(np.percentile(np.asarray(run.latencies_ms, np.float64), 90))
