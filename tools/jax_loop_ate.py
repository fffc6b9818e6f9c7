"""The JAX reference's ATE on the SLAM loop of chip_smoke.py phase 4.

Run from the root of a checkout, on a CPU:

    JAX_PLATFORMS=cpu python tools/jax_loop_ate.py

Builds bench.py's stereo configuration (``bench.py:39-57``,
``inertial=False``), renders its 130-frame strafe sequence (0.03 m/frame)
with the JAX package's ``io/synthetic``, feeds it to the JAX package's
``SlamSystem`` with loop closing off, one frame at a time at 20 fps
timestamps, and prints one JSON line: ``eval.ate.ate_rmse`` over all
frames, the final state, keyframes, lifecycle counters, landmarks and the
run's seconds. chip_smoke.py records the ATE as ``REF_ATE_M``.
"""

import json
import os
import sys
import time

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from orb_slam3_detailed_comments_kor_tpu.config import (  # noqa: E402
    CameraConfig, CapacityConfig, ORBConfig, SLAMConfig, SensorType, TrackingConfig,
)
from orb_slam3_detailed_comments_kor_tpu.eval import ate  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu.io import synthetic  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu.slam.system import SlamSystem  # noqa: E402

H, W, FX, BASELINE, N_FRAMES, FPS = 480, 752, 458.0, 0.11, 130, 20.0


def main() -> int:
    cfg = SLAMConfig(
        sensor=SensorType.STEREO,
        camera=CameraConfig(width=W, height=H, fx=FX, fy=FX, cx=W / 2.0, cy=H / 2.0, bf=BASELINE * FX),
        orb=ORBConfig(n_features=1200, cell_size=32),
        capacity=CapacityConfig(max_keyframes=64, max_landmarks=16384, max_local_landmarks=4096),
        tracking=TrackingConfig(max_frames_between_kf=10),
    )
    params = jnp.array([FX, FX, W / 2.0, H / 2.0])
    scene = synthetic.default_scene()
    Rs, ts = synthetic.make_trajectory(N_FRAMES, motion="strafe", speed=0.03)
    slam = SlamSystem(cfg)
    slam.enable_loop_closing = False
    t0 = time.time()
    for i in range(N_FRAMES):
        il, ir, _ = synthetic.stereo_pair(params, jnp.asarray(Rs[i]), jnp.asarray(ts[i]), BASELINE, scene,
                                          h=H, w=W)
        slam.track_stereo(il, ir, i / FPS)
    _, centers, _ = slam.trajectory_arrays()
    print(json.dumps({
        "ate_m": float(ate.ate_rmse(centers, ts[: len(centers)])), "state": slam.state,
        "n_kf": slam.n_kf, "stats": slam.stats, "frames": len(centers),
        "landmarks": int(np.asarray(slam.ms.lm_valid).sum()), "seconds": time.time() - t0,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
