"""The JAX reference's run of the Atlas-merge pass of chip_smoke.py phase 7.

Run from the root of a checkout, on a CPU:

    JAX_PLATFORMS=cpu python tools/jax_merge_ref.py [--out traj.npz]

Builds bench.py's stereo configuration (``bench.py:39-57``,
``inertial=False``) with one change, ``tracking.max_frames_between_kf = 3``
(as the JAX package's ``tests/test_map_merge.py`` sets it), and feeds the
JAX package's ``SlamSystem`` (its defaults: loop closing on) that test's
scenario at bench scale, with frames rendered by the JAX package's
``io/synthetic`` at 20 fps timestamps ``k / 20``:

1. 40 strafe frames at 0.03 m/frame, then a decision flush;
2. 22 black frames: the hard loss, which shelves the map (>= 10
   keyframes) after 20 lost frames;
3. strafe poses 8-21 replayed, then a decision flush: the new map
   initializes in its own frame and welds back into the shelved one.

Prints one JSON line: the frame whose background slice ran the merge and
its ``(kf_cur, kf_old)`` pair, the maps and keyframes after it, the
keyframes before the blackout, ``merges_rejected_gate``, the merge probes
(candidate searches, verifications, gate checks), the frames decided lost
and the relocalizations, the live camera-centre error against pose 21,
the mean error of the last 10 trajectory centres against poses 12-21, the
final state and the run's seconds. chip_smoke.py records these as
``REF_MERGE``. ``--out`` also writes the per-frame trajectory to an npz.

As ``tools/jax_loop_closure_ref.py`` does, the tool turns the CPU's
asynchronous dispatch off, so that every deferred decision read is ready
at its first chance, as on the H100 (ROADMAP F16).
"""

import argparse
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from orb_slam3_detailed_comments_kor_tpu.config import (  # noqa: E402
    CameraConfig, CapacityConfig, ORBConfig, SLAMConfig, SensorType, TrackingConfig,
)
from orb_slam3_detailed_comments_kor_tpu.io import synthetic  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu.slam import map_merging  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu.slam.system import SlamSystem  # noqa: E402

H, W, FX, BASELINE, FPS = 480, 752, 458.0, 0.11, 20.0
N_FIRST, N_BLACK, REPLAY, SPEED = 40, 22, (8, 22), 0.03


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="npz for the per-frame trajectory")
    args = ap.parse_args()
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    cfg = SLAMConfig(
        sensor=SensorType.STEREO,
        camera=CameraConfig(width=W, height=H, fx=FX, fy=FX, cx=W / 2.0, cy=H / 2.0, bf=BASELINE * FX),
        orb=ORBConfig(n_features=1200, cell_size=32),
        capacity=CapacityConfig(max_keyframes=64, max_landmarks=16384, max_local_landmarks=4096),
        tracking=TrackingConfig(max_frames_between_kf=3),
    )
    params = jnp.array([FX, FX, W / 2.0, H / 2.0])
    scene = synthetic.default_scene()
    Rs, ts = synthetic.make_trajectory(N_FIRST, motion="strafe", speed=SPEED)
    slam = SlamSystem(cfg)
    counts = {"merges": [], "candidate_searches": 0, "verifications": 0, "gate_checks": 0,
              "lost_frames": 0, "relocalizations": 0}

    def counted(name, key):
        fn = getattr(map_merging, name)

        def wrapper(*a, **k):
            counts[key] += 1
            return fn(*a, **k)
        setattr(map_merging, name, wrapper)

    counted("detect_merge_candidate", "candidate_searches")
    counted("verify_merge", "verifications")
    counted("_merge_gate_allows", "gate_checks")
    merge = map_merging.merge_into_shelved

    def merge_logged(slam_, shelf_idx, kf_cur, kf_old, R_d, t_d):
        ok = merge(slam_, shelf_idx, kf_cur, kf_old, R_d, t_d)
        counts["merges"].append(dict(frame=slam_.n_frames - 1, kf_cur=int(kf_cur), kf_old=int(kf_old),
                                     done=bool(ok)))
        return ok
    map_merging.merge_into_shelved = merge_logged
    handle_lost, relocalize = slam._handle_lost, slam._relocalize

    def lost_counted(frame):
        counts["lost_frames"] += 1
        return handle_lost(frame)

    def reloc_counted(frame):
        ok = relocalize(frame)
        counts["relocalizations"] += ok
        return ok
    slam._handle_lost, slam._relocalize = lost_counted, reloc_counted

    def feed(i, k):
        il, ir, _ = synthetic.stereo_pair(params, jnp.asarray(Rs[i]), jnp.asarray(ts[i]), BASELINE, scene,
                                          h=H, w=W)
        slam.track_stereo(il, ir, k / FPS)

    t0 = time.time()
    k = 0
    for i in range(N_FIRST):
        feed(i, k)
        k += 1
    slam.flush_decisions()
    n_kf_before = slam.n_kf
    black = jnp.zeros((H, W))
    for _ in range(N_BLACK):
        slam.track_stereo(black, black, k / FPS)
        k += 1
    maps_after_loss = len(slam.atlas_maps) + 1
    for i in range(*REPLAY):
        feed(i, k)
        k += 1
    slam.flush_decisions()
    times, centers, R_wc = slam.trajectory_arrays()
    live_err = float(np.linalg.norm(slam.camera_center() - ts[REPLAY[1] - 1]))
    tail_err = float(np.linalg.norm(centers[-10:] - ts[REPLAY[1] - 10:REPLAY[1]], axis=1).mean())
    print(json.dumps({
        **counts, "keyframes_before_blackout": n_kf_before, "maps_after_loss": maps_after_loss,
        "maps": slam.map_stats()["n_maps"], "n_kf": slam.n_kf,
        "merges_rejected_gate": slam.stats.get("merges_rejected_gate", 0), "stats": slam.stats,
        "state": slam.state, "frames": len(centers), "live_centre_err_m": live_err,
        "tail_mean_err_m": tail_err, "seconds": time.time() - t0,
    }))
    if args.out:
        np.savez(args.out, times=times, centers=centers, R_wc=R_wc)
    return 0


if __name__ == "__main__":
    sys.exit(main())
