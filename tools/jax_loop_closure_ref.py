"""The JAX reference's run of the loop-closure pass of chip_smoke.py phase 6.

Run from the root of a checkout, on a CPU:

    JAX_PLATFORMS=cpu python tools/jax_loop_closure_ref.py [--out traj.npz]

Builds bench.py's stereo configuration (``bench.py:39-57``,
``inertial=False``), renders bench.py's 150-frame out-and-back sequence
(``motion="outback"``, 0.045 m/frame) with the JAX package's
``io/synthetic``, and feeds it to the JAX package's ``SlamSystem`` with its
defaults (loop closing on), one frame at a time at 20 fps timestamps. At
frame 80 it flushes the deferred decisions and injects bench.py's drift
(``_inject_drift``: mag 0.35, yaw 0.03), as ``bench_loop_latency`` does.
Prints one JSON line: the loops closed, the last closure
``(kf_idx, cand, degrees, metres, source)``, the frame whose background
slice corrected the map, the global-BA chunks run, the hypothesis steps and
verifications, the frames decided lost (``_handle_lost`` calls), the
successful relocalizations and the frames they happened at, the keyframes,
lifecycle counters, landmarks, final state,
``eval.ate.ate_rmse`` over all frames and the run's seconds. chip_smoke.py
records these as ``REF_LOOP``. ``--out`` also writes the per-frame
trajectory (times, centres, rotations) and the ground truth to an npz.

The system reads its deferred keyframe decisions as soon as their copies
have landed (``is_ready``). On a CPU with asynchronous dispatch a copy
lands one or more frames later than on a device that keeps up with the
host, so the keyframes go in at other frames; the tool turns the CPU's
asynchronous dispatch off, so that every deferred read is ready at its
first chance, as on the H100, where the tracking step is host-bound.
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
from orb_slam3_detailed_comments_kor_tpu.eval import ate  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu.io import synthetic  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu.slam import loop_closing  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu.slam.system import SlamSystem  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu.utils import lie  # noqa: E402

H, W, FX, BASELINE, FPS = 480, 752, 458.0, 0.11, 20.0
N_LOOP, INJECT_AT, SPEED = 150, 80, 0.045


def inject_drift(slam, mag=0.35, yaw=0.03):
    """bench.py's ``_inject_drift``: the newest third of the map and the
    live pose warped by a rigid drift, late keyframes' observations of
    early landmarks cleared."""
    ms = slam.ms
    cut = 2 * slam.n_kf // 3
    K = ms.K
    R_d, t_d = lie.se3_exp(jnp.array([0.0, yaw, 0.0, mag * 0.7, mag * 0.7, 0.0]))
    Rd_i, td_i = lie.se3_inverse(R_d, t_d)
    late_kf = jnp.arange(K) >= cut
    R_new, t_new = lie.se3_compose(ms.kf_R_cw, ms.kf_t_cw,
                                   jnp.broadcast_to(Rd_i, (K, 3, 3)), jnp.broadcast_to(td_i, (K, 3)))
    late_lm = ms.lm_valid & (ms.lm_first_kf >= cut)
    X_new = ms.lm_pos @ R_d.T + t_d
    early_lm_obs = (ms.obs_lm >= 0) & (ms.lm_first_kf[jnp.clip(ms.obs_lm, 0)] < cut)
    clear = late_kf[:, None] & early_lm_obs
    slam.ms = ms._replace(
        kf_R_cw=jnp.where(late_kf[:, None, None], R_new, ms.kf_R_cw),
        kf_t_cw=jnp.where(late_kf[:, None], t_new, ms.kf_t_cw),
        lm_pos=jnp.where(late_lm[:, None], X_new, ms.lm_pos),
        obs_lm=jnp.where(clear, -1, ms.obs_lm),
    )
    slam.R_cw, slam.t_cw = lie.se3_compose(slam.R_cw, slam.t_cw, Rd_i, td_i)
    slam.has_velocity = False


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
        tracking=TrackingConfig(max_frames_between_kf=10),
    )
    params = jnp.array([FX, FX, W / 2.0, H / 2.0])
    scene = synthetic.default_scene()
    Rs, ts = synthetic.make_trajectory(N_LOOP, motion="outback", speed=SPEED)
    slam = SlamSystem(cfg)
    counts = {"gba_chunks": 0, "hypothesis_steps": 0, "verifications": 0, "corrected_at_frame": [],
              "lost_frames": 0, "relocalizations": 0, "relocalized_at_frame": []}
    lc_cls = loop_closing.LoopCloser
    handle_lost, relocalize = slam._handle_lost, slam._relocalize

    def lost_counted(frame):
        counts["lost_frames"] += 1
        return handle_lost(frame)

    def reloc_counted(frame):
        ok = relocalize(frame)
        if ok:
            counts["relocalizations"] += 1
            counts["relocalized_at_frame"].append(slam.n_frames - 1)
        return ok
    slam._handle_lost, slam._relocalize = lost_counted, reloc_counted

    def counted(name, key):
        fn = getattr(lc_cls, name)

        def wrapper(self, *a, **k):
            counts[key] += 1
            return fn(self, *a, **k)
        setattr(lc_cls, name, wrapper)

    counted("gba_chunk", "gba_chunks")
    counted("hypothesis_step", "hypothesis_steps")
    counted("verify", "verifications")
    correct = lc_cls.correct

    def correct_logged(self, *a, **k):
        counts["corrected_at_frame"].append(slam.n_frames - 1)
        return correct(self, *a, **k)
    lc_cls.correct = correct_logged

    t0 = time.time()
    kf_at = []
    for i in range(N_LOOP):
        if i == INJECT_AT:
            slam.flush_decisions()
            inject_drift(slam)
        il, ir, _ = synthetic.stereo_pair(params, jnp.asarray(Rs[i]), jnp.asarray(ts[i]), BASELINE, scene,
                                          h=H, w=W)
        n0 = slam.stats["kf_inserted"]
        slam.track_stereo(il, ir, i / FPS)
        if slam.stats["kf_inserted"] != n0:
            kf_at.append(i)
    times, centers, R_wc = slam.trajectory_arrays()
    lc = slam.loop_closer
    print(json.dumps({
        "loops_closed": lc.n_loops_closed, "last_closure": list(getattr(lc, "last_closure", ())),
        **counts, "keyframe_frames": kf_at, "n_kf": slam.n_kf, "stats": slam.stats,
        "state": slam.state, "frames": len(centers),
        "landmarks": int(np.asarray(slam.ms.lm_valid).sum()),
        "ate_m": float(ate.ate_rmse(centers, ts[: len(centers)])), "seconds": time.time() - t0,
    }))
    if args.out:
        np.savez(args.out, times=times, centers=centers, R_wc=R_wc, gt=ts[: len(centers)])
    return 0


if __name__ == "__main__":
    sys.exit(main())
