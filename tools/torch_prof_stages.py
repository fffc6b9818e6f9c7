"""Host stage breakdown of bench.py's stereo or stereo-inertial pass on the
port: the port of ``tools/prof_stages.py`` and ``tools/prof_si.py``.

Renders the pass's frames (``--pass stereo``: bench.py's 130-frame strafe
at its stereo setup, ``chip_smoke.loop_config()``; ``--pass si``: its
stereo-inertial sequence, ``chip_smoke.si_config()`` with the 200 Hz
samples of ``synthetic.AnalyticTrajectory``), runs a warm-up system over
the first ``--warmup`` frames (all of them by default, as the reference
tools do), then two timed systems with the ``StageTimer`` on, each over
every frame and loop closing on (the default):

- throughput mode: the frames back to back, one synchronize at the end;
- blocking mode: each frame's call waits for its pose (a host read of
  ``t_cw``), as bench.py's latency pass does.

For each mode it prints the span report (``StageTimer.report``: host wall
ms per stage), frames/s, keyframes and the final state; for the blocking
mode also p50/p90/p99/max of the frame wall (frames 5 on) and the ten
slowest frames. ``--out`` also writes both modes' numbers and span
summaries as JSON.

Run (on the card; ``--device cpu`` on the CPU):
    python3 tools/torch_prof_stages.py --pass stereo|si [--frames 130] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu_torch.slam.system import SlamSystem  # noqa: E402
from torch_eval_vocab import card_and_limit  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu_torch.utils.timing import StageTimer  # noqa: E402


def render(pass_name, cfg, n, device):
    """The pass's frames and a ``track(slam, i)`` that feeds frame i."""
    if pass_name == "stereo":
        _, frames = cs.render_loop_sequence(cfg, n, device)
        return lambda slam, i: slam.track_stereo(frames[i][0], frames[i][1], i / cs.FPS)
    _, frames, imu_pf = cs.render_si_sequence(cfg, n, device)
    return lambda slam, i: slam.track_stereo_inertial(frames[i][0], frames[i][1], i / cs.FPS, imu_pf[i])


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_pass(cfg, track, n, device, block, timer):
    """One new system over frames 0..n-1, each call in a "frame" span;
    ``block``: each frame waits for its pose. Returns (system, wall s to
    the final synchronize, per-frame wall ms)."""
    slam = SlamSystem(cfg, device=device)
    slam.timer = StageTimer(enabled=timer)
    lat = []
    sync(device)
    t0 = time.perf_counter()
    for i in range(n):
        t1 = time.perf_counter()
        with slam.timer.span("frame"):
            track(slam, i)
            if block:
                slam.t_cw.cpu()
        lat.append((time.perf_counter() - t1) * 1e3)
    sync(device)
    return slam, time.perf_counter() - t0, np.array(lat)


def main(pass_name="stereo", frames=130, warmup=None, device="cuda", small=False, out=None, log=print) -> dict:
    cfg = cs.loop_config(small) if pass_name == "stereo" else cs.si_config(small)
    track = render(pass_name, cfg, frames, device)
    log(f"device: {card_and_limit(device)}; pass {pass_name}, {frames} frames")
    if warmup != 0:
        run_pass(cfg, track, frames if warmup is None else warmup, device, block=False, timer=False)
    result = {"pass": pass_name, "frames": frames, "device": card_and_limit(device)}
    for mode, block in (("throughput", False), ("blocking", True)):
        slam, wall, lat = run_pass(cfg, track, frames, device, block=block, timer=True)
        rec = dict(frames_per_s=frames / wall, wall_s=wall, keyframes=slam.n_kf, state=int(slam.state),
                   spans=slam.timer.summary())
        log(f"=== {mode} mode ===")
        log(slam.timer.report())
        log(f"fps={rec['frames_per_s']:.2f}  wall={wall:.2f}s  kf={slam.n_kf}  state={slam.state}")
        if block:
            tail = lat[5:] if lat.size > 5 else lat
            rec.update({f"p{q}_ms": float(np.percentile(tail, q)) for q in (50, 90, 99)}, max_ms=float(tail.max()))
            rec["slowest_frames"] = [[int(i), float(lat[i])] for i in sorted(np.argsort(lat)[-10:])]
            log(f"p50={rec['p50_ms']:.1f} p90={rec['p90_ms']:.1f} p99={rec['p99_ms']:.1f} max={rec['max_ms']:.1f}")
            log(f"slowest frames: {[(i, round(v, 1)) for i, v in rec['slowest_frames']]}")
        result[mode] = rec
        del slam
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pass", dest="pass_name", choices=["stereo", "si"], default="stereo")
    parser.add_argument("--frames", type=int, default=130)
    parser.add_argument("--warmup", type=int, default=None, help="warm-up frames (default: all)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=None, help="also write the result (JSON) here")
    args = parser.parse_args()
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        sys.exit("torch_prof_stages: CUDA is not available")
    main(args.pass_name, args.frames, args.warmup, args.device, out=args.out)
