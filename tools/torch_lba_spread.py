"""Run-to-run spread and device time of one local-BA slice on the card.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 tools/torch_lba_spread.py [--root DIR] [--runs 4]

Imports the port and ``chip_smoke.py`` from DIR (default: the checkout
this file sits in; an earlier commit unpacked with ``git archive`` works
too, as long as its ``chip_smoke.py`` has ``loop_config``,
``render_loop_sequence``, ``run_loop`` and ``profiled_device_ms``). Builds
the map of chip_smoke.py phase 4's first frames (bench.py's stereo
configuration, loop closing off, 24 strafe frames rendered on the card,
then a decision flush), runs the newest keyframe's local-BA slice (window
8, 2 LM iterations, the system's own arguments) ``--runs`` times on the
same inputs and prints one JSON line: the card's name and power limit,
the largest differences of any run from the first (pose translations,
rotation entries, landmark positions, observation slots), and the slice's
device ms (torch.profiler's CUDA activity, median of 3 calls).
"""

import argparse
import json
import os
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--frames", type=int, default=24)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_lba_spread: CUDA is not available")
    import chip_smoke
    from orb_slam3_detailed_comments_kor_tpu_torch.slam import tracking

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda:0")
    cfg = chip_smoke.loop_config()
    _, frames = chip_smoke.render_loop_sequence(cfg, args.frames, dev)
    slam, _ = chip_smoke.run_loop(cfg, frames, dev, loop_closing=False)
    slam.flush_decisions()
    ms, kf, cap = slam.ms, slam.n_kf - 1, cfg.capacity

    def slice_():
        return tracking.local_ba_step(ms, kf, slam.cam_params, cfg.camera.bf, window=min(8, cap.max_local_kfs),
                                      lm_cap=cap.max_local_landmarks, iters=2)

    outs = [slice_() for _ in range(args.runs)]
    torch.cuda.synchronize()

    def err(a, b):
        return float((a.double() - b.double()).abs().max())

    first = outs[0]
    spread = dict(
        pose_t_m=max(err(o.kf_t_cw, first.kf_t_cw) for o in outs[1:]),
        pose_R=max(err(o.kf_R_cw, first.kf_R_cw) for o in outs[1:]),
        points_m=max(err(o.lm_pos, first.lm_pos) for o in outs[1:]),
        obs_differ=max(int((o.obs_lm != first.obs_lm).sum()) for o in outs[1:]),
    )
    moved = dict(pose_t_m=err(first.kf_t_cw, ms.kf_t_cw), points_m=err(first.lm_pos, ms.lm_pos))
    print(json.dumps({"root": root, "card": smi, "keyframes": slam.n_kf, "runs": args.runs, "spread": spread,
                      "slice_moved": moved, "slice_device_ms": chip_smoke.profiled_device_ms(slice_)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
