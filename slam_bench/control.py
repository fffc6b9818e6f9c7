"""Readings of the program and of the control, over many seeds in one
process, to set the limits of ``correct`` (PERF.md gives the readings and
the limits set from them).

    python3 slam_bench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...] [--fault NAME] [--out FILE]

For each seed it runs the cell as ``run.py`` does (set-up, the measured
window, the comparison with the plain reference) and also the control:
the reference put in the program's place with one guarantee of the
configuration broken, read by the same comparison (``harness.compare``):

- ``ate_mm``: every frame answered with its latest keyframe's true pose
  (the per-frame pose left out);
- ``desc_bits``: the reference rBRIEF compared in float8 (e4m3), the
  precision below the bfloat16 the descriptor states;
- ``kp_bad_pct``: the reference's FAST corners at the minimum threshold,
  as many as the program kept on each level, with the non-maximum
  suppression left out;
- ``reproj_px``: the reference map (scene points at the observed pixels)
  with each keyframe left at its predecessor's pose;
- ``ba_gap_pct``: the reference map with bundle adjustment left out (each
  landmark where its first stereo observation puts it from its
  keyframe's true pose), judged from the true poses;
- ``depth_err_pct`` (read, not compared: it reads under three times the
  program's): the true disparity rounded to whole pixels (the sub-pixel
  refinement left out);
- ``preint_rel_err``: the reference integration carried out in bfloat16,
  the precision below float32.

``--fault`` plants a fault in the program first (``sut.FAULTS``), so that
its readings show which number catches it. The run's own limits are not
applied here. Needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--fault", default=None, help="a fault of sut.FAULTS")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    from slam_bench import harness, sut

    if args.fault:
        sut.FAULTS[args.fault]()
    rows = []
    for seed in args.seeds:
        res = harness.run_cell(args.workload, seed, args.seconds, False, control=True, limits={})
        row = {"seed": seed, "fault": args.fault, "program": res["readings"], "control": res["control"],
               "frames_per_s": res["metrics"].get("frames_per_s", {}).get("value"),
               "setup_s": res["metrics"].get("setup_s", {}).get("value"),
               "attempted": res["attempted"], "failed": res["failed"], "device": res["device"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
