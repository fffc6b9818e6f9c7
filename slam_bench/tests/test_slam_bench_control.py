"""On the card, at each cell's own size: the program's readings stay
within the cell's limits and the control's (the reference put in the
program's place with one guarantee broken, ``control.py``) exceed every
one of them, on three seeds. Skipped without a card; run on the card with
``python -m pytest --noconftest -o addopts="" -m cuda slam_bench/tests``."""

import json

import pytest

from slam_bench import harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]
SEEDS = (2147470001, 2147470002, 2147470003)
# the cells' own window: a shorter one can hold no stereo-inertial keyframe
WINDOW_S = float(harness.benchmark()["run_seconds"])


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's size on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_program_within_limits_control_beyond(card, cell):
    lim = harness.load_json(harness.limits_file(cell))
    for seed in SEEDS:
        res = harness.run_cell(cell, seed, WINDOW_S, False, control=True)
        print(json.dumps({"cell": cell, "seed": seed, "program": res["readings"], "control": res["control"]}))
        assert res["correct"], (seed, res["checks"])
        over = {k: res["control"][k] for k in lim if res["control"][k] is not None and res["control"][k] > lim[k]}
        assert set(over) == set(lim), (seed, res["control"], lim)
