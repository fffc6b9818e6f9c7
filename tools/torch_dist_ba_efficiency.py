"""Sharded GBA against the one-device solve: the port of
``tools/dist_ba_efficiency.py``.

The reference's problem, seeded the same way: K=128 keyframes, L=32,768
landmarks seen 8 times each (262,144 observation rows), 4 LM iterations of
24 PCG steps each. It solves it once with ``optim.ba.bundle_adjust_cg``
(one device), then with ``parallel.dist_ba.distributed_bundle_adjust_cg``
on meshes of 2, 4 and 8 shards, and reports each solve's wall time
(warm, the mean of ``--reps`` runs, each ended by a synchronize), the
speed-up and efficiency against one device, and ``max_dX_vs_single``, the
largest landmark difference from the one-device solve.

Every shard of a mesh here lies on the one ``--device``: the CPU (the
reference's own proxy, there 8 virtual XLA devices) or one card. Shards of
one device run one after another, so the rows measure what sharding costs
and whether it keeps the bits, not how the solve scales across devices.

Run (on the card; ``--device cpu`` on the CPU):
    python3 tools/torch_dist_ba_efficiency.py [--out dist_ba_efficiency.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from orb_slam3_detailed_comments_kor_tpu_torch.optim import ba, factors  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu_torch.parallel import dist_ba  # noqa: E402
from torch_eval_vocab import card_and_limit  # noqa: E402

K, L, OBS_PER, ITERS, CG = 128, 32768, 8, 4, 24
SCALING_NOTE = ("every shard lies on one device: the rows measure the cost of sharding and its bits, "
                "not scaling across devices")


def make_problem(k=K, n_lm=L, obs_per=OBS_PER, seed=0, device="cuda"):
    """The reference's ``make_problem``: the same numpy draws in the same
    order, the same float32 arithmetic. Returns (R, t, X, obs, fixed_pose,
    fixed_point, cam) on ``device``."""
    rng = np.random.default_rng(seed)
    X = torch.from_numpy(rng.uniform(-5, 5, (n_lm, 3)).astype(np.float32))
    R = torch.eye(3).expand(k, 3, 3).contiguous()
    t = torch.from_numpy(rng.uniform(-1, 1, (k, 3)).astype(np.float32))
    kf = torch.from_numpy(rng.integers(0, k, (n_lm * obs_per,)).astype(np.int32))
    lm = torch.from_numpy(np.repeat(np.arange(n_lm), obs_per).astype(np.int32))
    pc = X[lm.long()] + t[kf.long()]
    uv = 400.0 * pc[:, :2] / torch.clamp(pc[:, 2:3], min=0.5) + 300.0
    uv = uv + torch.from_numpy(rng.normal(0, 0.5, tuple(uv.shape)).astype(np.float32))
    n = n_lm * obs_per
    obs = factors.Observations(kf=kf, lm=lm, uv=uv, u_right=-torch.ones((n,)), inv_sigma2=torch.ones((n,)),
                               valid=torch.ones((n,), dtype=torch.bool))
    cam = torch.tensor([400.0, 400.0, 376.0, 240.0])
    fp = torch.zeros((k,), dtype=torch.bool)
    fp[0] = True
    fl = torch.zeros((n_lm,), dtype=torch.bool)
    dev = torch.device(device)
    obs = factors.Observations(*(None if x is None else x.to(dev) for x in obs))
    return R.to(dev), t.to(dev), X.to(dev), obs, fp.to(dev), fl.to(dev), cam.to(dev)


def timeit(fn, device, reps=3):
    """(mean wall seconds of ``reps`` warm runs, each ended by a
    synchronize; the last result)."""
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    out = fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
        sync()
    return (time.perf_counter() - t0) / reps, out


def main(device="cuda", shards=(2, 4, 8), k=K, n_lm=L, obs_per=OBS_PER, iters=ITERS, cg=CG, reps=3,
         out=None, log=print) -> dict:
    R, t, X, obs, fp, fl, cam = make_problem(k, n_lm, obs_per, device=device)
    t1, ref = timeit(lambda: ba.bundle_adjust_cg(R, t, X, obs, fp, fl, cam, 45.0, iters=iters, cg_iters=cg),
                     device, reps)
    rows = [{"devices": 1, "ms": t1 * 1e3, "speedup": 1.0, "efficiency": 1.0, "impl": "single-device solve"}]
    for n in shards:
        mesh = [torch.device(device)] * n
        tn, res = timeit(lambda m=mesh: dist_ba.distributed_bundle_adjust_cg(
            m, R, t, X, obs, fp, fl, cam, 45.0, iters=iters, cg_iters=cg), device, reps)
        rows.append({"devices": n, "ms": tn * 1e3, "speedup": t1 / tn, "efficiency": t1 / tn / n,
                     "max_dX_vs_single": float(torch.max(torch.abs(res[2] - ref.X))),
                     "impl": f"observation-sharded, {n} shards of one device"})
    result = {"problem": f"K={k} L={n_lm} obs={n_lm * obs_per} iters={iters} cg={cg}",
              "platform": torch.device(device).type, "device": card_and_limit(device), "note": SCALING_NOTE,
              "rows": rows}
    log(json.dumps(result, indent=2))
    log(f"note: {SCALING_NOTE}")
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=None, help="also write the result (JSON) here")
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args()
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        sys.exit("torch_dist_ba_efficiency: CUDA is not available")
    main(device=args.device, reps=args.reps, out=args.out)
