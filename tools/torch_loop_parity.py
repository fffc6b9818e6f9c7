"""The port's SLAM loop against the JAX reference's, per frame, on the CPU.

Run from the root of a checkout where both packages import (JAX on the CPU):

    JAX_PLATFORMS=cpu python tools/torch_loop_parity.py [--frames 16] [--scatter last|park]

Both ``SlamSystem``s take the same stereo pairs of the strafe sequence in
``chip_smoke.loop_config(small=True)`` (240x376, 600 features, 8 keyframe
slots, a keyframe every second frame, decision batch 1). Prints one JSON
line: keyframe frames, lifecycle counters, per-frame camera-centre (m) and
rotation (rad) differences of the final trajectories, the largest inlier
difference per decision, landmark counts and both ATEs.

``--units`` prints instead the largest differences of ``bundle_adjust`` and
``local_ba_step`` on the synthetic windows of ``tests/test_torch_ba.py``
and ``tests/test_torch_mapping.py``.

``--scatter park`` runs the port with its two duplicate-index scatters
(``make_keyframe``'s feature inversion and ``local_ba_step``'s refined
points) resolved by parking every duplicate write, where the default
keeps the last write, as the reference's CPU scatter does.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def to_jax_config(cfg):
    """The reference's config dataclasses with the port config's values."""
    from orb_slam3_detailed_comments_kor_tpu import config as jcfg

    if dataclasses.is_dataclass(cfg):
        cls = getattr(jcfg, type(cfg).__name__)
        return cls(**{f.name: to_jax_config(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)})
    return cfg


def park_duplicate_scatters():
    """Point the port's duplicate-index scatters at a parking variant: for
    each destination, only a write that is the one the caller wants lands
    (make_keyframe: only matched landmarks write; local BA: only used slots
    write)."""
    from orb_slam3_detailed_comments_kor_tpu_torch.slam import map_state as msx

    last = msx.scatter_last

    def parked(arr, idx, vals):
        if vals.dtype == torch.bool or arr.dtype == torch.int32:
            # make_keyframe: unmatched landmarks write -1 / False: drop them
            keep = vals if vals.dtype == torch.bool else vals >= 0
        else:
            # local BA: unused slots write landmark 0's old position
            keep = torch.ones(idx.shape[0], dtype=torch.bool, device=idx.device)
            keep[1:] = idx[1:] != 0
        return last(arr, torch.where(keep, idx, arr.shape[0]), vals)

    msx.scatter_last = parked


def units() -> int:
    """bundle_adjust (10 iterations) and local_ba_step (2) of both packages on
    the tests' windows: the largest rotation, translation and point
    differences, chi2 beyond rtol 1e-3, and the inlier agreement."""
    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))
    import test_torch_ba as tb
    import test_torch_mapping as tm
    from orb_slam3_detailed_comments_kor_tpu.optim import ba as jba
    from orb_slam3_detailed_comments_kor_tpu_torch.optim import ba as tba

    T = torch.from_numpy
    out = {"bundle_adjust": {}, "local_ba_step": {}}
    for seed in (0, 1, 2):
        w = tb.make_window(seed)
        j = [np.asarray(x) for x in jba.bundle_adjust(
            jnp.asarray(w["R"]), jnp.asarray(w["t"]), jnp.asarray(w["X"]), tb.jax_obs(w),
            jnp.asarray(w["fixed_pose"]), jnp.asarray(w["fixed_point"]), jnp.asarray(tb.CAM), tb.BF, iters=10)]
        t = [x.numpy() for x in tba.bundle_adjust(
            T(w["R"]), T(w["t"]), T(w["X"]), tb.torch_obs(w), T(w["fixed_pose"]), T(w["fixed_point"]),
            T(tb.CAM), tb.BF, iters=10)]
        out["bundle_adjust"][seed] = dict(
            rotation_rad=float(tb.rotation_angles(j[0], t[0]).max()), translation_m=float(np.abs(j[1] - t[1]).max()),
            point_m=float(np.abs(j[2] - t[2]).max()),
            chi2_beyond_rtol=float((np.abs(j[3] - t[3]) - 1e-3 * np.abs(j[3])).max()),
            inlier_agreement=float((j[4] == t[4]).mean()))
    for seed in (20, 21):
        jn, tn = tm._local_ba(tm.geometric_map(seed))
        out["local_ba_step"][seed] = dict(
            rotation_rad=float(tm.rotation_angles(jn["kf_R_cw"], tn["kf_R_cw"]).max()),
            translation_m=float(np.abs(jn["kf_t_cw"] - tn["kf_t_cw"]).max()),
            point_m=float(np.abs(jn["lm_pos"] - tn["lm_pos"]).max()))
    print(json.dumps(out))
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, default=16)
    parser.add_argument("--scatter", choices=("last", "park"), default="last")
    parser.add_argument("--units", action="store_true", help="BA and local-BA differences only")
    args = parser.parse_args()
    if args.units:
        return units()

    import jax.numpy as jnp

    import chip_smoke as cs
    from orb_slam3_detailed_comments_kor_tpu.io import synthetic as jsyn
    from orb_slam3_detailed_comments_kor_tpu.slam.system import SlamSystem as JaxSlam
    from orb_slam3_detailed_comments_kor_tpu_torch.eval import ate
    from orb_slam3_detailed_comments_kor_tpu_torch.slam.system import SlamSystem as TorchSlam

    if args.scatter == "park":
        park_duplicate_scatters()
    cfg = cs.loop_config(small=True)
    cam = cfg.camera
    params = jnp.array([cam.fx, cam.fy, cam.cx, cam.cy])
    scene = jsyn.default_scene()
    Rs, ts = jsyn.make_trajectory(args.frames, motion="strafe", speed=cs.SPEED)
    imgs = [tuple(np.array(x) for x in jsyn.stereo_pair(
        params, jnp.asarray(Rs[i]), jnp.asarray(ts[i]), cs.BASELINE, scene, h=cam.height, w=cam.width)[:2])
        for i in range(args.frames)]

    def run(system):
        decisions, kf_at = [], []
        decide = system._decide

        def spy(frame, tr, t, n_inliers=None, dispatch_idx=None):
            decisions.append(n_inliers)
            return decide(frame, tr, t, n_inliers=n_inliers, dispatch_idx=dispatch_idx)

        system._decide = spy
        for i, (il, ir) in enumerate(imgs):
            n0 = system.stats["kf_inserted"]
            system.track_stereo(il, ir, i / cs.FPS)
            if system.stats["kf_inserted"] != n0:
                kf_at.append(i)
        traj = system.trajectory_arrays()
        return dict(traj=traj, kf_at=kf_at, decisions=decisions, stats=dict(system.stats),
                    landmarks=system.map_stats()["n_landmarks"], ate_m=ate.ate_rmse(traj[1], ts))

    jax_system = JaxSlam(to_jax_config(cfg))
    jax_system.enable_loop_closing = False
    j = run(jax_system)
    t = run(TorchSlam(cfg, device="cpu"))
    d_c, d_r = cs.trajectory_diff(j["traj"], t["traj"])
    print(json.dumps({
        "frames": args.frames, "scatter": args.scatter,
        "keyframes": {"jax": j["kf_at"], "port": t["kf_at"]},
        "stats": {"jax": j["stats"], "port": t["stats"]},
        "centre_diff_m": d_c.tolist(), "rotation_diff_rad": d_r.tolist(),
        "max_centre_diff_m": float(d_c.max()), "max_rotation_diff_rad": float(d_r.max()),
        "max_inlier_diff": max(abs(a - b) for a, b in zip(j["decisions"], t["decisions"])),
        "landmarks": {"jax": j["landmarks"], "port": t["landmarks"]},
        "ate_m": {"jax": j["ate_m"], "port": t["ate_m"]},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
