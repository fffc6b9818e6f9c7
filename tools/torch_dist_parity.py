"""The port's sharded VI solver against the JAX reference's, on the CPU.

Run from the root of a checkout where both packages import (JAX on the CPU):

    JAX_PLATFORMS=cpu python tools/torch_dist_parity.py [--devices 8 2] [--iters 4]

``parallel/dist_vi_ba.distributed_vi_ba_cg`` of each package on the VI
problem of ``tests/test_dist_ba.py`` (``test_vi_ba.build_vi_problem``,
6 keyframes, 150 landmarks, perturbed from ``PRNGKey(21)``): the
reference's on ``make_mesh(n)`` of XLA's virtual CPU devices, the port's on
n shards of the CPU, and the port's one-device ``vi_bundle_adjust_cg``.
Prints one JSON line per mesh size with the largest differences of body
positions (m), rotations (matrix entries), velocities, biases and
landmarks (m), and how far the reference's solve moved the positions.
The reference compiles its sharded program over the n devices for
minutes, which is why the tier-1 tests leave this comparison here.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))


def main(devices=(8, 2), iters=4):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_force_host_platform_device_count={max(devices)}").strip()
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    import test_vi_ba
    from orb_slam3_detailed_comments_kor_tpu.optim import vi_ba as jvb
    from orb_slam3_detailed_comments_kor_tpu.parallel import dist_ba as jdist
    from orb_slam3_detailed_comments_kor_tpu.parallel import dist_vi_ba as jdvb
    from orb_slam3_detailed_comments_kor_tpu.utils import lie as jlie
    from orb_slam3_detailed_comments_kor_tpu_torch.optim import factors as tf
    from orb_slam3_detailed_comments_kor_tpu_torch.optim import vi_ba as tvb
    from orb_slam3_detailed_comments_kor_tpu_torch.parallel import dist_vi_ba as tdvb

    jax.config.update("jax_platforms", "cpu")
    st_gt, X_gt, obs, edges = test_vi_ba.build_vi_problem(n_kf=6)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(21), 3)
    xi = 0.01 * jax.random.normal(k1, (6, 6)).at[0].set(0.0)
    dR, dt = jlie.se3_exp(xi)
    st0 = st_gt._replace(R_bw=dR @ st_gt.R_bw, t_bw=jnp.einsum("kij,kj->ki", dR, st_gt.t_bw) + dt,
                         v=st_gt.v + 0.05 * jax.random.normal(k2, st_gt.v.shape))
    X0 = X_gt + 0.02 * jax.random.normal(k3, X_gt.shape)
    fixed_kf = jnp.zeros((6,), bool).at[0].set(True)
    fixed_point = jnp.zeros((X0.shape[0],), bool)
    kw = dict(gyro_walk_info=jvb.WALK_INFO_CAP, acc_walk_info=jvb.WALK_INFO_CAP, iters=iters)
    args = (test_vi_ba.CAM, jnp.eye(3), jnp.zeros(3), test_vi_ba.BF, test_vi_ba.G)

    def T(a):
        a = np.asarray(a)
        return torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a.copy())

    t_st = tvb.VIState(*(T(x) for x in st0))
    t_obs = tf.Observations(*(None if x is None else T(x) for x in obs))
    t_edges = tvb.InertialEdges(*(T(x) for x in edges))
    t_args = tuple(T(a) if hasattr(a, "shape") else a for a in args)
    single = tvb.vi_bundle_adjust_cg(t_st, T(X0), t_obs, t_edges, T(fixed_kf), T(fixed_point), *t_args,
                                     cg_iters=24, **kw)
    body = lambda st: -np.einsum("kji,kj->ki", np.asarray(st.R_bw), np.asarray(st.t_bw))
    rows = []
    for n in devices:
        t0 = time.time()
        ref = jdvb.distributed_vi_ba_cg(jdist.make_mesh(n), st0, X0, obs, edges, fixed_kf, fixed_point, *args, **kw)
        ref = jax.tree.map(np.asarray, ref)
        ref_s = time.time() - t0
        port = tdvb.distributed_vi_ba_cg([torch.device("cpu")] * n, t_st, T(X0), t_obs, t_edges, T(fixed_kf),
                                         T(fixed_point), *t_args, **kw)

        def gaps(a, b):
            return dict(body_pos_m=float(np.abs(body(a[0]) - body(b[0])).max()),
                        R=float(np.abs(np.asarray(a[0].R_bw) - np.asarray(b[0].R_bw)).max()),
                        vel=float(np.abs(np.asarray(a[0].v) - np.asarray(b[0].v)).max()),
                        bias=float(max(np.abs(np.asarray(a[0].bg) - np.asarray(b[0].bg)).max(),
                                       np.abs(np.asarray(a[0].ba) - np.asarray(b[0].ba)).max())),
                        points_m=float(np.abs(np.asarray(a[1]) - np.asarray(b[1])).max()))
        row = dict(devices=n, iters=iters, port_vs_reference=gaps(port, ref),
                   port_vs_port_one_device=gaps(port, single),
                   reference_moved_m=float(np.abs(body(ref[0]) - body(st0)).max()), reference_s=round(ref_s, 1))
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, nargs="+", default=[8, 2])
    ap.add_argument("--iters", type=int, default=4)
    a = ap.parse_args()
    main(tuple(a.devices), a.iters)
