"""One step of each sharded solver over a mesh, at the sizes of the
multi-device dry run of the reference's ``__graft_entry__.py``
(``dryrun_multichip``): the dense block-Schur solver at local-BA scale, the
matrix-free PCG solver at GBA scale (the dense coupling would be
[128,6,32768,3], never formed) and the sharded FullInertialBA solver on a
static chain.

Usage:  python -m orb_slam3_detailed_comments_kor_tpu_torch.parallel.dryrun [n_shards]
(every shard on the first card; ``dryrun_multichip(mesh)`` takes any mesh).
"""

from __future__ import annotations

import sys

import torch

from orb_slam3_detailed_comments_kor_tpu_torch.optim import ba, factors, vi_ba
from orb_slam3_detailed_comments_kor_tpu_torch.parallel import dist_ba, dist_vi_ba

CAM = (230.0, 230.0, 188.0, 120.0)
BF = 25.3
#: (keyframes, landmarks, observations per keyframe, LM iterations[, CG iterations])
DENSE = (4, 64, 64, 2)
GBA = (128, 32768, 2048, 1, 8)
INERTIAL = (32, 8192, 1024, 1, 8)


def make_problem(K: int, L: int, obs_per_kf: int, seed: int, device):
    """Noise-free stereo observations of L random points (x, y in [-4, 4],
    z in [3, 10]) from K identity-rotation poses 0.5 m apart along x; the
    first pose fixed. Returns (R_cw, t_cw, X, obs, fixed_pose,
    fixed_point) on ``device``."""
    g = torch.Generator().manual_seed(seed)
    lo, hi = torch.tensor([-4.0, -4.0, 3.0]), torch.tensor([4.0, 4.0, 10.0])
    X = lo + (hi - lo) * torch.rand((L, 3), generator=g)
    lm = torch.randint(0, L, (K * obs_per_kf,), generator=g)
    R_cw = torch.eye(3).expand(K, 3, 3).contiguous()
    t_cw = torch.stack([torch.linspace(0, 0.5, K), torch.zeros(K), torch.zeros(K)], dim=-1)
    kf = torch.arange(K).repeat_interleave(obs_per_kf)
    pc = (R_cw[kf] @ X[lm][..., None])[..., 0] + t_cw[kf]
    pred, _ = factors.project_with_jac(torch.tensor(CAM), pc, BF)
    obs = factors.Observations(kf=kf, lm=lm, uv=pred[:, :2], u_right=pred[:, 2],
                               inv_sigma2=torch.ones(kf.shape), valid=torch.ones(kf.shape, dtype=torch.bool))
    fixed_pose = torch.arange(K) == 0
    fixed_point = torch.zeros((L,), dtype=torch.bool)
    return ba._to((R_cw, t_cw, X, obs, fixed_pose, fixed_point), device)


def static_chain(K: int, device) -> vi_ba.InertialEdges:
    """K−1 identity preintegrations of 0.25 s between consecutive
    keyframes (the dry run's gravity is zero)."""
    E = K - 1
    z3, eye = torch.zeros((E, 3)), torch.eye(3).expand(E, 3, 3).contiguous()
    zm = torch.zeros((E, 3, 3))
    return ba._to(vi_ba.InertialEdges(
        i=torch.arange(E), j=torch.arange(1, K), dt=torch.full((E,), 0.25), dR=eye, dV=z3, dP=z3,
        info9=1e2 * torch.eye(9).expand(E, 9, 9).contiguous(), JRg=zm, JVg=zm, JVa=zm, JPg=zm, JPa=zm,
        bias_g0=z3, bias_a0=z3, valid=torch.ones((E,), dtype=torch.bool)), device)


def dryrun_cases(mesh, dense=DENSE, gba=GBA, inertial=INERTIAL) -> dict:
    """The three cases on ``mesh``, each a callable that runs its solve
    and returns its output tensors; problems are made once, on mesh[0]."""
    dev = mesh[0]
    cam = torch.tensor(CAM, device=dev)
    K, L, n, iters = dense
    p_dense = make_problem(K, L, n, 0, dev)
    K, L, n, iters_g, cg = gba
    p_gba = make_problem(K, L, n, 1, dev)
    K, L, n, iters_i, cg_i = inertial
    R_cw, t_cw, X, obs, fp, fl = make_problem(K, L, n, 2, dev)
    st = vi_ba.VIState(R_bw=R_cw, t_bw=t_cw, v=torch.zeros((K, 3), device=dev),
                       bg=torch.zeros((K, 3), device=dev), ba=torch.zeros((K, 3), device=dev))
    edges = static_chain(K, dev)
    eye, zero = torch.eye(3, device=dev), torch.zeros(3, device=dev)

    def vi():
        st_f, X_f = dist_vi_ba.distributed_vi_ba_cg(
            mesh, st, X, obs, edges, fp, fl, cam, eye, zero, BF, zero,
            gyro_walk_info=vi_ba.WALK_INFO_CAP, acc_walk_info=vi_ba.WALK_INFO_CAP, iters=iters_i, cg_iters=cg_i)
        return st_f.t_bw, st_f.v, X_f

    return {
        "dense": lambda: dist_ba.distributed_bundle_adjust(mesh, *p_dense[:4], *p_dense[4:], cam, BF, iters=iters),
        "gba_pcg": lambda: dist_ba.distributed_bundle_adjust_cg(mesh, *p_gba[:4], *p_gba[4:], cam, BF,
                                                                iters=iters_g, cg_iters=cg),
        "inertial": vi,
    }


def dryrun_multichip(mesh, dense=DENSE, gba=GBA, inertial=INERTIAL) -> dict:
    """Run each case once on ``mesh``; raise on a non-finite output.
    Returns each case's outputs."""
    out = {name: fn() for name, fn in dryrun_cases(mesh, dense, gba, inertial).items()}
    for name, tensors in out.items():
        for x in tensors:
            if not bool(torch.isfinite(x).all()):
                raise FloatingPointError(f"dryrun {name}: non-finite output on {len(mesh)} shards")
    return out


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1
    res = dryrun_multichip([torch.device("cuda", 0)] * n)
    print(f"dryrun_multichip OK on {n} shards: t_cw={res['dense'][1][1].tolist()} "
          f"gba_t={res['gba_pcg'][1][1].tolist()} vi_t={res['inertial'][0][1].tolist()}")
