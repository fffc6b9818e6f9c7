"""Observation-sharded whole-map visual-inertial BA over a mesh of devices.

Port of ``orb_slam3_detailed_comments_kor_tpu/parallel/dist_vi_ba.py``
(``Optimizer::FullInertialBA``, ``src/Optimizer.cc:397``, at mesh scale):
the visual observation table is sharded as in :mod:`parallel.dist_ba`;
the preintegration chain, the bias random walks and the bias priors (K−1
edges) are computed once, on ``mesh[0]``, with the reduced [K,15] system.
The solver is ``optim/vi_ba.py``'s PCG solver run over the shards: a
one-device mesh gives its bits.
"""

from __future__ import annotations

import torch

from orb_slam3_detailed_comments_kor_tpu_torch.optim import ba, vi_ba
from orb_slam3_detailed_comments_kor_tpu_torch.optim.factors import Observations
from orb_slam3_detailed_comments_kor_tpu_torch.parallel.dist_ba import resolve_mesh, shard_observations
from orb_slam3_detailed_comments_kor_tpu_torch.slam import inertial


def distributed_vi_ba_cg(
    mesh,
    st: vi_ba.VIState,
    X: torch.Tensor,
    obs: Observations,
    edges: vi_ba.InertialEdges,
    fixed_kf: torch.Tensor,
    fixed_point: torch.Tensor,
    cam_params: torch.Tensor,
    R_cb: torch.Tensor,
    t_cb: torch.Tensor,
    bf,
    gravity: torch.Tensor,
    gyro_walk_info: float,
    acc_walk_info: float,
    prior_bg_info: float = 0.0,
    prior_ba_info: float = 0.0,
    iters: int = 4,
    cg_iters: int = 24,
    cam_model: str = "pinhole",
    rig=None,
):
    """Sharded matrix-free PCG Schur VI-LM (the counterpart of
    :func:`optim.vi_ba.vi_bundle_adjust_cg`: the same state, factors and
    [K,15] tangent ordering). Returns (VIState, X) refined, on the inputs'
    device."""
    dev0 = mesh[0]
    st_f, X_f, _ = vi_ba._vi_bundle_adjust_cg_shards(
        ba._to(st, dev0), ba._to(X, dev0), shard_observations(obs, mesh), ba._to(edges, dev0),
        *ba._to((fixed_kf, fixed_point, cam_params, R_cb, t_cb), dev0), bf, ba._to(gravity, dev0),
        gyro_walk_info, acc_walk_info, prior_bg_info, prior_ba_info, iters, cg_iters, cam_model,
        ba._to(rig, dev0))
    return ba._to(st_f, X.device), ba._to(X_f, X.device)


#: the mesh of the inertial GBA's sharded branch; None: ``make_mesh`` for
#: the map's device (every visible card, as the reference takes every JAX
#: device; one shard on the CPU)
_VI_GBA_MESH = None


def distributed_full_inertial_ba(
    ms, ikf, gravity, cam_params, R_cb, t_cb, bf,
    prior_bg_info=0.0, prior_ba_info=0.0, iters: int = 2,
    cam_model: str = "pinhole", rig=None,
):
    """Mesh-routed FullInertialBA (``LoopClosing.cc:2287-2289``): the
    whole-map problem of ``inertial.full_inertial_ba`` solved sharded over
    ``_VI_GBA_MESH``. Returns (ms', ikf', None)."""
    st, obs, edges, fixed_kf, fixed_point = inertial.build_fiba_problem(ms, ikf, R_cb, t_cb, rig=rig)
    st_f, X_f = distributed_vi_ba_cg(
        resolve_mesh(_VI_GBA_MESH, ms.lm_pos.device), st, ms.lm_pos, obs, edges, fixed_kf, fixed_point,
        cam_params, R_cb, t_cb, bf, gravity,
        gyro_walk_info=vi_ba.WALK_INFO_CAP, acc_walk_info=vi_ba.WALK_INFO_CAP,
        prior_bg_info=prior_bg_info, prior_ba_info=prior_ba_info,
        iters=iters, cam_model=cam_model, rig=rig,
    )
    ms, ikf = inertial.apply_fiba_result(ms, ikf, st_f, X_f, fixed_kf, R_cb, t_cb)
    return ms, ikf, None
