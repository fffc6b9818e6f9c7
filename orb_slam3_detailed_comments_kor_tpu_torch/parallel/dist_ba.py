"""Observation-sharded bundle adjustment over a mesh of devices.

Port of ``orb_slam3_detailed_comments_kor_tpu/parallel/dist_ba.py``. A
mesh is an ordered list of ``torch.device``s that one process drives; one
device may appear more than once. The flat observation table is padded to
a multiple of the mesh size and split into equal contiguous blocks, block
``i`` on ``mesh[i]`` (the partition ``shard_map`` over ``P('obs')`` gives
the reference). Each block evaluates its residuals and Jacobians and sums
its normal-equation blocks per keyframe and per landmark; the partial sums
are copied to ``mesh[0]`` and added in shard order (the reference's
``psum``), so the sum is the same on every run. The reduced camera system
is solved once, on ``mesh[0]``, where the state lives, and what the blocks
need of it is copied to them.

The solvers are the one-device solvers of ``optim/ba.py`` run over the
shards (``ba.Shards``): a one-device mesh gives their bits.
"""

from __future__ import annotations

from typing import Tuple

import torch

from orb_slam3_detailed_comments_kor_tpu_torch.optim import ba
from orb_slam3_detailed_comments_kor_tpu_torch.optim.factors import Observations


def make_mesh(n_devices: int | None = None, device="cuda") -> list:
    """A mesh for work on ``device``: on CUDA the visible cards, that
    device first, the first ``n_devices`` of them (all by default); on the
    CPU ``n_devices`` shards of the CPU (one by default)."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * (n_devices or 1)
    first = device.index if device.index is not None else torch.cuda.current_device()
    cards = [first] + [i for i in range(torch.cuda.device_count()) if i != first]
    return [torch.device("cuda", i) for i in cards[:n_devices]]


def resolve_mesh(mesh, device) -> list:
    """``mesh``, or ``make_mesh`` for ``device`` when it is None."""
    return make_mesh(device=device) if mesh is None else list(mesh)


def pad_obs_to_devices(obs: Observations, n_dev: int) -> Observations:
    """Pad the observation table so its length divides the mesh size; the
    padded rows are invalid and mono (``u_right`` -1)."""
    pad = (-obs.kf.shape[0]) % n_dev
    if pad == 0:
        return obs

    def f(x, value=0):
        return torch.cat([x, torch.full((pad,) + x.shape[1:], value, dtype=x.dtype, device=x.device)])

    return Observations(
        kf=f(obs.kf), lm=f(obs.lm), uv=f(obs.uv), u_right=f(obs.u_right, -1.0),
        inv_sigma2=f(obs.inv_sigma2), valid=f(obs.valid, False),
        cam=None if obs.cam is None else f(obs.cam),
    )


def shard_observations(obs: Observations, mesh) -> ba.Shards:
    """The padded table split into len(mesh) contiguous blocks, block i on
    mesh[i], with int64 index columns."""
    n = len(mesh)
    obs = pad_obs_to_devices(obs, n)
    obs = obs._replace(kf=obs.kf.to(torch.int64), lm=obs.lm.to(torch.int64))
    m = obs.kf.shape[0] // n
    blocks = tuple(
        Observations(*(None if x is None else x[i * m:(i + 1) * m].to(d, non_blocking=True) for x in obs))
        for i, d in enumerate(mesh))
    return ba.Shards(blocks, tuple(mesh))


def distributed_bundle_adjust(
    mesh,
    R_cw: torch.Tensor,
    t_cw: torch.Tensor,
    X: torch.Tensor,
    obs: Observations,
    fixed_pose: torch.Tensor,
    fixed_point: torch.Tensor,
    cam_params: torch.Tensor,
    bf: float,
    iters: int = 10,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sharded LM-BA with the dense block-Schur reduced system (local-BA
    scale: each shard's [K,6,L,3] coupling is reduced with the other
    blocks). Returns (R_cw, t_cw, X) refined, on the inputs' device."""
    dev0 = mesh[0]
    R, t, Xc, _ = ba._bundle_adjust_shards(
        *ba._to((R_cw, t_cw, X), dev0), shard_observations(obs, mesh),
        *ba._to((fixed_pose, fixed_point, cam_params), dev0), bf, iters, use_huber=True, cam_model="pinhole",
        rig=None)
    return ba._to((R, t, Xc), X.device)


def distributed_bundle_adjust_cg(
    mesh,
    R_cw: torch.Tensor,
    t_cw: torch.Tensor,
    X: torch.Tensor,
    obs: Observations,
    fixed_pose: torch.Tensor,
    fixed_point: torch.Tensor,
    cam_params: torch.Tensor,
    bf: float,
    iters: int = 8,
    cg_iters: int = 20,
    cam_model: str = "pinhole",
    rig=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GBA-scale sharded LM-BA: matrix-free PCG on the reduced camera
    system. Each shard keeps its rows' coupling blocks w·Jpᵀ·Jl, so a
    Schur product is two reductions ([L,3] and [K,6]) and two copies of
    the CG vector. Returns (R_cw, t_cw, X) refined, on the inputs'
    device."""
    dev0 = mesh[0]
    R, t, Xc, _ = ba._bundle_adjust_cg_shards(
        *ba._to((R_cw, t_cw, X), dev0), shard_observations(obs, mesh),
        *ba._to((fixed_pose, fixed_point, cam_params), dev0), bf, iters, cg_iters, use_huber=True,
        cam_model=cam_model, rig=ba._to(rig, dev0))
    return ba._to((R, t, Xc), X.device)
