"""On-manifold IMU preintegration (Forster et al. TRO'17).

Port of ``orb_slam3_detailed_comments_kor_tpu/ops/imu.py``
(``IMU::Preintegrated``, ``include/ImuTypes.h:155-267``,
``src/ImuTypes.cc:224-335``): ΔR/ΔV/ΔP accumulation, the 9x9 covariance of
(φ, v, p) and the five bias Jacobians (JRg, JVg, JVa, JPg, JPa). A
measurement window has a fixed capacity and a validity mask; the reference
scans it with ``lax.scan``, the port runs a loop of that fixed length and
selects with ``torch.where``, so a padded sample leaves the state as it was
and nothing reads the device. ``integrate_j``/``compose_j`` are the
reference's ``jax.jit`` wrappers: the plain functions take their place.

Conventions: gravity is handled by the consumer (residuals subtract g·Δt in
the world frame); measurements are body-frame specific force and angular
rate.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from orb_slam3_detailed_comments_kor_tpu_torch.utils import lie


class ImuBatch(NamedTuple):
    """Fixed-capacity IMU measurement window (between two frames/KFs)."""

    acc: torch.Tensor    # [M,3]
    gyro: torch.Tensor   # [M,3]
    dt: torch.Tensor     # [M]
    valid: torch.Tensor  # [M] bool


class Preintegrated(NamedTuple):
    dt: torch.Tensor      # scalar total time
    dR: torch.Tensor      # [3,3]
    dV: torch.Tensor      # [3]
    dP: torch.Tensor      # [3]
    cov: torch.Tensor     # [9,9] for (φ, v, p)
    JRg: torch.Tensor     # [3,3] ∂ΔR/∂bg
    JVg: torch.Tensor     # [3,3]
    JVa: torch.Tensor     # [3,3]
    JPg: torch.Tensor     # [3,3]
    JPa: torch.Tensor     # [3,3]
    bias_g: torch.Tensor  # [3] linearization gyro bias
    bias_a: torch.Tensor  # [3] linearization acc bias


def identity_preintegrated(device="cuda", dtype=torch.float32) -> Preintegrated:
    z3 = torch.zeros((3, 3), dtype=dtype, device=device)
    return Preintegrated(
        dt=torch.zeros((), dtype=dtype, device=device),
        dR=torch.eye(3, dtype=dtype, device=device),
        dV=torch.zeros(3, dtype=dtype, device=device),
        dP=torch.zeros(3, dtype=dtype, device=device),
        cov=torch.zeros((9, 9), dtype=dtype, device=device),
        JRg=z3, JVg=z3, JVa=z3, JPg=z3, JPa=z3,
        bias_g=torch.zeros(3, dtype=dtype, device=device),
        bias_a=torch.zeros(3, dtype=dtype, device=device),
    )


def _blocks(rows):
    """A matrix from a list of rows of blocks."""
    return torch.cat([torch.cat(r, dim=-1) for r in rows], dim=-2)


def integrate(batch: ImuBatch, bias_g, bias_a, sigma_g: float, sigma_a: float) -> Preintegrated:
    """Integrate a measurement window at the given bias linearization point
    (``IntegrateNewMeasurement``, ``ImuTypes.cc:254``): per sample
      dP += dV·dt + ½·dR·a·dt²;  dV += dR·a·dt;  dR ← dR·Exp(w·dt)
    with the covariance propagated through the A/B system and the bias
    Jacobians updated recursively. The noise densities are already scaled
    by √freq by the caller."""
    dev, dt_ = batch.acc.device, batch.acc.dtype
    eye3 = torch.eye(3, dtype=dt_, device=dev)
    z3 = torch.zeros((3, 3), dtype=dt_, device=dev)
    Ng = (sigma_g ** 2) * eye3
    Na = (sigma_a ** 2) * eye3
    pre = identity_preintegrated(dev, dt_)._replace(bias_g=bias_g, bias_a=bias_a)
    for m in range(batch.acc.shape[0]):
        valid = batch.valid[m]
        dt = torch.where(valid, batch.dt[m], 0.0)
        a = batch.acc[m] - bias_a
        w = batch.gyro[m] - bias_g
        dt2 = dt * dt
        dRa = pre.dR @ a
        # position/velocity first (the pre-update dR)
        dP = pre.dP + pre.dV * dt + 0.5 * dRa * dt2
        dV = pre.dV + dRa * dt
        # covariance propagation (Forster eq. A.7-A.9, ImuTypes.cc:278-311)
        wdt = w * dt
        dRk = lie.so3_exp(wdt)
        Jr = lie.so3_right_jacobian(wdt)
        a_hat = lie.hat(a)
        Ra = pre.dR @ a_hat
        A = _blocks([
            [dRk.T, z3, z3],
            [-Ra * dt, eye3, z3],
            [-0.5 * Ra * dt2, eye3 * dt, eye3],
        ])
        B = _blocks([
            [Jr * dt, z3],
            [z3, pre.dR * dt],
            [z3, 0.5 * pre.dR * dt2],
        ])
        dt_floor = torch.clamp(dt, min=1e-9)
        Q = _blocks([[Ng / dt_floor, z3], [z3, Na / dt_floor]])
        cov = A @ pre.cov @ A.T + B @ Q @ B.T
        # bias Jacobians (ImuTypes.cc:313-320)
        RaJ = Ra @ pre.JRg
        new = Preintegrated(
            dt=pre.dt + dt, dR=pre.dR @ dRk, dV=dV, dP=dP, cov=cov,
            JRg=dRk.T @ pre.JRg - Jr * dt,
            JVg=pre.JVg - RaJ * dt,
            JVa=pre.JVa - pre.dR * dt,
            JPg=pre.JPg + pre.JVg * dt - 0.5 * RaJ * dt2,
            JPa=pre.JPa + pre.JVa * dt - 0.5 * pre.dR * dt2,
            bias_g=bias_g, bias_a=bias_a,
        )
        # an invalid sample leaves the whole state as it was
        pre = Preintegrated(*(torch.where(valid, n, o) for n, o in zip(new, pre)))
    return pre._replace(dR=lie.project_to_so3(pre.dR))


def bias_corrected_delta(pre: Preintegrated, bias_g, bias_a) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """First-order bias-corrected (ΔR, ΔV, ΔP) (``ImuTypes.cc:340-365``)."""
    dbg = bias_g - pre.bias_g
    dba = bias_a - pre.bias_a
    dR = pre.dR @ lie.so3_exp(pre.JRg @ dbg)
    dV = pre.dV + pre.JVg @ dbg + pre.JVa @ dba
    dP = pre.dP + pre.JPg @ dbg + pre.JPa @ dba
    return dR, dV, dP


def predict_state(pre: Preintegrated, R_wb, p_wb, v_w, bias_g, bias_a, gravity):
    """Dead-reckon the next body state (``Tracking::PredictStateIMU``,
    ``Tracking.cc:1561``). Returns (R_wb', p_wb', v_w')."""
    dR, dV, dP = bias_corrected_delta(pre, bias_g, bias_a)
    t = pre.dt
    R2 = R_wb @ dR
    v2 = v_w + gravity * t + R_wb @ dV
    p2 = p_wb + v_w * t + 0.5 * gravity * t * t + R_wb @ dP
    return R2, p2, v2


def compose(p1: Preintegrated, p2: Preintegrated) -> Preintegrated:
    """Compose two consecutive preintegrations with the same bias point
    (the covariances are transported and added, first order)."""
    dev, dt_ = p1.dR.device, p1.dR.dtype
    eye3 = torch.eye(3, dtype=dt_, device=dev)
    z3 = torch.zeros((3, 3), dtype=dt_, device=dev)
    T = _blocks([
        [p2.dR.T @ eye3, z3, z3],
        [z3, eye3, z3],
        [z3, eye3 * p2.dt, eye3],
    ])
    return Preintegrated(
        dt=p1.dt + p2.dt,
        dR=p1.dR @ p2.dR,
        dV=p1.dV + p1.dR @ p2.dV,
        dP=p1.dP + p1.dV * p2.dt + p1.dR @ p2.dP,
        cov=T @ p1.cov @ T.T + p2.cov,
        JRg=p2.dR.T @ p1.JRg + p2.JRg,
        JVg=p1.JVg + p1.dR @ p2.JVg,
        JVa=p1.JVa + p1.dR @ p2.JVa,
        JPg=p1.JPg + p1.JVg * p2.dt + p1.dR @ p2.JPg,
        JPa=p1.JPa + p1.JVa * p2.dt + p1.dR @ p2.JPa,
        bias_g=p1.bias_g, bias_a=p1.bias_a,
    )


def merge(pre1: Preintegrated, batch2: ImuBatch, sigma_g, sigma_a) -> Preintegrated:
    """Append a second window (MergePrevious analog): integrate it at
    pre1's bias and compose."""
    return compose(pre1, integrate(batch2, pre1.bias_g, pre1.bias_a, sigma_g, sigma_a))
