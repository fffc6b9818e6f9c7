"""Pinhole camera model on torch tensors.

Port of the pinhole part of ``orb_slam3_detailed_comments_kor_tpu/models/
camera.py``. ``params`` is [fx, fy, cx, cy]; 3-D points are camera-frame,
z forward; all functions broadcast over leading batch dims.
"""

from __future__ import annotations

import torch

_EPS = 1e-9


def pinhole_project(params, xyz):
    """Camera-frame points [...,3] -> pixels [...,2]. No distortion."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    z = torch.clamp(xyz[..., 2], min=_EPS)
    u = fx * xyz[..., 0] / z + cx
    v = fy * xyz[..., 1] / z + cy
    return torch.stack([u, v], dim=-1)


def pinhole_unproject(params, uv):
    """Pixels [...,2] -> unit-depth rays [...,3] (z=1)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def project(params, xyz, model: str = "pinhole"):
    if model != "pinhole":
        raise NotImplementedError(f"camera model {model!r} is not ported")
    return pinhole_project(params, xyz)


def unproject(params, uv, model: str = "pinhole"):
    if model != "pinhole":
        raise NotImplementedError(f"camera model {model!r} is not ported")
    return pinhole_unproject(params, uv)


def camera_params_from_config(cam, device=None) -> torch.Tensor:
    """[fx, fy, cx, cy] float32 from a pinhole CameraConfig."""
    if cam.model != "pinhole":
        raise NotImplementedError(f"camera model {cam.model!r} is not ported")
    return torch.tensor(
        [cam.fx, cam.fy, cam.cx, cam.cy], dtype=torch.float32, device=device
    )
