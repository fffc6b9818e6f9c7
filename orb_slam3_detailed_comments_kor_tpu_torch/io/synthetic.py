"""Synthetic textured-world renderer with exact ground truth.

Port of the pinhole path of ``orb_slam3_detailed_comments_kor_tpu/io/
synthetic.py``: a box room of textured planes ray-cast through the camera,
giving images with dense FAST-able texture plus exact poses and depths.
Rendering runs on the device of the camera parameters. The texture lattice
is the reference's ``np.random.RandomState(7)`` draw, so both packages
render the same world.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from orb_slam3_detailed_comments_kor_tpu_torch.models import camera as cam
from orb_slam3_detailed_comments_kor_tpu_torch.utils import lie

_LATTICE_N = 1024


def _texture_lattice(seed: int = 7) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return rng.rand(_LATTICE_N, _LATTICE_N).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _lattice(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_texture_lattice()).to(device)


def _tex_nearest(lat, x, y):
    xi = torch.remainder(torch.floor(x).to(torch.int64), _LATTICE_N)
    yi = torch.remainder(torch.floor(y).to(torch.int64), _LATTICE_N)
    return lat[yi, xi]


def _tex_bilinear(lat, x, y):
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    xi = torch.remainder(x0.to(torch.int64), _LATTICE_N)
    yi = torch.remainder(y0.to(torch.int64), _LATTICE_N)
    xi1 = torch.remainder(xi + 1, _LATTICE_N)
    yi1 = torch.remainder(yi + 1, _LATTICE_N)
    return (
        lat[yi, xi] * (1 - fx) * (1 - fy)
        + lat[yi, xi1] * fx * (1 - fy)
        + lat[yi1, xi] * (1 - fx) * fy
        + lat[yi1, xi1] * fx * fy
    )


def texture(x, y, scale: float = 4.0):
    """Procedural texture over world metres -> intensity [0,255]."""
    lat = _lattice(x.device)
    blocky = _tex_nearest(lat, x * scale, y * scale)
    fine = _tex_bilinear(lat, x * scale * 7.3 + 11.0, y * scale * 7.3 + 5.0)
    coarse = _tex_bilinear(lat, x * scale * 0.37, y * scale * 0.37)
    v = 0.55 * blocky + 0.25 * fine + 0.20 * coarse
    return v * 255.0


class Scene(NamedTuple):
    """A set of textured planes n_p·x = d_p bounding the world."""

    normals: torch.Tensor  # [P,3] unit normals
    ds: torch.Tensor       # [P]
    u_axes: torch.Tensor   # [P,3] texture u direction (orthogonal to normal)
    v_axes: torch.Tensor   # [P,3]
    offsets: torch.Tensor  # [P,2] texture offset so planes look different


def default_scene(device="cuda") -> Scene:
    """Closed box room: walls z=5/z=-4, floor y=+1.5, ceiling y=-1.5,
    side walls x=+4/-2.5 — every heading sees texture. On ``device``, the
    card unless the caller names another."""
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    return Scene(
        normals=t([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0],
                   [0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]]),
        ds=t([5.0, 4.0, 1.5, 1.5, 4.0, 2.5]),
        u_axes=t([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0], [1.0, 0.0, 0.0],
                  [1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, 0.0, 1.0]]),
        v_axes=t([[0.0, 1.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0],
                  [0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [0.0, 1.0, 0.0]]),
        offsets=t([[0.0, 0.0], [310.0, 95.0], [37.0, 11.0], [91.0, 53.0],
                   [140.0, 7.0], [200.0, 170.0]]),
    )


def render(
    params: torch.Tensor,
    R_wc: torch.Tensor,
    t_wc: torch.Tensor,
    scene: Scene,
    h: int = 480,
    w: int = 752,
    model: str = "pinhole",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Image + depth map for the camera-to-world pose (R_wc, t_wc).

    Nearest positive plane intersection per pixel. Returns (img [h,w]
    float32 0..255, depth [h,w] float32 along camera z, -1 where no hit).
    """
    dev = params.device
    vv, uu = torch.meshgrid(
        torch.arange(h, device=dev), torch.arange(w, device=dev), indexing="ij"
    )
    uv = torch.stack([uu + 0.5, vv + 0.5], dim=-1).to(torch.float32)
    rays_c = cam.unproject(params, uv.reshape(-1, 2), model)  # [hw,3] z=1
    rays_w = rays_c @ R_wc.T
    n_dot_ray = rays_w @ scene.normals.T                       # [hw,P]
    n_dot_t = scene.normals @ t_wc                             # [P]
    s_all = (scene.ds - n_dot_t)[None, :] / torch.where(
        torch.abs(n_dot_ray) < 1e-6, 1e-6, n_dot_ray
    )
    s_all = torch.where(s_all > 0.05, s_all, float("inf"))
    s, plane = torch.min(s_all, dim=-1)
    hit = torch.isfinite(s)
    s_safe = torch.where(hit, s, 1.0)
    pts_w = t_wc[None, :] + s_safe[:, None] * rays_w
    tu = torch.sum(pts_w * scene.u_axes[plane], dim=-1) + scene.offsets[plane, 0]
    tv = torch.sum(pts_w * scene.v_axes[plane], dim=-1) + scene.offsets[plane, 1]
    img = texture(tu, tv).reshape(h, w)
    depth = (s_safe * rays_c[:, 2]).reshape(h, w)
    hit = hit.reshape(h, w)
    return torch.where(hit, img, 0.0), torch.where(hit, depth, -1.0)


def make_trajectory(
    n_frames: int,
    motion: str = "strafe",
    speed: float = 0.04,
) -> Tuple[np.ndarray, np.ndarray]:
    """Ground-truth camera-to-world poses (R_wc [T,3,3], t_wc [T,3]).

    'strafe': translate along +x facing the wall; 'arc': translate + slow
    yaw; 'outback': out and back along x.
    """
    Rs, ts = [], []
    for i in range(n_frames):
        if motion == "strafe":
            R = np.eye(3)
            t = np.array([i * speed, 0.02 * np.sin(i * 0.2), 0.0])
        elif motion == "arc":
            yaw = 0.003 * i
            R = lie.so3_exp(torch.tensor([0.0, yaw, 0.0])).numpy()
            t = np.array([i * speed, 0.0, 0.005 * i])
        elif motion == "outback":
            half = n_frames // 2
            x = speed * i if i < half else speed * (2 * half - i)
            R = np.eye(3)
            t = np.array([x, 0.015 * np.sin(i * 0.35), 0.0])
        else:
            raise ValueError(f"motion {motion!r} is not ported")
        Rs.append(R)
        ts.append(t)
    return np.stack(Rs).astype(np.float32), np.stack(ts).astype(np.float32)


def stereo_pair(
    params: torch.Tensor,
    R_wc: torch.Tensor,
    t_wc: torch.Tensor,
    baseline: float,
    scene: Scene,
    h: int = 480,
    w: int = 752,
    model: str = "pinhole",
):
    """Rectified stereo pair; the right camera sits +baseline along the
    camera x-axis. Returns (imgL, imgR, depthL)."""
    imgL, depthL = render(params, R_wc, t_wc, scene, h, w, model)
    offset = torch.tensor([baseline, 0.0, 0.0], dtype=R_wc.dtype, device=R_wc.device)
    imgR, _ = render(params, R_wc, t_wc + R_wc @ offset, scene, h, w, model)
    return imgL, imgR, depthL
