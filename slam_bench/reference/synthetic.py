"""The benchmark's own copy of the lattice-scene renderer and the analytic
trajectory with its exact IMU, in plain PyTorch.

A frozen copy of the pinhole path of the port's ``io/synthetic.py``
(``default_scene``, ``render``, ``stereo_pair``, ``AnalyticTrajectory``)
with the two Lie helpers it needs. It imports nothing of the port, so a
change to the port cannot change the traffic or the ground truth it is
judged against. ``ray_depth`` is new: the depth along camera z of the
scene point seen at arbitrary (sub-pixel) pixel coordinates, which the
correctness check reads.

World frame: x right, y down (gravity +y), z forward into the scene. The
texture lattice is ``np.random.RandomState(7)``'s draw, as the port's.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

_LATTICE_N = 1024


# --- SO(3) helpers (the port's utils/lie formulas) ------------------------
def hat(w):
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([torch.stack([z, -wz, wy], dim=-1),
                        torch.stack([wz, z, -wx], dim=-1),
                        torch.stack([-wy, wx, z], dim=-1)], dim=-2)


def vee(W):
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def so3_exp(w):
    """Rodrigues' formula, Taylor-safe near 0."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-12
    theta = torch.where(small, 0.0, torch.sqrt(torch.where(small, 1.0, theta2)))
    tiny = torch.abs(theta) < 1e-4
    ts = torch.where(tiny, 1.0, theta)
    a = torch.where(tiny, 1.0 - theta * theta / 6.0, torch.sin(ts) / ts)[..., None, None]
    b = torch.where(tiny, 0.5 - theta * theta / 24.0, (1.0 - torch.cos(ts)) / (ts * ts))[..., None, None]
    W = hat(w)
    eye = torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)
    return eye + a * W + b * (W @ W)


# --- texture --------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _lattice(device: torch.device) -> torch.Tensor:
    rng = np.random.RandomState(7)
    return torch.from_numpy(rng.rand(_LATTICE_N, _LATTICE_N).astype(np.float32)).to(device)


def _tex_nearest(lat, x, y):
    xi = torch.remainder(torch.floor(x).to(torch.int64), _LATTICE_N)
    yi = torch.remainder(torch.floor(y).to(torch.int64), _LATTICE_N)
    return lat[yi, xi]


def _tex_bilinear(lat, x, y):
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    xi = torch.remainder(x0.to(torch.int64), _LATTICE_N)
    yi = torch.remainder(y0.to(torch.int64), _LATTICE_N)
    xi1 = torch.remainder(xi + 1, _LATTICE_N)
    yi1 = torch.remainder(yi + 1, _LATTICE_N)
    return (lat[yi, xi] * (1 - fx) * (1 - fy) + lat[yi, xi1] * fx * (1 - fy)
            + lat[yi1, xi] * (1 - fx) * fy + lat[yi1, xi1] * fx * fy)


def texture(x, y, scale: float = 4.0):
    """Procedural texture over world metres -> intensity [0, 255]."""
    lat = _lattice(x.device)
    blocky = _tex_nearest(lat, x * scale, y * scale)
    fine = _tex_bilinear(lat, x * scale * 7.3 + 11.0, y * scale * 7.3 + 5.0)
    coarse = _tex_bilinear(lat, x * scale * 0.37, y * scale * 0.37)
    return (0.55 * blocky + 0.25 * fine + 0.20 * coarse) * 255.0


# --- scene ----------------------------------------------------------------
class Scene(NamedTuple):
    normals: torch.Tensor  # [P,3]
    ds: torch.Tensor       # [P]   plane n·x = d
    u_axes: torch.Tensor   # [P,3]
    v_axes: torch.Tensor   # [P,3]
    offsets: torch.Tensor  # [P,2]


def default_scene(device) -> Scene:
    """Closed box room: walls z=5 / z=-4, floor y=+1.5, ceiling y=-1.5,
    side walls x=+4 / -2.5."""
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


def _cast(params, R_wc, t_wc, scene, uv):
    """Nearest positive plane hit of the rays through pixels ``uv`` [M,2]:
    (unit-depth camera rays [M,3], world rays [M,3], ray parameter s [M],
    plane index [M], hit mask [M])."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    rays_c = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    rays_w = rays_c @ R_wc.T
    n_dot_ray = rays_w @ scene.normals.T
    n_dot_t = scene.normals @ t_wc
    s_all = (scene.ds - n_dot_t)[None, :] / torch.where(torch.abs(n_dot_ray) < 1e-6, 1e-6, n_dot_ray)
    s_all = torch.where(s_all > 0.05, s_all, float("inf"))
    s, plane = torch.min(s_all, dim=-1)
    return rays_c, rays_w, s, plane, torch.isfinite(s)


def render(params, R_wc, t_wc, scene: Scene, h: int, w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(image [h,w] float32 0..255, depth [h,w] along camera z, -1 where
    no plane is hit) of the pinhole camera ``params`` = [fx, fy, cx, cy]
    at camera-to-world pose (R_wc, t_wc)."""
    dev = params.device
    vv, uu = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev), indexing="ij")
    uv = torch.stack([uu + 0.5, vv + 0.5], dim=-1).to(torch.float32).reshape(-1, 2)
    rays_c, rays_w, s, plane, hit = _cast(params, R_wc, t_wc, scene, uv)
    s_safe = torch.where(hit, s, 1.0)
    pts_w = t_wc[None, :] + s_safe[:, None] * rays_w
    tu = torch.sum(pts_w * scene.u_axes[plane], dim=-1) + scene.offsets[plane, 0]
    tv = torch.sum(pts_w * scene.v_axes[plane], dim=-1) + scene.offsets[plane, 1]
    img = texture(tu, tv).reshape(h, w)
    depth = (s_safe * rays_c[:, 2]).reshape(h, w)
    hit = hit.reshape(h, w)
    return torch.where(hit, img, 0.0), torch.where(hit, depth, -1.0)


def stereo_pair(params, R_wc, t_wc, baseline: float, scene: Scene, h: int, w: int):
    """Rectified pair; the right camera sits +baseline along camera x.
    Returns (left, right, left depth)."""
    img_l, depth_l = render(params, R_wc, t_wc, scene, h, w)
    offset = torch.tensor([baseline, 0.0, 0.0], dtype=R_wc.dtype, device=R_wc.device)
    img_r, _ = render(params, R_wc, t_wc + R_wc @ offset, scene, h, w)
    return img_l, img_r, depth_l


def render_many(params, R_wc, t_wc, scene: Scene, h: int, w: int) -> torch.Tensor:
    """Images [B,h,w] float32 0..255 of the cameras (R_wc [B,3,3], t_wc
    [B,3]): ``render``'s image for each pose, in one batched pass (the
    generator's fast path; the test holds it to ``render``)."""
    dev = params.device
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    vv, uu = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev), indexing="ij")
    uv = torch.stack([uu + 0.5, vv + 0.5], dim=-1).to(torch.float32).reshape(-1, 2)
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    rays_c = torch.stack([x, y, torch.ones_like(x)], dim=-1)           # [M,3]
    rays_w = rays_c @ R_wc.transpose(-1, -2)                             # [B,M,3]
    n_dot_ray = rays_w @ scene.normals.T                                 # [B,M,P]
    n_dot_t = t_wc @ scene.normals.T                                     # [B,P]
    s_all = (scene.ds - n_dot_t)[:, None, :] / torch.where(torch.abs(n_dot_ray) < 1e-6, 1e-6, n_dot_ray)
    s_all = torch.where(s_all > 0.05, s_all, float("inf"))
    s, plane = torch.min(s_all, dim=-1)                                  # [B,M]
    hit = torch.isfinite(s)
    s_safe = torch.where(hit, s, 1.0)
    pts_w = t_wc[:, None, :] + s_safe[..., None] * rays_w
    tu = torch.sum(pts_w * scene.u_axes[plane], dim=-1) + scene.offsets[plane, 0]
    tv = torch.sum(pts_w * scene.v_axes[plane], dim=-1) + scene.offsets[plane, 1]
    img = torch.where(hit, texture(tu, tv), 0.0)
    return img.reshape(-1, h, w)


def stereo_many(params, R_wc, t_wc, baseline: float, scene: Scene, h: int, w: int) -> torch.Tensor:
    """[B,2,h,w] rectified pairs (``stereo_pair``'s images) of B poses."""
    offset = torch.tensor([baseline, 0.0, 0.0], dtype=R_wc.dtype, device=R_wc.device)
    t_r = t_wc + R_wc @ offset
    both = render_many(params, torch.cat([R_wc, R_wc]), torch.cat([t_wc, t_r]), scene, h, w)
    return torch.stack([both[:len(R_wc)], both[len(R_wc):]], dim=1)


def ray_depth(params, R_wc, t_wc, scene: Scene, uv) -> torch.Tensor:
    """Depth along camera z [M] of the scene point seen at image
    coordinates ``uv`` [M,2] (pixel centres at +0.5, as ``render``); -1
    where no plane is hit. Evaluated in float64."""
    d = torch.float64
    sc = Scene(*(a.to(d) for a in scene))
    rays_c, _, s, _, hit = _cast(params.to(d), R_wc.to(d), t_wc.to(d), sc, uv.to(d))
    return torch.where(hit, s * rays_c[:, 2], -1.0)


# --- trajectory -----------------------------------------------------------
class AnalyticTrajectory:
    """Smooth analytic body trajectory with exact derivatives: sinusoidal
    position and rotation vector, evaluated in float64 at the
    float32-rounded time and returned as float32. ``excitation`` scales the
    translation frequencies. The port's trajectory differentiates the law
    by forward-mode automatic differentiation; this copy writes the same
    derivatives out (velocity and acceleration of the sinusoids; the body
    rate J_r(φ)·φ̇ with J_r the right Jacobian of SO(3)), which is two
    orders of magnitude faster over a run's samples and equal to float32
    rounding."""

    # position: amplitude, angular frequency (× excitation), phase
    POS = ((0.8, 0.50, 0.0), (0.15, 0.90, 1.0), (0.40, 0.40, 0.3))
    # rotation vector: amplitude, angular frequency, phase
    ROT = ((0.10, 0.45, 0.5), (0.25, 0.30, 0.0), (0.05, 0.70, 1.2))

    def __init__(self, excitation: float = 1.0, gravity: float = 9.81, device="cpu"):
        self.device = torch.device(device)
        self.f = float(excitation)
        # gravity as float32, then widened (as the port's trajectory holds it)
        self._g64 = torch.tensor([0.0, gravity, 0.0], dtype=torch.float32, device=self.device).to(torch.float64)

    def _t64(self, t):
        return torch.as_tensor(np.asarray(t, np.float32), device=self.device).to(torch.float64)

    def _sines(self, t, table, f, order):
        """d^order/dt^order of A·sin(w·f·t + p) per axis: [..., 3]."""
        out = []
        for a, w, p in table:
            ww = w * f
            x = ww * t + p
            val = (torch.sin(x), torch.cos(x), -torch.sin(x))[order]
            out.append(a * (ww ** order) * val)
        return torch.stack(out, dim=-1)

    def _pos(self, t):
        return self._sines(t, self.POS, self.f, 0)

    def _rotvec(self, t):
        return self._sines(t, self.ROT, 1.0, 0)

    def pose(self, t):
        """(R_wb [3,3], p_wb [3]) float32 at time t."""
        t = self._t64(t)
        return so3_exp(self._rotvec(t)).to(torch.float32), self._pos(t).to(torch.float32)

    def poses(self, ts):
        """(R_wb [T,3,3], p_wb [T,3]) float32 at a 1-D array of times."""
        return self.pose(ts)

    def velocity(self, t):
        return self._sines(self._t64(t), self.POS, self.f, 1).to(torch.float32)

    def imu_at(self, t):
        """(acc_body, gyro_body) ideal measurements: the specific force
        R^T (a - g) and the body rate J_r(φ) φ̇; [T,3] each for a 1-D array
        of times."""
        t = self._t64(t)
        phi = self._rotvec(t)
        R = so3_exp(phi)
        acc_w = self._sines(t, self.POS, self.f, 2)
        acc_b = (R.transpose(-1, -2) @ (acc_w - self._g64)[..., None])[..., 0]
        theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)[..., None]
        th = torch.sqrt(theta2)
        P = hat(phi)
        Jr = (torch.eye(3, dtype=phi.dtype, device=phi.device) - (1.0 - torch.cos(th)) / theta2 * P
              + (th - torch.sin(th)) / (theta2 * th) * (P @ P))
        gyro = (Jr @ self._sines(t, self.ROT, 1.0, 1)[..., None])[..., 0]
        return acc_b.to(torch.float32), gyro.to(torch.float32)
