"""Device-resident SoA map state: keyframes, landmarks, observation graph.

Port of ``MapState``, ``empty_map``, ``allocate_slots``,
``landmark_scale_band`` and ``predict_level`` from
``orb_slam3_detailed_comments_kor_tpu/slam/map_state.py``, plus the numpy
converters that carry a map between the two packages. Packed descriptors
(the reference's uint32 words) are stored as int32 bit patterns.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch


class MapState(NamedTuple):
    # --- keyframes (capacity K, feature slots N) ---
    kf_R_cw: torch.Tensor      # [K,3,3]
    kf_t_cw: torch.Tensor      # [K,3]
    kf_valid: torch.Tensor     # [K] bool
    kf_time: torch.Tensor      # [K] float32 seconds
    kf_xy: torch.Tensor        # [K,N,2] float32 feature pixels (level-0)
    kf_level: torch.Tensor     # [K,N] int32
    kf_angle: torch.Tensor     # [K,N] float32
    kf_desc: torch.Tensor      # [K,N,8] int32 packed descriptors
    kf_ur: torch.Tensor        # [K,N] float32 right-u (-1 mono)
    kf_uvr: torch.Tensor       # [K,N,2] float32 rig right-cam pixel (x<0 none)
    kf_feat_valid: torch.Tensor  # [K,N] bool
    # --- observation graph ---
    obs_lm: torch.Tensor       # [K,N] int32 landmark idx or -1
    # --- landmarks (capacity L) ---
    lm_pos: torch.Tensor       # [L,3] world
    lm_valid: torch.Tensor     # [L] bool
    lm_desc: torch.Tensor      # [L,8] int32 representative descriptor
    lm_normal: torch.Tensor    # [L,3] mean viewing direction
    lm_min_dist: torch.Tensor  # [L] scale-invariance band
    lm_max_dist: torch.Tensor  # [L]
    lm_found: torch.Tensor     # [L] int32
    lm_visible: torch.Tensor   # [L] int32
    lm_first_kf: torch.Tensor  # [L] int32

    @property
    def K(self) -> int:
        return self.kf_valid.shape[0]

    @property
    def N(self) -> int:
        return self.kf_feat_valid.shape[1]

    @property
    def L(self) -> int:
        return self.lm_valid.shape[0]


# fields that hold the reference's uint32 descriptor words
_U32_FIELDS = ("kf_desc", "lm_desc")


def empty_map(max_kf: int, n_feat: int, max_lm: int, device="cuda") -> MapState:
    """An empty map on ``device`` (the card unless the caller names another)."""
    K, N, L = max_kf, n_feat, max_lm
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    b = dict(dtype=torch.bool, device=device)
    return MapState(
        kf_R_cw=torch.eye(3, **f32).repeat(K, 1, 1),
        kf_t_cw=torch.zeros((K, 3), **f32),
        kf_valid=torch.zeros((K,), **b),
        kf_time=torch.zeros((K,), **f32),
        kf_xy=torch.zeros((K, N, 2), **f32),
        kf_level=torch.zeros((K, N), **i32),
        kf_angle=torch.zeros((K, N), **f32),
        kf_desc=torch.zeros((K, N, 8), **i32),
        kf_ur=-torch.ones((K, N), **f32),
        kf_uvr=-torch.ones((K, N, 2), **f32),
        kf_feat_valid=torch.zeros((K, N), **b),
        obs_lm=-torch.ones((K, N), **i32),
        lm_pos=torch.zeros((L, 3), **f32),
        lm_valid=torch.zeros((L,), **b),
        lm_desc=torch.zeros((L, 8), **i32),
        lm_normal=torch.zeros((L, 3), **f32),
        lm_min_dist=torch.zeros((L,), **f32),
        lm_max_dist=torch.zeros((L,), **f32),
        lm_found=torch.zeros((L,), **i32),
        lm_visible=torch.zeros((L,), **i32),
        lm_first_kf=torch.zeros((L,), **i32),
    )


def map_state_from_numpy(arrays: Dict[str, np.ndarray], device) -> MapState:
    """MapState from the reference's ``MapState._asdict()`` with
    ``np.asarray`` on each field; uint32 words become int32 bit views."""
    fields = {}
    for name in MapState._fields:
        a = np.asarray(arrays[name])
        if name in _U32_FIELDS:
            a = a.view(np.int32)
        fields[name] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return MapState(**fields)


def map_state_to_numpy(ms: MapState) -> Dict[str, np.ndarray]:
    """Inverse of ``map_state_from_numpy``: int32 words go back to uint32."""
    out = {}
    for name, t in ms._asdict().items():
        a = t.detach().cpu().numpy()
        out[name] = a.view(np.uint32) if name in _U32_FIELDS else a
    return out


def scatter_drop(arr: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """``arr.at[idx].set(vals, mode="drop")`` for idx in [0, len(arr)]:
    index len(arr) is a parking slot whose writes are discarded. Torch
    leaves the winner of duplicate indices undefined, so every write the
    caller discards must go to the parking slot, never to a real one."""
    buf = torch.cat([arr, arr[:1]])
    buf[idx.to(torch.int64)] = vals
    return buf[:-1]


def allocate_slots(free: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """A distinct free slot index per wanted request, else -1.

    free [L] bool (slot availability), want [M] bool (requests) -> [M] int32.
    """
    L = free.shape[0]
    # rank of each free slot among free slots; taken slots park at L + 1
    free_rank = torch.where(free, torch.cumsum(free, 0) - 1, L + 1)
    slot_of_rank = torch.full((L + 2,), -1, dtype=torch.int32, device=free.device)
    slot_of_rank[free_rank] = torch.arange(L, dtype=torch.int32, device=free.device)
    want_rank = torch.where(want, torch.cumsum(want, 0) - 1, L + 1)
    got = slot_of_rank[torch.clamp(want_rank, max=L + 1)]
    return torch.where(want, got, -1)


def landmark_scale_band(
    dist: torch.Tensor, level: torch.Tensor, scale: float = 1.2, n_levels: int = 8
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scale-invariance distance band from the observing level
    (MapPoint::UpdateNormalAndDepth)."""
    max_dist = dist * scale ** level.to(torch.float32)
    min_dist = max_dist / (scale ** (n_levels - 1))
    return min_dist, max_dist


def _log_f32(x: float) -> float:
    # log evaluated in float32, as the reference's jnp.log(python float);
    # float32(math.log(1.2)) is one ulp away and flips rounding at ceil()
    return float(torch.log(torch.tensor(x, dtype=torch.float32)))


def predict_level(
    dist: torch.Tensor, max_dist: torch.Tensor, scale: float = 1.2,
    n_levels: int = 8,
) -> torch.Tensor:
    """Pyramid level a landmark should appear at from its distance
    (MapPoint::PredictScale)."""
    ratio = torch.clamp(max_dist / torch.clamp(dist, min=1e-6), min=1e-6)
    lvl = torch.ceil(torch.log(ratio) / _log_f32(scale)).to(torch.int32)
    return torch.clamp(lvl, 0, n_levels - 1)
