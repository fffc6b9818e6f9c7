"""Device-resident SoA map state: keyframes, landmarks, observation graph.

Port of ``MapState``, ``empty_map``, ``allocate_slots``,
``covisibility_weights``, ``landmark_scale_band``, ``predict_level``,
``compact_keyframes`` and ``apply_scale`` from
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
    if not isinstance(vals, torch.Tensor):
        # a Python value assigned through an index tensor is copied from the
        # host, and the copy waits on the stream: fill it on the device
        vals = torch.full((), vals, dtype=arr.dtype, device=arr.device)
    buf[idx.to(torch.int64)] = vals
    return buf[:-1]


def scatter_last(arr: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """``arr.at[idx].set(vals, mode="drop")`` as the reference's CPU scatter
    applies it: updates land in order, so among updates to one index the
    last one wins (torch leaves that winner undefined); indices >= len(arr)
    are dropped (the callers' indices are never negative). The winner is
    found with an integer ``amax`` scatter, so every device agrees."""
    n = arr.shape[0]
    idx = idx.to(torch.int64)
    inside = (idx >= 0) & (idx < n)
    order = torch.arange(idx.shape[0], device=idx.device)
    last = torch.full((n + 1,), -1, dtype=torch.int64, device=idx.device)
    last = last.scatter_reduce(0, torch.where(inside, idx, n), torch.where(inside, order, -1), "amax")[:n]
    if not isinstance(vals, torch.Tensor) or vals.dim() == 0:
        vals = torch.full((), vals, dtype=arr.dtype, device=arr.device).expand(idx.shape[0], *arr.shape[1:])
    hit = (last >= 0).reshape((n,) + (1,) * (arr.dim() - 1))
    return torch.where(hit, vals[torch.clamp(last, min=0)], arr)


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


def covisibility_weights(ms: MapState, kf_set: torch.Tensor) -> torch.Tensor:
    """Shared-landmark counts between keyframes (KeyFrame::UpdateConnections
    analog, derived not maintained).

    kf_set [W] keyframe indices -> [W, K] int32 counts of landmarks shared
    with every keyframe in the map: the product of two 0/1 indicators,
    exact in f32 (TF32 is off).
    """
    L = ms.L

    def indicator(obs, ok):
        # column L parks the empty observation slots
        ind = torch.zeros((obs.shape[0], L + 1), dtype=torch.float32, device=obs.device)
        ind.scatter_(1, torch.where(ok, obs, L).to(torch.int64), 1.0)
        return ind[:, :L]

    obs = ms.obs_lm[kf_set]
    ind_w = indicator(obs, (obs >= 0) & ms.kf_feat_valid[kf_set])
    ind_all = indicator(ms.obs_lm, (ms.obs_lm >= 0) & ms.kf_feat_valid)
    counts = (ind_w @ ind_all.T) * ms.kf_valid[None, :]
    return counts.to(torch.int32)


def landmark_scale_band(
    dist: torch.Tensor, level: torch.Tensor, scale: float = 1.2, n_levels: int = 8
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scale-invariance distance band from the observing level
    (MapPoint::UpdateNormalAndDepth)."""
    max_dist = dist * scale ** level.to(torch.float32)
    # XLA compiles a division by a constant as a product with its f32 reciprocal
    min_dist = max_dist * _recip_f32(scale ** (n_levels - 1))
    return min_dist, max_dist


def _log_f32(x: float) -> float:
    # log evaluated in float32, as the reference's jnp.log(python float);
    # float32(math.log(1.2)) is one ulp away and flips rounding at ceil()
    return float(torch.log(torch.tensor(x, dtype=torch.float32)))


def _recip_f32(c: float) -> float:
    """1 / f32(c) rounded to f32: the constant that XLA multiplies by where
    the reference divides by the constant c."""
    return float(np.float32(1.0) / np.float32(c))


def predict_level(
    dist: torch.Tensor, max_dist: torch.Tensor, scale: float = 1.2,
    n_levels: int = 8,
) -> torch.Tensor:
    """Pyramid level a landmark should appear at from its distance
    (MapPoint::PredictScale)."""
    ratio = torch.clamp(max_dist / torch.clamp(dist, min=1e-6), min=1e-6)
    lvl = torch.ceil(torch.log(ratio) * _recip_f32(_log_f32(scale))).to(torch.int32)
    return torch.clamp(lvl, 0, n_levels - 1)


def compact_keyframes(ms: MapState):
    """Slide valid keyframes down into the lowest slots, preserving time
    order, so culled slots become insertable again (slot order is temporal
    order: the trajectory references rely on it).

    Returns (ms', new_of_old [K] int32 -- new slot per old slot, K for
    culled/invalid -- and n_valid, a 0-d tensor).
    """
    K = ms.K
    dev = ms.kf_valid.device
    valid = ms.kf_valid
    new_of_old = torch.where(valid, torch.cumsum(valid, 0) - 1, K)
    # slot K of old_of_new parks the invalid slots' writes
    old_of_new = torch.zeros((K + 1,), dtype=torch.int64, device=dev)
    old_of_new[new_of_old] = torch.arange(K, device=dev)
    src = old_of_new[:K]
    n_valid = torch.sum(valid)
    mask = torch.arange(K, device=dev) < n_valid

    def take(a, fill=0):
        m = mask.reshape((K,) + (1,) * (a.dim() - 1))
        # a 0-d fill of a's own type (a Python 0 would promote bool to int)
        return torch.where(m, a[src], torch.full((), fill, dtype=a.dtype, device=dev))

    # landmark birth keyframes (used only to group "new" landmarks for
    # fusion) follow their keyframe; culled parents collapse to slot 0
    first_new = new_of_old[torch.clamp(ms.lm_first_kf, 0, K - 1).to(torch.int64)]
    eye = torch.eye(3, dtype=ms.kf_R_cw.dtype, device=dev)
    return ms._replace(
        kf_R_cw=torch.where(mask[:, None, None], ms.kf_R_cw[src], eye),
        kf_t_cw=take(ms.kf_t_cw),
        kf_valid=mask,
        kf_time=take(ms.kf_time),
        kf_xy=take(ms.kf_xy),
        kf_level=take(ms.kf_level),
        kf_angle=take(ms.kf_angle),
        kf_desc=take(ms.kf_desc),
        kf_ur=take(ms.kf_ur, -1.0),
        kf_uvr=take(ms.kf_uvr, -1.0),
        kf_feat_valid=take(ms.kf_feat_valid),
        obs_lm=take(ms.obs_lm, -1),
        lm_first_kf=torch.clamp(first_new, 0, K - 1).to(torch.int32),
    ), new_of_old.to(torch.int32), n_valid


def apply_scale(ms: MapState, s) -> MapState:
    """Re-gauge the whole map by a scalar scale ``s`` (a 0-d tensor or a
    float; the scale part of ``Map::ApplyScaledRotation``, ``Map.cc:289``),
    after monocular-inertial initialization solves the metric scale.
    Landmark positions and keyframe translations scale together, so every
    reprojection stays as it was."""
    return ms._replace(
        lm_pos=ms.lm_pos * s,
        kf_t_cw=ms.kf_t_cw * s,
        lm_min_dist=ms.lm_min_dist * s,
        lm_max_dist=ms.lm_max_dist * s,
    )
