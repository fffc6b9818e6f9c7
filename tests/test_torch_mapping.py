"""The port's mapping steps against the JAX reference on the CPU, on map
states built from a numpy seed (``map_state_from_numpy``):
covisibility, keyframe compaction, landmark and keyframe culling,
duplicate fusion, eviction, local BA and the ATE.

Tolerances: every integer, mask and index output is compared exactly
(covisibility, compaction, culling, fusion, eviction, the local-BA
window). Local BA (2 LM iterations, as the SLAM loop runs it) agrees on
poses within 1e-4 rad and 1e-4 m and on points within 1e-3 m, and both
move the same keyframes; ``ate_rmse`` within 1e-9 m.

Local BA scatters its refined points as the reference does on the CPU:
every unused slot of the landmark block writes landmark 0's old position
back to landmark 0 after the used slots, and the last write wins
(``map_state.scatter_last``, checked against the reference's scatter).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_detailed_comments_kor_tpu.eval import ate as jate
from orb_slam3_detailed_comments_kor_tpu.slam import map_merging as jmm
from orb_slam3_detailed_comments_kor_tpu.slam import map_state as jms
from orb_slam3_detailed_comments_kor_tpu.slam import system as jsys
from orb_slam3_detailed_comments_kor_tpu.slam import tracking as jtr
from orb_slam3_detailed_comments_kor_tpu_torch.eval import ate as tate
from orb_slam3_detailed_comments_kor_tpu_torch.slam import map_merging as tmm
from orb_slam3_detailed_comments_kor_tpu_torch.slam import map_state as tms
from orb_slam3_detailed_comments_kor_tpu_torch.slam import system as tsys
from orb_slam3_detailed_comments_kor_tpu_torch.slam import tracking as ttr
from orb_slam3_detailed_comments_kor_tpu_torch.utils import lie as tlie

CAM = np.array([230.0, 230.0, 188.0, 120.0], np.float32)
BF = 0.11 * 230.0


def _base(rng, K, N, L, n_kf):
    f32 = np.float32
    return dict(
        kf_R_cw=np.tile(np.eye(3, dtype=f32), (K, 1, 1)),
        kf_t_cw=np.zeros((K, 3), f32),
        kf_valid=np.arange(K) < n_kf,
        kf_time=(np.arange(K) * 0.5).astype(f32),
        kf_xy=rng.uniform(0, 300, (K, N, 2)).astype(f32),
        kf_level=rng.integers(0, 4, (K, N)).astype(np.int32),
        kf_angle=rng.uniform(-3, 3, (K, N)).astype(f32),
        kf_desc=rng.integers(0, 2**32, (K, N, 8), dtype=np.uint64).astype(np.uint32),
        kf_ur=np.where(rng.random((K, N)) < 0.6, rng.uniform(0, 300, (K, N)), -1.0).astype(f32),
        kf_uvr=-np.ones((K, N, 2), f32),
        kf_feat_valid=rng.random((K, N)) < 0.9,
        obs_lm=-np.ones((K, N), np.int32),
        lm_pos=np.stack([rng.uniform(-2, 2, L), rng.uniform(-1.5, 1.5, L), rng.uniform(1.5, 4, L)],
                        1).astype(f32),
        lm_valid=rng.random(L) < 0.9,
        lm_desc=rng.integers(0, 2**32, (L, 8), dtype=np.uint64).astype(np.uint32),
        lm_normal=np.tile(np.array([0, 0, 1], f32), (L, 1)),
        lm_min_dist=np.full(L, 0.3, f32),
        lm_max_dist=np.full(L, 8.0, f32),
        lm_found=np.zeros(L, np.int32),
        lm_visible=np.zeros(L, np.int32),
        lm_first_kf=rng.integers(0, n_kf, L).astype(np.int32),
    )


def random_map(seed, K=12, N=96, L=400, n_kf=10, max_obs=7, rich=0.0):
    """Landmarks observed by 1..max_obs keyframes at random feature slots;
    holes in the keyframe and landmark validity; counters around the
    culling ratio. A ``rich`` share of the landmarks is seen by 5..8 valid
    keyframes and the rest only by valid odd slots, so the even keyframes
    see only well-observed landmarks."""
    rng = np.random.default_rng(seed)
    a = _base(rng, K, N, L, n_kf)
    a["kf_valid"][[3, 7]] = False
    free = [list(rng.permutation(N)) for _ in range(K)]
    valid = np.flatnonzero(a["kf_valid"])
    odd = valid[valid % 2 == 1]
    for lm in range(L):
        if rng.random() < rich:
            kfs = rng.choice(valid, size=int(rng.integers(5, 9)), replace=False)
        elif rich:
            kfs = rng.choice(odd, size=int(rng.integers(1, 3)), replace=False)
        else:
            kfs = rng.choice(K, size=int(rng.integers(1, max_obs + 1)), replace=False)
        for k in kfs:
            if free[k]:
                f = free[k].pop()
                a["obs_lm"][k, f] = lm
                a["kf_feat_valid"][k, f] |= rich > 0
    a["lm_visible"] = rng.integers(0, 12, L).astype(np.int32)
    a["lm_found"] = (a["lm_visible"] * rng.uniform(0, 1, L)).astype(np.int32)
    return a


def jax_map(a):
    return jms.MapState(**{k: jnp.asarray(v) for k, v in a.items()})


def torch_map(a):
    return tms.map_state_from_numpy(a, "cpu")


def assert_maps_equal(jm, tm, fields=None):
    jn = {k: np.asarray(v) for k, v in jm._asdict().items()}
    tn = tms.map_state_to_numpy(tm)
    for k in fields or jn:
        assert jn[k].dtype == tn[k].dtype, k
        assert np.array_equal(jn[k], tn[k]), k


@pytest.mark.parametrize("kf_set", [list(range(12)), [3, 7, 0], [9]])
def test_covisibility_weights_exact(kf_set):
    a = random_map(0)
    j = np.asarray(jms.covisibility_weights(jax_map(a), jnp.asarray(kf_set, jnp.int32)))
    t = tms.covisibility_weights(torch_map(a), torch.tensor(kf_set)).numpy()
    assert t.dtype == np.int32 and np.array_equal(j, t)
    assert t.max() > 1


def test_compact_keyframes_exact():
    a = random_map(1)
    jm, jnoo, jn = jms.compact_keyframes(jax_map(a))
    tm, tnoo, tn = tms.compact_keyframes(torch_map(a))
    assert_maps_equal(jm, tm)
    assert np.array_equal(np.asarray(jnoo), tnoo.numpy()) and tnoo.dtype == torch.int32
    assert int(jn) == int(tn) == 8


def test_cull_landmarks_exact():
    a = random_map(2)
    a["obs_lm"][0, :] = -1  # orphans: landmarks seen only by keyframe 0 lose it
    jm = jtr.cull_landmarks(jax_map(a))
    tm = ttr.cull_landmarks(torch_map(a))
    assert_maps_equal(jm, tm)
    culled = a["lm_valid"].sum() - np.asarray(jm.lm_valid).sum()
    assert 10 < culled < a["lm_valid"].sum()


@pytest.mark.parametrize("max_cull,redundancy", [(1, 0.9), (8, 0.9), (8, 0.75)])
def test_cull_redundant_keyframes_exact(max_cull, redundancy):
    # the even keyframes see only landmarks seen by 5-9 keyframes: several
    # are redundant at once (the first unprotected one goes first), and
    # each removal lowers the others' counts
    a = random_map(3, rich=0.7)
    protect = np.zeros(12, bool)
    protect[[0, 1, 9]] = True
    jm = jtr.cull_redundant_keyframes(jax_map(a), jnp.asarray(protect), max_cull=max_cull,
                                      redundancy=redundancy)
    tm = ttr.cull_redundant_keyframes(torch_map(a), torch.from_numpy(protect), max_cull=max_cull,
                                      redundancy=redundancy)
    assert_maps_equal(jm, tm)
    n_culled = a["kf_valid"].sum() - np.asarray(jm.kf_valid).sum()
    assert n_culled == 1 if max_cull == 1 else n_culled >= 2


@pytest.mark.parametrize("radius", [0.05, 0.5 * 0.11])
def test_fuse_duplicate_landmarks_exact(radius):
    rng = np.random.default_rng(4)
    a = random_map(4, L=1500)
    new = rng.random(1500) < 0.3
    old_idx = np.flatnonzero(~new & a["lm_valid"])
    dup = np.flatnonzero(new)[:300]
    src = rng.choice(old_idx, size=dup.size)
    # duplicates at 0-2 radii from an original, descriptors 0-80 bits apart
    a["lm_pos"][dup] = a["lm_pos"][src] + rng.normal(0, 1, (dup.size, 3)).astype(np.float32) * (
        rng.uniform(0, 2 * radius, (dup.size, 1)) / np.sqrt(3)).astype(np.float32)
    bits = np.unpackbits(a["lm_desc"][src].view(np.uint8), axis=1)
    for i, nflip in enumerate(rng.integers(0, 80, dup.size)):
        bits[i, rng.choice(256, nflip, replace=False)] ^= 1
    a["lm_desc"][dup] = np.packbits(bits, axis=1).view(np.uint32)
    jm, jn = jmm.fuse_duplicate_landmarks(jax_map(a), jnp.asarray(new), radius=radius)
    tm, tn = tmm.fuse_duplicate_landmarks(torch_map(a), torch.from_numpy(new), radius=radius)
    assert_maps_equal(jm, tm)
    assert int(jn) == int(tn) and 30 < int(tn) < dup.size


@pytest.mark.parametrize("case", ["ties", "no_old"])
def test_fuse_nearest_cpu_path(case):
    """The CPU's compacted nearest-original search (new rows against the
    original columns only) gives every new landmark the fixed-shape
    search's nearest slot and squared distance, bit for bit, on a map with
    gaps, exact duplicates (ties go to the first slot) and invalid slots."""
    rng = np.random.default_rng(21)
    L = 2600
    pos = rng.normal(0, 1, (L, 3)).astype(np.float32)
    valid = rng.random(L) < 0.8
    new = rng.random(L) < 0.3
    if case == "ties":
        pos[1200:1210] = pos[5]  # exact ties among originals
        new[1200:1210] = new[5] = False
        new[[7, 8]] = valid[[5, 7, 8]] = True
        pos[[7, 8]] = pos[5]
    else:
        new[:] = valid
    pos_t, old, nw = torch.from_numpy(pos), torch.from_numpy(valid & ~new), torch.from_numpy(valid & new)
    n_full, d_full = tmm._nearest_old(pos_t, old)
    n_cpu, d_cpu = tmm._nearest_old_compact(pos_t, old, nw)
    rows = nw.numpy()
    assert np.array_equal(n_cpu.numpy()[rows], n_full.numpy()[rows]) or case == "no_old"
    assert np.array_equal(d_cpu.numpy()[rows], d_full.numpy()[rows])
    assert np.isinf(d_cpu.numpy()[~rows]).all()
    if case == "ties":
        assert int(n_cpu[7]) == int(n_cpu[8]) == 5


@pytest.mark.parametrize("case", range(4))
def test_select_eviction_slots_exact(case):
    rng = np.random.default_rng(10 + case)
    K, n_kf = 16, 14
    cov = rng.integers(0, 60, (K, K))
    cov = cov + cov.T
    protect = np.zeros(K, bool)
    protect[[0, n_kf - 1, n_kf - 2]] = True
    soft = rng.random(K) < (0.3, 0.6, 1.0, 0.0)[case]
    if case == 3:
        protect[:] = True  # everything protected: the fallback
        protect[5] = False
    j = jsys.select_eviction_slots(cov, protect, n_kf, n_evict=5, protect_soft=soft)
    t = tsys.select_eviction_slots(cov, protect, n_kf, n_evict=5, protect_soft=soft)
    assert np.array_equal(j, t) and t.any()


# ---------------------------------------------------------------------------
# local BA
# ---------------------------------------------------------------------------

# covisible landmarks each keyframe 0..9 shares with the centre keyframe 10:
# sorted, the window of 8 takes the centre and 35, 30, 25, 20, 16, 14, and of
# the two keyframes at 12 (2 and 3, the tie at its edge) keyframe 2
SHARED = [5, 9, 12, 12, 14, 16, 20, 25, 30, 35]
CENTRE = 10


def geometric_map(seed, K=12, N=192, L=400):
    """Keyframes on a 0.5 m strafe, landmarks at 1.5-4 m observed by the
    centre and one other keyframe (SHARED) or by four consecutive
    keyframes, with projected pixels (0.3 px noise) at levels 0-2, and
    poses and points perturbed by 2 mrad / 5 mm / 2 cm. The keyframes
    zigzag 0.4 m across a 1 m strafe, and every row is stereo but 30 % of
    the non-centre rows of the centre's pairs, so every landmark the window
    sees has a stereo row in it: a point seen once in mono has no depth,
    and a straight strafe leaves a weak rotation/translation mode, either
    of which f32 Schur solves resolve differently in any two
    implementations."""
    rng = np.random.default_rng(seed)
    n_kf = CENTRE + 1
    a = _base(rng, K, N, L, n_kf)
    centres = np.stack([np.linspace(0, 1.0, n_kf), 0.2 * (-1.0) ** np.arange(n_kf),
                        rng.normal(0, 0.1, n_kf)], 1)
    R = np.stack([tlie.so3_exp(torch.from_numpy(rng.normal(0, 0.01, 3).astype(np.float32))).numpy()
                  for _ in range(n_kf)])
    t = -np.einsum("kij,kj->ki", R, centres)
    X = a["lm_pos"].astype(np.float64)
    pairs = [(k, CENTRE) for k, n in enumerate(SHARED) for _ in range(n)]
    pairs += [(k, k + 1, k + 2, k + 3) for k in range(CENTRE - 3) for _ in range(20)]
    assert len(pairs) < L
    a["lm_valid"][:] = False
    a["kf_feat_valid"][:] = False
    a["kf_ur"][:] = -1.0
    slot = np.zeros(K, int)
    for lm, pair in enumerate(pairs):
        a["lm_valid"][lm] = True
        for k in pair:
            pc = R[k] @ X[lm] + t[k]
            u, v = CAM[0] * pc[0] / pc[2] + CAM[2], CAM[1] * pc[1] / pc[2] + CAM[3]
            s = slot[k]
            slot[k] += 1
            a["kf_level"][k, s] = min(a["kf_level"][k, s], 2)
            sig = 1.2 ** a["kf_level"][k, s]
            a["kf_xy"][k, s] = np.array([u, v]) + rng.normal(0, 0.3, 2) * sig
            if k == CENTRE or len(pair) == 4 or rng.random() < 0.7:
                a["kf_ur"][k, s] = u - BF / pc[2] + rng.normal(0, 0.3) * sig
            a["kf_feat_valid"][k, s] = True
            a["obs_lm"][k, s] = lm
    dR = np.stack([tlie.so3_exp(torch.from_numpy(rng.normal(0, 0.002, 3).astype(np.float32))).numpy()
                   for _ in range(n_kf)])
    a["kf_R_cw"][:n_kf] = np.einsum("kij,kjl->kil", dR, R)
    a["kf_t_cw"][:n_kf] = t + rng.normal(0, 0.005, t.shape)
    a["lm_pos"] = (X + rng.normal(0, 0.02, X.shape)).astype(np.float32)
    return a


def _local_ba(a, centre=CENTRE):
    jm = jtr.local_ba_step(jax_map(a), jnp.int32(centre), jnp.asarray(CAM), BF, window=8,
                           lm_cap=512, iters=2)
    tm = ttr.local_ba_step(torch_map(a), centre, torch.from_numpy(CAM), BF, window=8, lm_cap=512,
                           iters=2)
    return {k: np.asarray(v) for k, v in jm._asdict().items()}, tms.map_state_to_numpy(tm)


def rotation_angles(Ra, Rb):
    M = np.einsum("kji,kjl->kil", Ra.astype(np.float64), Rb.astype(np.float64))
    skew = np.stack([M[:, 2, 1] - M[:, 1, 2], M[:, 0, 2] - M[:, 2, 0], M[:, 1, 0] - M[:, 0, 1]], -1)
    return np.arcsin(np.clip(np.linalg.norm(skew, axis=1) / 2.0, 0.0, 1.0))


def test_local_ba_window_ties_pick_lower_slot():
    a = geometric_map(20)
    cov = np.asarray(jms.covisibility_weights(jax_map(a), jnp.asarray([CENTRE], jnp.int32)))[0]
    assert cov[2] == cov[3] == 12  # the tie at the window's edge
    cov_t = tms.covisibility_weights(torch_map(a), torch.tensor([CENTRE]))[0]
    cov_t = torch.where(torch.arange(12) == CENTRE, 1 << 20, cov_t)
    cov_t = torch.where(torch.from_numpy(a["kf_valid"]), cov_t, -1)
    cov_j = jnp.where(jnp.asarray(a["kf_valid"]), jnp.asarray(cov).at[CENTRE].set(1 << 20), -1)
    win_j = np.asarray(jax.lax.top_k(cov_j, 8)[1])
    win_t = ttr._top_k_stable(cov_t, 8).numpy()
    assert np.array_equal(win_j, win_t)
    assert 2 in win_t and 3 not in win_t


@pytest.mark.parametrize("seed", [20, 21])
def test_local_ba_step_matches_reference(seed):
    a = geometric_map(seed)
    jn, tn = _local_ba(a)
    moved_j = np.abs(jn["kf_t_cw"] - a["kf_t_cw"]).max(1) > 0
    moved_t = np.abs(tn["kf_t_cw"] - a["kf_t_cw"]).max(1) > 0
    # the window minus its anchor (keyframe 2, the oldest in it)
    assert np.array_equal(moved_j, moved_t)
    assert np.array_equal(np.flatnonzero(moved_t), np.arange(4, 11))
    assert rotation_angles(jn["kf_R_cw"], tn["kf_R_cw"]).max() <= 1e-4
    assert np.abs(jn["kf_t_cw"] - tn["kf_t_cw"]).max() <= 1e-4
    assert np.abs(jn["lm_pos"] - tn["lm_pos"]).max() <= 1e-3
    assert np.array_equal(tn["lm_pos"][0], a["lm_pos"][0])  # landmark 0 is in the block, not refined
    assert np.abs(tn["lm_pos"] - a["lm_pos"]).max() > 5e-3  # the points moved
    for k in ("obs_lm", "kf_valid", "lm_valid", "lm_desc", "kf_xy"):
        assert np.array_equal(jn[k], tn[k]), k


@pytest.mark.parametrize("rows", [False, True])
def test_scatter_last_matches_reference_scatter(rows):
    """``scatter_last`` against the reference's ``.at[].set(mode="drop")``
    on the CPU: many duplicate indices (the last update wins) and indices
    past the end (dropped)."""
    rng = np.random.default_rng(31)
    shape = (50, 3) if rows else (50,)
    arr = rng.normal(size=shape).astype(np.float32)
    idx = rng.integers(0, 60, 400).astype(np.int32)
    idx[-30:] = 0
    vals = rng.normal(size=(400,) + shape[1:]).astype(np.float32)
    ref = jax.jit(lambda a, i, v: a.at[i].set(v, mode="drop"))(arr, idx, vals)
    got = tms.scatter_last(torch.from_numpy(arr), torch.from_numpy(idx), torch.from_numpy(vals))
    assert np.array_equal(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("with_scale", [False, True])
def test_ate_rmse_matches_reference(with_scale):
    rng = np.random.default_rng(30)
    gt = np.cumsum(rng.normal(0, 0.05, (60, 3)), axis=0)
    est = 1.3 * gt @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T + rng.normal(0, 0.01, gt.shape) + 2.0
    j = jate.ate_rmse(est, gt, with_scale)
    t = tate.ate_rmse(est, gt, with_scale)
    assert abs(j - t) <= 1e-9 and t > 0

