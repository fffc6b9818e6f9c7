"""The port's loop-closing parts against the JAX reference on the CPU:
the threefry stream (``utils/prng``), the vocabulary and BoW scoring,
``match_nn_ratio``, the Sim(3)/SE(3) Lie additions, Horn alignment and the
Sim3/PnP RANSACs, the pose graphs and the matrix-free global BA, on
inputs made from a numpy seed.

Tolerances: the random stream, the BoW word ids, the matches, the RANSAC
inlier masks and counts are exact; BoW weights and L1 scores within 1e-6;
RANSAC and pose-graph rotations within 1e-5 (matrix entries) and
translations within 1e-5 m (the sim3 RANSAC's free scale within 1e-5
relative); the Lie maps within 1e-5; the global BA (2 LM iterations, 24 CG
steps) poses within 1e-4 rad / 1e-4 m, points within 1e-3 m, chi2 within
rtol 1e-3. The RANSACs are fed the very indices JAX drew
(``jax.random.choice`` from the same key), and separately draw them
themselves from the key.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import test_torch_ba as tba_test  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu.models import vocabulary as jvoc  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu.ops import matching as jmatch  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu.ops import ransac as jr  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu.optim import ba as jba  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu.optim import pose_graph as jpg  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu.utils import lie as jlie  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu_torch.models import vocabulary as tvoc  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu_torch.ops import matching as tmatch  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu_torch.ops import ransac as tr  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu_torch.optim import ba as tba  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu_torch.optim import pose_graph as tpg  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu_torch.utils import lie as tlie  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu_torch.utils import prng  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAM = np.array([458.0, 458.0, 376.0, 240.0], np.float32)
SEED_KEY = b"loopseed"


def T(a):
    return torch.from_numpy(np.array(a))


def jkey():
    return jnp.asarray(np.frombuffer(SEED_KEY, dtype=np.uint32)[:2])


def tkey():
    return prng.key_from_bytes(SEED_KEY, "cpu")


def keys(n):
    """n successive (jax, torch) subkeys, split as the system splits them."""
    kj, kt, out = jkey(), tkey(), []
    for _ in range(n):
        kj, sj = jax.random.split(kj)
        st = prng.split(kt)
        kt = st[0]
        out.append((sj, st[1]))
    return out


def jax_draw(key, valid, shape):
    """JAX's own sample draw, as ``ops/ransac.py`` makes it."""
    probs = jnp.asarray(valid).astype(jnp.float32)
    probs = probs / jnp.maximum(probs.sum(), 1e-9)
    return np.asarray(jax.random.choice(key, valid.shape[0], shape=shape, p=probs))


# --- the random stream -----------------------------------------------------

def test_prng_matches_jax_bit_for_bit():
    kj, kt = jkey(), tkey()
    rng = np.random.default_rng(0)
    for _ in range(6):
        pair_j = jax.random.split(kj)
        pair_t = prng.split(kt)
        assert (np.asarray(pair_j).astype(np.int64) == pair_t.numpy()).all()
        kj, sj = pair_j
        kt, st = pair_t[0], pair_t[1]
        assert (np.asarray(jax.random.uniform(sj, (192, 3))) == prng.uniform(st, (192, 3)).numpy()).all()
        for M in (1, 7, 600, 4097):
            valid = rng.random(M) > 0.4
            valid[0] = True
            t = tr._draw(st, T(valid), (192, 4)).numpy()
            assert (jax_draw(sj, valid, (192, 4)) == t).all(), M


@pytest.mark.parametrize("n", [1, 16, 17, 300, 4097])
def test_xla_cumsum_order(n):
    x = np.random.default_rng(n).random(n).astype(np.float32)
    assert (np.asarray(jnp.cumsum(jnp.asarray(x))) == prng.xla_cumsum(T(x)).numpy()).all()


# --- vocabulary and BoW ----------------------------------------------------

def test_vocabulary_file_is_the_references():
    files = [os.path.join(REPO, pkg, "models", "default_vocab.npz")
             for pkg in ("orb_slam3_detailed_comments_kor_tpu", "orb_slam3_detailed_comments_kor_tpu_torch")]
    with open(files[0], "rb") as a, open(files[1], "rb") as b:
        assert a.read() == b.read()
    assert tvoc._DEFAULT_PATH == os.path.abspath(files[1])


@pytest.fixture(scope="module")
def vocabs():
    return jvoc.load_default(), tvoc.load_default("cpu")


def descriptors(vocab, seed, n=400):
    """Half near leaf centroids (5 % of bits flipped, so words tie and
    neighbour), half random; 10 % invalid."""
    rng = np.random.default_rng(seed)
    leaves = np.asarray(vocab.centroids)[jvoc._level_offset(vocab.k, vocab.depth - 1):]
    bits = (rng.random((n, 256)) > 0.5).astype(np.uint8)
    near = leaves[rng.integers(0, leaves.shape[0], n // 2)].astype(np.uint8)
    bits[: n // 2] = near ^ (rng.random(near.shape) < 0.05)
    return bits, rng.random(n) > 0.1


def test_sparse_bow_rows_and_scores(vocabs):
    jv, tv = vocabs
    rows = []
    for seed in range(4):
        bits, valid = descriptors(jv, seed)
        if seed:
            bits[:150] = descriptors(jv, 0)[0][:150]  # rows that share words with row 0
        ij, wj = (np.asarray(a) for a in jvoc.sparse_bow_soft_from_desc(jv, jnp.asarray(bits), jnp.asarray(valid)))
        it, wt = (a.numpy() for a in tvoc.sparse_bow_soft_from_desc(tv, T(bits), T(valid)))
        assert (ij == it).all()
        assert (ij >= 0).sum() > 300
        assert np.abs(wj - wt).max() <= 1e-6
        rows.append((ij, wj))
    ids = np.stack([r[0] for r in rows])
    wts = np.stack([r[1] for r in rows])
    sj = np.asarray(jvoc.sparse_l1_score(jnp.asarray(ids[0]), jnp.asarray(wts[0]), jnp.asarray(ids),
                                         jnp.asarray(wts)))
    st = tvoc.sparse_l1_score(T(ids[0]), T(wts[0]), T(ids), T(wts)).numpy()
    assert abs(sj[0] - 1.0) < 1e-5 and sj[1:].max() > 0.05
    assert np.abs(sj - st).max() <= 1e-6


def test_top_k_ties_at_the_boundary():
    # 100,000 weights whose values tie across the 2,048th slot: the lower
    # index goes first, as the reference's top-k on the CPU
    rng = np.random.default_rng(3)
    v = np.zeros(100000, np.float32)
    v[rng.choice(100000, 1500, replace=False)] = rng.random(1500).astype(np.float32) + 1.0
    tie = rng.choice(np.flatnonzero(v == 0), 1200, replace=False)
    v[tie] = 0.5
    wj, ij = jax.lax.approx_max_k(jnp.asarray(v), tvoc.TOPW)
    wt, it = tvoc.top_k_stable(T(v), tvoc.TOPW)
    assert (np.asarray(ij) == it.numpy()).all() and (np.asarray(wj) == wt.numpy()).all()
    assert (np.asarray(wj) == 0.5).sum() == tvoc.TOPW - 1500  # the boundary falls inside the tie


def test_match_nn_ratio_exact():
    rng = np.random.default_rng(5)
    a = (rng.random((300, 256)) > 0.5).astype(np.uint8)
    b = np.concatenate([a[:200] ^ (rng.random((200, 256)) < 0.1), (rng.random((150, 256)) > 0.5)]).astype(np.uint8)
    b[200:210] = b[:10]  # duplicates: ratio-test ties
    va, vb = rng.random(300) > 0.1, rng.random(350) > 0.1
    j = jmatch.match_nn_ratio(jnp.asarray(a), jnp.asarray(b), jnp.asarray(va), jnp.asarray(vb), max_dist=60,
                              ratio=0.85)
    t = tmatch.match_nn_ratio(T(a), T(b), T(va), T(vb), max_dist=60, ratio=0.85)
    assert (np.asarray(j.idx) == t.idx.numpy()).all() and (np.asarray(j.valid) == t.valid.numpy()).all()
    assert np.asarray(j.valid).sum() > 100


# --- Lie groups -------------------------------------------------------------

def test_lie_additions():
    rng = np.random.default_rng(7)
    w = (rng.normal(size=(20, 3)) * np.r_[[1e-7] * 3, [0.3] * 17][:, None]).astype(np.float32)
    t = rng.normal(size=(20, 3)).astype(np.float32)
    sig = (rng.normal(size=20) * 0.2).astype(np.float32)
    sig[:3] = 0.0
    R = np.asarray(jlie.so3_exp(jnp.asarray(w)))
    pairs = [
        (jlie.se3_log(jnp.asarray(R), jnp.asarray(t)), tlie.se3_log(T(R), T(t))),
        (jlie.so3_right_jacobian_inv(jnp.asarray(w)), tlie.so3_right_jacobian_inv(T(w))),
    ]
    xi = np.concatenate([t, w, sig[:, None]], 1)
    ej = jlie.sim3_exp(jnp.asarray(xi))
    et = tlie.sim3_exp(T(xi))
    pairs += list(zip(ej, et))
    pairs.append((jlie.sim3_log(*ej), tlie.sim3_log(*et)))
    s = np.exp(sig).astype(np.float32)
    x = rng.normal(size=(20, 3)).astype(np.float32)
    inv_j, inv_t = jlie.sim3_inverse(jnp.asarray(R), jnp.asarray(t), jnp.asarray(s)), tlie.sim3_inverse(T(R), T(t), T(s))
    pairs += list(zip(inv_j, inv_t))
    pairs += list(zip(jlie.sim3_compose(*inv_j, jnp.asarray(R), jnp.asarray(t), jnp.asarray(s)),
                      tlie.sim3_compose(*inv_t, T(R), T(t), T(s))))
    pairs.append((jlie.sim3_apply(jnp.asarray(R), jnp.asarray(t), jnp.asarray(s), jnp.asarray(x)),
                  tlie.sim3_apply(T(R), T(t), T(s), T(x))))
    for j, t_ in pairs:
        np.testing.assert_allclose(t_.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


# --- alignment and RANSAC --------------------------------------------------

def points(seed, M=300, n_out=60):
    """src/dst pairs under a 0.2 rad, (0.3, -0.2, 0.1) m warp, 1 cm noise,
    ``n_out`` outliers displaced by ~1 m."""
    rng = np.random.default_rng(seed)
    src = (rng.normal(size=(M, 3)) * 2 + np.r_[0, 0, 5]).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.array([0.05, -0.1, 0.2])))
    dst = src @ R.T + np.r_[0.3, -0.2, 0.1]
    dst[:n_out] += rng.normal(size=(n_out, 3))
    dst = (dst + rng.normal(size=dst.shape) * 0.01).astype(np.float32)
    return src, dst, R, rng.random(M) > 0.1, rng


def assert_pose_close(j, t, tol=1e-5):
    for a, b in zip(j, t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=tol)


@pytest.mark.parametrize("fix_scale", [True, False])
def test_horn_align(fix_scale):
    src, dst, _, _, rng = points(0)
    w = (rng.random(src.shape[0]) > 0.5).astype(np.float32)
    j = jr.horn_align(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), fix_scale)
    t = tr.horn_align(T(src), T(dst), T(w), fix_scale)
    assert_pose_close(j, t)
    # near-degenerate C: three points, one 1 % off the line of the other two
    w3 = np.zeros_like(w)
    w3[[3, 4, 5]] = 1.0
    s3 = src.copy()
    s3[5] = s3[3] + 0.5 * (s3[4] - s3[3]) + 0.01 * np.linalg.norm(s3[4] - s3[3]) * np.r_[0, 0, 1]
    d3 = s3 @ np.asarray(jlie.so3_exp(jnp.array([0.0, 0.2, 0.0]))).T
    j = jr.horn_align(jnp.asarray(s3), jnp.asarray(d3.astype(np.float32)), jnp.asarray(w3), fix_scale)
    t = tr.horn_align(T(s3), T(d3.astype(np.float32)), T(w3), fix_scale)
    assert_pose_close(j, t, 1e-4)


def test_sim3_ransac_with_jax_draws():
    src, dst, _, valid, _ = points(1)
    for sj, st in keys(2):
        idx = jax_draw(sj, valid, (192, 3))
        j = jr.sim3_ransac(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid), sj, n_hyp=192, inlier_th=0.12)
        for t in (tr.sim3_ransac(T(src), T(dst), T(valid), None, n_hyp=192, inlier_th=0.12, idx=T(idx)),
                  tr.sim3_ransac(T(src), T(dst), T(valid), st, n_hyp=192, inlier_th=0.12)):
            assert (np.asarray(j.inliers) == t.inliers.numpy()).all() and int(j.n_inliers) == int(t.n_inliers)
            assert_pose_close(j[:3], t[:3])
        assert int(j.n_inliers) > 150


def reproj_problem(seed):
    src, _, R, valid, rng = points(seed)
    M = src.shape[0]
    Ra, ta = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    Rb = np.asarray(jlie.so3_exp(jnp.array([0.0, 0.1, 0.0])))
    tb = np.r_[0.2, 0.0, 0.1].astype(np.float32)

    def proj(R_, t_, X):
        pc = X @ R_.T + t_
        return (CAM[:2] * pc[:, :2] / pc[:, 2:3] + CAM[2:]).astype(np.float32)

    Xd = (src @ R.T + np.r_[0.3, -0.2, 0.1]).astype(np.float32)
    dst = Xd + rng.normal(size=Xd.shape).astype(np.float32) * 0.01
    dst[:60] += rng.normal(size=(60, 3)).astype(np.float32)
    uva = proj(Ra, ta, src) + rng.normal(size=(M, 2)).astype(np.float32) * 0.5
    uvb = proj(Rb, tb, Xd) + rng.normal(size=(M, 2)).astype(np.float32) * 0.5
    s2a = (1.2 ** (2 * rng.integers(0, 3, M))).astype(np.float32)
    s2b = (1.2 ** (2 * rng.integers(0, 3, M))).astype(np.float32)
    return [src, dst, uva, uvb, s2a, s2b, (Ra, ta), (Rb, tb), CAM, valid]


@pytest.mark.parametrize("fix_scale", [True, False])
def test_sim3_ransac_reproj_with_jax_draws(fix_scale):
    args = reproj_problem(2)
    valid = args[-1]
    conv = lambda f: [tuple(f(x) for x in a) if isinstance(a, tuple) else f(a) for a in args]
    (sj, st), = keys(1)
    j = jr.sim3_ransac_reproj(*conv(jnp.asarray), sj, n_hyp=192, fix_scale=fix_scale)
    idx = jax_draw(sj, valid, (192, 3))
    for t in (tr.sim3_ransac_reproj(*conv(T), None, n_hyp=192, fix_scale=fix_scale, idx=T(idx)),
              tr.sim3_ransac_reproj(*conv(T), st, n_hyp=192, fix_scale=fix_scale)):
        assert (np.asarray(j.inliers) == t.inliers.numpy()).all() and int(j.n_inliers) == int(t.n_inliers)
        assert_pose_close(j[:2], t[:2])
        assert abs(float(t.s) / float(j.s) - 1.0) <= 1e-5
    assert int(j.n_inliers) > 150


def pnp_problem(seed):
    src, _, _, valid, rng = points(seed)
    Rc = np.asarray(jlie.so3_exp(jnp.array([0.02, 0.3, -0.05])))
    tc = np.r_[0.1, 0.2, -0.3].astype(np.float32)
    pc = src @ Rc.T + tc
    uv = (CAM[:2] * pc[:, :2] / pc[:, 2:3] + CAM[2:] + rng.normal(size=(src.shape[0], 2)) * 0.5).astype(np.float32)
    uv[:80] = (rng.random((80, 2)) * np.r_[752, 480]).astype(np.float32)
    return src, uv, valid, Rc, tc


def test_pnp_ransac_with_jax_draws():
    X, uv, valid, _, _ = pnp_problem(3)
    (sj, st), = keys(1)
    j = jr.pnp_ransac(jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid), jnp.asarray(CAM), sj, n_hyp=192,
                      inlier_px=6.0)
    idx = jax_draw(sj, valid, (192, 4))
    for t in (tr.pnp_ransac(T(X), T(uv), T(valid), T(CAM), None, n_hyp=192, inlier_px=6.0, idx=T(idx)),
              tr.pnp_ransac(T(X), T(uv), T(valid), T(CAM), st, n_hyp=192, inlier_px=6.0)):
        assert (np.asarray(j[2]) == t[2].numpy()).all() and int(j[3]) == int(t[3])
        assert_pose_close(j[:2], t[:2])
    assert int(j[3]) > 150


def test_mlpnp_refine():
    X, uv, valid, Rc, tc = pnp_problem(4)
    w = (valid & (np.arange(X.shape[0]) >= 80)).astype(np.float32)
    R0 = np.asarray(jlie.so3_exp(jnp.array([0.03, 0.28, -0.04])))
    t0 = (tc + 0.02).astype(np.float32)
    j = jr.mlpnp_refine(jnp.asarray(X), jnp.asarray(uv), jnp.asarray(w), jnp.asarray(CAM), jnp.asarray(R0),
                        jnp.asarray(t0), iters=4)
    t = tr.mlpnp_refine(T(X), T(uv), T(w), T(CAM), T(R0), T(t0), iters=4)
    assert_pose_close(j, t)
    assert np.abs(np.asarray(j[1]) - tc).max() < 5e-3  # it converged


# --- pose graphs and global BA ------------------------------------------------

def pose_graph_problem(K=12):
    rng = np.random.default_rng(0)
    R = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=(K, 3)) * 0.1, jnp.float32)))
    t = (rng.normal(size=(K, 3)) * 0.5).astype(np.float32)
    chain = jpg.make_edges_from_poses(jnp.arange(K - 1), jnp.arange(1, K), jnp.asarray(R), jnp.asarray(t))
    loop = jpg.PoseGraphEdges(
        i=jnp.array([K - 1]), j=jnp.array([0]),
        R_meas=jlie.so3_exp(jnp.array([[0.02, 0.03, -0.01]])), t_meas=jnp.array([[0.1, 0.2, 0.05]]),
        s_meas=jnp.array([1.1]), weight=jnp.array([30.0]), valid=jnp.ones((1,), bool))
    edges = jax.tree.map(lambda a, b: jnp.concatenate([a, b]), chain, loop)
    edges = edges._replace(valid=edges.valid.at[3].set(False))
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return R, t, edges, fixed


def test_pose_graph_se3():
    R, t, edges, fixed = pose_graph_problem()
    edges = edges._replace(s_meas=jnp.ones_like(edges.s_meas))
    j = jpg.optimize_pose_graph_se3(jnp.asarray(R), jnp.asarray(t), edges, jnp.asarray(fixed), iters=15)
    t_ = tpg.optimize_pose_graph_se3(T(R), T(t), tpg.PoseGraphEdges(*(T(a) for a in edges)), T(fixed), iters=15)
    assert np.abs(np.asarray(j[1]) - t).max() > 1e-3  # the loop edge moved the graph
    assert_pose_close(j, t_)


def test_pose_graph_sim3():
    R, t, edges, fixed = pose_graph_problem()
    s = np.ones(R.shape[0], np.float32)
    j = jpg.optimize_pose_graph_sim3(jnp.asarray(R), jnp.asarray(t), jnp.asarray(s), edges, jnp.asarray(fixed),
                                     iters=15)
    t_ = tpg.optimize_pose_graph_sim3(T(R), T(t), T(s), tpg.PoseGraphEdges(*(T(a) for a in edges)), T(fixed),
                                      iters=15)
    assert np.abs(np.asarray(j[2]) - 1.0).max() > 1e-3  # the loop edge's scale spread over the graph
    assert_pose_close(j, t_)


def test_bundle_adjust_cg():
    w = tba_test.make_window(5)
    cam, bf = tba_test.CAM, tba_test.BF
    j = jba.bundle_adjust_cg(
        jnp.asarray(w["R"]), jnp.asarray(w["t"]), jnp.asarray(w["X"]), tba_test.jax_obs(w),
        jnp.asarray(w["fixed_pose"]), jnp.asarray(w["fixed_point"]), jnp.asarray(cam), bf, iters=2, cg_iters=24)
    t = tba.bundle_adjust_cg(
        T(w["R"]), T(w["t"]), T(w["X"]), tba_test.torch_obs(w), T(w["fixed_pose"]), T(w["fixed_point"]),
        T(cam), bf, iters=2, cg_iters=24)
    j = [np.asarray(x) for x in j]
    t = [x.numpy() for x in t]
    assert np.abs(j[1] - w["t"]).max() > 2e-3  # the solve moved the window
    assert tba_test.rotation_angles(j[0], t[0]).max() <= 1e-4
    assert np.abs(j[1] - t[1]).max() <= 1e-4
    assert np.abs(j[2] - t[2]).max() <= 1e-3
    np.testing.assert_allclose(t[3], j[3], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reloc_candidate_groups(seed):
    from orb_slam3_detailed_comments_kor_tpu.slam import system as jsys
    from orb_slam3_detailed_comments_kor_tpu_torch.slam import system as tsys

    rng = np.random.default_rng(seed)
    n = 20
    cov = rng.integers(0, 40, (n, n))
    cov = np.minimum(cov, cov.T)
    scores = np.where(rng.random(n) < 0.3, 0.0, rng.random(n) * 0.4).astype(np.float32)
    scores[rng.integers(0, n)] = scores.max()  # a tie for the best member
    for top_k in (1, 3):
        assert tsys.reloc_candidate_groups(cov, scores, top_k=top_k) == \
            jsys.reloc_candidate_groups(cov, scores, top_k=top_k)
