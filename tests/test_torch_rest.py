"""The reference's remaining functions against their ports, on the CPU:
the Lie quaternion helpers and ``se3_apply``, ``rotation_consistency_mask``,
single-image FAST and the plain stack path, ``build_pyramid`` and
``gaussian_blur``, stereo matching over per-level (ragged) pyramids, and the
dense DBoW2 API of the vocabulary. Inputs are made with numpy from a seed
(images: a synthetic stereo pair at the 240x376 small setup) and go
through both packages.

Tolerances, and why:
- exact: masks, word ids, FAST maps (the same float operations in the same
  order), the stereo valid mask, the atlas and its row offsets;
- quaternions and rotations within 1e-6, ``se3_apply`` within 1e-5 m
  (the norm and the matrix-vector products sum in another order);
- ``build_pyramid`` within 1e-3 grey levels (0..255; measured 1.2e-4 here
  and 4.7e-4 at 480x752): the port rebuilds the weights
  ``jax.image.resize`` computes (within 5e-6; measured 2.7e-6), and the
  two resize products sum in another order;
- ``gaussian_blur`` within 1e-4 grey levels (measured 3.1e-5): XLA fuses
  the tap sums into multiply-adds;
- stereo depth within 1e-5 relative and u_right within 1e-4 px (measured
  0): the SAD sums of the refine run in another order;
- BoW vectors, L1 scores and sparse weights within 1e-6 (the normalizing
  sums over the vocabulary run in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax._src.image import scale as jscale
from orb_slam3_detailed_comments_kor_tpu.models import vocabulary as jvoc
from orb_slam3_detailed_comments_kor_tpu.ops import fast as jfast
from orb_slam3_detailed_comments_kor_tpu.ops import matching as jmatch
from orb_slam3_detailed_comments_kor_tpu.ops import orb as jorb
from orb_slam3_detailed_comments_kor_tpu.ops import pyramid as jpyr
from orb_slam3_detailed_comments_kor_tpu.ops import stereo as jstereo
from orb_slam3_detailed_comments_kor_tpu.utils import lie as jlie
from orb_slam3_detailed_comments_kor_tpu_torch.io import synthetic as tsyn
from orb_slam3_detailed_comments_kor_tpu_torch.models import vocabulary as tvoc
from orb_slam3_detailed_comments_kor_tpu_torch.ops import fast as tfast
from orb_slam3_detailed_comments_kor_tpu_torch.ops import matching as tmatch
from orb_slam3_detailed_comments_kor_tpu_torch.ops import orb as torb
from orb_slam3_detailed_comments_kor_tpu_torch.ops import pyramid as tpyr
from orb_slam3_detailed_comments_kor_tpu_torch.ops import stereo as tstereo
from orb_slam3_detailed_comments_kor_tpu_torch.utils import lie as tlie

H, W, FX, BASELINE = 240, 376, 230.0, 0.11
BF = BASELINE * FX
CAM = np.array([FX, FX, W / 2.0, H / 2.0], np.float32)
T = torch.from_numpy


def npy(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


@pytest.fixture(scope="module")
def pair():
    """A rendered 240x376 stereo pair at the origin (the port's renderer,
    the inputs of both packages)."""
    il, ir, _ = tsyn.stereo_pair(T(CAM), torch.eye(3), torch.zeros(3), BASELINE, tsyn.default_scene("cpu"), h=H, w=W)
    return il.numpy(), ir.numpy()


def test_quaternions_and_se3_apply():
    """``rotmat_to_quat`` (each of Shepperd's four branches: near the
    identity and near 180° about x, y and z), ``quat_to_rotmat`` and
    ``se3_apply`` on batches."""
    rng = np.random.RandomState(0)
    w = rng.normal(size=(64, 3)).astype(np.float32)
    w[:4] = [[1e-4, 0, 0], [3.1, 0.01, 0], [0, 3.1, 0.02], [0.01, 0, 3.1]]
    qn = rng.normal(size=(64, 4)).astype(np.float32)
    t = rng.normal(size=(64, 3)).astype(np.float32)
    x = rng.normal(size=(64, 5, 3)).astype(np.float32) * 10
    R, q_ref, R_ref, y_ref = jax.tree.map(np.array, jax.jit(lambda w, qn, t, x: (
        jlie.so3_exp(w), jlie.rotmat_to_quat(jlie.so3_exp(w)), jlie.quat_to_rotmat(qn),
        jlie.se3_apply(jlie.so3_exp(w)[:, None], t[:, None], x)))(*map(jnp.asarray, (w, qn, t, x))))
    np.testing.assert_allclose(npy(tlie.rotmat_to_quat(T(R))), q_ref, rtol=0, atol=1e-6)
    assert (np.argmax(np.abs(q_ref[:4]), axis=1) == [0, 1, 2, 3]).all()
    np.testing.assert_allclose(npy(tlie.quat_to_rotmat(T(qn))), R_ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(npy(tlie.se3_apply(T(R)[:, None], T(t)[:, None], T(x))), y_ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ["dominant", "uniform", "none_valid"])
def test_rotation_consistency_mask(case):
    """The 30-bin histogram's top-3 bins with the 10 % floor: exact."""
    rng = np.random.RandomState(["dominant", "uniform", "none_valid"].index(case))
    n, m = 400, 300
    angle_b = rng.uniform(0, 2 * np.pi, m).astype(np.float32)
    idx = rng.randint(0, m, n).astype(np.int32)
    if case == "dominant":  # most matches rotated by ~0.5 rad, a few spread
        diff = np.where(rng.rand(n) < 0.8, 0.5 + rng.normal(0, 0.05, n), rng.uniform(-7, 7, n))
    else:
        diff = rng.uniform(-7, 7, n)
    angle_a = (angle_b[idx] + diff).astype(np.float32)
    valid = rng.rand(n) < (0.0 if case == "none_valid" else 0.9)
    ref = np.asarray(jmatch.rotation_consistency_mask(jnp.asarray(angle_a), jnp.asarray(angle_b), jnp.asarray(idx),
                                                      jnp.asarray(valid)))
    got = npy(tmatch.rotation_consistency_mask(T(angle_a), T(angle_b), T(idx), T(valid)))
    assert np.array_equal(got, ref)
    if case == "dominant":
        assert 0.5 * valid.sum() < got.sum() < valid.sum()
    if case == "none_valid":
        assert not got.any()


@jax.jit
def _jax_fast(img, flat, inb):
    return (jfast._has_contiguous_run(((jnp.arange(2 ** 16)[:, None] >> jnp.arange(16)[None, :]) & 1) > 0),
            [jfast.fast_score_raw(img, th) for th in (20.0, 7.0)], [jfast.fast_score(img, th) for th in (20.0, 7.0)],
            jfast.fast_with_fallback(img, 20.0, 7.0, 24), jfast.fast_with_fallback_stack(flat, 20.0, 7.0, 24, inb))


def test_fast_single_image_and_stack_exact(pair):
    """``_has_contiguous_run`` on every 16-bit mask, ``fast_score_raw``,
    ``fast_score`` and ``fast_with_fallback`` on the rendered image, and the
    plain stack path ``fast_with_fallback_stack`` on its three-level padded
    stack: exact."""
    img = pair[0]
    levels = [npy(x) for x in tpyr.build_pyramid(T(img), 3, 1.2)]
    hs, ws = tuple(x.shape[0] for x in levels), tuple(x.shape[1] for x in levels)
    flat = np.zeros((3, H, 384), np.float32)
    for l, x in enumerate(levels):
        flat[l, :x.shape[0], :x.shape[1]] = x
    inb = tfast.level_interior(hs, ws, 3, H, 384, torch.device("cpu"))
    run, raw, score, fwf, stack = jax.tree.map(np.array, _jax_fast(jnp.asarray(img), jnp.asarray(flat),
                                                                     jnp.asarray(npy(inb))))
    masks = ((np.arange(2 ** 16)[:, None] >> np.arange(16)[None, :]) & 1).astype(bool)
    got = npy(tfast._has_contiguous_run(T(masks)))
    assert np.array_equal(got, run) and np.array_equal(got, npy(tfast._run9_bits(T(np.arange(2 ** 16, dtype=np.int32)))))
    for i, th in enumerate((20.0, 7.0)):
        assert np.array_equal(npy(tfast.fast_score_raw(T(img), th)), raw[i])
        assert np.array_equal(npy(tfast.fast_score(T(img), th)), score[i])
    got = npy(tfast.fast_with_fallback(T(img), 20.0, 7.0, 24))
    assert np.array_equal(got, fwf) and (got > 0).sum() > 500
    for a, b in zip(tfast.fast_with_fallback_stack(T(flat), 20.0, 7.0, 24, inb), stack):
        assert np.array_equal(npy(a), b)


@jax.jit
def _jax_pyramid(img, x):
    shapes = jpyr.level_shapes(H, W, 8, 1.2)
    weights = [jscale.compute_weight_mat(a, b, b / a, 0.0, jscale._kernels[jscale.ResizeMethod.LINEAR], True).T
               for s0, s1 in zip(shapes[:-1], shapes[1:]) for a, b in zip(s0, s1)]
    return (jpyr.build_pyramid(img, 8, 1.2), weights, jpyr._gauss_kernel(7, 2.0), jpyr.gaussian_blur(x),
            jpyr.gaussian_blur(img, 5, 1.5))


def test_build_pyramid_and_blur(pair):
    """``build_pyramid`` (each level from the one before) level by level;
    the resize weights against jax's own; ``_gauss_kernel`` exactly;
    ``gaussian_blur`` with batch dimensions and another kernel size."""
    img = pair[0]
    x = np.random.RandomState(1).uniform(0, 255, (2, 3, 40, 52)).astype(np.float32)
    ref, weights, kernel, blur, blur5 = jax.tree.map(np.array, _jax_pyramid(jnp.asarray(img), jnp.asarray(x)))
    got = [npy(v) for v in tpyr.build_pyramid(T(img), 8, 1.2)]
    shapes = tpyr.level_shapes(H, W, 8, 1.2)
    assert [v.shape for v in got] == [v.shape for v in ref] == shapes
    assert max(float(np.abs(a - b).max()) for a, b in zip(got, ref)) <= 1e-3
    sizes = [(a, b) for s0, s1 in zip(shapes[:-1], shapes[1:]) for a, b in zip(s0, s1)]
    assert max(float(np.abs(w - tpyr._eager_weights(a, b)).max()) for w, (a, b) in zip(weights, sizes)) <= 5e-6
    assert np.array_equal(npy(tpyr._gauss_kernel(7, 2.0)), kernel)
    np.testing.assert_allclose(npy(tpyr.gaussian_blur(T(x))), blur, rtol=0, atol=1e-4)
    np.testing.assert_allclose(npy(tpyr.gaussian_blur(T(img), 5, 1.5)), blur5, rtol=0, atol=1e-4)


@jax.jit
def _jax_stereo(il, ir):
    fl, fr = (jorb.extract_orb(x, n_features=600, cell=24) for x in (il, ir))
    pyr_l, pyr_r = (jpyr.build_pyramid(x, 8, 1.2) for x in (il, ir))
    return (fl, fr, pyr_l, pyr_r, jstereo.compute_stereo_matches(fl, fr, pyr_l, pyr_r, BF)) + tuple(
        jstereo._stack_pyramid(pyr_l))


def test_stereo_over_ragged_pyramids(pair):
    """The list branch of ``compute_stereo_matches`` (``tests/test_orb.py``'s
    stereo setup at 240x376): the same features and per-level pyramids go
    into both; the atlas, the valid mask and the depths against the
    reference's output."""
    fl, fr, pyr_l, pyr_r, ref, ref_atlas, ref_off = jax.tree.map(np.array, _jax_stereo(*map(jnp.asarray, pair)))
    atlas, off = tstereo._stack_pyramid([T(x) for x in pyr_l])
    assert atlas.shape == (sum(x.shape[0] for x in pyr_l), W)
    assert np.array_equal(npy(atlas), ref_atlas) and np.array_equal(npy(off), ref_off)
    tf = [torb.Features(*(T(np.array(a)) for a in f)) for f in (fl, fr)]
    got = tstereo.compute_stereo_matches(tf[0], tf[1], [T(x) for x in pyr_l], [T(x) for x in pyr_r], BF)
    valid = ref.valid
    assert valid.sum() > 100 and np.array_equal(npy(got.valid), valid)
    np.testing.assert_allclose(npy(got.depth)[valid], ref.depth[valid], rtol=1e-5, atol=0)
    np.testing.assert_allclose(npy(got.u_right)[valid], ref.u_right[valid], rtol=0, atol=1e-4)
    assert (npy(got.depth)[~valid] == -1).all()


@functools.partial(jax.jit, static_argnames=("k", "depth"))
def _jax_vocab(cents, idf, desc, valid, k, depth):
    v = jvoc.Vocabulary(centroids=cents, k=k, depth=depth, idf=idf)
    words = jvoc.transform_exact(v, desc, valid, chunk=100)
    bows = [jvoc.bow_vector(v, words[lo:lo + 100], valid[lo:lo + 100]) for lo in (0, 100, 200)]
    ids, dist = jvoc.transform_exact_topk(v, desc, valid, kk=3)
    wts = jvoc.soft_assign_weights(dist, sigma=8.0)
    return dict(words=words, words_one_chunk=jvoc.transform_exact(v, desc, valid), bows=bows,
                l1=jvoc.l1_score(bows[0], bows[1]), db=jvoc.score_against_database(bows[0], jnp.stack(bows)),
                ids=ids, wts=wts, soft=jvoc.bow_vector_soft(v, ids, wts, valid),
                sparse=[jvoc.sparse_bow(v, words, valid, topw=t) for t in (64, 256)])


@pytest.fixture(scope="module")
def vocab():
    """A k=4, depth 4 tree (256 words) of random 0/1 centroids with leaf
    200 a copy of leaf 20 (a tie across word chunks), 300 descriptors
    (random ones, exact copies of leaves 20 and 7, invalid rows), the
    port's tree and the reference's outputs."""
    rng = np.random.RandomState(0)
    off = jvoc._level_offset(4, 3)
    cents = (rng.rand(off + 256, 256) < 0.5).astype(np.float32)
    cents[off + 200] = cents[off + 20]
    idf = rng.uniform(0.5, 3.0, 256).astype(np.float32)
    desc = (rng.rand(300, 256) < 0.5).astype(np.uint8)
    desc[:5] = cents[off + 20]
    desc[5:8] = cents[off + 7]
    valid = rng.rand(300) < 0.9
    valid[:8] = True
    ref = jax.tree.map(np.array, _jax_vocab(*map(jnp.asarray, (cents, idf, desc, valid)), k=4, depth=4))
    return tvoc.Vocabulary(centroids=T(cents), k=4, depth=4, idf=T(idf)), desc, valid, ref


def test_transform_exact_and_bow_vectors(vocab):
    """``transform_exact`` over three word chunks and over one (ties take
    the lowest word), then ``bow_vector``, ``bow_vector_soft``,
    ``l1_score`` and ``score_against_database``."""
    tv, desc, valid, ref = vocab
    got = npy(tvoc.transform_exact(tv, T(desc), T(valid), chunk=100))
    assert got.dtype == np.int32 and np.array_equal(got, ref["words"])
    assert (got[:5] == 20).all() and (got[5:8] == 7).all() and (got[~valid] == -1).all()
    assert np.array_equal(npy(tvoc.transform_exact(tv, T(desc), T(valid))), ref["words_one_chunk"])
    bows = [npy(tvoc.bow_vector(tv, T(got[lo:lo + 100]), T(valid[lo:lo + 100]))) for lo in (0, 100, 200)]
    for a, b in zip(bows, ref["bows"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    np.testing.assert_allclose(npy(tvoc.l1_score(T(bows[0]), T(bows[1]))), ref["l1"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(npy(tvoc.score_against_database(T(bows[0]), T(np.stack(bows)))), ref["db"],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(npy(tvoc.bow_vector_soft(tv, T(ref["ids"]), T(ref["wts"]), T(valid))), ref["soft"],
                               rtol=0, atol=1e-6)


def test_sparse_bow(vocab):
    """``sparse_bow``: ids exactly (the stable top-k, F3; -1 past the
    document's words), weights within 1e-6."""
    tv, _, valid, ref = vocab
    for topw, (ri, rw) in zip((64, 256), ref["sparse"]):
        gi, gw = tvoc.sparse_bow(tv, T(ref["words"]), T(valid), topw=topw)
        assert npy(gi).dtype == np.int32 and np.array_equal(npy(gi), ri)
        np.testing.assert_allclose(npy(gw), rw, rtol=0, atol=1e-6)
    assert (npy(gi) == -1).sum() > 0
