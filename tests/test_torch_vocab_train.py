"""The port's vocabulary training, online training in the loop closer, the
corridor scenes and trajectory, and the offline viewer, against the JAX
package on the same inputs.

Tolerances: ``train_vocabulary`` centroids bit-equal (both train on the
host with the same ``np.random.RandomState`` draws; the 0/1 distance
products are exact in float32); ``transform`` words equal; ``compute_idf``
within 1e-6; ``LoopCloser(vocab=None)``: the same vocabulary, and the
backfilled database rows (as dense vectors over the words) within 1e-5;
``corridor_scene`` / ``wall_scene`` exactly; ``CorridorTrajectory``
poses and velocities within 2e-6, IMU samples within 5e-6 (a few float32
ulps of gravity's 9.81: the reference evaluates its law in float32, the
port in float64 from the same float32 time);
``draw_frame`` and ``export_html`` exactly, ``_map_arrays`` exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from orb_slam3_detailed_comments_kor_tpu.io import synthetic as jsyn
from orb_slam3_detailed_comments_kor_tpu.models import vocabulary as jvoc
from orb_slam3_detailed_comments_kor_tpu.slam import loop_closing as jlc
from orb_slam3_detailed_comments_kor_tpu.slam import map_state as jms
from orb_slam3_detailed_comments_kor_tpu.viz import viewer as jviewer
from orb_slam3_detailed_comments_kor_tpu_torch.io import synthetic as tsyn
from orb_slam3_detailed_comments_kor_tpu_torch.models import vocabulary as tvoc
from orb_slam3_detailed_comments_kor_tpu_torch.slam import loop_closing as tlc
from orb_slam3_detailed_comments_kor_tpu_torch.slam import map_state as tms
from orb_slam3_detailed_comments_kor_tpu_torch.utils import lie as tlie
from orb_slam3_detailed_comments_kor_tpu_torch.viz import viewer as tviewer


def clustered(rng, n, n_clusters=20, flip=0.05):
    """Clustered binary descriptors [n,256] uint8 (so a vocabulary has
    structure) and their cluster ids."""
    protos = rng.randint(0, 2, (n_clusters, 256))
    assign = rng.randint(0, n_clusters, n)
    return np.logical_xor(protos[assign], rng.rand(n, 256) < flip).astype(np.uint8), assign


@pytest.fixture(scope="module")
def vocabs():
    desc, _ = clustered(np.random.RandomState(0), 3000)
    j = jvoc.train_vocabulary(desc, k=5, depth=3, iters=5)
    t = tvoc.train_vocabulary(desc, k=5, depth=3, iters=5, device="cpu")
    return j, t


def test_train_vocabulary_bit_equal(vocabs):
    j, t = vocabs
    assert (t.k, t.depth, t.n_words) == (j.k, j.depth, j.n_words) == (5, 3, 125)
    assert t.centroids.dtype == torch.float32 and t.centroids.device.type == "cpu"
    assert np.array_equal(np.asarray(j.centroids), t.centroids.numpy())
    assert np.array_equal(np.asarray(j.idf), t.idf.numpy())


def test_train_vocabulary_small_clusters():
    """Clusters with no more descriptors than branches keep them, zero-padded
    (the reference's ``n <= k`` branch), and empty ones draw a replacement."""
    desc, _ = clustered(np.random.RandomState(7), 37, n_clusters=3, flip=0.2)
    j = jvoc.train_vocabulary(desc, k=4, depth=3, iters=3, seed=5)
    t = tvoc.train_vocabulary(desc, k=4, depth=3, iters=3, seed=5, device="cpu")
    assert np.array_equal(np.asarray(j.centroids), t.centroids.numpy())


def test_transform_words_equal(vocabs):
    j, t = vocabs
    rng = np.random.RandomState(3)
    q, _ = clustered(rng, 400, flip=0.03)
    valid = rng.rand(400) > 0.15
    wj = np.asarray(jvoc.transform(j, jnp.asarray(q), jnp.asarray(valid)))
    wt = tvoc.transform(t, torch.from_numpy(q), torch.from_numpy(valid))
    assert wt.dtype == torch.int32 and np.array_equal(wj, wt.numpy())
    assert (wt[torch.from_numpy(~valid)] == -1).all() and int(wt.max()) < t.n_words


def test_compute_idf(vocabs):
    j, t = vocabs
    rng = np.random.RandomState(4)
    docs = [rng.randint(-1, 125, size=rng.randint(5, 60)) for _ in range(9)]
    ij = jvoc.compute_idf(j, docs, len(docs))
    it = tvoc.compute_idf(t, [torch.from_numpy(d) if i % 2 else d for i, d in enumerate(docs)], len(docs))
    np.testing.assert_allclose(it.idf.numpy(), np.asarray(ij.idf), rtol=0, atol=1e-6)
    assert it.idf.dtype == torch.float32 and np.array_equal(it.centroids.numpy(), np.asarray(j.centroids))


def keyframe_descriptors():
    """Four keyframes' descriptors and validity masks (600 slots, 540 valid
    each)."""
    rng = np.random.RandomState(11)
    out = []
    for _ in range(4):
        d, _ = clustered(rng, 600, n_clusters=40)
        valid = np.zeros(600, bool)
        valid[rng.permutation(600)[:540]] = True
        out.append((d, valid))
    return out


def dense(ids, wts, n_words):
    v = np.zeros(n_words + 1)
    np.add.at(v, np.where(ids >= 0, ids, n_words), np.where(ids >= 0, wts, 0.0))
    return v[:n_words]


def test_loop_closer_trains_online():
    """``LoopCloser(vocab=None)`` buffers its keyframes' valid descriptors,
    trains at the fourth keyframe (6 iterations) and backfills the four
    rows in buffer order, as the reference; here at k=8, depth=4, whose
    4,096 words fill a row's 2,048 slots."""
    kfs = keyframe_descriptors()
    j = jlc.LoopCloser(max_kf=16, vocab_k=8, vocab_depth=4, vocab=None)
    t = tlc.LoopCloser(max_kf=16, vocab_k=8, vocab_depth=4, vocab=None)
    for i, (d, v) in enumerate(kfs):
        j.add_keyframe(i, d, v)
        t.add_keyframe(i, torch.from_numpy(d), torch.from_numpy(v))
        assert (t.vocab is None) == (i < 3)
    assert np.array_equal(np.asarray(j.vocab.centroids), t.vocab.centroids.numpy())
    jw, jt = np.asarray(j.db_words), np.asarray(j.db_wts)
    tw, tt = t.db_words.numpy(), t.db_wts.numpy()
    assert tw.shape == jw.shape == (16, tvoc.TOPW)
    for r in range(4):
        assert set(tw[r][tw[r] >= 0]) == set(jw[r][jw[r] >= 0])
        np.testing.assert_allclose(dense(tw[r], tt[r], 4096), dense(jw[r], jt[r], 4096), rtol=0, atol=1e-5)
    assert (tw[4:] == -1).all() and (tt[4:] == 0).all()
    # later keyframes go through the trained vocabulary
    d, v = kfs[0]
    j.add_keyframe(5, d, v)
    t.add_keyframe(5, torch.from_numpy(d), torch.from_numpy(v))
    np.testing.assert_allclose(dense(t.db_words[5].numpy(), t.db_wts[5].numpy(), 4096),
                               dense(np.asarray(j.db_words)[5], np.asarray(j.db_wts)[5], 4096), rtol=0, atol=1e-5)


def test_loop_closer_trains_online_default_depth():
    """At the loop closer's defaults (k=8, depth=3: 512 words) training
    starts once 3 x 512 descriptors are buffered (here at the third
    keyframe) and the reference's backfill raises, since a row has 2,048
    slots (ROADMAP F30); the port leaves the slots past the vocabulary's
    words empty, and its rows equal the reference's 512-slot rows of the
    same vocabulary."""
    kfs = keyframe_descriptors()[:3]
    j = jlc.LoopCloser(max_kf=16, vocab=None)
    t = tlc.LoopCloser(max_kf=16, vocab=None)
    for i, (d, v) in enumerate(kfs[:2]):
        j.add_keyframe(i, d, v)
    with pytest.raises(ValueError):
        j.add_keyframe(2, *kfs[2])
    for i, (d, v) in enumerate(kfs):
        assert t.vocab is None
        t.add_keyframe(i, torch.from_numpy(d), torch.from_numpy(v))
    buf = np.concatenate([d[v] for d, v in kfs])
    jv = jvoc.train_vocabulary(buf, k=8, depth=3, iters=6)
    assert np.array_equal(np.asarray(jv.centroids), t.vocab.centroids.numpy())
    for r, (d, v) in enumerate(kfs):
        ids, wts = jvoc.sparse_bow_soft_from_desc(jv, jnp.asarray(d[v]), jnp.ones((int(v.sum()),), bool), topw=512)
        tw, tt = t.db_words[r].numpy(), t.db_wts[r].numpy()
        np.testing.assert_allclose(dense(tw, tt, 512), dense(np.asarray(ids), np.asarray(wts), 512), rtol=0,
                                   atol=1e-5)
        assert (tw[512:] == -1).all() and (tt[512:] == 0).all()


@pytest.mark.parametrize("name", ["corridor_scene", "wall_scene"])
def test_scenes_equal(name):
    j, t = getattr(jsyn, name)(), getattr(tsyn, name)("cpu")
    for f in j._fields:
        assert np.array_equal(np.asarray(getattr(j, f)), getattr(t, f).numpy()), f


def test_corridor_trajectory():
    j = jsyn.CorridorTrajectory(length=12.0, duration=150.0)
    t = tsyn.CorridorTrajectory(length=12.0, duration=150.0, device="cpu")
    for s in (149.9,):  # the latest time: the float32 rounding of the reference's law grows with t
        (Rj, pj), (Rt, pt) = j.pose(s), t.pose(s)
        np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), rtol=0, atol=2e-6)
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=2e-6)
        np.testing.assert_allclose(t.velocity(s).numpy(), np.asarray(j.velocity(s)), rtol=0, atol=2e-6)
        for a, b in zip(t.imu_at(s), j.imu_at(s)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=5e-6)
    assert float(t.pose(75.0)[1][0]) - float(tsyn.AnalyticTrajectory(device="cpu").pose(75.0)[1][0]) > 11.99


class _Stand:
    """A system stand-in for the viewer: a map and a recorded trajectory."""

    def __init__(self, ms, traj):
        self.ms, self._traj = ms, traj
        self.trajectory = list(range(len(traj[0])))

    def trajectory_arrays(self):
        return self._traj


@pytest.fixture(scope="module")
def small_map():
    """A small map (6 keyframe slots, 4 valid; 40 landmarks) with random
    poses and observations, in both packages."""
    rng = np.random.RandomState(6)
    K, N, L = 6, 60, 40
    arrays = tms.map_state_to_numpy(tms.empty_map(K, N, L, device="cpu"))
    arrays["kf_valid"] = np.array([True, True, False, True, True, False])
    rot = tlie.so3_exp(torch.from_numpy(rng.randn(K, 3).astype(np.float32) * 0.3))
    arrays["kf_R_cw"] = rot.numpy()
    arrays["kf_t_cw"] = rng.randn(K, 3).astype(np.float32)
    arrays["lm_pos"] = rng.randn(L, 3).astype(np.float32) * 2
    arrays["lm_valid"] = rng.rand(L) > 0.3
    arrays["obs_lm"] = np.where(rng.rand(K, N) > 0.2, rng.randint(0, L, (K, N)), -1).astype(np.int32)
    arrays["kf_feat_valid"] = rng.rand(K, N) > 0.1
    tmap = tms.map_state_from_numpy(arrays, "cpu")
    jmap = jms.MapState(**{f: jnp.asarray(arrays[f]) for f in jms.MapState._fields})
    n = 7
    traj = (np.arange(n) * 0.05, rng.randn(n, 3).astype(np.float32),
            np.tile(np.eye(3, dtype=np.float32), (n, 1, 1)))
    return _Stand(jmap, traj), _Stand(tmap, traj)


def test_map_arrays_equal(small_map):
    j, t = small_map
    aj, at = jviewer._map_arrays(j), tviewer._map_arrays(t)
    for a, b in zip(aj[:5], at[:5]):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert aj[5] == at[5] and len(at[5]) >= 1


def test_export_html_equal(small_map, tmp_path):
    j, t = small_map
    pj, pt = tmp_path / "j.html", tmp_path / "t.html"
    jviewer.export_html(j, str(pj))
    tviewer.export_html(t, str(pt))
    assert pt.read_text() == pj.read_text() and "const DATA = {" in pt.read_text()
    tviewer.export_html(t, str(pt), max_points=5)
    jviewer.export_html(j, str(pj), max_points=5)
    assert pt.read_text() == pj.read_text()


def test_draw_frame_equal():
    rng = np.random.RandomState(8)
    img = rng.uniform(0, 255, (60, 80)).astype(np.float32)
    xy = np.c_[rng.uniform(-5, 85, 50), rng.uniform(-5, 65, 50)].astype(np.float32)
    valid, tracked = rng.rand(50) > 0.2, rng.rand(50) > 0.5
    for tr in (None, tracked):
        a = jviewer.draw_frame(img, xy, valid, tr)
        b = tviewer.draw_frame(img, xy, valid, tr)
        assert a.dtype == b.dtype == np.uint8 and np.array_equal(a, b)


def test_render_map_equal(small_map, tmp_path):
    """``render_map`` (matplotlib, imported inside the call) draws the same
    pixels from the port's map as from the reference's."""
    from PIL import Image

    j, t = small_map
    jviewer.render_map(j, str(tmp_path / "j.png"), title="m")
    tviewer.render_map(t, str(tmp_path / "t.png"), title="m")
    a, b = (np.asarray(Image.open(tmp_path / f"{n}.png")) for n in "jt")
    assert a.shape == b.shape and a.shape[0] > 100 and np.array_equal(a, b)
