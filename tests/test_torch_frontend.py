"""The port's ORB + stereo front end against the JAX reference on the CPU,
on one rendered 240x376 stereo pair (600 features, 24-px cells — the
small setup of ``__graft_entry__``).

Tolerances, and why:
- pyramid levels within 1e-3 (0..255 scale): the resize matmuls sum in
  another order;
- fed the SAME level stack, keypoint xy / level / valid are exactly equal
  and >= 99% of descriptors identical (orientation matmul order can move
  a keypoint across a steering-bin edge);
- from the images, >= 98% of keypoint slots agree (level-stack rounding
  can flip a FAST comparison), and stereo valid masks agree on >= 98%
  with depth within 1e-3 relative where both are valid.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_detailed_comments_kor_tpu.io import synthetic as jsyn
from orb_slam3_detailed_comments_kor_tpu.ops import orb as jorb
from orb_slam3_detailed_comments_kor_tpu.ops import pyramid as jpyr
from orb_slam3_detailed_comments_kor_tpu.ops import stereo as jstereo
from orb_slam3_detailed_comments_kor_tpu_torch.ops import orb as torb
from orb_slam3_detailed_comments_kor_tpu_torch.ops import pyramid as tpyr
from orb_slam3_detailed_comments_kor_tpu_torch.ops import stereo as tstereo
from orb_slam3_detailed_comments_kor_tpu_torch.slam import frontend as tfe

H, W, FX, BASELINE = 240, 376, 230.0, 0.11
BF = BASELINE * FX
NF, CELL = 600, 24
CAM = np.array([FX, FX, W / 2.0, H / 2.0], np.float32)


@jax.jit
def _jax_front(imgs):
    feats, stack, patches = jorb.extract_orb_batch.__wrapped__(
        imgs, n_features=NF, cell=CELL, return_stack=True
    )
    fl = jax.tree.map(lambda a: a[0], feats)
    fr = jax.tree.map(lambda a: a[1], feats)
    sd = jstereo.compute_stereo_matches(
        fl, fr, stack[0], stack[1], BF, 1.2,
        level_hw=jpyr.level_shapes(H, W, 8, 1.2), left_patches=patches[:fl.n],
    )
    return feats, stack, sd


@pytest.fixture(scope="module")
def front():
    il, ir, _ = jsyn.stereo_pair(
        jnp.asarray(CAM), jnp.eye(3), jnp.zeros(3), BASELINE, jsyn.default_scene(), h=H, w=W
    )
    imgs = np.stack([np.asarray(il), np.asarray(ir)])
    feats, stack, sd = _jax_front(jnp.asarray(imgs))
    jax_out = dict(
        feats=jax.tree.map(np.array, feats), stack=np.array(stack),
        sd=jax.tree.map(np.array, sd),
    )
    # the port's process_stereo, split open to keep its level stack
    tfeats, tstack, tpatches = torb.extract_orb_batch(
        torch.from_numpy(imgs), n_features=NF, cell=CELL, return_stack=True
    )
    fl, fr = tfe._view(tfeats, 0), tfe._view(tfeats, 1)
    tsd = tstereo.compute_stereo_matches(
        fl, fr, tstack[0], tstack[1], BF, 1.2,
        level_hw=tpyr.level_shapes(H, W, 8, 1.2), left_patches=tpatches[:fl.n],
    )
    return jax_out, tfeats, tstack, tsd


def test_pyramid_levels_close(front):
    jax_out, _, tstack, _ = front
    assert np.abs(jax_out["stack"] - tstack.numpy()).max() <= 1e-3


def test_features_from_same_stack_exact(front):
    jax_out, _, _, _ = front
    jf = jax_out["feats"]
    shapes = tpyr.level_shapes(H, W, 8, 1.2)
    tf, _ = torb.features_from_stack(
        torch.from_numpy(jax_out["stack"]), shapes, NF, 1.2, 20.0, 7.0, CELL
    )
    assert jf.valid.sum() > 900
    for name in ("xy", "level", "valid", "response"):
        assert np.array_equal(getattr(jf, name), getattr(tf, name).numpy()), name
    same = (jf.desc == tf.desc.numpy()).all(-1)[jf.valid]
    assert same.mean() >= 0.99


def test_features_from_images_agree(front):
    jax_out, tfeats, _, _ = front
    jf = jax_out["feats"]
    vj, vt = jf.valid, tfeats.valid.numpy()
    near = np.abs(jf.xy - tfeats.xy.numpy()).max(-1) < 0.05
    agree = (vj == vt) & (~vj | near)
    assert agree[vj | vt].mean() >= 0.98


def test_stereo_depth_agrees(front):
    jax_out, _, _, tsd = front
    sd = jax_out["sd"]
    vj, vt = sd.valid, tsd.valid.numpy()
    assert vj.sum() > 300
    assert (vj == vt)[vj | vt].mean() >= 0.98
    both = vj & vt
    rel = np.abs(sd.depth[both] - tsd.depth.numpy()[both]) / sd.depth[both]
    assert rel.max() <= 1e-3
    ur = np.abs(sd.u_right[both] - tsd.u_right.numpy()[both])
    assert ur.max() <= 1e-2  # px


def test_nanmedian_matches_jax():
    rng = np.random.default_rng(3)
    for n in (0, 1, 2, 7, 10):
        x = np.full(12, np.nan, np.float32)
        x[:n] = rng.random(n).astype(np.float32) * 100
        rng.shuffle(x)
        ref = np.asarray(jnp.nanmedian(jnp.asarray(x)))
        got = tstereo._nanmedian(torch.from_numpy(x)).numpy()
        assert np.array_equal(ref, got, equal_nan=True), n
