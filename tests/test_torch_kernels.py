"""Plain PyTorch versions of the port's three CUDA kernels against the JAX
reference on the CPU: FAST+NMS (``cuda_fast``), the patch gather
(``cuda_gather``) and the masked Hamming best-2 matcher
(``cuda_matching``), plus ``select_keypoints``.

JAX runs its kernels as its own CPU tests do: ``fast_nms_stack`` and
``gather_patches`` take their XLA paths off-TPU, and the Pallas matcher
runs in interpret mode. Every comparison here is exact, ties included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_detailed_comments_kor_tpu.ops import matching as jmatch
from orb_slam3_detailed_comments_kor_tpu.ops import pallas_fast as jpf
from orb_slam3_detailed_comments_kor_tpu.ops import pallas_gather as jpg
from orb_slam3_detailed_comments_kor_tpu.ops import pallas_matching as jpm
from orb_slam3_detailed_comments_kor_tpu.ops import select as jsel
from orb_slam3_detailed_comments_kor_tpu_torch.ops import cuda_fast
from orb_slam3_detailed_comments_kor_tpu_torch.ops import cuda_gather
from orb_slam3_detailed_comments_kor_tpu_torch.ops import cuda_matching
from orb_slam3_detailed_comments_kor_tpu_torch.ops import orb as torb
from orb_slam3_detailed_comments_kor_tpu_torch.ops import pyramid as tpyr
from orb_slam3_detailed_comments_kor_tpu_torch.ops import select as tsel

H, W, NL, CELL = 240, 376, 8, 24


def _level_stack(seed=0):
    """[2·NL, Hp, Wp] padded stack of blocky integer-valued images (integer
    pixels give many exactly tied FAST scores)."""
    rng = np.random.default_rng(seed)
    shapes = tpyr.level_shapes(H, W, NL, 1.2)
    Hp, Wp = 240, 384
    stack = np.zeros((2, NL, Hp, Wp), np.float32)
    for b in range(2):
        for l, (h, w) in enumerate(shapes):
            blocks = rng.integers(0, 256, size=(h // 6 + 1, w // 6 + 1))
            img = np.kron(blocks, np.ones((6, 6)))[:h, :w]
            img += rng.integers(0, 12, size=(h, w))
            stack[b, l, :h, :w] = img
    hs = np.array([s[0] for s in shapes], np.int32)
    ws = np.array([s[1] for s in shapes], np.int32)
    return stack.reshape(2 * NL, Hp, Wp), hs, ws


@pytest.fixture(scope="module")
def fast_results():
    flat, hs, ws = _level_stack()
    jfn = jax.jit(lambda f: jpf.fast_nms_stack(f, hs, ws, NL, 20.0, 7.0, CELL))
    sj, rj = (np.array(a) for a in jfn(jnp.asarray(flat)))
    st, rt = cuda_fast.fast_nms_stack(torch.from_numpy(flat), hs, ws, NL, 20.0, 7.0, CELL)
    return sj, rj, st, rt


def test_fast_nms_stack_exact(fast_results):
    sj, rj, st, rt = fast_results
    assert (sj > 0).sum() > 1000  # a meaningful number of corners
    assert np.array_equal(sj, st.numpy())
    assert np.array_equal(rj, rt.numpy())


def test_select_keypoints_exact(fast_results):
    sj, _, _, _ = fast_results
    K0 = max(torb.level_budgets(600, NL, 1.2))
    jfn = jax.jit(jax.vmap(lambda s: jsel.select_keypoints(s, K0, cell=CELL, border=0)))
    xyj, rj, vj = (np.asarray(a) for a in jfn(jnp.asarray(sj)))
    xyt, rt, vt = tsel.select_keypoints(torch.from_numpy(sj), K0, cell=CELL, border=0)
    # tied responses exist, so slot order really exercises the tie rule
    r = rj[vj]
    assert len(np.unique(r)) < len(r)
    assert np.array_equal(xyj, xyt.numpy())
    assert np.array_equal(rj, rt.numpy())
    assert np.array_equal(vj, vt.numpy())


@pytest.mark.parametrize(
    "ph,pw,k,row_t,col_t",
    [pytest.param(48, 45, 64, np.int32, np.int32, id="48-45"),
     pytest.param(11, 21, 64, np.int32, np.int32, id="11-21"),
     # the ORB call's corner types, and int64 both
     pytest.param(48, 45, 64, np.int64, np.int32, id="48-45-int64-rows"),
     pytest.param(11, 21, 64, np.int64, np.int64, id="11-21-int64"),
     pytest.param(11, 21, 1, np.int32, np.int64, id="11-21-K1"),
     pytest.param(48, 45, 0, np.int64, np.int32, id="48-45-K0")],
)
def test_gather_patches_exact(ph, pw, k, row_t, col_t):
    rng = np.random.default_rng(2)
    img = rng.random((200, 96)).astype(np.float32)
    rows = rng.integers(-30, 230, size=k)  # many need clamping
    cols = rng.integers(-30, 120, size=k)
    jfn = jax.jit(jpg.gather_patches, static_argnums=(3, 4))
    # JAX takes int32 corners (no x64); the port gets the same values as row_t/col_t
    pj = np.asarray(jfn(jnp.asarray(img), jnp.asarray(rows.astype(np.int32)),
                        jnp.asarray(cols.astype(np.int32)), ph, pw))
    pt = cuda_gather.gather_patches(
        torch.from_numpy(img), torch.from_numpy(rows.astype(row_t)),
        torch.from_numpy(cols.astype(col_t)), ph, pw
    )
    assert pj.shape == pt.shape == (k, ph, pw)
    assert pt.dtype == torch.float32
    assert np.array_equal(pj, pt.numpy())


_jax_best2 = jax.jit(lambda a, b, m: jmatch.masked_best2(jmatch.hamming_matrix(a, b), m))


@pytest.mark.parametrize("n,m", [(128, 128), (200, 300), (513, 130)])
def test_masked_best2_exact(n, m):
    rng = np.random.default_rng(n * 1000 + m)
    a = (rng.random((n, 256)) > 0.5).astype(np.uint8)
    b = (rng.random((m, 256)) > 0.5).astype(np.uint8)
    b[m // 2] = b[0]  # duplicated column: best == second on rows that pick it
    mask = rng.random((n, m)) > 0.3
    mask[3] = False   # a row with no allowed column
    ref_i = [np.asarray(x) for x in jpm.fused_masked_best2(
        jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32), jnp.asarray(mask), interpret=True)]
    ref_x = [np.asarray(x) for x in _jax_best2(jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask))]
    at, bt, mt = torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(mask)
    for got in (
        cuda_matching.fused_masked_best2(at, bt, mt),
        cuda_matching.fused_masked_best2(torb.pack_descriptors(at), torb.pack_descriptors(bt), mt),
    ):
        for ref in (ref_i, ref_x):
            for r, g in zip(ref, got):
                assert np.array_equal(r, g.numpy())
    idx, best, second = (x.numpy() for x in got)
    assert idx[3] == 0 and best[3] == second[3] == jmatch.BIG
    # argbest ties really occur and are resolved to the lowest column
    d = np.asarray(jmatch.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    d = np.where(mask, d, jmatch.BIG)
    n_ties = int(((d == best[:, None]).sum(1) > 1).sum())
    assert n_ties > 0
    assert np.array_equal(idx, np.argmin(d, axis=1))
