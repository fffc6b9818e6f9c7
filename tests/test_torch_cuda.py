"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where there is no CUDA device (this file
imports no jax, so it also runs where jax is not installed). On a GPU
machine, from the repository root:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

Every comparison is exact: the kernels compute the same integer and
float operations in the same order as the plain versions.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from orb_slam3_detailed_comments_kor_tpu_torch.ops import cuda_fast, cuda_gather, cuda_matching  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu_torch.ops import pyramid  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_fast_nms_kernel(dev):
    shapes = pyramid.level_shapes(120, 200, 4, 1.2)
    hs = [s[0] for s in shapes]
    ws = [s[1] for s in shapes]
    g = torch.Generator(device=dev).manual_seed(0)
    flat = torch.zeros((8, 120, 256), device=dev)
    for b in range(8):
        h, w = shapes[b % 4]
        flat[b, :h, :w] = torch.floor(torch.rand((h, w), generator=g, device=dev) * 255)
    before = cuda_fast.fast_nms.launches
    got = cuda_fast.fast_nms(flat, hs, ws, 20.0, 7.0)
    assert cuda_fast.fast_nms.launches == before + 1
    ref = cuda_fast.fast_nms_plain(flat, hs, ws, 20.0, 7.0)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert (ref[0] > 0).sum() > 100


def test_gather_patches_kernel(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    img = torch.rand((300, 128), generator=g, device=dev)
    rows = torch.randint(-20, 320, (97,), generator=g, device=dev, dtype=torch.int32)
    cols = torch.randint(-20, 140, (97,), generator=g, device=dev, dtype=torch.int32)
    got = cuda_gather.gather_patches(img, rows, cols, 48, 45)
    r = torch.clamp(rows, 0, 300 - 48)
    c = torch.clamp(cols, 0, 128 - 45)
    ref = cuda_gather.gather_patches_plain(img, r, c, 48, 45)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("n,m", [(128, 128), (513, 130), (4096, 1200)])
def test_masked_best2_kernel(dev, n, m):
    rng = np.random.default_rng(n + m)
    a = torch.from_numpy((rng.random((n, 256)) > 0.5).astype(np.uint8)).to(dev)
    b = torch.from_numpy((rng.random((m, 256)) > 0.5).astype(np.uint8)).to(dev)
    mask = torch.from_numpy(rng.random((n, m)) > 0.5).to(dev)
    mask[1] = False
    got = cuda_matching.fused_masked_best2(a, b, mask)
    ref = cuda_matching.fused_masked_best2_plain(a, b, mask)
    torch.cuda.synchronize()
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
