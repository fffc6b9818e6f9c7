"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where there is no CUDA device (this file
imports no jax, so it also runs where jax is not installed). On a GPU
machine, from the repository root:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

Every comparison is exact: the kernels compute the same integer and
float operations in the same order as the plain versions. The edge cases
are ``chip_smoke.py``'s, which checks the same ones on every run.
"""

import pytest
import torch

torch.set_num_threads(1)

import chip_smoke  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu_torch.ops import cuda_fast, cuda_gather, cuda_matching  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu_torch.ops import orb  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "h,w,wp,th_hi,th_lo", [(120, 200, 256, 20.0, 7.0), (480, 752, 768, 20.0, 7.0),
                           *chip_smoke.FAST_EDGE_CASES],
)
def test_fast_nms_kernel(dev, h, w, wp, th_hi, th_lo):
    flat, hs, ws = chip_smoke.fast_edge_inputs(h, w, wp, dev)
    before = cuda_fast.fast_nms.launches
    got = cuda_fast.fast_nms(flat, hs, ws, th_hi, th_lo)
    assert cuda_fast.fast_nms.launches == before + 1
    ref = cuda_fast.fast_nms_plain(flat, hs, ws, th_hi, th_lo)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert (ref[0] > 0).sum() > 100


@pytest.mark.parametrize("width,offset", [(202, 0), (204, 1)])
def test_fast_nms_needs_float4_rows(dev, width, offset):
    # the kernel moves rows as float4: a width that is no multiple of 4 or a
    # stack that starts off a 16-byte boundary is refused before the launch
    buf = torch.zeros(8 * 16 * width + offset, device=dev)
    flat = buf[offset:].view(8, 16, width)
    before = cuda_fast.fast_nms.launches
    with pytest.raises(ValueError):
        cuda_fast.fast_nms(flat, [16, 12], [width, width - 40], 20.0, 7.0)
    assert cuda_fast.fast_nms.launches == before


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


@pytest.mark.parametrize(
    "n,m,offset", [(128, 128, 0), (513, 130, 0), (4096, 1200, 0), *chip_smoke.MATCH_EDGE_CASES],
)
def test_masked_best2_kernel(dev, n, m, offset):
    a, b, mask = chip_smoke.matcher_edge_inputs(n, m, offset, dev)
    ref = cuda_matching.fused_masked_best2_plain(a, b, mask)
    # packed descriptors, as the main path hands them, and {0,1} bits
    for args in ((a, b, mask), (orb.unpack_descriptors(a), orb.unpack_descriptors(b), mask)):
        got = cuda_matching.fused_masked_best2(*args)
        torch.cuda.synchronize()
        for x, y in zip(got, ref):
            assert torch.equal(x, y)
