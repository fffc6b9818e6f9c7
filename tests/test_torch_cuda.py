"""The port's CUDA kernels against their plain PyTorch versions, on the
card, and the SLAM loop on the card against the CPU.

Marked ``cuda``: each test skips where there is no CUDA device (this file
imports no jax, so it also runs where jax is not installed). On a GPU
machine, from the repository root:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

Every kernel comparison is exact: the kernels compute the same integer
and float operations in the same order as the plain versions. The edge
cases are ``chip_smoke.py``'s, which checks the same ones on every run.
The loop tests are chip_smoke.py phase 5 at 8 frames (poses within its
TRANS_TOL and ROT_TOL), a local-BA slice under the sync debug mode, the
small injected loop closure (``chip_smoke.SMALL_CLOSURE``) on the card
against the CPU, and a global-BA slice under the sync debug mode in
"error".
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


@pytest.mark.parametrize(
    "case", [(7680, 768, 2400, 48, 45, "int64", "int32"), (3840, 768, 1200, 11, 21, "int32", "int32"),
             *chip_smoke.GATHER_EDGE_CASES],
)
def test_gather_patches_kernel(dev, case):
    # raw corners of either type: the kernel clamps them, the plain version too
    img, rows, cols, ph, pw = chip_smoke.gather_edge_inputs(*case, dev)
    before = cuda_gather.gather_patches.launches
    got = cuda_gather.gather_patches(img, rows, cols, ph, pw)
    assert cuda_gather.gather_patches.launches == before + (rows.shape[0] > 0)
    ref = cuda_gather.gather_patches_plain(img, rows, cols, ph, pw)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (rows.shape[0], ph, pw)
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


def test_slam_loop_card_matches_cpu(dev):
    # chip_smoke.py phase 5 at 8 frames: the small loop on the card and on
    # the CPU inserts keyframes at the same frames and agrees per frame
    cpu = torch.device("cpu")
    cfg = chip_smoke.loop_config(small=True)
    _, frames = chip_smoke.render_loop_sequence(cfg, 8, cpu)
    card, kf_card = chip_smoke.run_loop(cfg, [(a.to(dev), b.to(dev)) for a, b in frames], dev)
    host, kf_host = chip_smoke.run_loop(cfg, frames, cpu)
    assert kf_card == kf_host and len(kf_card) >= 3
    assert card.stats == host.stats
    d_c, d_r = chip_smoke.trajectory_diff(card.trajectory_arrays(), host.trajectory_arrays())
    assert d_c.max() <= chip_smoke.TRANS_TOL and d_r.max() <= chip_smoke.ROT_TOL


def test_local_ba_slice_never_syncs(dev):
    # one local-BA slice of the small loop, run under the sync debug mode:
    # no call in it may wait on the device
    import warnings

    cfg = chip_smoke.loop_config(small=True)
    _, frames = chip_smoke.render_loop_sequence(cfg, 8, dev)
    slam, _ = chip_smoke.run_loop(cfg, frames[:5], dev)
    kinds = [k for k, _ in slam._bg_queue]
    assert "local_ba_chunk" in kinds, kinds
    fn = dict(slam._bg_queue)["local_ba_chunk"]
    before = slam.ms.kf_t_cw.clone()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in caught if chip_smoke.SYNC_WARNING in str(w.message)]
    assert not syncs, syncs
    assert not torch.equal(slam.ms.kf_t_cw, before)  # the slice moved the window


def test_small_injected_loop_card_matches_cpu(dev):
    # chip_smoke.SMALL_CLOSURE on the card and on the CPU: the same closure,
    # keyframes and counters, and the trajectory right after the correction
    # within TRANS_TOL / ROT_TOL per frame
    cpu = torch.device("cpu")
    sc = chip_smoke.SMALL_CLOSURE
    cfg = chip_smoke.loop_config(small=True, closure=True)
    _, frames = chip_smoke.render_loop_sequence(cfg, sc["frames"], cpu, "outback", sc["speed"])
    runs = []
    for d in (dev, cpu):
        at_closure = {}

        def on_frame(i, slam, call):
            n = slam.loop_closer.n_loops_closed
            call()
            if slam.loop_closer.n_loops_closed != n:
                at_closure["traj"] = slam.trajectory_arrays()
                at_closure["frame"] = i

        slam, kf_at = chip_smoke.run_loop(cfg, [(a.to(d), b.to(d)) for a, b in frames], d, on_frame,
                                          inject_at=sc["inject_at"], min_gap=sc["min_gap"])
        runs.append((slam, kf_at, at_closure))
    (card, kf_card, c_card), (host, kf_host, c_host) = runs
    assert card.loop_closer.n_loops_closed == host.loop_closer.n_loops_closed == 1
    assert card.loop_closer.last_closure[:2] == host.loop_closer.last_closure[:2]
    assert c_card["frame"] == c_host["frame"] and kf_card == kf_host and card.stats == host.stats
    d_c, d_r = chip_smoke.trajectory_diff(c_card["traj"], c_host["traj"])
    assert d_c.max() <= chip_smoke.TRANS_TOL and d_r.max() <= chip_smoke.ROT_TOL


def test_gba_chunk_reads_the_host_once(dev):
    # one GBA slice of the small loop's map under the sync debug mode in
    # "error": any call in it that waits on the device raises; the slice's
    # one host read is its cost, taken after it
    cfg = chip_smoke.loop_config(small=True)
    _, frames = chip_smoke.render_loop_sequence(cfg, 8, dev)
    slam, _ = chip_smoke.run_loop(cfg, frames, dev)
    before = slam.ms.kf_t_cw.clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ms, cost = slam.loop_closer.gba_chunk(slam.ms, slam.cam_params, cfg.camera.bf)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert float(cost) > 0.0
    assert not torch.equal(ms.kf_t_cw, before)  # the slice moved the map
