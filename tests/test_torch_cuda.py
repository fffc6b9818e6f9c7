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
against the CPU, a global-BA slice under the sync debug mode in
"error", and the Atlas merge pass of chip_smoke.py phase 7 at the small
configuration, card against CPU (the same merge, keyframes and counters,
poses within TRANS_TOL / ROT_TOL), with a local-BA slice that gives the
same bits twice on the card; and the small stereo-inertial pass
(``chip_smoke.si_config(small=True)``) on the card against the CPU (the
same keyframes, IMU init and counters, poses within TRANS_TOL / ROT_TOL,
gravity within 1e-3 rad), with a VI local-BA slice that gives the same
bits twice on the card; and the small monocular pass
(``chip_smoke.mono_config(small=True)``) on the card against the CPU (the
same initialization frame, keyframes and counters, centres within
MONO_TRANS_TOL, rotations within ROT_TOL); and the small RGB-D,
stereo-fisheye and monocular KB8 passes (``chip_smoke.sensor_config(kind,
small=True)``) on the card against the CPU (the same keyframes and
counters, poses within TRANS_TOL / ROT_TOL; the monocular KB8 pass with
both sides resumed from the CPU's map, made on eight threads, right after
its initialization, both tracking, centres within MONO_TRANS_TOL); and
the port's dataset runner on the small EuRoC-layout sequence of the CPU
runner test, card against CPU (the same keyframe frames, poses within
TRANS_TOL / ROT_TOL); tracked frames of the small stereo,
stereo-inertial and monocular passes fed numpy images under the sync
debug mode (no synchronizing call outside the batched decision read); and
a loop closer training its vocabulary online, card against CPU (the same
centroids, database rows within 1e-5); and the three sharded solvers of
``parallel/`` at small sizes: one shard of the card gives the one-device
solver's bits, four shards of it give the same bits twice and stay within
tests/test_dist_ba.py's distributed-versus-single bounds of one shard; and
the remaining ported functions (the quaternion helpers and ``se3_apply``,
``rotation_consistency_mask``, single-image FAST, ``build_pyramid`` and
``gaussian_blur``, stereo over ragged pyramids, ``transform_exact``,
``bow_vector`` and ``sparse_bow``) on the card against the CPU, with the
CUDA ``fast_nms_stack`` against the plain ``fast_with_fallback_stack``.
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


def test_small_merge_pass_card_matches_cpu(dev):
    # chip_smoke.py phase 7's scenario at the small configuration: the map
    # is shelved by the blackout and merged back at the same pair on the
    # card and on the CPU, with the same keyframes and counters
    from orb_slam3_detailed_comments_kor_tpu_torch.slam import map_merging
    from orb_slam3_detailed_comments_kor_tpu_torch.slam.system import SlamSystem

    cpu = torch.device("cpu")
    cfg = chip_smoke.merge_config(small=True)
    _, frames = chip_smoke.render_loop_sequence(cfg, chip_smoke.MERGE_FIRST, cpu, "strafe", chip_smoke.MERGE_SPEED)
    black = torch.zeros((cfg.camera.height, cfg.camera.width))
    runs = []
    for d in (dev, cpu):
        merges = []

        def weld(fn):
            def wrapper(slam_, *a):
                done = fn(slam_, *a)
                merges.append((a[1], a[2], done))
                return done
            return wrapper

        slam = SlamSystem(cfg, device=d)
        with chip_smoke.patched([(map_merging, "merge_into_shelved", weld)]):
            chip_smoke.run_merge_steps(slam, chip_smoke.merge_schedule([(a.to(d), b.to(d)) for a, b in frames],
                                                                       black.to(d)))
        runs.append((slam, merges))
    (card, m_card), (host, m_host) = runs
    assert m_card == m_host and len(m_host) == 1 and m_host[0][2]
    assert card.n_kf == host.n_kf and card.stats == host.stats and not card.atlas_maps
    d_c, d_r = chip_smoke.trajectory_diff(card.trajectory_arrays(), host.trajectory_arrays())
    assert d_c.max() <= chip_smoke.TRANS_TOL and d_r.max() <= chip_smoke.ROT_TOL


def test_local_ba_slice_is_deterministic(dev):
    # two runs of one local-BA slice on the same inputs give the same bits
    # (the normal equations are summed by segmented scans on the card)
    from orb_slam3_detailed_comments_kor_tpu_torch.slam import tracking

    cfg = chip_smoke.loop_config(small=True)
    _, frames = chip_smoke.render_loop_sequence(cfg, 8, dev)
    slam, _ = chip_smoke.run_loop(cfg, frames, dev)
    slam.flush_decisions()
    kf = slam.n_kf - 1
    spread = chip_smoke.local_ba_spread(
        lambda: tracking.local_ba_step(slam.ms, kf, slam.cam_params, cfg.camera.bf, window=8,
                                       lm_cap=cfg.capacity.max_local_landmarks, iters=2), slam.ms)
    assert all(v == 0 for v in spread.values()), spread


def test_small_inertial_pass_card_matches_cpu(dev):
    # the small stereo-inertial pass (chip_smoke.si_config(small=True), the
    # CPU test's 22 frames at 10 fps) on the card and on the CPU: the same
    # keyframes, IMU-init frame and counters; poses within TRANS_TOL /
    # ROT_TOL; gravity within 1e-3 rad
    cpu = torch.device("cpu")
    cfg = chip_smoke.si_config(small=True)
    si = chip_smoke.SMALL_SI
    _, frames, imu = chip_smoke.render_si_sequence(cfg, si["frames"], cpu, fps=si["fps"])
    card = chip_smoke.run_si(cfg, [(a.to(dev), b.to(dev)) for a, b in frames], imu, dev, fps=si["fps"])
    host = chip_smoke.run_si(cfg, frames, imu, cpu, fps=si["fps"])
    assert card[1] == host[1] and card[2]["frame"] == host[2]["frame"] and host[0].imu_initialized
    assert card[0].stats == host[0].stats
    d_c, d_r = chip_smoke.trajectory_diff(card[0].trajectory_arrays(), host[0].trajectory_arrays())
    assert d_c.max() <= chip_smoke.TRANS_TOL and d_r.max() <= chip_smoke.ROT_TOL
    assert chip_smoke.gravity_angle(card[0].gravity.cpu(), host[0].gravity) <= 1e-3


def test_vi_local_ba_slice_is_deterministic(dev):
    # two runs of one VI local-BA slice on the same inputs give the same bits
    # (the normal equations are summed by segmented scans on the card)
    from orb_slam3_detailed_comments_kor_tpu_torch.slam import inertial

    cfg = chip_smoke.si_config(small=True)
    si = chip_smoke.SMALL_SI
    _, frames, imu = chip_smoke.render_si_sequence(cfg, si["frames"], dev, fps=si["fps"])
    slam = chip_smoke.run_si(cfg, frames, imu, dev, fps=si["fps"])[0]
    slam.flush_decisions()
    assert slam.imu_initialized

    def vi_slice():
        return inertial.local_vi_ba_step(slam.ms, slam.ikf, slam.n_kf - 1, slam.gravity, slam.cam_params,
                                         slam.R_cb, slam.t_cb, cfg.camera.bf, window=10,
                                         lm_cap=cfg.capacity.max_local_landmarks, iters=2)

    (ms_a, ikf_a, cost_a), (ms_b, ikf_b, cost_b) = vi_slice(), vi_slice()
    for a, b in zip((ms_a.kf_R_cw, ms_a.kf_t_cw, ms_a.lm_pos, ikf_a.vel, ikf_a.bg, ikf_a.ba, cost_a),
                    (ms_b.kf_R_cw, ms_b.kf_t_cw, ms_b.lm_pos, ikf_b.vel, ikf_b.bg, ikf_b.ba, cost_b)):
        assert torch.equal(a, b)
    assert not torch.equal(ms_a.kf_t_cw, slam.ms.kf_t_cw)  # the slice moved the window


def test_small_mono_pass_card_matches_cpu(dev):
    # the small monocular pass (chip_smoke.mono_config(small=True), the CPU
    # test's 20 strafe frames) on the card and on the CPU: the same
    # initialization frame, keyframes and counters; camera centres within
    # MONO_TRANS_TOL (in the map's gauge) and rotations within ROT_TOL
    cpu = torch.device("cpu")
    cfg = chip_smoke.mono_config(small=True)
    sm = chip_smoke.SMALL_MONO
    _, imgs = chip_smoke.render_mono_sequence(cfg, sm["frames"], cpu, speed=sm["speed"])
    card = chip_smoke.run_mono(cfg, [m.to(dev) for m in imgs], dev)
    host = chip_smoke.run_mono(cfg, imgs, cpu)
    for s in (card[0], host[0]):
        s.flush_decisions()
    assert card[1] == host[1] and card[2] == host[2] and host[0].state == 1
    assert card[0].stats == host[0].stats
    d_c, d_r = chip_smoke.trajectory_diff(card[0].trajectory_arrays(), host[0].trajectory_arrays())
    assert d_c.max() <= chip_smoke.MONO_TRANS_TOL and d_r.max() <= chip_smoke.ROT_TOL, (
        d_c.round(5).tolist(), d_r.round(5).tolist())


@pytest.mark.parametrize("kind", ["rgbd", "fisheye"])
def test_small_sensor_pass_card_matches_cpu(dev, kind):
    # the small RGB-D pass (chip_smoke.sensor_config("rgbd", small=True),
    # 16 strafe frames at 0.03 m) and the small stereo-fisheye pass (the
    # rig of the JAX package's tests/test_fisheye.py, 16 frames at 0.04 m)
    # on the card and on the CPU: the same keyframes and counters, centres
    # within TRANS_TOL and rotations within ROT_TOL
    cpu = torch.device("cpu")
    cfg = chip_smoke.sensor_config(kind, small=True)
    _, frames, _ = chip_smoke.render_sensor_sequence(kind, cfg, 16, cpu, speed=0.03 if kind == "rgbd" else 0.04)
    card = chip_smoke.run_sensor(kind, cfg, [tuple(x.to(dev) for x in f) for f in frames], dev)
    host = chip_smoke.run_sensor(kind, cfg, frames, cpu)
    for s in (card[0], host[0]):
        s.flush_decisions()
    assert card[1] == host[1] and host[0].state == card[0].state == 1
    assert card[0].stats == host[0].stats
    if kind == "fisheye":
        assert chip_smoke.rig_rows(card[0], card[0].n_kf - 1) == chip_smoke.rig_rows(host[0], host[0].n_kf - 1)
    d_c, d_r = chip_smoke.trajectory_diff(card[0].trajectory_arrays(), host[0].trajectory_arrays())
    assert d_c.max() <= chip_smoke.TRANS_TOL and d_r.max() <= chip_smoke.ROT_TOL, (
        d_c.round(5).tolist(), d_r.round(5).tolist())


def test_small_mono_kb8_pass_card_matches_cpu(dev, tmp_path):
    # the small monocular KB8 pass (chip_smoke.sensor_config("mono",
    # small=True): the camera of the JAX package's tests/test_fisheye.py,
    # 20 strafe frames at 0.05 m). The initialization's BA leaves the map's
    # scale free to follow the order of float additions (ROADMAP F24: the
    # maps that the card and this file's one-thread CPU make lose track at
    # the next frame), so the CPU initializes on eight threads and the card
    # and the CPU both resume from its checkpoint right after the
    # initializing frame; then the same keyframes and counters, both
    # tracking (state OK), centres within MONO_TRANS_TOL (in the map's
    # gauge), rotations within ROT_TOL
    from orb_slam3_detailed_comments_kor_tpu_torch.slam.system import SlamSystem

    cpu = torch.device("cpu")
    cfg = chip_smoke.sensor_config("mono", small=True)
    _, imgs, _ = chip_smoke.render_sensor_sequence("mono", cfg, 20, cpu, speed=0.05)
    init, threads = SlamSystem(cfg, device=cpu), torch.get_num_threads()
    torch.set_num_threads(8)
    try:
        for i, img in enumerate(imgs):
            init.track_mono(img, i / chip_smoke.FPS)
            if init.state == 1:
                break
    finally:
        torch.set_num_threads(threads)
    start, path = i + 1, str(tmp_path / "init.npz")
    init.save_map(path)
    card, host = SlamSystem(cfg, device=dev), SlamSystem(cfg, device=cpu)
    for s in (card, host):
        s.load_map(path)
    kf_at = {}
    for name, s in (("card", card), ("host", host)):
        kf_at[name] = []
        for i in range(start, len(imgs)):
            n0 = s.stats["kf_inserted"]
            s.track_mono(imgs[i].to(s.device), i / chip_smoke.FPS)
            if s.stats["kf_inserted"] != n0:
                kf_at[name].append(i)
        s.flush_decisions()
    assert kf_at["card"] == kf_at["host"] and card.state == host.state == 1, (kf_at, card.state, host.state)
    assert card.stats == host.stats
    n = len(imgs) - start
    d_c, d_r = chip_smoke.trajectory_diff(*(tuple(a[-n:] for a in s.trajectory_arrays()) for s in (card, host)))
    assert d_c.max() <= chip_smoke.MONO_TRANS_TOL and d_r.max() <= chip_smoke.ROT_TOL, (
        d_c.round(5).tolist(), d_r.round(5).tolist())


def test_small_runner_card_matches_cpu(dev, tmp_path):
    # the port's dataset runner on the CPU runner test's small EuRoC-layout
    # sequence (chip_smoke.small_euroc_sequence, stereo mode), on the card
    # and on the CPU: the same keyframe frames and counters, centres within
    # TRANS_TOL and rotations within ROT_TOL
    from orb_slam3_detailed_comments_kor_tpu_torch.examples import run_dataset
    from orb_slam3_detailed_comments_kor_tpu_torch.io import native_host
    from orb_slam3_detailed_comments_kor_tpu_torch.slam import system as tsys

    try:  # the native decoder where the machine can build it (libpng), else PIL
        native_host.load()
        decoder = "native"
    except Exception:
        decoder = "python"
    seq, settings, gt, _ = chip_smoke.small_euroc_sequence(str(tmp_path / "euroc"))
    out = {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        argv = ["--mode", "stereo", "--dataset", "euroc", "--seq", seq, "--settings", settings, "--gt", gt,
                "--out", str(tmp_path / f"{name}.csv")]
        with chip_smoke.keyframes_recorded(tsys.SlamSystem, "track_stereo", {}) as rec:
            res = run_dataset.main(argv, device=device)
        out[name] = (res, rec["kf_at"])
    (card, kf_card), (host, kf_host) = out["card"], out["cpu"]
    assert card["slam"].device.type == "cuda" and card["decoder"] == host["decoder"] == decoder
    assert kf_card == kf_host and len(kf_card) >= 2 and card["slam"].stats == host["slam"].stats
    d_c, d_r = chip_smoke.trajectory_diff(card["slam"].trajectory_arrays(), host["slam"].trajectory_arrays())
    assert d_c.max() <= chip_smoke.TRANS_TOL and d_r.max() <= chip_smoke.ROT_TOL


@pytest.mark.parametrize("sensor", ["stereo", "stereo_inertial", "mono"])
def test_tracked_frames_fed_host_arrays_never_sync(dev, sensor):
    # the small passes fed numpy images (and IMU samples): a tracked frame
    # makes no synchronizing call outside the batched decision read; each
    # host image goes up with one non-blocking copy from pinned memory
    cpu = torch.device("cpu")
    records, lat = [], []
    watch = chip_smoke.watched_frames(records, lat, block=False)
    if sensor == "stereo":
        cfg = chip_smoke.loop_config(small=True)
        _, frames = chip_smoke.render_loop_sequence(cfg, 16, cpu)
        chip_smoke.run_loop(cfg, [(a.numpy(), b.numpy()) for a, b in frames], dev, on_frame=watch)
    elif sensor == "stereo_inertial":
        cfg = chip_smoke.si_config(small=True)
        si = chip_smoke.SMALL_SI
        _, frames, imu = chip_smoke.render_si_sequence(cfg, si["frames"], cpu, fps=si["fps"])
        chip_smoke.run_si(cfg, [(a.numpy(), b.numpy()) for a, b in frames], imu, dev, on_frame=watch,
                          fps=si["fps"])
    else:
        cfg = chip_smoke.mono_config(small=True)
        _, imgs = chip_smoke.render_mono_sequence(cfg, 16, cpu, speed=chip_smoke.SMALL_MONO["speed"])
        chip_smoke.run_mono(cfg, [a.numpy() for a in imgs], dev, on_frame=watch)
    tracked = [f for f in records if f["kind"] in ("tracking", "keyframe")]
    assert len(tracked) >= 2, chip_smoke.sync_summary(records)
    assert sum(f["syncs"] for f in tracked) == 0, [f["sync_calls"] for f in tracked if f["syncs"]]


def test_online_vocabulary_card_matches_cpu(dev):
    # LoopCloser(vocab=None) trained online from four keyframes' descriptors
    # on the card and on the CPU: the same centroids, and the backfilled
    # database rows (dense over the words) within 1e-5
    import numpy as np

    from orb_slam3_detailed_comments_kor_tpu_torch.slam import loop_closing

    rng = np.random.RandomState(11)
    protos = rng.randint(0, 2, (40, 256))
    kfs = []
    for _ in range(4):
        d = np.logical_xor(protos[rng.randint(0, 40, 600)], rng.rand(600, 256) < 0.05).astype(np.uint8)
        kfs.append((torch.from_numpy(d), torch.from_numpy(rng.rand(600) > 0.1)))
    lcs = {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        lc = loop_closing.LoopCloser(max_kf=16, vocab=None)
        for i, (d, v) in enumerate(kfs):
            lc.add_keyframe(i, d.to(device), v.to(device))
        lcs[name] = lc
    card, host = lcs["card"], lcs["cpu"]
    assert card.vocab.centroids.device.type == "cuda" and card.db_words.device.type == "cuda"
    assert torch.equal(card.vocab.centroids.cpu(), host.vocab.centroids)

    def dense(lc):
        ids, wts = lc.db_words.cpu().long(), lc.db_wts.cpu()
        out = torch.zeros((ids.shape[0], lc.vocab.n_words + 1))
        return out.scatter_add_(1, torch.where(ids >= 0, ids, lc.vocab.n_words), torch.where(ids >= 0, wts, 0.0))
    assert float((dense(card) - dense(host)).abs().max()) <= 1e-5


@pytest.mark.parametrize("kind", ["cg", "dense", "vi"])
def test_sharded_solvers_on_the_card(dev, kind):
    # a one-shard mesh on the card gives the one-device solver's bits; four
    # shards of the card give the same bits twice (the ordered reduction)
    # and stay within tests/test_dist_ba.py's distributed-versus-single
    # bounds of one shard
    from orb_slam3_detailed_comments_kor_tpu_torch.optim import ba, vi_ba
    from orb_slam3_detailed_comments_kor_tpu_torch.parallel import dist_ba, dist_vi_ba, dryrun

    K, L, n = (4, 64, 64) if kind == "dense" else (8, 512, 64)
    R, t, X, obs, fp, fl = dryrun.make_problem(K, L, n, 3, dev)
    g = torch.Generator().manual_seed(3)
    t = t + torch.where(fp[:, None].cpu(), 0.0, 0.01 * torch.randn((K, 3), generator=g)).to(dev)
    X = X + (0.02 * torch.randn(X.shape, generator=g)).to(dev)
    cam = torch.tensor(dryrun.CAM, device=dev)
    if kind == "vi":
        st = vi_ba.VIState(R, t, torch.zeros_like(t), torch.zeros_like(t), torch.zeros_like(t))
        args = (X, obs, dryrun.static_chain(K, dev), fp, fl, cam, torch.eye(3, device=dev),
                torch.zeros(3, device=dev), dryrun.BF, torch.zeros(3, device=dev))
        kw = dict(gyro_walk_info=vi_ba.WALK_INFO_CAP, acc_walk_info=vi_ba.WALK_INFO_CAP, iters=2)
        one_device = vi_ba.vi_bundle_adjust_cg(st, *args, **kw)[:2]
        run = lambda mesh: dist_vi_ba.distributed_vi_ba_cg(mesh, st, *args, **kw)
        flat = lambda out: (out[0].t_bw, out[1], out[0].v, out[0].R_bw)
    else:
        solver = ba.bundle_adjust_cg if kind == "cg" else ba.bundle_adjust
        sharded = dist_ba.distributed_bundle_adjust_cg if kind == "cg" else dist_ba.distributed_bundle_adjust
        kw = dict(iters=2, cg_iters=24) if kind == "cg" else dict(iters=2)  # the defaults differ
        one_device = solver(R, t, X, obs, fp, fl, cam, dryrun.BF, **kw)[:3]
        run = lambda mesh: sharded(mesh, R, t, X, obs, fp, fl, cam, dryrun.BF, **kw)
        flat = lambda out: (out[1], out[2], out[0])
    one, four_a, four_b = run([dev]), run([dev] * 4), run([dev] * 4)
    assert all(torch.equal(a, b) for a, b in zip(flat(one_device), flat(one)))
    assert all(torch.equal(a, b) for a, b in zip(flat(four_a), flat(four_b)))
    assert float((flat(four_a)[0] - flat(one)[0]).abs().max()) <= 2e-3
    assert float((flat(four_a)[1] - flat(one)[1]).abs().max()) <= 5e-3
    assert float((flat(one)[0] - t).abs().max()) > 1e-3  # the solve moved the poses


def _rest_inputs():
    """The remaining functions' inputs at the small setup, made on the CPU
    from seeds: a rendered 240x376 stereo pair, its features, random
    rotations, angles and matches, a 256-word random tree and 300
    descriptors."""
    import numpy as np

    from orb_slam3_detailed_comments_kor_tpu_torch.io import synthetic
    from orb_slam3_detailed_comments_kor_tpu_torch.utils import lie

    cfg = chip_smoke.loop_config(small=True)
    c = cfg.camera
    cam = torch.tensor([c.fx, c.fy, c.cx, c.cy])
    il, ir, _ = synthetic.stereo_pair(cam, torch.eye(3), torch.zeros(3), chip_smoke.BASELINE,
                                      synthetic.default_scene("cpu"), h=c.height, w=c.width)
    rng = np.random.RandomState(0)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    cents = (rng.rand(4 + 16 + 64 + 256, 256) < 0.5).astype(np.float32)
    return dict(cfg=cfg, il=il, ir=ir, R=lie.so3_exp(T(rng.normal(size=(64, 3)).astype(np.float32))),
                q=T(rng.normal(size=(64, 4)).astype(np.float32)), t=T(rng.normal(size=(64, 3)).astype(np.float32)),
                x=T(rng.normal(size=(64, 5, 3)).astype(np.float32)),
                angle_a=T(rng.uniform(0, 6.3, 400).astype(np.float32)),
                angle_b=T(rng.uniform(0, 6.3, 300).astype(np.float32)), idx=T(rng.randint(0, 300, 400)),
                match_valid=T(rng.rand(400) < 0.9), cents=T(cents), idf=T(rng.uniform(0.5, 3, 256).astype(np.float32)),
                desc=T((rng.rand(300, 256) < 0.5).astype(np.uint8)), desc_valid=T(rng.rand(300) < 0.9))


@pytest.mark.parametrize("name", ["lie", "rotation_mask", "fast", "pyramid", "stereo_ragged", "vocabulary"])
def test_remaining_functions_card_matches_cpu(dev, name):
    # the ported remaining functions on the card against the CPU at the
    # small setup: integers, masks and word ids exactly; the FAST maps
    # exactly (the CUDA fast_nms_stack against the plain
    # fast_with_fallback_stack on the card too); quaternions, rotations and
    # se3_apply within 1e-6 / 1e-5; the pyramid within 1e-3 and the blur
    # within 1e-4 grey levels (the resize products sum in another order);
    # the ragged-pyramid stereo's valid masks on >= 99 % of the features,
    # depths within 1e-4 relative where both are valid; BoW vectors and
    # sparse weights within 1e-6
    from orb_slam3_detailed_comments_kor_tpu_torch.models import vocabulary as voc
    from orb_slam3_detailed_comments_kor_tpu_torch.ops import fast as fast_ops, matching, pyramid, stereo
    from orb_slam3_detailed_comments_kor_tpu_torch.slam import frontend
    from orb_slam3_detailed_comments_kor_tpu_torch.utils import lie

    inp = _rest_inputs()
    cpu = torch.device("cpu")

    def on(d):
        return {k: v.to(d) if isinstance(v, torch.Tensor) else v for k, v in inp.items()}

    def run(d):
        a = on(d)
        if name == "lie":
            return dict(q=lie.rotmat_to_quat(a["R"]), R=lie.quat_to_rotmat(a["q"]),
                        y=lie.se3_apply(a["R"][:, None], a["t"][:, None], a["x"]))
        if name == "rotation_mask":
            return dict(m=matching.rotation_consistency_mask(a["angle_a"], a["angle_b"], a["idx"], a["match_valid"]))
        if name == "fast":
            return dict(raw=fast_ops.fast_score_raw(a["il"], 20.0), score=fast_ops.fast_score(a["il"], 7.0),
                        fwf=fast_ops.fast_with_fallback(a["il"], 20.0, 7.0, 24))
        if name == "pyramid":
            return dict(**{f"l{i}": x for i, x in enumerate(pyramid.build_pyramid(a["il"], 8, 1.2))},
                        blur=pyramid.gaussian_blur(a["il"]))
        if name == "stereo_ragged":
            feats = orb.extract_orb_batch(torch.stack([inp["il"], inp["ir"]]), n_features=600, cell=24)
            fl, fr = (orb.Features(*(x.to(d) for x in frontend._view(feats, i))) for i in (0, 1))
            pyr_l, pyr_r = (pyramid.build_pyramid(inp[k], 8, 1.2) for k in ("il", "ir"))
            sd = stereo.compute_stereo_matches(fl, fr, [x.to(d) for x in pyr_l], [x.to(d) for x in pyr_r],
                                               a["cfg"].camera.bf)
            return dict(valid=sd.valid, depth=sd.depth)
        v = voc.Vocabulary(centroids=a["cents"], k=4, depth=4, idf=a["idf"])
        words = voc.transform_exact(v, a["desc"], a["desc_valid"], chunk=100)
        ids, wts = voc.sparse_bow(v, words, a["desc_valid"], topw=128)
        return dict(words=words, bow=voc.bow_vector(v, words, a["desc_valid"]), ids=ids, wts=wts)

    card, host = run(dev), run(cpu)
    torch.cuda.synchronize()
    tol = dict(q=1e-6, R=1e-6, y=1e-5, blur=1e-4, bow=1e-6, wts=1e-6, depth=None)
    for k, h in host.items():
        g = card[k].cpu()
        assert card[k].device.type == "cuda" and g.dtype == h.dtype and g.shape == h.shape, k
        if k == "valid":
            assert (g == h).float().mean() >= 0.99 and int(h.sum()) > 100
        elif k == "depth":
            both = host["valid"] & card["valid"].cpu()
            assert float(((g - h).abs() / h.abs())[both].max()) <= 1e-4
        elif k.startswith("l"):
            assert float((g - h).abs().max()) <= 1e-3, k
        elif k in tol:
            assert float((g - h).abs().max()) <= tol[k], k
        else:
            assert torch.equal(g, h), k
    if name == "fast":
        from orb_slam3_detailed_comments_kor_tpu_torch.ops import pyramid as pyr_ops

        flat = torch.zeros((8, 240, 384), device=dev)
        shapes = pyr_ops.level_shapes(240, 376, 8, 1.2)
        for i, x in enumerate(pyr_ops.build_pyramid(inp["il"].to(dev), 8, 1.2)):
            flat[i, :shapes[i][0], :shapes[i][1]] = x
        hs, ws = tuple(s[0] for s in shapes), tuple(s[1] for s in shapes)
        inb = fast_ops.level_interior(hs, ws, 3, 240, 384, dev)
        before = cuda_fast.fast_nms.launches
        got = cuda_fast.fast_nms_stack(flat, hs, ws, 8, 20.0, 7.0, 24)
        assert cuda_fast.fast_nms.launches == before + 1
        for a, b in zip(got, fast_ops.fast_with_fallback_stack(flat, 20.0, 7.0, 24, inb)):
            assert torch.equal(a, b)
