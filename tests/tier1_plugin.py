"""Tier-1 harness for ``tests/``, loaded by ``pytest.ini`` (``-p``, before
conftest.py): one torch thread and single-threaded XLA Eigen kernels in each
worker, the heaviest files first, the reference-only tests too long for the
tier-1 run marked ``slow``, and a time limit on each test's setup and call."""

import contextlib
import os
import signal
from pathlib import Path

import pytest

TESTS = Path(__file__).parent

# six xdist workers share eight CPUs (the reference's outputs are bit-equal
# either way). XLA_FLAGS is read when the backend initializes, later than
# conftest.py's import of jax.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_cpu_multi_thread_eigen" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_cpu_multi_thread_eigen=false").strip()

#: the files over ~60 s, heaviest first, by setup + call seconds on a worker
#: in run 7 of the tier-1 command logged in CHANGES.md
HEAVIEST_FIRST = (
    "test_full_inertial_ba.py", "test_slam_vi_e2e.py", "test_torch_loop.py", "test_torch_mono.py",
    "test_kf_lifecycle.py", "test_torch_inertial.py", "test_fisheye.py", "test_torch_fisheye_mono.py",
    "test_torch_fisheye.py", "test_vio.py", "test_atlas_culling.py", "test_reloc_multicand.py",
    "test_map_merge.py", "test_localization_mode.py", "test_loop_injected.py", "test_vi_ba.py",
    "test_torch_run_dataset.py", "test_fisheye_rig.py", "test_dist_ba.py", "test_torch_system.py",
    "test_loopparts.py", "test_torch_loopparts.py", "test_atlas_reloc.py", "test_loop_e2e.py",
    "test_ba.py", "test_default_capacity.py", "test_torch_dist_ba.py",
)

#: reference-only tests too long for the tier-1 run (``-m 'not slow'``);
#: ``python -m pytest tests/ -m slow`` runs them
SLOW = (
    "test_loop_fp_control.py::test_no_loop_control_sequence",
    "test_default_capacity_si.py::test_default_capacity_stereo_inertial",
    "test_vio_system.py::test_frame_vio_improves_biased_ate",
    "test_map_merge_inertial.py::test_shelf_carries_inertial_state",
    "test_map_merge_inertial.py::test_merge_welds_maps",
    "test_map_merge_inertial.py::test_gravity_frame_survives_merge",
    "test_map_merge_inertial.py::test_tracking_continues_after_weld",
    "test_mono_inertial.py::TestMonoInertial::test_tracking_ok",
    "test_mono_inertial.py::TestMonoInertial::test_imu_initialized",
    "test_mono_inertial.py::TestMonoInertial::test_metric_scale_recovered",
    "test_mono_inertial.py::TestMonoInertial::test_gravity_recovered",
    "test_mono_inertial.py::TestMonoInertial::test_ate_reasonable",
    "test_long_lifecycle.py::test_corridor_out_and_back_600",
    "test_dist_ba.py::test_distributed_vi_ba_matches_single_device",
)

#: seconds that a test's setup, or its call, may take
LIMIT = 900


def _ours(path):
    return TESTS == path or TESTS in path.parents


def _check_names():
    """A renamed file or test fails the run instead of leaving its list."""
    for name in HEAVIEST_FIRST:
        if not (TESTS / name).is_file():
            raise pytest.UsageError(f"HEAVIEST_FIRST names {name}, which is not in {TESTS}")
    for nodeid in SLOW:
        file, *_, test = nodeid.split("::")
        if f"def {test}(" not in (TESTS / file).read_text():
            raise pytest.UsageError(f"SLOW names {nodeid}, which is not in {TESTS}")


def pytest_collectstart(collector):
    if _ours(collector.path):
        try:
            import torch
        except ImportError:
            return
        torch.set_num_threads(1)


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(config, items):
    _check_names()
    rank = {name: i for i, name in enumerate(HEAVIEST_FIRST)}
    slow = set(SLOW)
    for item in items:
        if _ours(item.path) and f"{item.path.name}::{item.nodeid.split('::', 1)[1]}" in slow:
            item.add_marker(pytest.mark.slow)
    items.sort(key=lambda item: rank.get(item.path.name, len(rank)) if _ours(item.path) else len(rank))


@contextlib.contextmanager
def _time_limit(item, phase):
    if not _ours(item.path):
        yield
        return

    def expire(signum, frame):
        pytest.fail(f"the test's {phase} ran past its limit of {LIMIT} s", pytrace=False)

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, LIMIT)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    with _time_limit(item, "setup"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _time_limit(item, "call"):
        return (yield)
