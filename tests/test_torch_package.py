"""The PyTorch port's package boundary and configuration against the JAX
reference package.

Tolerances: the config dataclasses are compared exactly.
"""

import ast
import dataclasses
import importlib
import inspect
import os
import subprocess
import sys

import pytest
import torch

from orb_slam3_detailed_comments_kor_tpu import config as jcfg
from orb_slam3_detailed_comments_kor_tpu_torch import config as tcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "orb_slam3_detailed_comments_kor_tpu_torch"
SLICE_MODULES = [
    "config", "utils.lie", "models.camera", "ops.pyramid", "ops.fast",
    "ops.cuda_fast", "ops.select", "ops.cuda_gather", "ops.orb",
    "ops.matching", "ops.cuda_matching", "ops.stereo", "slam.frontend",
    "optim.factors", "optim.ba", "slam.map_state", "slam.tracking",
    "io.synthetic",
    # the stereo SLAM loop
    "slam.map_merging", "slam.system", "eval.ate", "io.trajectory", "utils.timing",
    # loop closing and relocalization
    "utils.prng", "utils.host_read", "models.vocabulary", "ops.ransac", "optim.pose_graph",
    "slam.loop_closing",
    # the Atlas merge, checkpoints and localization mode
    "slam.checkpoint",
    # the stereo-inertial path
    "ops.imu", "optim.vi_ba", "optim.vi_init", "optim.vio", "slam.inertial",
    # the monocular and monocular-inertial paths
    "ops.twoview",
    # the recorded-sequence and live-sensor entry points and the viewer
    "utils.verbose", "io.native_host", "io.datasets", "io.online", "examples.run_dataset",
    "examples.run_synthetic", "viz.viewer",
    # multi-device bundle adjustment
    "parallel.dist_ba", "parallel.dist_vi_ba", "parallel.dryrun",
]
# the functions of the RGB-D and fisheye paths, in the modules they extend
SLICE_FUNCTIONS = [
    ("models.camera", "kb8_project"), ("models.camera", "kb8_unproject"), ("models.camera", "kb8_project_jac"),
    ("models.camera", "project_jac"), ("slam.frontend", "process_rgbd"), ("slam.frontend", "process_stereo_fisheye"),
    ("optim.factors", "with_rig_rows"), ("optim.factors", "_rig_select"), ("slam.tracking", "full_rgbd_step"),
    ("slam.tracking", "full_fisheye_step"), ("slam.system", "SlamSystem.track_rgbd"),
    ("slam.system", "SlamSystem._track_fisheye_fused"),
    # online vocabulary training, the corridor scenes and the profiler block
    ("models.vocabulary", "train_vocabulary"), ("models.vocabulary", "transform"),
    ("models.vocabulary", "compute_idf"), ("io.synthetic", "corridor_scene"), ("io.synthetic", "wall_scene"),
    ("io.synthetic", "CorridorTrajectory"), ("utils.timing", "torch_profile"),
    # the one-image extractor of the host tools
    ("ops.orb", "extract_orb"),
]


def test_imports_without_jax():
    """Every slice module imports with jax made unimportable."""
    code = (
        "import sys\n"
        "for k in [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib')]:\n"
        "    del sys.modules[k]\n"
        "sys.modules['jax'] = None  # any `import jax` now raises\n"
        "import importlib\n"
        f"for m in {SLICE_MODULES!r}:\n"
        f"    importlib.import_module('{PKG}.' + m)\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def test_sources_never_import_jax():
    """AST scan: no module of the port names jax or the JAX package."""
    bad = []
    for root, _, files in os.walk(os.path.join(REPO, PKG)):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(root, fn)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                for n in names:
                    top = n.split(".")[0]
                    if top in ("jax", "jaxlib", "orb_slam3_detailed_comments_kor_tpu"):
                        bad.append(f"{path}: {n}")
    assert not bad, bad


def test_slice_modules_present():
    for m in SLICE_MODULES:
        assert os.path.exists(os.path.join(REPO, PKG, *m.split(".")) + ".py"), m
    for m, name in SLICE_FUNCTIONS:
        obj = importlib.import_module(f"{PKG}.{m}")
        for part in name.split("."):
            obj = getattr(obj, part)
        assert callable(obj), (m, name)


@pytest.mark.parametrize(
    "name",
    ["CameraConfig", "ORBConfig", "IMUConfig", "TrackingConfig",
     "CapacityConfig", "SLAMConfig"],
)
def test_config_fields_equal(name):
    j, t = getattr(jcfg, name), getattr(tcfg, name)
    assert [f.name for f in dataclasses.fields(j)] == [f.name for f in dataclasses.fields(t)]
    assert dataclasses.asdict(j()) == dataclasses.asdict(t())
    assert vars(jcfg.SensorType).keys() == vars(tcfg.SensorType).keys()


@pytest.mark.parametrize(
    "module,name",
    [("slam.map_state", "empty_map"), ("io.synthetic", "default_scene"),
     ("models.camera", "camera_params_from_config"), ("slam.system", "SlamSystem"),
     ("models.vocabulary", "load_default"), ("utils.prng", "key_from_bytes"),
     ("slam.inertial", "empty_inertial"), ("ops.imu", "identity_preintegrated"),
     ("io.synthetic", "AnalyticTrajectory"), ("examples.run_dataset", "main"), ("examples.run_synthetic", "main"),
     ("models.vocabulary", "train_vocabulary"), ("io.synthetic", "corridor_scene"), ("io.synthetic", "wall_scene"),
     ("parallel.dist_ba", "make_mesh")],
)
def test_entry_points_default_to_cuda(module, name):
    """Entry points that make tensors from nothing put them on the card
    unless the caller names a device. Read from the signature: a call
    without a device needs a card, and the CPU tests name ``cpu``."""
    fn = getattr(importlib.import_module(f"{PKG}.{module}"), name)
    default = inspect.signature(fn).parameters["device"].default
    assert default is not None and torch.device(default).type == "cuda"


@pytest.mark.parametrize(
    "module,name",
    [("slam.map_merging", "try_merge"), ("slam.map_merging", "merge_into_shelved"),
     ("slam.map_merging", "verify_merge"), ("slam.map_merging", "_concat_maps"),
     ("slam.checkpoint", "save_map"), ("slam.checkpoint", "load_map"),
     ("slam.system", "SlamSystem.save_map"), ("slam.system", "SlamSystem.load_map"),
     ("slam.system", "SlamSystem.activate_localization_mode"), ("slam.system", "SlamSystem._loc_vo_fallback"),
     ("slam.system", "SlamSystem.track_stereo_inertial"), ("slam.inertial", "local_vi_ba_step"),
     ("slam.inertial", "full_inertial_ba"), ("slam.inertial", "initialize_imu"), ("optim.vio", "vio_frame_step"),
     ("optim.vi_ba", "vi_bundle_adjust"), ("slam.loop_closing", "LoopCloser.correct"),
     ("slam.system", "SlamSystem.track_mono"), ("slam.system", "SlamSystem.track_mono_inertial"),
     ("slam.frontend", "process_mono"), ("slam.tracking", "full_mono_step"),
     ("slam.tracking", "triangulate_with_neighbor"), ("slam.tracking", "add_triangulated_landmarks"),
     ("ops.twoview", "reconstruct_two_views_hf"), ("slam.map_state", "apply_scale"),
     ("slam.frontend", "process_rgbd"), ("slam.frontend", "process_stereo_fisheye"),
     ("slam.tracking", "full_rgbd_step"), ("slam.tracking", "full_fisheye_step"),
     ("slam.system", "SlamSystem.track_rgbd"), ("slam.loop_closing", "LoopCloser.add_keyframe"),
     ("models.vocabulary", "transform"), ("models.vocabulary", "compute_idf"),
     ("slam.loop_closing", "global_ba"), ("parallel.dist_vi_ba", "distributed_full_inertial_ba"),
     ("parallel.dist_ba", "distributed_bundle_adjust_cg"), ("parallel.dist_vi_ba", "distributed_vi_ba_cg")],
)
def test_entry_points_follow_their_inputs_device(module, name):
    """Entry points that work on a system's or a map's tensors take no
    device of their own: what they make lands on the device of what they
    are given (the system's, the card unless its caller named another)."""
    obj = importlib.import_module(f"{PKG}.{module}")
    for part in name.split("."):
        obj = getattr(obj, part)
    assert "device" not in inspect.signature(obj).parameters


def test_loop_closing_on_by_default():
    """``SlamSystem(cfg)`` closes loops unless told otherwise, as the
    reference's does: a plain attribute, True after construction, with a
    loop closer over the default vocabulary on the system's device."""
    from orb_slam3_detailed_comments_kor_tpu_torch.slam.system import SlamSystem

    slam = SlamSystem(tcfg.SLAMConfig(), device="cpu")
    assert slam.enable_loop_closing is True
    assert slam.loop_closer.vocab is not None and slam.loop_closer.vocab.idf.device.type == "cpu"
    assert slam.loop_closer.db_words.shape == (slam.ms.K, 2048)
    slam.enable_loop_closing = False  # a plain attribute: the caller may turn it off
    assert slam.enable_loop_closing is False


@pytest.mark.parametrize("case", ["rgbd", "mono_kb8", "stereo_fisheye", "stereo_fisheye_inertial"])
def test_sensor_systems_build_on_the_card_by_default(case):
    """``SlamSystem(cfg)`` builds for RGB-D and for the KB8 fisheye (one
    camera, or a stereo rig with ``right_intrinsics`` and ``Tlr``, with or
    without an IMU), on the card unless the caller names another device;
    a rig system carries its extrinsic and the right camera on the
    system's device."""
    import chip_smoke
    from orb_slam3_detailed_comments_kor_tpu_torch.slam.system import SlamSystem, TrackingState

    assert torch.device(inspect.signature(SlamSystem).parameters["device"].default).type == "cuda"
    kind = {"rgbd": "rgbd", "mono_kb8": "mono", "stereo_fisheye": "fisheye",
            "stereo_fisheye_inertial": "fsi"}[case]
    cfg = chip_smoke.sensor_config(kind)
    slam = SlamSystem(cfg, device="cpu")
    assert slam.state == TrackingState.NOT_INITIALIZED and slam.ms.kf_t_cw.device.type == "cpu"
    assert slam.cfg.is_inertial == (case == "stereo_fisheye_inertial")
    assert slam.stereo_fisheye == (case.startswith("stereo"))
    assert slam._dist is None
    if slam.stereo_fisheye:
        R_rl, t_rl, params_r = slam.rig
        assert params_r.device.type == "cpu" and params_r.shape == (8,)
        # Tlr is a pure +x offset of the right camera: left-to-right is -x
        assert torch.equal(R_rl, torch.eye(3)) and torch.allclose(t_rl, torch.tensor([-chip_smoke.FISH_BASE, 0, 0]))
    else:
        assert slam.rig is None


@pytest.mark.parametrize("sensor", ["MONOCULAR", "IMU_MONOCULAR"])
def test_monocular_systems_build_on_the_card_by_default(sensor):
    """``SlamSystem(cfg)`` with a monocular sensor and a pinhole camera
    builds, on the card unless the caller names another device, and
    ``track_mono`` / ``track_mono_inertial`` run on the system's device."""
    from orb_slam3_detailed_comments_kor_tpu_torch.slam.system import SlamSystem, TrackingState

    assert torch.device(inspect.signature(SlamSystem).parameters["device"].default).type == "cuda"
    slam = SlamSystem(tcfg.SLAMConfig(sensor=getattr(tcfg.SensorType, sensor)), device="cpu")
    assert slam.state == TrackingState.NOT_INITIALIZED and slam.ms.kf_t_cw.device.type == "cpu"
    assert slam.cfg.is_inertial == (sensor == "IMU_MONOCULAR")


# the reference's top-level functions that the port replaces rather than
# copies: the Pallas modules (the CUDA wrappers ``ops/cuda_*.py``), the
# JAX profiler hook (``utils.timing.torch_profile``), the reference's
# library path helper (the port builds its own source into ``_build/``)
# and the checkpoint's NamedTuple packing (the port writes the same
# ``.npz`` layout field by field)
REPLACED = {"ops/pallas_fast.py": None, "ops/pallas_gather.py": None, "ops/pallas_matching.py": None,
            "utils/timing.py": {"jax_profile"}, "io/native_host.py": {"_native_dir"},
            "slam/checkpoint.py": {"_pack_namedtuple", "_unpack_namedtuple"}}
# the functions the last slice ported: the reference's argument names, in order
LAST_SLICE = [
    ("models.vocabulary", n) for n in ("transform_exact", "bow_vector_soft", "bow_vector", "l1_score", "sparse_bow",
                                       "score_against_database")] + [
    ("ops.stereo", "_stack_pyramid"), ("ops.pyramid", "build_pyramid"), ("ops.pyramid", "_gauss_kernel"),
    ("ops.pyramid", "gaussian_blur"), ("ops.fast", "_has_contiguous_run"), ("ops.fast", "fast_score_raw"),
    ("ops.fast", "fast_score"), ("ops.fast", "fast_with_fallback_stack"), ("ops.fast", "fast_with_fallback"),
    ("ops.matching", "rotation_consistency_mask"), ("utils.lie", "rotmat_to_quat"),
    ("utils.lie", "quat_to_rotmat"), ("utils.lie", "se3_apply")]


def test_every_reference_function_has_a_counterpart():
    """Every top-level function and class of every module of the JAX
    package has a function, class or alias of the same name in the port's
    module of the same path, except those the port replaces (REPLACED);
    the last slice's functions take the reference's arguments, in its
    order."""
    ref_pkg = os.path.join(REPO, "orb_slam3_detailed_comments_kor_tpu")
    missing = []
    for root, _, files in os.walk(ref_pkg):
        for fn in sorted(files):
            if not fn.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(root, fn), ref_pkg)
            if rel in REPLACED and REPLACED[rel] is None:
                continue

            def defs(path, aliases):
                with open(path) as f:
                    body = ast.parse(f.read()).body
                return {n.name for n in body if isinstance(n, (ast.FunctionDef, ast.ClassDef))} | ({
                    t.id for n in body if isinstance(n, ast.Assign) for t in n.targets if isinstance(t, ast.Name)}
                    if aliases else set())

            port = os.path.join(REPO, PKG, rel)
            want = defs(os.path.join(root, fn), False) - REPLACED.get(rel, set())
            missing += [f"{rel}: {n}" for n in sorted(want - (defs(port, True) if os.path.exists(port) else set()))]
    assert not missing, missing
    for m, name in LAST_SLICE:
        ref = inspect.signature(getattr(importlib.import_module(f"orb_slam3_detailed_comments_kor_tpu.{m}"), name))
        got = inspect.signature(getattr(importlib.import_module(f"{PKG}.{m}"), name))
        assert list(got.parameters) == list(ref.parameters), (m, name)
