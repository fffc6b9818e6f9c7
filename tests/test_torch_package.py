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

torch.set_num_threads(1)

from orb_slam3_detailed_comments_kor_tpu import config as jcfg  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu_torch import config as tcfg  # noqa: E402

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
     ("models.vocabulary", "load_default"), ("utils.prng", "key_from_bytes")],
)
def test_entry_points_default_to_cuda(module, name):
    """Entry points that make tensors from nothing put them on the card
    unless the caller names a device. Read from the signature: a call
    without a device needs a card, and the CPU tests name ``cpu``."""
    fn = getattr(importlib.import_module(f"{PKG}.{module}"), name)
    default = inspect.signature(fn).parameters["device"].default
    assert default is not None and torch.device(default).type == "cuda"


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
