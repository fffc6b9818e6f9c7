"""PyTorch / CUDA port of the visual-inertial SLAM engine.

A second package beside the JAX reference ``orb_slam3_detailed_comments_kor_tpu``
with the same layout (``utils/ models/ ops/ optim/ slam/ io/``), module names,
function names and argument order, so each function has an obvious
counterpart. Plain tensor code is PyTorch; the reference's three Pallas TPU
kernels are CUDA C++ kernels for Hopper (``csrc/``), each beside a plain
PyTorch version that the CPU path runs.

It covers every sensor path of ``slam.system.SlamSystem`` (tracking,
local mapping, loop closing, the Atlas merge, checkpoints and localization
mode): stereo, stereo-inertial, monocular and monocular-inertial on the
pinhole camera; RGB-D; and the Kannala-Brandt (KB8) fisheye, monocular or
as a two-camera rig with its right-camera observation rows, with or
without an IMU. Not ported: training a vocabulary online and the
multi-device BA branches.

The package imports torch and numpy only — never jax.
"""

__version__ = "0.1.0"

import torch as _torch

# The reference pins f32 matmuls (bf16 broke LM convergence). Here that means
# no TF32 anywhere: cuBLAS matmuls and cuDNN convolutions both in full f32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from orb_slam3_detailed_comments_kor_tpu_torch.config import (  # noqa: E402,F401
    CameraConfig,
    IMUConfig,
    ORBConfig,
    SLAMConfig,
    TrackingConfig,
)
