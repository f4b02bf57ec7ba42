"""VrdONE in PyTorch: the port of ``vrdone_tpu`` to CUDA on NVIDIA Hopper.

The package keeps the JAX package's module layout and names, so each module
here has its counterpart at the same path under ``vrdone_tpu/``. It imports
``torch`` and never ``jax``. The attention kernels of the eval and train
paths (band attention forward and backward, key-masked full attention
forward) and of the MEGA detector (fused set-attention, geometric position
bias) are hand-written CUDA C++ (``csrc/``), built with ``nvcc`` at first
use.
"""

__version__ = "0.1.0"

from .config import (InferenceConfig, ModelConfig, PredictorConfig,
                     load_yaml_config, model_config_from_yaml)

__all__ = [
    "InferenceConfig", "ModelConfig", "PredictorConfig",
    "load_yaml_config", "model_config_from_yaml", "__version__",
]
