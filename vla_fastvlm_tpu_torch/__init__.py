"""PyTorch port of vla_fastvlm_tpu for one NVIDIA H100 (sm_90a).

The JAX package ``vla_fastvlm_tpu`` stays the numerical reference; this
package mirrors its layout (``ops/``, ``models/``, ``io/``, ``model/``,
``fastvla/``) so each module's counterpart is found under the same path.
It imports ``torch`` only: never ``jax``, ``flax`` or the JAX package.

Every Pallas TPU kernel on a ported path becomes a hand-written CUDA kernel
under ``csrc/``, built with ``nvcc`` at first use (``ops/kernels/_build.py``)
and launched through a ctypes wrapper that keeps a plain PyTorch version
beside it. Entry points run on the card unless the caller passes
``device="cpu"`` (``device.resolve_device``). The top-level names are
those of the JAX package (``FastVLAConfig``, ``FastVLAPolicy``,
``FastVLMPolicy``, ``Trainer``, ``TrainingConfig``,
``load_policy_from_checkpoint``, the device helpers and the
sub-packages), resolved on first access.
"""

import importlib

from .device import (
    get_best_device,
    is_cuda_available,
    is_mps_available,
    move_batch_to_device,
    resolve_device,
)

__version__ = "0.1.0"

_SUBPACKAGES = ("models", "ops", "io", "data", "training", "serving", "fastvla", "model", "utils", "parallel")


def __getattr__(name):
    # Lazy exports, as in the JAX package: the top-level API resolves on
    # first access, so ``import vla_fastvlm_tpu_torch`` stays light.
    if name in ("FastVLAConfig", "FastVLAPolicy"):
        from . import fastvla

        return getattr(fastvla, name)
    if name == "FastVLMPolicy":
        from .model.policy import FastVLMPolicy

        return FastVLMPolicy
    if name in ("Trainer", "TrainingConfig"):
        from . import training

        return getattr(training, name)
    if name == "load_policy_from_checkpoint":
        from .io.checkpoint import load_policy_from_checkpoint

        return load_policy_from_checkpoint
    if name in _SUBPACKAGES:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "get_best_device",
    "is_cuda_available",
    "is_mps_available",
    "move_batch_to_device",
    "resolve_device",
    "FastVLMPolicy",
    "FastVLAConfig",
    "FastVLAPolicy",
    "Trainer",
    "TrainingConfig",
    "load_policy_from_checkpoint",
]
