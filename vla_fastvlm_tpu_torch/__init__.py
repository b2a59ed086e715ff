"""PyTorch port of vla_fastvlm_tpu for one NVIDIA H100 (sm_90a).

The JAX package ``vla_fastvlm_tpu`` stays the numerical reference; this
package mirrors its layout (``ops/``, ``models/``, ``io/``, ``model/``,
``fastvla/``) so each module's counterpart is found under the same path.
It imports ``torch`` only: never ``jax``, ``flax`` or the JAX package.

Every Pallas TPU kernel on a ported path becomes a hand-written CUDA kernel
under ``csrc/``, built with ``nvcc`` at first use (``ops/kernels/_build.py``)
and launched through a ctypes wrapper that keeps a plain PyTorch version
beside it. Entry points run on the card unless the caller passes
``device="cpu"`` (``device.resolve_device``).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
