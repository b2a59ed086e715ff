"""Helpers shared by the PyTorch port's parity tests (not collected).

JAX parameters are made from ``jax.eval_shape`` of the Flax init (a trace,
no compile) and filled with seeded numpy values at realistic scales, so the
dirac, layer-scale 1e-5 and ones/zeros inits hide nothing and no JAX
initializer has to be compiled.
"""

import jax
import numpy as np
import torch


def t(x):
    return torch.from_numpy(np.asarray(x))


def random_params(shapes, seed=0):
    """numpy tree shaped like ``shapes`` (arrays or ShapeDtypeStructs)."""
    rng = np.random.default_rng(seed)

    def make(path, leaf):
        name = getattr(path[-1], "key", str(path[-1]))
        shape = tuple(leaf.shape)
        if name == "kernel":
            # (in, out) dense, (L, in, out) scanned dense, (kh, kw, in, out) conv
            fan_in = shape[-2] if len(shape) == 3 else int(np.prod(shape[:-1]))
            arr = rng.standard_normal(shape) / np.sqrt(fan_in)
        elif name == "embedding":
            arr = rng.standard_normal(shape)
        elif name in ("scale", "weight", "gamma"):
            arr = 1.0 + 0.1 * rng.standard_normal(shape)
        else:  # biases
            arr = 0.1 * rng.standard_normal(shape)
        return arr.astype(np.float32)

    return jax.tree_util.tree_map_with_path(make, shapes)


def jax_param_shapes(module, *inputs, **kw):
    """Abstract Flax init of ``module`` on ``inputs``: the parameter shapes."""
    return jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *inputs, **kw))["params"]
