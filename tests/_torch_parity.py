"""Helpers shared by the PyTorch port's parity tests (not collected).

JAX parameters are made from ``jax.eval_shape`` of the Flax init (a trace,
no compile) and filled with seeded numpy values at realistic scales, so the
dirac, layer-scale 1e-5 and ones/zeros inits hide nothing and no JAX
initializer has to be compiled.
"""

import contextlib
import sys
from pathlib import Path

import jax
import numpy as np
import torch

LEROBOT_STUB = str(Path(__file__).parent / "lerobot_stub")

# The port's CPU tests run their tiny models on one intra-op thread. A test
# run with N worker processes (``pytest -n N``) on the machine's cores gives
# each of them torch's default pool of a thread per core, which
# oversubscribes the CPU: tests/test_torch_*.py took 595.9 s with the default
# pool and 242.3 s with one thread at -n 6 (857 passed both ways). Every
# worker imports this module when it collects the tests.
torch.set_num_threads(1)


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


def tiny_vlm_pair(seed, kvq="none", mode="prefix", embed_scale=0.1, prompt=8):
    """The JAX tiny FastVLM (1 image token at 64 px), its params from
    ``seed`` and the port's model with the same weights, fp32. The token
    embedding is scaled by ``embed_scale``: at unit scale the tiny models
    copy their input token, and greedy sequences do not vary."""
    import jax.numpy as jnp

    from vla_fastvlm_tpu.models import fastvlm as j_vlm
    from vla_fastvlm_tpu.models import qwen2 as j_qwen
    from vla_fastvlm_tpu_torch.io.bridge import jax_params_to_torch
    from vla_fastvlm_tpu_torch.models import fastvlm as t_vlm
    from vla_fastvlm_tpu_torch.models import qwen2 as t_qwen

    jm = j_vlm.FastVLM(j_vlm.fastvlm_tiny(image_token_mode=mode).replace(
        text=j_qwen.qwen2_tiny(kv_cache_quantization=kvq)))
    images = jnp.zeros((1, 3, 64, 64)) if mode == "prefix" else None
    params = random_params(jax_param_shapes(jm, images, jnp.ones((1, prompt), jnp.int32)), seed=seed)
    embed = params["language_model"]["embed_tokens"]
    embed["embedding"] = embed["embedding"] * embed_scale
    tm = t_vlm.FastVLM(t_vlm.fastvlm_tiny(image_token_mode=mode).replace(
        text=t_qwen.qwen2_tiny(kv_cache_quantization=kvq)))
    tm.load_state_dict(jax_params_to_torch(params), strict=True)
    return jm, params, tm.eval().requires_grad_(False)


def jax_adapter(params, rank, seed, scale=0.05):
    """A JAX LoRA adapter tree for the tiny FastVLM's ``params``
    (``vla_fastvlm_tpu/io/lora.py::init_lora``'s structure, from a trace)
    with seeded numpy values: A at JAX's init scale, B non-zero."""
    from vla_fastvlm_tpu.io.lora import init_lora

    shapes = jax.eval_shape(lambda: init_lora({"language_model": params["language_model"]}, rank,
                                              jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        std = 1 / np.sqrt(leaf.shape[-2]) if path[-1].key == "a" else scale
        return (rng.standard_normal(leaf.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def rel_l2(a, b) -> float:
    """||a - b|| / ||b|| over numpy-convertible arrays."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@contextlib.contextmanager
def lerobot_stub(*packages):
    """Import ``lerobot`` from ``tests/lerobot_stub`` while inside.

    ``lerobot.*`` and the ``packages`` given (plugins, which register into
    the stub's class-level registry when imported) leave ``sys.modules``
    before and after, so each import inside is fresh; what was there
    before comes back on exit, in ``sys.modules`` and as its parent
    package's attribute (``import a.b as c`` reads the attribute)."""

    def held(name):
        return any(name == p or name.startswith(p + ".") for p in ("lerobot",) + packages)

    saved = {name: module for name, module in sys.modules.items() if held(name)}
    for name in saved:
        del sys.modules[name]
    sys.path.insert(0, LEROBOT_STUB)
    try:
        yield
    finally:
        sys.path.remove(LEROBOT_STUB)
        inside = [name for name in sys.modules if held(name)]
        for name in inside:
            del sys.modules[name]
        sys.modules.update(saved)
        for name in set(inside) | set(saved):
            parent, _, child = name.rpartition(".")
            if parent not in sys.modules:
                continue
            if name in saved:
                setattr(sys.modules[parent], child, saved[name])
            elif hasattr(sys.modules[parent], child):
                delattr(sys.modules[parent], child)


def random_quantized_params(tree, seed=0):
    """Seeded numpy parameters shaped like ``tree`` (``random_params``), with
    every node whose kernel ``tree`` holds quantized (int8, or int4 with the
    group its scales imply) quantized from its random float kernel by the
    JAX package's ``quantize_kernel`` / ``quantize_kernel_int4``."""
    from vla_fastvlm_tpu.ops.quant import quantize_kernel, quantize_kernel_int4

    floats = random_params(tree, seed)

    def walk(node, fnode):
        if not isinstance(node, dict):
            return fnode
        kernel = node.get("kernel")
        kind = getattr(getattr(kernel, "dtype", None), "name", None)
        if kind == "int8":
            return dict(fnode, **quantize_kernel(fnode["kernel"]))
        if kind == "int4":
            group = kernel.shape[-2] // node["scale"].shape[-2]
            return dict(fnode, **quantize_kernel_int4(fnode["kernel"], group))
        return {k: walk(v, fnode[k]) for k, v in node.items()}

    return walk(tree, floats)
