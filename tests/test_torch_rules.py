"""Rules of the PyTorch port, checked on the CPU.

- The port imports without JAX and without the JAX package.
- No file of the port, nor ``chip_smoke.py``, names the JAX package or JAX.
- Entry points raise without CUDA unless ``device="cpu"`` is passed.
- The weight bridge covers every parameter at full ``fastvlm_0_5b`` width:
  ``jax.eval_shape`` of the JAX init against the port built on the meta
  device (nothing is allocated for either).
"""

import importlib
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vla_fastvlm_tpu_torch
from vla_fastvlm_tpu_torch.io.bridge import jax_params_to_torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "vla_fastvlm_tpu_torch"


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(vla_fastvlm_tpu_torch.__path__, "vla_fastvlm_tpu_torch.")
    )


def test_imports_without_jax():
    code = (
        "import sys, importlib\n"
        "for name in ('jax', 'jaxlib', 'flax', 'vla_fastvlm_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"for mod in {_port_modules()!r}:\n"
        "    importlib.import_module(mod)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


FORBIDDEN = [
    re.compile(r"vla_fastvlm_tpu\."),
    re.compile(r"(import|from)\s+vla_fastvlm_tpu(?!_torch)\b"),
    re.compile(r"^\s*(import|from)\s+(jax|flax|jaxlib)\b", re.M),
]


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*") if p.suffix in (".py", ".cu"))
    + ["chip_smoke.py"],
)
def test_no_jax_in_port_sources(path):
    text = (ROOT / path).read_text()
    for pattern in FORBIDDEN:
        assert not pattern.search(text), f"{path} matches {pattern.pattern}"


def test_every_module_has_a_jax_counterpart_layout():
    """The port mirrors the JAX package's layout for every ported module."""
    mirrored = {
        "ops/norms.py", "ops/rope.py", "ops/attention.py", "ops/image.py",
        "models/qwen2.py", "models/fastvit.py", "models/fastvlm.py", "models/action_head.py",
        "io/tokenizer.py", "model/fastvlm_adapter.py", "fastvla/configuration_fastvla.py",
        "fastvla/processor_fastvla.py", "fastvla/fastvlm_with_expert.py", "fastvla/modeling_fastvla.py",
    }
    for rel in mirrored:
        assert (PORT / rel).is_file() and (ROOT / "vla_fastvlm_tpu" / rel).is_file(), rel


class TestDevice:
    def test_resolve_device(self, monkeypatch):
        from vla_fastvlm_tpu_torch.device import resolve_device

        assert resolve_device("cpu") == torch.device("cpu")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device("cuda")

    @pytest.mark.parametrize("entry", ["FastVLMBackbone", "FastVLMWithExpert", "FastVLAPolicy"])
    def test_entry_points_need_cuda_unless_cpu(self, entry, monkeypatch):
        from vla_fastvlm_tpu_torch.fastvla import FastVLAConfig, FastVLAPolicy, FastVLMWithExpert
        from vla_fastvlm_tpu_torch.model import FastVLMBackbone

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        cfg = FastVLAConfig(vlm_model_name="tiny", hidden_dim=8, fusion_dim=8, tokenizer_max_length=8)
        build = {
            "FastVLMBackbone": lambda **kw: FastVLMBackbone(cfg.to_backbone_config(), **kw),
            "FastVLMWithExpert": lambda **kw: FastVLMWithExpert(cfg, **kw),
            "FastVLAPolicy": lambda **kw: FastVLAPolicy(cfg, **kw),
        }[entry]
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
        assert build(device="cpu").device == torch.device("cpu")

    def test_forward_rejects_another_device(self):
        from vla_fastvlm_tpu_torch.model import FastVLMBackbone, FastVLMBackboneConfig

        bb = FastVLMBackbone(FastVLMBackboneConfig(model_id="tiny", tokenizer_max_length=8), device="cpu")
        with pytest.raises(ValueError, match="lives on"):
            bb.forward(np.zeros((1, 3, 64, 64), np.float32), ["x"], device="meta")


class TestBridgeCoverage:
    @staticmethod
    def _zeros_like_shapes(shapes):
        # Zero-stride int8 views: the bridge's reshapes cost no memory.
        return jax.tree_util.tree_map(
            lambda s: np.broadcast_to(np.zeros((), np.int8), s.shape), shapes
        )

    def test_fastvlm_0_5b_full_width(self):
        from vla_fastvlm_tpu.models.fastvlm import FastVLM as JFastVLM, fastvlm_0_5b as j_cfg
        from vla_fastvlm_tpu_torch.models import FastVLM, fastvlm_0_5b

        jmodel = JFastVLM(j_cfg(image_size=256))
        shapes = jax.eval_shape(
            lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 256, 256)),
                                jnp.zeros((1, 64), jnp.int32))
        )["params"]
        bridged = jax_params_to_torch(self._zeros_like_shapes(shapes))
        with torch.device("meta"):
            port = FastVLM(fastvlm_0_5b(image_size=256))
        expect = {k: tuple(v.shape) for k, v in port.state_dict().items()}
        got = {k: tuple(v.shape) for k, v in bridged.items()}
        assert sorted(got) == sorted(expect)
        assert got == expect
        assert sum(int(np.prod(s)) for s in got.values()) > 600e6  # the full 0.5B tree

    @pytest.mark.parametrize("chunk", [1, 4])
    def test_head_full_width(self, chunk):
        from vla_fastvlm_tpu.models.action_head import ActionChunkHead as JChunk, ActionExpertHead as JHead
        from vla_fastvlm_tpu_torch.models import ActionChunkHead, ActionExpertHead

        jhead = JHead(14, 14) if chunk == 1 else JChunk(14, 14, chunk)
        shapes = jax.eval_shape(
            lambda: jhead.init(jax.random.PRNGKey(0), jnp.zeros((1, 896)), jnp.zeros((1, 14)))
        )["params"]
        bridged = jax_params_to_torch(self._zeros_like_shapes(shapes))
        with torch.device("meta"):
            port = ActionExpertHead(896, 14, 14) if chunk == 1 else ActionChunkHead(896, 14, 14, chunk)
        assert {k: tuple(v.shape) for k, v in bridged.items()} == {
            k: tuple(v.shape) for k, v in port.state_dict().items()
        }

    def test_bf16_leaves_are_widened(self):
        import ml_dtypes

        out = jax_params_to_torch({"fc": {"kernel": np.ones((2, 3), ml_dtypes.bfloat16)}})
        assert out["fc.weight"].dtype == torch.float32 and tuple(out["fc.weight"].shape) == (3, 2)


def test_port_module_names_match_import():
    for name in _port_modules():
        assert importlib.import_module(name).__name__ == name
