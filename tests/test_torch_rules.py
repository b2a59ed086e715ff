"""Rules of the PyTorch port, checked on the CPU.

- The port imports without JAX and without the JAX package.
- No file of the port, nor ``chip_smoke.py``, names the JAX package or JAX.
- Entry points raise without CUDA unless ``device="cpu"`` is passed (the
  policies, the legacy policy, the LeRobot plugin's policy, the trainer,
  the closed-loop, eval, serve and generate CLIs, ``get_best_device``);
  the paged server runs where the backbone put its model.
- The top-level exports of the JAX package resolve, lazily.
- The weight bridge covers every parameter at full ``fastvlm_0_5b`` width:
  ``jax.eval_shape`` of the JAX init against the port built on the meta
  device (nothing is allocated for either), both ways.
"""

import ast
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
from vla_fastvlm_tpu_torch.io.bridge import jax_params_to_torch, torch_params_to_jax

from _torch_parity import LEROBOT_STUB, lerobot_stub

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "vla_fastvlm_tpu_torch"


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(vla_fastvlm_tpu_torch.__path__, "vla_fastvlm_tpu_torch.")
    )


def test_imports_without_jax():
    """Every module, the LeRobot plugin's through the stub on the path."""
    code = (
        "import sys, importlib\n"
        "for name in ('jax', 'jaxlib', 'flax', 'vla_fastvlm_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"sys.path.insert(0, {LEROBOT_STUB!r})\n"
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
        "ops/norms.py", "ops/rope.py", "ops/attention.py", "ops/image.py", "ops/quant.py",
        "serving/__init__.py", "serving/sampling.py", "serving/generate.py",
        "serving/continuous_batching.py", "serving/paged_kv.py", "serving/speculative.py",
        "serving/speculative_paged.py",
        "models/qwen2.py", "models/fastvit.py", "models/fastvlm.py", "models/action_head.py",
        "io/tokenizer.py", "model/fastvlm_adapter.py", "fastvla/configuration_fastvla.py",
        "fastvla/processor_fastvla.py", "fastvla/fastvlm_with_expert.py", "fastvla/modeling_fastvla.py",
        "training/trainer.py", "data/aloha_dataset.py", "data/prefetch.py", "io/checkpoint.py",
        "utils/cli.py", "utils/logging.py", "models/action_tokens.py", "fastvla/token_policy.py",
        "serving/policy_runtime.py", "serving/token_policy_server.py",
        "model/policy.py", "utils/checkpoint.py", "lerobot_fastvla/__init__.py",
        "lerobot_fastvla/configuration_fastvla.py", "lerobot_fastvla/modeling_fastvla.py",
        "lerobot_fastvla/processor_fastvla.py", "io/reparam.py", "io/weights.py", "io/vision_convert.py",
        "io/model_loader.py", "native/__init__.py", "native/image_ops.cpp",
        "parallel/__init__.py", "parallel/mesh.py", "parallel/sharding.py", "parallel/pipeline.py",
        "serving/sharded.py", "utils/flops.py",
    }
    for rel in mirrored:
        assert (PORT / rel).is_file() and (ROOT / "vla_fastvlm_tpu" / rel).is_file(), rel
    # The CLIs' twins, against the repository's scripts/.
    for rel in ("train.py", "eval_dataset.py", "eval_closed_loop.py", "serve.py", "generate.py",
                "convert_checkpoint.py"):
        assert (PORT / "scripts" / rel).is_file() and (ROOT / "scripts" / rel).is_file(), rel


def test_top_level_exports_resolve():
    """The JAX package's top-level API, resolved lazily."""
    import vla_fastvlm_tpu as jax_package

    from vla_fastvlm_tpu_torch.device import get_best_device
    from vla_fastvlm_tpu_torch.fastvla import FastVLAConfig, FastVLAPolicy
    from vla_fastvlm_tpu_torch.io.checkpoint import load_policy_from_checkpoint
    from vla_fastvlm_tpu_torch.model.policy import FastVLMPolicy
    from vla_fastvlm_tpu_torch.training import Trainer, TrainingConfig

    expect = {"FastVLAConfig": FastVLAConfig, "FastVLAPolicy": FastVLAPolicy, "FastVLMPolicy": FastVLMPolicy,
              "Trainer": Trainer, "TrainingConfig": TrainingConfig, "get_best_device": get_best_device,
              "load_policy_from_checkpoint": load_policy_from_checkpoint}
    for name, value in expect.items():
        assert getattr(vla_fastvlm_tpu_torch, name) is value, name
    for name in jax_package.__all__:
        if name != "is_tpu_available":  # no TPU here
            assert hasattr(vla_fastvlm_tpu_torch, name), name
    for name in ("models", "ops", "io", "data", "training", "serving", "fastvla", "model", "utils", "parallel"):
        assert getattr(vla_fastvlm_tpu_torch, name).__name__ == f"vla_fastvlm_tpu_torch.{name}"
    # The mesh's names resolve where JAX exports them.
    import vla_fastvlm_tpu.parallel as jax_parallel
    import vla_fastvlm_tpu.serving as jax_serving

    port_parallel = vla_fastvlm_tpu_torch.parallel
    for name in jax_parallel.__all__:
        if name not in ("PIPE_AXIS", "make_pipe_mesh", "make_pipeline_train_step", "pipeline_forward"):
            assert name in port_parallel.__all__ and hasattr(port_parallel, name), name  # the pipeline: not yet
    for name in ("ShardedPolicyRuntime", "sharded_generate"):
        assert name in jax_serving.__all__ and getattr(vla_fastvlm_tpu_torch.serving, name).__module__ == \
            "vla_fastvlm_tpu_torch.serving.sharded"
    assert vla_fastvlm_tpu_torch.utils.load_policy_from_checkpoint is load_policy_from_checkpoint
    with pytest.raises(AttributeError):
        vla_fastvlm_tpu_torch.not_an_export
    light = subprocess.run([sys.executable, "-c", "import sys, vla_fastvlm_tpu_torch; "
                            "print(sorted(m for m in sys.modules if m.startswith('vla_fastvlm_tpu_torch.')))"],
                           cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert light.returncode == 0, light.stderr
    assert ast.literal_eval(light.stdout) == ["vla_fastvlm_tpu_torch.data", "vla_fastvlm_tpu_torch.data.aloha_dataset",
                                  "vla_fastvlm_tpu_torch.data.prefetch", "vla_fastvlm_tpu_torch.device"]


def test_device_helpers(monkeypatch):
    from vla_fastvlm_tpu_torch.device import is_cuda_available, is_mps_available, move_batch_to_device

    assert is_mps_available() is False
    assert is_cuda_available() == torch.cuda.is_available()
    batch = {"images": np.ones((2, 3), np.float32), "states": torch.zeros(2), "tasks": ["a", "b"],
             "meta": {"ids": np.arange(2), "name": "x"}}
    out = move_batch_to_device(batch, "cpu")
    assert isinstance(out["images"], torch.Tensor) and torch.equal(out["images"], torch.ones(2, 3))
    assert out["states"] is batch["states"] and out["tasks"] is batch["tasks"]
    assert torch.equal(out["meta"]["ids"], torch.arange(2)) and out["meta"]["name"] == "x"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert is_cuda_available() is False
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        move_batch_to_device(batch, None)
    with pytest.raises(ValueError, match="unsupported device"):
        vla_fastvlm_tpu_torch.get_best_device("mps")


def _generate_backbone(module, monkeypatch, **kw):
    """Run the generate CLI at the tiny preset; the backbone it built."""
    built = []
    cls = module.FastVLMBackbone
    monkeypatch.setattr(module, "FastVLMBackbone", lambda *a, **k: built.append(cls(*a, **k)) or built[-1])
    module.main(module.GenerateArgs(model_id="tiny", bootstrap_model_id="tiny", max_new_tokens=2,
                                    tokenizer_max_length=8, dtype="float32", **kw))
    return built[-1]


class TestDevice:
    def test_resolve_device(self, monkeypatch):
        from vla_fastvlm_tpu_torch.device import resolve_device

        assert resolve_device("cpu") == torch.device("cpu")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device("cuda")

    @pytest.mark.parametrize(
        "entry", ["FastVLMBackbone", "FastVLMWithExpert", "FastVLAPolicy", "PagedGenerationServer", "Trainer",
                  "FastVLMTokenPolicy", "eval_closed_loop", "serve", "generate", "FastVLMPolicy", "eval_dataset",
                  "lerobot FastVLAPolicy", "get_best_device"]
    )
    def test_entry_points_need_cuda_unless_cpu(self, entry, monkeypatch, tmp_path):
        from types import SimpleNamespace

        from vla_fastvlm_tpu_torch.device import get_best_device
        from vla_fastvlm_tpu_torch.fastvla import FastVLAConfig, FastVLAPolicy, FastVLMTokenPolicy, FastVLMWithExpert
        from vla_fastvlm_tpu_torch.io.checkpoint import save_policy_checkpoint
        from vla_fastvlm_tpu_torch.model import FastVLMBackbone, FastVLMBackboneConfig, FastVLMPolicy, FastVLMPolicyConfig
        from vla_fastvlm_tpu_torch.scripts import eval_closed_loop, eval_dataset, generate, serve
        from vla_fastvlm_tpu_torch.serving import PagedGenerationServer
        from vla_fastvlm_tpu_torch.training import Trainer, TrainingConfig

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        cfg = FastVLAConfig(vlm_model_name="tiny", hidden_dim=8, fusion_dim=8, tokenizer_max_length=8,
                            kv_cache_quantization="int8")
        build = {
            "FastVLMBackbone": lambda **kw: FastVLMBackbone(cfg.to_backbone_config(), **kw),
            "FastVLMWithExpert": lambda **kw: FastVLMWithExpert(cfg, **kw),
            "FastVLAPolicy": lambda **kw: FastVLAPolicy(cfg, **kw),
            # The server runs where the backbone put the model, pools included.
            "PagedGenerationServer": lambda **kw: PagedGenerationServer(
                FastVLMBackbone(cfg.to_backbone_config(), **kw).model, num_slots=1, prompt_len=8, max_new_tokens=2
            ),
            # The trainer runs where the policy lives.
            "Trainer": lambda **kw: Trainer(FastVLAPolicy(cfg, **kw), [], None, TrainingConfig(max_steps=1)),
            "FastVLMTokenPolicy": lambda **kw: FastVLMTokenPolicy(FastVLAConfig(
                vlm_model_name="tiny", action_head="token", action_bins=64, tokenizer_max_length=8), **kw),
            # The CLI's summary names the device it ran on.
            "eval_closed_loop": lambda **kw: SimpleNamespace(device=torch.device(eval_closed_loop.main(
                eval_closed_loop.ClosedLoopArgs(num_envs=1, max_steps=1, state_dim=2, action_dim=2, **kw)
            )["device"])),
            # The serving CLIs default to the card.
            "serve": lambda **kw: SimpleNamespace(device=torch.device(serve.main(serve.ServeArgs(
                model_id="tiny", num_slots=1, prefill_batch=1, prompt_len=4, max_new_tokens=2, num_requests=1,
                dtype="float32", paged=True, page_size=4, **kw))["device"])),
            "generate": lambda **kw: _generate_backbone(generate, monkeypatch, **kw),
            "FastVLMPolicy": lambda **kw: FastVLMPolicy(FastVLMPolicyConfig(
                backbone=FastVLMBackboneConfig(model_id="tiny", tokenizer_max_length=8), hidden_dim=8, fusion_dim=8),
                **kw),
            # The CLI's result names the device it ran on.
            "eval_dataset": lambda **kw: SimpleNamespace(device=torch.device(eval_dataset.main(eval_dataset.EvalArgs(
                checkpoint_dir=str(tmp_path), synthetic_data=True, synthetic_samples=2, synthetic_image_size=32,
                state_dim=14, action_dim=14, batch_size=2, num_workers=0, **kw))["device"])),
            # The plugin runs on config.device, the card when it is None.
            "lerobot FastVLAPolicy": lambda **kw: _lerobot_policy(kw.get("device")),
            "get_best_device": lambda **kw: SimpleNamespace(device=get_best_device(kw.get("device"))),
        }[entry]
        if entry == "eval_dataset":
            policy = FastVLAPolicy(cfg, device="cpu")
            save_policy_checkpoint(tmp_path, policy.config, policy.jax_params(as_numpy=False))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
        built = build(device="cpu")
        assert built.device == torch.device("cpu")
        if entry == "PagedGenerationServer":
            assert built.pool.pool_k.device == torch.device("cpu") and built.pool.quantized

    def test_train_script_needs_cuda_unless_cpu(self, monkeypatch, tmp_path):
        from vla_fastvlm_tpu_torch.scripts.train import TrainArgs, main
        from vla_fastvlm_tpu_torch.utils import parse_cli

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        flags = ["--synthetic-data", "--synthetic-samples", "4", "--synthetic-image-size", "32", "--model-id",
                 "tiny", "--hidden-dim", "8", "--fusion-dim", "8", "--tokenizer-max-length", "8", "--batch-size",
                 "4", "--num-workers", "0", "--max-steps", "1", "--eval-split", "none", "--output-dir", str(tmp_path)]
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(parse_cli(TrainArgs, flags))
        main(parse_cli(TrainArgs, flags + ["--device", "cpu"]))
        assert (tmp_path / "training_config.json").exists()

    def test_forward_rejects_another_device(self):
        from vla_fastvlm_tpu_torch.model import FastVLMBackbone, FastVLMBackboneConfig

        bb = FastVLMBackbone(FastVLMBackboneConfig(model_id="tiny", tokenizer_max_length=8), device="cpu")
        with pytest.raises(ValueError, match="lives on"):
            bb.forward(np.zeros((1, 3, 64, 64), np.float32), ["x"], device="meta")


def _lerobot_policy(device):
    """The LeRobot plugin's policy at the tiny preset, built through the stub."""
    with lerobot_stub("vla_fastvlm_tpu_torch.lerobot_fastvla"):
        from lerobot.configs.types import FeatureType, PolicyFeature

        from vla_fastvlm_tpu_torch.lerobot_fastvla import FastVLAConfig, FastVLAPolicy

        config = FastVLAConfig(
            input_features={"observation.state": PolicyFeature(FeatureType.STATE, (4,)),
                            "observation.images.top": PolicyFeature(FeatureType.VISUAL, (3, 64, 64))},
            output_features={"action": PolicyFeature(FeatureType.ACTION, (4,))},
            vlm_model_name="tiny", hidden_dim=8, fusion_dim=8, tokenizer_max_length=8, device=device,
        )
        return FastVLAPolicy(config)


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

    def test_inverse_bridge_fastvlm_0_5b_full_width(self):
        """torch_params_to_jax of the port on the meta device gives the JAX
        tree's names and shapes (stacked layers, split projections), and the
        forward bridge takes it back to the port's state_dict."""
        from vla_fastvlm_tpu.models.fastvlm import FastVLM as JFastVLM, fastvlm_0_5b as j_cfg
        from vla_fastvlm_tpu_torch.io.bridge import flatten_params
        from vla_fastvlm_tpu_torch.models import FastVLM, fastvlm_0_5b

        jmodel = JFastVLM(j_cfg(image_size=256))
        shapes = jax.eval_shape(
            lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 256, 256)),
                                jnp.zeros((1, 64), jnp.int32))
        )["params"]
        with torch.device("meta"):
            port = FastVLM(fastvlm_0_5b(image_size=256))
        tree = torch_params_to_jax(port, as_numpy=False)
        expect = {k: tuple(v.shape) for k, v in flatten_params(shapes).items()}
        got = {k: tuple(v.shape) for k, v in flatten_params(tree).items()}
        assert got == expect
        back = jax_params_to_torch(self._zeros_like_shapes(tree))
        assert {k: tuple(v.shape) for k, v in back.items()} == {k: tuple(v.shape) for k, v in port.state_dict().items()}

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
    with lerobot_stub("vla_fastvlm_tpu_torch.lerobot_fastvla"):
        for name in _port_modules():
            assert importlib.import_module(name).__name__ == name
