"""The port's serving CLIs against the repository's JAX scripts, on the CPU.

``python -m vla_fastvlm_tpu_torch.scripts.serve`` at ``fastvlm-tiny
--device cpu`` on the dense, paged, paged with prefix cache and chunked
admission, and speculative paged servers, against ``scripts/serve.py``'s
``main`` run in-process on the same arguments and weights: the summary's
``total_new_tokens``, ``ticks``, prefix-cache hits and misses and the
speculative ``tokens_per_tick`` are equal, and so with ``--quantization
int8`` on the paged server. ``... .generate`` prints the same text as
``scripts/generate.py`` on the zero image, float and with ``--quantization
int4``. The flags that are not ported raise, as does an unknown
quantization mode.

Both sides build their backbones from the same presets and seeds; the test
replaces the JAX backbones' parameters with numpy values from seeds (the
token embedding scaled by 0.1, ``tests/_torch_parity.py``; a quantized
backbone's kernels quantized from seeded float kernels by the JAX package)
and loads the same values into the port's backbones, in the order the
scripts build them.
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

import vla_fastvlm_tpu.model.fastvlm_adapter as j_adapter
from vla_fastvlm_tpu_torch.scripts import generate as t_generate
from vla_fastvlm_tpu_torch.scripts import serve as t_serve

from _torch_parity import random_quantized_params

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"


def jax_script(name):
    """``scripts/<name>.py`` as a module of its own name space."""
    if str(SCRIPTS) not in sys.path:
        sys.path.insert(0, str(SCRIPTS))
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # its dataclasses look their module up
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def same_weights(monkeypatch):
    """JAX backbones take seeded numpy parameters as they are built; the
    port's backbones, built in the same order, load the same values."""
    made = []

    class Seeded(j_adapter.FastVLMBackbone):
        def __init__(self, config=None):
            super().__init__(config)
            params = random_quantized_params(self.params, seed=len(made))
            embed = params["language_model"]["embed_tokens"]
            embed["embedding"] = embed["embedding"] * 0.1
            self.params = params
            made.append(params)

    monkeypatch.setattr(j_adapter, "FastVLMBackbone", Seeded)
    loaded = []

    def load_next(backbone):
        backbone.load_jax_params(made[len(loaded)])
        loaded.append(backbone)
        return backbone

    build = t_serve.build_backbone
    monkeypatch.setattr(t_serve, "build_backbone", lambda *a, **kw: load_next(build(*a, **kw)))
    cls = t_generate.FastVLMBackbone
    monkeypatch.setattr(t_generate, "FastVLMBackbone", lambda *a, **kw: load_next(cls(*a, **kw)))
    return made, loaded


SERVE = dict(model_id="fastvlm-tiny", num_slots=3, prefill_batch=2, prompt_len=8, max_new_tokens=4,
             num_requests=6, arrivals_per_tick=2, dtype="float32", seed=0, page_size=4)
SERVE_RUNS = {
    "dense": {},
    "paged": dict(paged=True),
    "paged_prefix_chunk": dict(paged=True, prefix_cache=2, repeat_fraction=0.5, prefill_chunk_tokens=4),
    "spec_paged": dict(paged=True, draft_model_id="fastvlm-tiny", spec_k=2),
    "paged_int8": dict(paged=True, quantization="int8"),
}


@pytest.mark.parametrize("run", sorted(SERVE_RUNS))
def test_serve_summary_matches_jax_script(run, same_weights, capsys):
    made, loaded = same_weights
    jax_serve = jax_script("serve")
    kw = dict(SERVE, **SERVE_RUNS[run])
    jax_serve.main(jax_serve.ServeArgs(**kw))
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    summary = t_serve.main(t_serve.ServeArgs(device="cpu", **kw))
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == summary
    assert len(loaded) == len(made) == (2 if "draft_model_id" in kw else 1)
    assert summary["device"] == "cpu" and summary["total_new_tokens"] == 6 * 4
    keys = ["requests", "slots", "prefill_batch", "total_new_tokens", "ticks"]
    if "prefix_cache" in kw:
        keys += ["prefix_cache_hits", "prefix_cache_misses"]
        assert summary["prefix_cache_hits"] > 0
    for key in keys:
        assert summary[key] == ref[key], key
    if "draft_model_id" in kw:
        assert round(summary["tokens_per_tick"], 2) == ref["tokens_per_tick"]
    assert 0 < summary["admission_ticks"] < summary["ticks"]
    if kw.get("paged"):
        pages = summary["pages"]
        assert pages["free"] + pages["pinned"] == pages["usable"] == pages["free_after_evict"]
        assert pages["tables_empty"]


def test_generate_text_matches_jax_script(same_weights, capsys):
    jax_generate = jax_script("generate")
    kw = dict(model_id="fastvlm-tiny", bootstrap_model_id="fastvlm-tiny", prompt="pick up the red cube",
              max_new_tokens=6, tokenizer_max_length=16, dtype="float32")
    jax_generate.main(jax_generate.GenerateArgs(**kw))
    ref = capsys.readouterr().out.splitlines()[-1]
    text = t_generate.main(t_generate.GenerateArgs(device="cpu", **kw))
    assert capsys.readouterr().out.splitlines()[-1] == text == ref


def test_generate_int4_matches_jax_script(same_weights, capsys):
    made, loaded = same_weights
    jax_generate = jax_script("generate")
    kw = dict(model_id="fastvlm-tiny", bootstrap_model_id="fastvlm-tiny", prompt="pick up the red cube",
              max_new_tokens=6, tokenizer_max_length=16, dtype="float32", quantization="int4")
    jax_generate.main(jax_generate.GenerateArgs(**kw))
    ref = capsys.readouterr().out.splitlines()[-1]
    text = t_generate.main(t_generate.GenerateArgs(device="cpu", **kw))
    assert capsys.readouterr().out.splitlines()[-1] == text == ref
    assert loaded[0].model.language_model.layers[0].mlp.down_proj.mode == "int4"


@pytest.mark.parametrize("script,kw", [
    ("serve", dict(tp=3)), ("serve", dict(quantization="int8")), ("serve", dict(lora_dir=("adapter",))),
    ("generate", dict(dp=2, tp=3)), ("generate", dict(tp=3)), ("generate", dict(quantization="int8")),
    ("serve", dict(quantization="int3")), ("generate", dict(quantization="int3")),
])
def test_unported_flags_raise(script, kw):
    module = {"serve": t_serve, "generate": t_generate}[script]
    args = module.ServeArgs if script == "serve" else module.GenerateArgs
    if "lora_dir" in kw:  # ported: a --lora-dir that is no policy checkpoint is refused
        with pytest.raises(FileNotFoundError, match="policy_config.json"):
            module.main(args(model_id="fastvlm-tiny", device="cpu", **kw))
        return
    if kw.get("quantization") == "int8":  # ported: a quantized run
        small = dict(SERVE, paged=True) if script == "serve" else dict(
            model_id="fastvlm-tiny", bootstrap_model_id="fastvlm-tiny", max_new_tokens=3, tokenizer_max_length=16,
            dtype="float32")
        out = module.main(args(**dict(small, device="cpu", **kw)))
        assert out["total_new_tokens"] == 6 * 4 if script == "serve" else isinstance(out, str)
        return
    if "quantization" in kw:  # an unknown mode
        with pytest.raises(ValueError, match="unknown quantization"):
            module.main(args(model_id="fastvlm-tiny", device="cpu", **kw))
        return
    # A mesh the tiny model's 4 heads do not split over raises before any rank starts.
    with pytest.raises(ValueError, match="does not split"):
        module.main(args(model_id="fastvlm-tiny", device="cpu", **kw))


def test_chunk_must_divide_the_prompt():
    with pytest.raises(ValueError, match="multiples"):
        t_serve.main(t_serve.ServeArgs(**dict(SERVE, paged=True, prefill_chunk_tokens=3), device="cpu"))


def test_parse_cli_flags():
    from vla_fastvlm_tpu_torch.utils import parse_cli

    args = parse_cli(t_serve.ServeArgs, ["--paged", "--prefix-cache", "16", "--prefill-chunk-tokens", "16",
                                         "--kv-cache-quantization", "int8", "--device", "cpu"])
    assert (args.paged, args.prefix_cache, args.prefill_chunk_tokens, args.kv_cache_quantization, args.device) == (
        True, 16, 16, "int8", "cpu")
    assert parse_cli(t_serve.ServeArgs, []).device == "cuda"
    assert np.isclose(parse_cli(t_generate.GenerateArgs, ["--top-p", "0.5"]).top_p, 0.5)
