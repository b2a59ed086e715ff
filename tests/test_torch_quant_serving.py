"""Quantized decoders through the port's servers and CLIs, against the JAX package on the CPU.

- The paged server over int8 weights, with and without an int8 pool: greedy
  tokens equal to the JAX ``generate`` of the same quantized model (int8
  KV beside it for the pool).
- Speculative decoding with an int8 target and a float draft (JAX
  ``test_speculative.py::test_quantized_target``): the generator and the
  speculative paged server emit the int8 target's own greedy tokens.
- QLoRA serving (JAX ``TestQLoRAServing``,
  ``test_spec_qlora_int8_base_with_adapter``): float adapters over the int8
  base on the dense, paged (multi-LoRA) and speculative servers.
- ``eval_quant_quality`` at ``fastvlm-tiny`` against the JAX script run
  in-process on the same weights (the serve and generate CLIs with
  ``--quantization`` are in ``test_torch_serve_cli.py``).

Tiny FastVLM (1 image token at 64 px), fp32, weights from numpy seeds
quantized by the JAX package and crossed through the bridge; tokens are
compared exactly (fp32 logits up to summation order, far from ties).
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import vla_fastvlm_tpu.fastvla as j_fastvla
from vla_fastvlm_tpu.io import lora as jlora
from vla_fastvlm_tpu.io import quantize as jquantize
from vla_fastvlm_tpu.models import fastvlm as j_vlm
from vla_fastvlm_tpu.ops import quant as jq
from vla_fastvlm_tpu.serving import generate as j_generate
from vla_fastvlm_tpu_torch.io import quantize as tquantize
from vla_fastvlm_tpu_torch.io.bridge import jax_lora_to_torch, jax_params_to_torch
from vla_fastvlm_tpu_torch.io.lora import lora_with_ids, stack_loras
from vla_fastvlm_tpu_torch.ops import quant as tq
from vla_fastvlm_tpu_torch.scripts import eval_quant_quality as t_eqq
from vla_fastvlm_tpu_torch.serving import (
    GenerationServer,
    PagedGenerationServer,
    SpeculativeGenerationServer,
    SpeculativeGenerator,
    SpeculativePagedGenerationServer,
    generate,
)

from _torch_parity import jax_adapter, random_params, tiny_vlm_pair
from test_torch_lora_serving import REQS, ROUTES, _drive, _stacked_ids
from test_torch_serve_cli import jax_script

PROMPT, NEW, PAGE = 8, 5, 4
DENSE = dict(num_slots=3, prompt_len=PROMPT, max_new_tokens=NEW, eos_token_id=-1, prefill_batch=2)
PAGED = dict(DENSE, page_size=PAGE)
# eval_quant_quality on both sides: the head's MSEs and deltas within 1e-4
# relative (fp32; the head's Adam steps in another summation order), the
# generation agreement exactly.
QUALITY_RTOL = 1e-4


def _quantized_pair(seed, kvq="none", mode="int8"):
    """The tiny pair's JAX model and params, quantized with ``mode``, and the port's twin."""
    jm, params, tm = tiny_vlm_pair(seed, kvq=kvq)
    jqm = j_vlm.FastVLM(jm.cfg.replace(text=jm.cfg.text.replace(quantization=mode)))
    qparams = jax.device_get(jquantize.quantize_params(params, mode=mode))
    tqm = copy.deepcopy(tm)
    tquantize.quantize_params(tqm, mode=mode)
    tqm.load_state_dict(jax_params_to_torch(qparams), strict=True)
    return dict(jm=jm, params=params, tm=tm, jqm=jqm, qparams=qparams, tqm=tqm)


def _batch(reqs):
    return [jnp.asarray(np.concatenate([r[i] for r in reqs])) for i in (2, 0, 1)]


@pytest.fixture(scope="module")
def pair():
    """The int8 pair and the JAX greedy reference of REQS on it."""
    p = _quantized_pair(3)
    imgs, ids, mask = _batch(REQS)
    p["ref"] = np.asarray(j_generate(p["jqm"], p["qparams"], imgs, ids, mask, max_new_tokens=NEW, eos_token_id=-1))
    return p


class TestServers:
    def test_paged_matches_jax(self, pair):
        got = _drive(PagedGenerationServer(pair["tqm"], **PAGED))
        np.testing.assert_array_equal(got, pair["ref"])
        tokens = generate(pair["tqm"], *(np.asarray(x) for x in _batch(REQS)), max_new_tokens=NEW, eos_token_id=-1)
        np.testing.assert_array_equal(tokens.numpy(), pair["ref"])

    def test_paged_int8_pool_matches_jax(self):
        p = _quantized_pair(3, kvq="int8")
        imgs, ids, mask = _batch(REQS)
        ref = np.asarray(j_generate(p["jqm"], p["qparams"], imgs, ids, mask, max_new_tokens=NEW, eos_token_id=-1))
        server = PagedGenerationServer(p["tqm"], **PAGED)
        assert server.pool.quantized
        np.testing.assert_array_equal(_drive(server), ref)

    def test_speculative_int8_target_float_draft(self, pair):
        """The int8 target's greedy tokens from the generator (k = 2) and the
        speculative paged server, with the float model as the draft."""
        imgs, ids, mask = (np.asarray(x) for x in _batch(REQS))
        got = SpeculativeGenerator(pair["tqm"], pair["tm"], k=2, eos_token_id=-1).generate(
            imgs, ids, mask, max_new_tokens=NEW)
        np.testing.assert_array_equal(np.asarray(got), pair["ref"])
        server = SpeculativePagedGenerationServer(pair["tqm"], pair["tm"], k=2, **PAGED)
        np.testing.assert_array_equal(_drive(server), pair["ref"])
        assert server.tokens_per_slot_round > 1.0  # the float draft agrees with the int8 target often


class TestQLoRAServing:
    @pytest.fixture(scope="class")
    def qlora(self, pair):
        jl = [jax_adapter(pair["params"], 4, seed=7 + i) for i in (1, 2)]
        imgs, ids, mask = _batch(REQS)
        gen = lambda lora: np.asarray(j_generate(pair["jqm"], pair["qparams"], imgs, ids, mask, max_new_tokens=NEW,
                                                 eos_token_id=-1, lora=lora))
        multi = jlora.lora_with_ids(jlora.stack_loras(jl), jnp.asarray(_stacked_ids(ROUTES)))
        return dict(tl=[jax_lora_to_torch(x) for x in jl], single=gen(jl[0]), multi=gen(multi))

    def test_dense_and_paged_with_adapter(self, pair, qlora):
        np.testing.assert_array_equal(_drive(GenerationServer(pair["tqm"], lora=qlora["tl"][0], **DENSE)),
                                      qlora["single"])
        assert not np.array_equal(qlora["single"], pair["ref"])  # the adapter moves the tokens
        paged = PagedGenerationServer(pair["tqm"], lora=qlora["tl"], **PAGED)
        np.testing.assert_array_equal(_drive(paged, routes=ROUTES), qlora["multi"])
        multi = lora_with_ids(stack_loras(qlora["tl"]), _stacked_ids(ROUTES))
        tokens = generate(pair["tqm"], *(np.asarray(x) for x in _batch(REQS)), max_new_tokens=NEW, eos_token_id=-1,
                          lora=multi)
        np.testing.assert_array_equal(tokens.numpy(), qlora["multi"])

    def test_speculative_with_target_adapter(self, pair, qlora):
        """The deployment shape: int8 base + float adapter on the target, the
        float base as the draft."""
        spec = SpeculativeGenerationServer(pair["tqm"], pair["tm"], k=2, lora=qlora["tl"][0], **DENSE)
        np.testing.assert_array_equal(_drive(spec), qlora["single"])


def _float_tree(params, seed=0):
    """Seeded float parameters shaped like a float backbone's, the token embedding scaled by 0.1."""
    tree = random_params(jax.device_get(params), seed=seed)
    tree["language_model"]["embed_tokens"]["embedding"] *= 0.1
    return tree


def _quantized(tree, mode):
    return tree if mode == "none" else jax.device_get(jquantize.quantize_params(tree, mode=mode))


class TestEvalQuantQuality:
    def test_eval_quant_quality_matches_jax_script(self, monkeypatch, capsys):
        """Both scripts at fastvlm-tiny, fp32, a few steps, on the same float
        weights and the same head init, without the SmoothQuant column
        (``test_torch_quant.py`` holds calibration and smoothing against
        JAX); then the port's script with it: the same numbers and the
        smoothed w8a8 columns."""
        monkeypatch.setattr(jq, "W8A8_MIN_TOKENS", jq.W8A8_MIN_TOKENS)  # both scripts lower the gate: restore
        monkeypatch.setattr(tq, "W8A8_MIN_TOKENS", tq.W8A8_MIN_TOKENS)
        monkeypatch.setenv("FASTVLM_COMPILATION_CACHE", "off")
        floats = {}

        class JSeeded(j_fastvla.FastVLMWithExpert):
            def __init__(self, config):
                super().__init__(config)
                tree = floats.setdefault("tree", _float_tree(self.backbone.params))
                head = floats.setdefault("head", jax.device_get(self.head_params))
                self.backbone.params, self.head_params = _quantized(tree, config.quantization), head

        monkeypatch.setattr(j_fastvla, "FastVLMWithExpert", JSeeded)
        port_cls = t_eqq.FastVLMWithExpert

        def port_seeded(config, device=None):
            model = port_cls(config, device=device)
            model.load_jax_params({"backbone": _quantized(floats["tree"], config.quantization),
                                   "head": floats["head"]})
            return model

        monkeypatch.setattr(t_eqq, "FastVLMWithExpert", port_seeded)
        kw = dict(model_id="fastvlm-tiny", image_size=64, num_samples=8, state_dim=4, action_dim=4, train_steps=20,
                  dtype="float32", gen_batch=2, gen_new_tokens=4, smooth_alpha=0.0)
        jax_eqq = jax_script("eval_quant_quality")
        jax_eqq.main(jax_eqq.Args(**kw, fabricate=True))
        ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        summary = t_eqq.main(t_eqq.Args(device="cpu", **kw))
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == summary
        assert sorted(summary) == sorted(ref)
        for key, value in ref.items():
            if isinstance(value, str):
                assert summary[key] == value, key
            elif key.startswith("gen_token"):
                assert summary[key] == value, key
            else:
                assert summary[key] == pytest.approx(value, rel=QUALITY_RTOL, abs=2e-6), key
        assert summary["feature_rel_delta_int4"] > summary["feature_rel_delta_int8"] > 0
        smoothed = t_eqq.main(t_eqq.Args(device="cpu", **dict(kw, smooth_alpha=0.5)))
        assert {k: v for k, v in smoothed.items() if k in summary} == summary
        assert smoothed["smooth_alpha"] == 0.5 and sorted(set(smoothed) - set(summary)) == [
            "action_rel_delta_w8a8_smooth", "eval_mse_w8a8_smooth", "feature_rel_delta_w8a8_smooth", "smooth_alpha"]
        assert 0 < smoothed["feature_rel_delta_w8a8_smooth"] < 1
