"""The port's ``scripts/eval_dataset.py`` against the repository's, on the CPU.

One checkpoint of each policy family, written by the JAX package at
``fastvlm-tiny`` in fp32 with seeded random parameters (the FastVLA MLP
head, the action-token head and the legacy ``FastVLMPolicy``), scored by
both CLIs on the same 16 synthetic records in batches of 4. The printed
lines have JAX's form letter for letter; their numbers agree within 1e-5
relative, or within the print's own rounding (one unit of the sixth
decimal), whichever is larger. The split fallback prints JAX's message.
"""

import ast
import dataclasses
import re
import sys
from pathlib import Path

import jax
import pytest

from vla_fastvlm_tpu.fastvla import FastVLAConfig as JConfig
from vla_fastvlm_tpu.fastvla import FastVLAPolicy as JPolicy
from vla_fastvlm_tpu.fastvla import FastVLMTokenPolicy as JTokenPolicy
from vla_fastvlm_tpu.io import checkpoint as jckpt
from vla_fastvlm_tpu.model.fastvlm_adapter import FastVLMBackboneConfig as JBackboneConfig
from vla_fastvlm_tpu.model.policy import FastVLMPolicy as JLegacyPolicy
from vla_fastvlm_tpu.model.policy import FastVLMPolicyConfig as JLegacyConfig
from vla_fastvlm_tpu_torch.scripts import eval_dataset as teval

from _torch_parity import random_params

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
import eval_dataset as jeval  # noqa: E402

TINY = dict(vlm_model_name="fastvlm-tiny", bootstrap_model_name="fastvlm-tiny", state_dim=4, action_dim=4,
            tokenizer_max_length=16, fabricate_params=True)
DATA = dict(synthetic_data=True, synthetic_samples=16, synthetic_image_size=32, state_dim=4, action_dim=4,
            batch_size=4, num_workers=0)
RTOL, PRINT_ULP = 1e-5, 1e-6
MSE_LINE = re.compile(r"^MSE on split '(?P<split>[^']*)': (?P<mse>-?\d+\.\d{6})$")
EXTRA_LINE = re.compile(r"^Additional metrics on split '(?P<split>[^']*)': (?P<extras>\{.*\})$")


def _policy(kind):
    if kind == "mlp":
        return JPolicy(JConfig(**TINY, hidden_dim=16, fusion_dim=16))
    if kind == "token":
        # JAX's token loss needs trainable parameters: the backbone (no head).
        return JTokenPolicy(JConfig(**TINY, action_head="token", action_bins=64, dropout=0.0, train_backbone=True))
    backbone = JBackboneConfig(model_id="fastvlm-tiny", bootstrap_model_id="fastvlm-tiny", tokenizer_max_length=16,
                               fabricate_params=True)
    return JLegacyPolicy(JLegacyConfig(backbone=backbone, state_dim=4, action_dim=4, hidden_dim=16, fusion_dim=16))


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """kind -> a checkpoint directory the JAX package wrote."""
    out = {}
    for seed, kind in enumerate(("mlp", "token", "legacy")):
        jpolicy = _policy(kind)
        jpolicy.load_params(random_params(jax.device_get(jpolicy.params), seed))
        out[kind] = tmp_path_factory.mktemp(kind)
        jckpt.save_policy_checkpoint(out[kind], jpolicy.config, jpolicy.params)
    return out


def _lines(capsys):
    """The MSE line's (split, value) and the extras line's (split, dict)."""
    lines = capsys.readouterr().out.strip().splitlines()
    [mse] = [MSE_LINE.match(ln) for ln in lines if ln.startswith("MSE on split")]
    extras = [EXTRA_LINE.match(ln) for ln in lines if ln.startswith("Additional metrics")]
    assert mse is not None and all(e is not None for e in extras), lines
    extra = (extras[0]["split"], ast.literal_eval(extras[0]["extras"])) if extras else None
    return (mse["split"], float(mse["mse"])), extra


def _close(got, ref):
    return abs(got - ref) <= max(RTOL * abs(ref), PRINT_ULP)


@pytest.mark.parametrize("kind", ["mlp", "token", "legacy"])
def test_eval_matches_jax(kind, checkpoints, capsys, monkeypatch):
    monkeypatch.setenv("FASTVLM_COMPILATION_CACHE", "off")  # JAX's main writes no cache
    ckpt = str(checkpoints[kind])
    jeval.main(jeval.EvalArgs(checkpoint_dir=ckpt, **DATA))
    (jsplit, jmse), jextra = _lines(capsys)
    summary = teval.main(teval.EvalArgs(checkpoint_dir=ckpt, device="cpu", **DATA))
    (split, mse), extra = _lines(capsys)
    assert split == jsplit == "synthetic(train-records)" and summary["device"] == "cpu"
    assert summary["samples"] == 16 and f"{summary['mse']:.6f}" == f"{mse:.6f}"
    assert _close(mse, jmse), (mse, jmse)
    if kind != "token":
        assert extra is None or set(extra[1]) == {"loss"}
        assert (extra is None) == (jextra is None)
        return
    assert extra[0] == jextra[0] and set(extra[1]) == set(jextra[1]) == {"loss", "token_accuracy",
                                                                        "binning_floor_mse"}
    for key, ref in jextra[1].items():
        assert _close(extra[1][key], ref), (key, extra[1][key], ref)


def test_eval_args_match_jax():
    """Every JAX flag with its default; ``device`` names the card here."""
    ref = {f.name: f.default for f in dataclasses.fields(jeval.EvalArgs)}
    got = {f.name: f.default for f in dataclasses.fields(teval.EvalArgs)}
    assert list(got) == list(ref)
    assert {k: v for k, v in got.items() if k != "device"} == {k: v for k, v in ref.items() if k != "device"}
    assert got["device"] == "cuda"


class _FakeDataset:
    """An AlohaDataset that knows no validation split (or fails otherwise)."""

    def __init__(self, calls, error):
        self.calls, self.error = calls, error

    def __call__(self, split=None, **kw):
        self.calls.append(split)
        if split == "validation" or self.error != "Unknown split 'validation'":
            raise ValueError(self.error)
        return object()


@pytest.mark.parametrize("allow,error", [(True, "Unknown split 'validation'"), (False, "Unknown split 'validation'"),
                                         (True, "disk on fire")])
def test_split_fallback_matches_jax(allow, error, monkeypatch, capsys):
    results = {}
    for name, module in (("jax", jeval), ("port", teval)):
        calls = []
        monkeypatch.setattr(module, "AlohaDataset", _FakeDataset(calls, error))
        args = module.EvalArgs(**dict(DATA, synthetic_data=False), split="validation", allow_missing_split=allow)
        try:
            results[name] = (module._build_dataset(args)[1], calls, capsys.readouterr().out)
        except ValueError as exc:
            results[name] = (type(exc), str(exc), calls)
    assert results["port"] == results["jax"]
    if allow and error.startswith("Unknown"):
        assert results["port"] == ("train", ["validation", "train"],
                                   "[eval_dataset] Split 'validation' not found; using 'train' instead.\n")
    else:
        assert results["port"][0] is ValueError and error in results["port"][1]
