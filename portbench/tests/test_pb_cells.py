"""Each traffic mix end to end at test size on the CPU: set-up, window,
comparison and the result line; a traced run; the control failing the
limits that sound runs meet; and faults planted under the timed path
turning ``correct`` false."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from portbench.bench import run_cell
from portbench.control import readings
from portbench.tests.tiny import ACT, LIMITS, SERVE, TRAIN, tiny_root

CELLS = (ACT, SERVE, TRAIN)
SEED = 2 ** 31 + 12345  # more than 32 signed bits


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    root = tmp_path_factory.mktemp("checkout")
    return tiny_root(root), root


def run(bench, name, traced=False, seed=SEED):
    spec, root = bench
    return run_cell(spec, root, name, seed, 0.3, traced, "cpu")


@pytest.mark.parametrize("name", CELLS)
def test_mix_runs_end_to_end(bench, name):
    result = run(bench, name)
    json.dumps(result)
    assert result["correct"], result["compared"]
    assert result["attempted"] > 0 and result["failed"] == 0
    expected = {"setup_s", {ACT: "actions_per_s", SERVE: "tokens_per_s", TRAIN: "samples_per_s"}[name]}
    assert expected <= set(result["metrics"])
    assert list(result)[-1] == "compared"
    assert set(result["compared"]) == set(LIMITS[name])


def test_act_reports_its_tail(bench):
    result = run(bench, ACT)
    assert {"actions_per_s", "control_tick_p95_ms", "setup_s"} == set(result["metrics"])


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_host_metrics_and_no_device_metric_on_the_cpu(bench, name):
    result = run(bench, name, traced=True)
    assert result["correct"]
    host = {ACT: {"host_prep_ms.act", "step_mfu.act"}, SERVE: {"decode_tick_ms.serve", "admission_ms.serve",
                                                               "step_mfu.serve"}, TRAIN: {"step_mfu.train"}}[name]
    assert host <= set(result["metrics"])
    assert not any(k.startswith(("device_idle", "tower_ms", "decoder_ms", "backward_ms", "optimizer_ms"))
                   or k.endswith("roofline.act") or "roofline" in k for k in result["metrics"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["device"]["window_s"] > 0


def _serve_cell(seed, slots=256):
    from portbench.kinds.serve import Cell
    from portbench.reference.config import parse_config
    from portbench.tests.tiny import tiny_config, tiny_traffic

    traffic = dict(tiny_traffic()[SERVE], slots=slots, prefill_batch=16, prompt_min=16, prompt_max=256,
                   prompt_buckets=[64, 128, 256])
    return Cell(parse_config(tiny_config()), tiny_config(), traffic, seed, "cpu", False)


def test_every_seed_serves_the_same_work_in_its_own_order():
    def groups(seed, n=48):
        stream = _serve_cell(seed)._stream()
        lengths = [len(next(stream)[0]) for _ in range(n)]
        return lengths, [sorted(min(b for b in (64, 128, 256) if b >= x) for x in lengths[i: i + 16])
                         for i in range(0, n, 16)]

    (a, ga), (b, gb), (c, _) = groups(7), groups(7), groups(8)
    assert a == b and a != c
    # Every admission group of 16 holds 8 prompts of the 64-token bucket and 4 of each other.
    assert all(g == [64] * 8 + [128] * 4 + [256] * 4 for g in ga + gb)
    assert sorted(groups(7, 256)[0]) == sorted(groups(9, 256)[0])


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(bench, name):
    spec, root = bench
    r = readings(root, spec, name, SEED, 0.3, "cpu")
    assert all(r["program"][k] <= limit for k, limit in LIMITS[name].items()), r
    assert any(r["control"].get(k, -1) > limit for k, limit in LIMITS[name].items()), r


# -- faults under the timed path -----------------------------------------


def _alter_one_action(monkeypatch):
    from vla_fastvlm_tpu_torch.models.action_head import ActionExpertHead

    forward = ActionExpertHead.forward

    def altered(self, *a, **k):
        out = forward(self, *a, **k).clone()
        out[0, 0] += 1.0
        return out

    monkeypatch.setattr(ActionExpertHead, "forward", altered)


def _half_the_batch(monkeypatch):
    from vla_fastvlm_tpu_torch.fastvla.fastvlm_with_expert import FastVLMWithExpert

    apply_fn = FastVLMWithExpert.apply_fn

    def half(self, images, ids, mask, states, *a, **k):
        n = images.shape[0] // 2
        out = apply_fn(self, images[:n], ids[:n], mask[:n], states[:n], *a, **k)
        return torch.cat([out, out.mean(dim=0, keepdim=True).expand(images.shape[0] - n, -1)])

    monkeypatch.setattr(FastVLMWithExpert, "apply_fn", half)


def _ticks_write_nothing(monkeypatch):
    """A decode tick that returns its state unchanged: the pools keep no new row."""
    from vla_fastvlm_tpu_torch.serving.paged_kv import PagedGenerationServer

    run_window = PagedGenerationServer._run_window
    monkeypatch.setattr(PagedGenerationServer, "_run_window",
                        lambda self, impl, tables, masks, lengths, window, write=True, lora=None:
                        run_window(self, impl, tables, masks, lengths, window, False, lora))


def _tick_half_the_slots(monkeypatch):
    """Half of the slots left out of a tick, given the mean of the rest."""
    from vla_fastvlm_tpu_torch.serving.paged_kv import PagedGenerationServer

    run_window = PagedGenerationServer._run_window

    def half(self, *args, **kwargs):
        logits = run_window(self, *args, **kwargs).clone()
        n = logits.shape[0] // 2
        logits[n:] = logits[:n].mean(dim=0, keepdim=True)
        return logits

    monkeypatch.setattr(PagedGenerationServer, "_run_window", half)


def _serve_the_second_best_token(monkeypatch):
    """A token altered where the server produces it: the sampler returns the
    second-best token of every row."""
    from vla_fastvlm_tpu_torch.serving.paged_kv import PagedGenerationServer

    monkeypatch.setattr(PagedGenerationServer, "_sample",
                        lambda self, logits: logits.topk(2, dim=-1).indices[..., 1].to(torch.int32))


def _cut_an_answer(monkeypatch):
    from vla_fastvlm_tpu_torch.serving.paged_kv import PagedGenerationServer

    step = PagedGenerationServer.step

    def cut(self):
        return {rid: toks[:-1] for rid, toks in step(self).items()}

    monkeypatch.setattr(PagedGenerationServer, "step", cut)


def _state_unchanged(monkeypatch):
    from vla_fastvlm_tpu_torch.training import Trainer

    monkeypatch.setattr(Trainer, "_apply_update", lambda self, grads: None)


def _half_the_loss(monkeypatch):
    from vla_fastvlm_tpu_torch.fastvla import FastVLAPolicy

    loss_fn = FastVLAPolicy.loss_fn

    def half(self, arrays, *a, **k):
        n = arrays["images"].shape[0] // 2
        return loss_fn(self, {key: v[:n] for key, v in arrays.items()}, *a, **k)

    monkeypatch.setattr(FastVLAPolicy, "loss_fn", half)


def _alter_a_gradient(monkeypatch):
    from vla_fastvlm_tpu_torch.training import Trainer

    grads = Trainer._grads

    def altered(self, loss):
        out = grads(self, loss)
        out[-1] = out[-1] * 2.0
        return out

    monkeypatch.setattr(Trainer, "_grads", altered)


FAULTS = [
    (ACT, _alter_one_action), (ACT, _half_the_batch),
    (SERVE, _ticks_write_nothing), (SERVE, _tick_half_the_slots), (SERVE, _serve_the_second_best_token),
    (SERVE, _cut_an_answer),
    (TRAIN, _state_unchanged), (TRAIN, _half_the_loss), (TRAIN, _alter_a_gradient),
]


@pytest.mark.parametrize("name,fault", FAULTS, ids=[f"{n}-{f.__name__.strip('_')}" for n, f in FAULTS])
def test_fault_under_the_timed_path_is_not_correct(bench, monkeypatch, name, fault):
    fault(monkeypatch)
    result = run(bench, name)
    assert not result["correct"], result["compared"]


def test_p95_is_the_nearest_rank_over_all_ticks():
    from portbench.common import p95

    values = list(np.arange(1.0, 201.0))
    assert p95(values) == 190.0
    assert p95([5.0]) == 5.0
    assert p95(list(range(1, 21))) == 19
