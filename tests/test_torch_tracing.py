"""The port's tracer (``vla_fastvlm_tpu_torch/utils/tracing.py``) on the CPU.

- Off (no profiler, no ``enable()``): a span opens no profiler range, reads
  no clock and keeps nothing, through the tracer's API and through a
  server step.
- ``on()`` follows ``enable()`` and a recording profiler.
- Under ``enable()``: parents, stamps, attrs, counters, the buffer's bound.
- Under ``torch.profiler``: the exported Chrome trace holds the ``vft.``
  ranges inside the profiled interval.
- The paged server's admission counters against hand-counted rows and
  positions, through plain, chunked and partial-hit admission.
- A trainer step and a policy forward emit their spans.
- The benchmark's readers of these spans and counters
  (``portbench/metrics/``) on synthetic spans, and on nothing.
"""

import json
import types

import numpy as np
import pytest
import torch

from portbench.bench import reader
from vla_fastvlm_tpu_torch.fastvla import FastVLAConfig, FastVLAPolicy
from vla_fastvlm_tpu_torch.models import fastvlm as t_vlm
from vla_fastvlm_tpu_torch.serving import PagedGenerationServer
from vla_fastvlm_tpu_torch.training import Trainer, TrainingConfig
from vla_fastvlm_tpu_torch.utils import tracing

TINY = dict(vlm_model_name="fastvlm-tiny", bootstrap_model_name="fastvlm-tiny", state_dim=4, action_dim=4,
            hidden_dim=16, fusion_dim=16, tokenizer_max_length=16, dropout=0.0)


@pytest.fixture(autouse=True)
def fresh_tracer():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture(scope="module")
def tiny_vlm():
    torch.manual_seed(0)
    return t_vlm.FastVLM(t_vlm.fastvlm_tiny()).eval().requires_grad_(False)


def _refuse(*args, **kwargs):
    raise AssertionError("a profiler range was opened with tracing off")


def test_off_opens_no_range_reads_no_clock_and_keeps_nothing(monkeypatch, tiny_vlm):
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(tracing, "time", types.SimpleNamespace(perf_counter_ns=_refuse))
    assert tracing.span("a") is tracing.span("b", bucket=4)
    with tracing.span("a", rows=2):
        with tracing.span("b"):
            tracing.count("c", 3)
    assert tracing.traced("d")(lambda x: x + 1)(1) == 2
    server = PagedGenerationServer(tiny_vlm, num_slots=2, prompt_len=8, max_new_tokens=2, eos_token_id=-1,
                                   prefill_batch=2, page_size=4)
    ids = np.arange(3, 8, dtype=np.int32)[None]
    server.submit(ids, np.ones_like(ids), np.zeros((1, 3, 64, 64), np.float32))
    server.run_to_completion()
    assert tracing.spans() == [] and tracing.counters() == {}


def test_on_follows_enable_and_a_recording_profiler():
    from torch.profiler import ProfilerActivity, profile

    assert not tracing.on()
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.on()
    assert not tracing.on()
    tracing.enable()
    assert tracing.on()
    tracing.disable()
    assert not tracing.on() and tracing.span("a") is tracing.span("b")


def test_enabled_spans_nest_with_parents_stamps_and_attrs():
    tracing.enable()
    with tracing.span("step"):
        with tracing.span("admit", rows=3):
            with tracing.span("upload"):
                tracing.count("rows", 3)
                tracing.count("rows")
        with tracing.span("tick"):
            pass
    tracing.disable()
    with tracing.span("after"):
        tracing.count("rows")
    spans = sorted(tracing.spans(), key=lambda s: s.index)
    assert [(s.index, s.name, s.parent) for s in spans] == [(0, "step", -1), (1, "admit", 0), (2, "upload", 1),
                                                          (3, "tick", 0)]
    by = {s.name: s for s in spans}
    assert by["admit"].attrs == {"rows": 3} and tracing.counters() == {"rows": 4}
    for s in spans:
        assert s.start_ns <= s.end_ns and s.ms >= 0
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    assert by["admit"].end_ns <= by["tick"].start_ns
    tracing.reset()
    assert tracing.spans() == [] and tracing.counters() == {}


def test_the_buffer_keeps_the_newest_spans_at_its_bound():
    tracing.enable()
    for _ in range(tracing.CAPACITY + 10):
        with tracing.span("s"):
            pass
    spans = tracing.spans()
    assert len(spans) == tracing.CAPACITY
    assert [s.index for s in spans] == list(range(10, tracing.CAPACITY + 10))


def test_profiler_trace_holds_the_ranges_inside_the_profiled_interval(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("profiled"):
            with tracing.span("outer"):
                with tracing.span("inner"):
                    torch.ones(4).sum()
    with tracing.span("after"):
        pass
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    ranges = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") == "user_annotation"}
    assert {"vft.outer", "vft.inner"} <= set(ranges) and "vft.after" not in ranges
    lo, hi = ranges["profiled"]
    (a, b), (c, d) = ranges["vft.outer"], ranges["vft.inner"]
    assert lo <= a <= c <= d <= b <= hi
    assert [s.name for s in tracing.spans()] == ["inner", "outer"]


# -- the paged server's admission counters ---------------------------------

PAGE = 4


def _wave(rng, template, frames, specs):
    """Requests ``(frame, length, shared)``: ``shared`` ones start with the template."""
    out = []
    for frame, length, shared in specs:
        ids = rng.integers(3, 500, (1, length)).astype(np.int32)
        if shared:
            ids[0, : len(template)] = template
        out.append((ids, np.ones_like(ids), frames[frame]))
    return out


# (mode, server options, (rows, rows computed, positions, positions computed))
# on the tiny FastVLM (one image token at 64 px), pages of 4, programs of up
# to 2 rows, each run on its real rows alone. Wave 1: a 7-token template + 1
# under frame 0, 3 tokens under frame 1, 6 under frame 2: programs [8, 6] at
# bucket 8 (2 rows of 9 positions) and [3] at bucket 4 (1 row of 5
# positions). Wave 2: the template + 1 twice under frame 0: a program of 2
# rows at bucket 8, or, with the cache, partial hits on both template pages
# whose one-row tails compute position 8 alone. Computed, without the
# cache: 2 x 9 + 1 x 5 + 2 x 9 = 41 positions of 5 rows; with it, wave 1's
# two miss programs, then 2 x 1 = 25.
ADMISSION = [
    ("plain", {}, (5, 5, (1 + 8) + (1 + 6) + (1 + 3) + 2 * (1 + 8), 2 * 9 + 1 * 5 + 2 * 9)),
    ("chunked", {"prefill_chunk_tokens": 4}, (5, 5, 38, 41)),
    ("partial_hit", {"prefix_cache_size": 4}, (5, 5, 9 + 7 + 4 + 2 * (1 + 8 - 8), 18 + 5 + 2 * (9 - 8))),
]


@pytest.mark.parametrize("mode,options,expected", ADMISSION, ids=[a[0] for a in ADMISSION])
def test_admission_counters_count_rows_and_positions(tiny_vlm, mode, options, expected):
    rng = np.random.default_rng(3)
    frames = rng.random((3, 1, 3, 64, 64), dtype=np.float32)
    template = rng.integers(3, 500, 7).astype(np.int32)
    server = PagedGenerationServer(tiny_vlm, num_slots=4, prompt_len=(4, 8), max_new_tokens=2, eos_token_id=-1,
                                   prefill_batch=2, page_size=PAGE, **options)
    tracing.enable()
    for specs in ([(0, 8, True), (1, 3, False), (2, 6, False)], [(0, 8, True), (0, 8, True)]):
        for req in _wave(rng, template, frames, specs):
            server.submit(*req)
        server.run_to_completion()
    c = tracing.counters()
    got = (c["serve.admit.rows"], c["serve.admit.rows_computed"], c["serve.admit.positions"],
           c["serve.admit.positions_computed"])
    assert got == expected
    assert server.prefix_cache_partial_hits == (2 if mode == "partial_hit" else 0)
    spans = tracing.spans()
    by_index = {s.index: s for s in spans}
    programs = [s for s in spans if s.name == "serve.admit.program"]
    assert sum(p.attrs["rows"] for p in programs) >= 5
    assert all(by_index[p.parent].name == "serve.admit" for p in programs)
    assert {s.name for s in spans if s.parent == -1} == {"serve.admit", "serve.tick"}
    parts = {by_index[s.parent].name for s in spans if s.name.startswith("serve.tick.")}
    assert parts == {"serve.tick"}
    fetches = [s for s in spans if s.name == "serve.admit.fetch"]
    assert fetches and all(by_index[s.parent].name == "serve.admit.program" for s in fetches)


# -- the trainer and the policy ----------------------------------------------


def _names_under(spans, parent_name):
    by_index = {s.index: s for s in spans}
    return {s.name for s in spans if s.parent in by_index and by_index[s.parent].name == parent_name}


def test_a_trainer_step_and_a_policy_forward_emit_their_spans(tmp_path):
    policy = FastVLAPolicy(FastVLAConfig(**TINY, freeze_backbone=False, train_backbone=True), device="cpu")
    config = TrainingConfig(report_to=[], mixed_precision=None, max_steps=10, output_dir=str(tmp_path))
    trainer = Trainer(policy, train_dataloader=[], config=config)
    rng = np.random.default_rng(0)
    batch = {"images": rng.random((2, 3, 48, 64), dtype=np.float32),
             "states": rng.standard_normal((2, 4)).astype(np.float32),
             "actions": rng.standard_normal((2, 4)).astype(np.float32), "tasks": ["pick up", "push"]}
    tracing.enable()
    trainer._train_step(trainer._place_batch(batch))
    spans = tracing.spans()
    assert sorted((s.name, s.parent) for s in spans) == [("train.feed", -1), ("train.step", -1)]

    tracing.reset()
    actions = policy.forward(batch["images"], batch["states"], batch["tasks"])
    assert actions.shape == (2, 4)
    spans = tracing.spans()
    assert [s.name for s in spans if s.parent == -1] == ["policy.forward"]
    assert _names_under(spans, "policy.forward") == {"policy.prep.frames", "policy.prep.text", "policy.prep.upload"}
    assert {s.name for s in spans} == {"policy.forward"} | _names_under(spans, "policy.forward")


# -- the benchmark's readers ---------------------------------------------------


def _synthetic(tree):
    """Spans from nested ``(name, ms, children)``: children run one after
    another from their parent's start, and a parent lasts ``ms``."""
    out = []

    def add(node, parent, start):
        name, ms, children = node
        index = len(out)
        out.append(None)
        t = start
        for child in children:
            t = add(child, index, t)
        out[index] = tracing.Span(index, name, start, start + int(ms * 1e6), parent, {})
        return start + int(ms * 1e6)

    t = 0
    for node in tree:
        t = add(node, -1, t)
    return out


def _tick(frames, upload, text=1.0):
    children = [("policy.prep.frames", f, []) for f in frames] + [("policy.prep.text", text, [])]
    children += [("policy.prep.upload", u, []) for u in upload]
    return ("policy.forward", 50.0, [("policy.forward", 40.0, children)])


def _program(upload, fetch):
    return ("serve.admit.program", 200.0, [("serve.admit.upload", upload, []), ("serve.admit.prefill", 10.0, []),
                                           ("serve.admit.scatter", 5.0, []), ("serve.admit.fetch", fetch, [])])


def _decode_tick(ms):
    return ("serve.tick", ms, [("serve.tick.forward", 1.0, []), ("serve.tick.fetch", 0.5, [])])


ACT = [_tick([2.0, 1.0], [4.0, 1.0]), _tick([5.0], [2.0]), _tick([1.5, 2.5], [3.0, 4.0])]
SERVE = [
    ("serve.admit", 450.0, [_program(20.0, 90.0), _program(30.0, 100.0)]), _decode_tick(30.0), _decode_tick(32.0), _decode_tick(40.0),
    ("serve.admit", 220.0, [_program(40.0, 150.0)]),
    ("serve.admit", 0.5, []),
]
TRAIN = [("train.feed", 20.0, []), ("train.step", 500.0, [("train.loss", 100.0, [])]), ("train.feed", 10.0, []),
         ("train.step", 500.0, []), ("train.feed", 15.0, [])]
COUNTS = {"serve.admit.positions": 282, "serve.admit.positions_computed": 1000, "serve.admit.rows": 16}

READERS = [
    ("prep_frames_ms.act", ACT, {}, 4.0),  # ticks 3, 5, 4
    ("prep_upload_ms.act", ACT, {}, 5.0),  # ticks 5, 2, 7
    ("admit_upload_ms.serve", SERVE, {}, 45.0),  # steps 50, 40
    ("admit_wait_ms.serve", SERVE, {}, 192.5),  # steps 105 + 115, 165
    ("prefill_use.serve", SERVE, COUNTS, 28.2),
    ("feed_ms.train", TRAIN, {}, 22.5),  # 45 ms over 2 steps
]


@pytest.mark.parametrize("name,tree,counts,expected", READERS, ids=[r[0] for r in READERS])
def test_reader_reads_synthetic_spans_and_none_without_them(monkeypatch, name, tree, counts, expected):
    read = reader(name)
    spans = _synthetic(tree)
    monkeypatch.setattr(tracing, "spans", lambda: list(spans))
    monkeypatch.setattr(tracing, "counters", lambda: dict(counts))
    assert read(None) == pytest.approx(expected)
    monkeypatch.setattr(tracing, "spans", lambda: [])
    monkeypatch.setattr(tracing, "counters", lambda: {})
    assert read(None) is None
