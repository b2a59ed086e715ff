"""The port's sharded training and mesh CLIs against the JAX package on the CPU.

- ``Trainer(mesh=...)`` at (2, 2), full backbone, with and without FSDP
  (``FSDP_MIN_ELEMENTS`` 0 in both packages, so the tiny model's leaves
  shard): the loss and gradient norm of three steps, the first batch's
  gradients gathered whole and the trained tree after three AdamW updates
  (warmup, a clip) against JAX's trainer on the same mesh; FSDP leaves and
  AdamW moments really sharded.
- A checkpoint written from a sharded FSDP run holds whole tensors and
  loads in JAX and, unsharded, in the port; a sharded trainer resumes
  from it.
- ``scripts.generate --dp 2 --tp 2`` prints JAX's text; ``scripts.train
  --dp 2 --fsdp`` logs the losses and writes the checkpoint of the port's
  one-rank run; both CLIs start their own ranks.

``fastvlm-tiny`` in fp32, dropout 0. Tolerances as the unsharded training
tests': loss 1e-5 relative, gradients 1e-4 relative to the leaf's largest
entry, parameters after the updates 1e-5.
"""

import json

import jax
import numpy as np
import pytest

from vla_fastvlm_tpu.data import AlohaDataset as JDataset
from vla_fastvlm_tpu.data import SyntheticAlohaSource as JSource
from vla_fastvlm_tpu.data import aloha_collate_fn as jcollate
from vla_fastvlm_tpu.fastvla import FastVLAConfig as JConfig
from vla_fastvlm_tpu.fastvla import FastVLAPolicy as JPolicy
from vla_fastvlm_tpu.parallel import make_mesh as j_make_mesh
from vla_fastvlm_tpu.parallel import sharding as jsh
from vla_fastvlm_tpu.training import Trainer as JTrainer
from vla_fastvlm_tpu.training import TrainingConfig as JTrainingConfig
from vla_fastvlm_tpu_torch.io.bridge import flatten_params, jax_params_to_torch
from vla_fastvlm_tpu_torch.training import linear_warmup_decay

from _torch_dist import RankPool
from _torch_parity import random_params

TINY = dict(vlm_model_name="fastvlm-tiny", bootstrap_model_name="fastvlm-tiny", state_dim=6, action_dim=5,
            hidden_dim=16, fusion_dim=16, tokenizer_max_length=16, dropout=0.0, train_backbone=True,
            freeze_backbone=False)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
UPDATE_ATOL = 1e-5
# The key bias's exact gradient is 0: a per-head key shift adds one constant
# to all of a query's logits, which softmax ignores. Both packages get
# rounding noise there (held to the gradient tolerance), which AdamW scales
# to steps of up to the learning rate, so its trained values are held to
# that bound instead.
NOISE_LEAVES = {"backbone.language_model.layers.self_attn.k_proj.bias"}
SETTINGS = dict(max_steps=10, warmup_ratio=0.2, learning_rate=1e-2, max_grad_norm=2.0, report_to=[],
                mixed_precision=None)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(4, tmp_path_factory.mktemp("ranks"))
    yield p
    p.close()


def _batches(n, size, seed=3):
    ds = JDataset(source=JSource(num_samples=n * size, image_hw=(40, 56), state_dim=6, action_dim=5, seed=seed))
    return [jcollate([ds[i] for i in range(j * size, (j + 1) * size)]) for j in range(n)]


def _jpolicy(seed):
    jp = JPolicy(JConfig(**TINY, fabricate_params=True))
    params = jax.device_get(random_params(jp.params, seed))
    jp.load_params(params)
    return jp, params


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's FSDP trainer at (2, 2) (leaves of any size sharded) over three
    batches, and JAX's gradients of the first; JAX's own tests pin its TP
    x DP step to the same numbers (``tests/test_fsdp.py``,
    ``test_parallel.py``), so both port layouts are held to this one."""
    jp, params = _jpolicy(4)
    batches = _batches(3, 4)
    jgrads = jax.device_get(jax.jit(jax.grad(lambda tr, fr, a: jp.loss_fn(tr, fr, a, train=True)[0]))(
        jp.trainable_params(), jp.frozen_params(), jp.prepare_batch(batches[0])))
    saved, jsh.FSDP_MIN_ELEMENTS = jsh.FSDP_MIN_ELEMENTS, 0
    try:
        jtrainer = JTrainer(jp, batches, None, JTrainingConfig(**SETTINGS, fsdp=True),
                            mesh=j_make_mesh(data=2, model=2, devices=jax.devices()[:4]))
        trainable, opt_state, rng = jtrainer.trainable, jtrainer.opt_state, jax.random.PRNGKey(0)
        loss, norm = [], []
        for batch in batches:
            trainable, opt_state, m = jtrainer._train_step(trainable, opt_state, jtrainer.frozen,
                                                            jp.prepare_batch(batch), rng)
            loss.append(float(m["loss"]))
            norm.append(float(m["grad_norm"]))
    finally:
        jsh.FSDP_MIN_ELEMENTS = saved
    return dict(params=params, batches=batches, grads=jgrads, loss=loss, norm=norm,
                trained=jax.device_get(trainable))


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp-dp", "fsdp"])
def test_train_step_matches_jax(pool, jax_ref, fsdp):
    ref = jax_ref
    got = pool.run("t_train", TINY, ref["params"], 2, 2, fsdp, ref["batches"], SETTINGS,
                   min_elements=0 if fsdp else None)[0]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"], ref["norm"], rtol=LOSS_RTOL)
    assert ref["norm"][1] >= SETTINGS["max_grad_norm"] > ref["norm"][0]  # the clip is hit
    expect = {f"{part}.{k}": v.numpy() for part, tree in ref["grads"].items()
              for k, v in jax_params_to_torch(tree).items()}
    assert sorted(expect) == sorted(got["grads"])
    for name, value in expect.items():
        assert _rel(got["grads"][name], value) <= GRAD_RTOL, name
    trained = {f"{part}.{k}": v for part, tree in ref["trained"].items() for k, v in flatten_params(tree).items()}
    mine = {f"{part}.{k}": v for part, tree in got["params"].items() for k, v in flatten_params(tree).items()}
    assert sorted(trained) == sorted(mine)
    lr_sum = sum(linear_warmup_decay(SETTINGS["learning_rate"], SETTINGS["max_steps"], 2)(i) for i in range(3))
    for name, value in trained.items():
        atol = 2 * lr_sum if name in NOISE_LEAVES else UPDATE_ATOL
        np.testing.assert_allclose(mine[name], np.asarray(value), atol=atol, err_msg=name)
    if fsdp:
        assert got["fsdp_shards"] > 0 and got["moment_shards"] > 0
    else:
        assert got["fsdp_shards"] == got["moment_shards"] == 0


def test_fsdp_checkpoint_loads_whole_in_jax_and_port(pool, tmp_path):
    from vla_fastvlm_tpu.io.checkpoint import load_policy_state as j_load
    from vla_fastvlm_tpu_torch.fastvla import FastVLAConfig, FastVLAPolicy
    from vla_fastvlm_tpu_torch.io.checkpoint import load_policy_state

    jp, params = _jpolicy(6)
    batches = _batches(2, 4, seed=9)
    runs = pool.run("t_fit_checkpoint", TINY, params, 2, 2, True, batches, str(tmp_path), min_elements=0)
    # A fresh trainer on the mesh resumes the whole optimizer state cut to its pieces.
    assert runs == [(2, (3, 3), [3.0])] * 4
    ckpt = tmp_path / "checkpoints" / "step-2"
    _, jtree = j_load(ckpt)
    _, ttree = load_policy_state(ckpt)
    ref = {k: np.asarray(v) for k, v in flatten_params(jax.device_get(jp.params)).items()}
    loaded = {k: np.asarray(v) for k, v in flatten_params(jtree).items()}
    assert sorted(loaded) == sorted(ref)
    for name, value in ref.items():
        assert loaded[name].shape == value.shape, name
    for name, value in flatten_params(ttree).items():
        np.testing.assert_array_equal(np.asarray(value), loaded[name], err_msg=name)
    assert any(not np.array_equal(loaded[k], ref[k]) for k in ref if k.startswith("backbone."))
    port = FastVLAPolicy(FastVLAConfig(**TINY), device="cpu")
    port.load_jax_params(ttree)
    jp.load_params(jtree)
    rng = np.random.default_rng(2)
    images, states = rng.random((2, 3, 32, 32), dtype=np.float32), rng.standard_normal((2, 6)).astype(np.float32)
    np.testing.assert_allclose(port.forward(images, states, ["go"] * 2).numpy(),
                               np.asarray(jp.forward(images, states, ["go"] * 2)), atol=2e-5)


def _stub_out(tmp_path, monkeypatch, *packages):
    """Make ``packages`` fail to import here and in the ranks a command
    starts (they take this process's ``sys.path``): their imports cost
    seconds a process, and the code under test falls back without them."""
    for name in packages:
        stub = tmp_path / "stub" / name
        stub.mkdir(parents=True)
        (stub / "__init__.py").write_text(f'raise ImportError("{name} is stubbed out in this test")\n')
    monkeypatch.syspath_prepend(str(tmp_path / "stub"))


def test_generate_cli_on_its_own_ranks_prints_jax_text(tmp_path, capsys, monkeypatch):
    """Both scripts read one FastVLM directory written from seeds (the port's
    ranks start fresh, so the weights travel on disk). ``transformers`` is
    stubbed out in the ranks: the directory holds no tokenizer, so both
    scripts take the byte-level tokenizer either way."""
    import torch
    from test_torch_hf_weights import _fast_jax_init, hf_decoder, train_mode_tower, write_directory
    from test_torch_serve_cli import jax_script

    from vla_fastvlm_tpu.model import fastvlm_adapter as j_adapter
    from vla_fastvlm_tpu_torch.models.fastvit import fastvithd_tiny
    from vla_fastvlm_tpu_torch.models.qwen2 import qwen2_tiny
    from vla_fastvlm_tpu_torch.scripts import generate as t_generate

    decoder = hf_decoder(qwen2_tiny(), seed=8, projector_in=fastvithd_tiny().out_channels)
    decoder["model.embed_tokens.weight"] *= 0.1
    path = write_directory(tmp_path / "fastvlm", [("model.safetensors", {**decoder, **train_mode_tower(
        fastvithd_tiny(), seed=7)}, torch.float32)])
    monkeypatch.setattr(j_adapter.FastVLMBackbone, "_init_params", _fast_jax_init)
    jax_generate = jax_script("generate")
    _stub_out(tmp_path, monkeypatch, "transformers")
    kw = dict(model_id=path, bootstrap_model_id="fastvlm-tiny", prompt="pick up the red cube", max_new_tokens=6,
              tokenizer_max_length=16, dtype="float32")
    jax_generate.main(jax_generate.GenerateArgs(**kw))
    ref = capsys.readouterr().out.splitlines()[-1]
    text = t_generate.main(t_generate.GenerateArgs(device="cpu", dp=2, tp=2, **kw))
    assert text == ref


def test_train_cli_fsdp_on_its_own_ranks_logs_one_rank_losses(tmp_path, monkeypatch):
    """``--dp 2 --fsdp`` on two ranks the command starts logs the losses of
    the one-rank run (held to JAX's trainer by ``test_torch_training.py``)
    and writes a whole checkpoint from rank 0. TensorBoard is stubbed out
    (its import loads TensorFlow for seconds a rank; the trainer warns and
    goes on)."""
    from vla_fastvlm_tpu_torch.io.checkpoint import load_policy_state
    from vla_fastvlm_tpu_torch.scripts.train import TrainArgs, main
    from vla_fastvlm_tpu_torch.utils import parse_cli

    _stub_out(tmp_path, monkeypatch, "tensorboard")
    for name in ("tensorboard", "torch.utils.tensorboard"):
        monkeypatch.delitem(__import__("sys").modules, name, raising=False)
    flags = ["--synthetic-data", "--synthetic-samples", "8", "--synthetic-image-size", "32", "--model-id",
             "fastvlm-tiny", "--bootstrap-model-id", "fastvlm-tiny", "--hidden-dim", "16", "--fusion-dim", "16",
             "--tokenizer-max-length", "16", "--batch-size", "4", "--num-workers", "0", "--max-steps", "2",
             "--save-steps", "2", "--logging-steps", "1", "--seed", "3", "--dtype", "float32", "--fsdp", "--dropout", "0",
             "--device", "cpu"]

    def losses(out):
        lines = (out / "logs" / "metrics.jsonl").read_text().splitlines()
        return [json.loads(ln)["train/loss"] for ln in lines if "train/loss" in ln]

    main(parse_cli(TrainArgs, flags + ["--output-dir", str(tmp_path / "sharded"), "--dp", "2"]))
    main(parse_cli(TrainArgs, flags + ["--output-dir", str(tmp_path / "one"), "--dp", "1"]))
    assert len(losses(tmp_path / "sharded")) == 2
    np.testing.assert_allclose(losses(tmp_path / "sharded"), losses(tmp_path / "one"), rtol=LOSS_RTOL)
    _, sharded = load_policy_state(tmp_path / "sharded" / "checkpoints" / "step-2")
    _, one = load_policy_state(tmp_path / "one" / "checkpoints" / "step-2")
    for name, value in flatten_params(one).items():
        np.testing.assert_allclose(np.asarray(flatten_params(sharded)[name]), np.asarray(value), atol=UPDATE_ATOL,
                                   err_msg=name)
