"""The port's ``Trainer`` and training CLI end to end on the CPU.

The JAX package's trainer tests (``tests/test_data_training.py``) on the
port: synthetic ALOHA-schema data -> ``Trainer.fit`` -> checkpoints in the
JAX layout -> reload, resume, pruning, the preemption checkpoint, the
precision fallback, the profiler trace, ``debug_nans``, and the training CLI
run with ``--device cpu``. ``fastvlm-tiny``, fp32, on the CPU.
"""

import json
import logging

import numpy as np
import pytest
import torch

from vla_fastvlm_tpu_torch.data import AlohaDataset, SyntheticAlohaSource, create_aloha_dataloader
from vla_fastvlm_tpu_torch.fastvla import FastVLAConfig, FastVLAPolicy
from vla_fastvlm_tpu_torch.io.checkpoint import load_policy_from_checkpoint
from vla_fastvlm_tpu_torch.training import Trainer, TrainingConfig

TINY = dict(vlm_model_name="fastvlm-tiny", bootstrap_model_name="fastvlm-tiny", state_dim=4, action_dim=4,
            hidden_dim=16, fusion_dim=16, tokenizer_max_length=16, dropout=0.0)


def make_loader(n=16, batch_size=8, shuffle=True):
    ds = AlohaDataset(source=SyntheticAlohaSource(num_samples=n, image_hw=(32, 32), state_dim=4, action_dim=4))
    return create_aloha_dataloader(ds, batch_size=batch_size, shuffle=shuffle, num_workers=0)


def make_policy(**kw):
    return FastVLAPolicy(FastVLAConfig(**TINY, **kw), device="cpu")


def quiet(**kw):
    return TrainingConfig(report_to=[], mixed_precision=None, **kw)


def step_dirs(out):
    return sorted((out / "checkpoints").glob("step-*"), key=lambda p: int(p.name.split("-")[1]))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    out = tmp_path_factory.mktemp("train")
    policy = make_policy()
    cfg = quiet(output_dir=str(out), num_epochs=3, learning_rate=1e-2, logging_steps=1, eval_steps=4,
                save_steps=3)
    trainer = Trainer(policy, make_loader(), make_loader(shuffle=False), cfg)
    first_eval = trainer.evaluate()["eval/mse"]
    trainer.fit()
    return policy, trainer, out, first_eval


class TestFit:
    def test_loss_decreases(self, trained):
        _, trainer, _, first_eval = trained
        assert trainer.global_step == 6 and trainer.updates == 6
        assert trainer.evaluate()["eval/mse"] < first_eval

    def test_layout_and_logs(self, trained):
        _, _, out, _ = trained
        assert json.loads((out / "training_config.json").read_text())["save_steps"] == 3
        ckpts = step_dirs(out)
        assert [c.name for c in ckpts] == ["step-3", "step-6"]
        for c in ckpts:
            assert (c / "policy_config.json").exists() and (c / "policy_state_dict.safetensors").exists()
            assert (c / "train_state" / "train_state.pt").exists()
        records = [json.loads(ln) for ln in (out / "logs" / "metrics.jsonl").read_text().splitlines()]
        train = [r for r in records if "train/loss" in r]
        assert [r["step"] for r in train] == list(range(1, 7))
        assert {"train/loss", "train/mse", "train/grad_norm", "train/lr", "train/epoch",
                "train/step_time_s"} <= set(train[0])
        assert all(np.isfinite(r["train/loss"]) and np.isfinite(r["train/grad_norm"]) for r in train)
        assert [r["step"] for r in records if "eval/mse" in r] == [4]

    def test_checkpoint_reloads_with_the_same_actions(self, trained):
        policy, _, out, _ = trained
        loaded, device = load_policy_from_checkpoint(step_dirs(out)[-1], device="cpu")
        imgs, states = np.zeros((2, 3, 32, 32), np.float32), np.ones((2, 4), np.float32)
        assert torch.equal(policy.forward(imgs, states, "t"), loaded.forward(imgs, states, "t"))

    def test_resume_restores_counters_optimizer_and_generator(self, trained):
        _, trainer, out, _ = trained
        ckpt = step_dirs(out)[-1]
        resumed = Trainer(make_policy(), make_loader(), None, quiet(output_dir=str(out), num_epochs=4))
        resumed._load_checkpoint(str(ckpt))
        assert (resumed.global_step, resumed.epoch, resumed.updates) == (6, 2, 6)
        assert torch.equal(resumed.generator.get_state(), trainer.generator.get_state())
        a, b = resumed.optimizer.state_dict()["state"], trainer.optimizer.state_dict()["state"]
        assert a.keys() == b.keys() and all(torch.equal(a[i]["exp_avg"], b[i]["exp_avg"]) for i in a)
        with pytest.raises(FileNotFoundError):
            resumed._load_checkpoint(str(out / "checkpoints" / "step-99"))

    def test_resume_continues_to_max_steps(self, trained, tmp_path):
        _, _, out, _ = trained
        cfg = quiet(output_dir=str(tmp_path), num_epochs=4, resume_from=str(step_dirs(out)[0]), logging_steps=1)
        resumed = Trainer(make_policy(), make_loader(), None, cfg)
        resumed.fit()
        assert resumed.global_step == 9 and resumed.epoch == 3  # each epoch runs whole, as in JAX


def test_keep_last_n_prunes_old_checkpoints(tmp_path):
    cfg = quiet(output_dir=str(tmp_path), num_epochs=6, save_steps=1, keep_last_n=2)
    Trainer(make_policy(), make_loader(8, shuffle=False), None, cfg).fit()
    ckpts = step_dirs(tmp_path)
    assert [c.name for c in ckpts] == ["step-5", "step-6"]
    load_policy_from_checkpoint(ckpts[-1], device="cpu")


def test_preemption_checkpoint(tmp_path):
    """A SIGTERM-style preemption saves a resumable checkpoint mid-run."""
    trainer = Trainer(make_policy(), make_loader(shuffle=False), None,
                      quiet(output_dir=str(tmp_path), num_epochs=10, save_steps=1000, async_save=False))
    original = trainer._train_step

    def step_then_preempt(arrays):
        out = original(arrays)
        trainer._preempted = True  # what the signal handler sets
        return out

    trainer._train_step = step_then_preempt
    trainer.fit()
    assert trainer.global_step == 1
    preempt = list((tmp_path / "checkpoints").glob("preempt-step-*"))
    assert [p.name for p in preempt] == ["preempt-step-1"]
    t2 = Trainer(make_policy(), make_loader(), None, quiet(output_dir=str(tmp_path)))
    t2._load_checkpoint(str(preempt[0]))
    assert t2.global_step == 1


def test_bad_precision_falls_back(caplog):
    with caplog.at_level(logging.WARNING):
        trainer = Trainer(make_policy(), make_loader(8), None,
                          TrainingConfig(mixed_precision="fp8-bogus", report_to=[], max_steps=1))
    assert trainer.config.mixed_precision == "no" and "falling back" in caplog.text


def test_unported_options_raise():
    """A mesh that is no ("data", "model") DeviceMesh raises; ``fsdp``
    without a mesh is a no-op, as in JAX (tests/test_torch_sharded_training.py
    trains on meshes)."""
    with pytest.raises(ValueError, match="mesh"):
        Trainer(make_policy(), make_loader(8), None, quiet(max_steps=1), mesh=object())
    trainer = Trainer(make_policy(), make_loader(8), None, quiet(max_steps=1, fsdp=True))
    assert trainer.mesh is None and not any(hasattr(p, "device_mesh") for p in trainer._params)
    from vla_fastvlm_tpu_torch.data import AlohaIterableDataset

    stream = create_aloha_dataloader(AlohaIterableDataset(source=SyntheticAlohaSource(num_samples=4)), batch_size=2)
    with pytest.raises(ValueError, match="max_steps"):
        Trainer(make_policy(), stream, None, quiet())


def test_debug_nans_raises(tmp_path):
    policy = make_policy()
    with torch.no_grad():
        policy.model.head.action_head.bias.fill_(float("nan"))
    trainer = Trainer(policy, make_loader(8), None, quiet(output_dir=str(tmp_path), max_steps=1, debug_nans=True))
    with pytest.raises(FloatingPointError, match="non-finite"):
        trainer.fit()


def test_profile_writes_a_trace(tmp_path):
    cfg = quiet(output_dir=str(tmp_path), max_steps=3, profile_start_step=1, profile_num_steps=1)
    Trainer(make_policy(), make_loader(8), None, cfg).fit()
    traces = list((tmp_path / "logs" / "profile").glob("trace_step1.json"))
    assert len(traces) == 1 and json.loads(traces[0].read_text())["traceEvents"]


def test_accumulation_takes_k_batches_an_update(tmp_path):
    trainer = Trainer(make_policy(), make_loader(16, batch_size=4), None,
                      quiet(output_dir=str(tmp_path), num_epochs=1, gradient_accumulation_steps=2))
    assert trainer.num_training_steps == 2
    trainer.fit()
    assert (trainer.global_step, trainer.updates) == (4, 2)


class TestTrainScript:
    FLAGS = ["--synthetic-data", "--synthetic-samples", "8", "--synthetic-image-size", "32", "--model-id",
             "fastvlm-tiny", "--bootstrap-model-id", "fastvlm-tiny", "--hidden-dim", "16", "--fusion-dim", "16",
             "--tokenizer-max-length", "16", "--batch-size", "4", "--eval-batch-size", "4", "--num-workers", "0",
             "--max-steps", "2", "--save-steps", "2", "--logging-steps", "1", "--seed", "3"]

    def test_synthetic_run_on_the_cpu(self, tmp_path):
        from vla_fastvlm_tpu_torch.scripts.train import TrainArgs, main
        from vla_fastvlm_tpu_torch.utils import parse_cli

        main(parse_cli(TrainArgs, self.FLAGS + ["--output-dir", str(tmp_path), "--device", "cpu"]))
        assert (tmp_path / "checkpoints" / "step-2" / "policy_state_dict.safetensors").exists()
        lines = (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()
        assert [json.loads(ln)["step"] for ln in lines if "train/loss" in ln] == [1, 2]

    @pytest.mark.parametrize("flag", ["--tp", "--dp"])
    def test_mesh_flags_raise(self, flag):
        """A mesh the model or the batch cannot split raises before any rank
        starts: 4 heads over --tp 3, a batch of 4 over --dp 3."""
        from vla_fastvlm_tpu_torch.scripts.train import TrainArgs, main
        from vla_fastvlm_tpu_torch.utils import parse_cli

        with pytest.raises(ValueError, match="does not split" if flag == "--tp" else "not divisible"):
            main(parse_cli(TrainArgs, self.FLAGS + ["--device", "cpu", flag, "3"]))

    def test_yaml_config_gives_defaults(self):
        from vla_fastvlm_tpu_torch.scripts.train import TrainArgs
        from vla_fastvlm_tpu_torch.utils import parse_cli

        args = parse_cli(TrainArgs, ["--config", "configs/train_aloha.yaml", "--batch-size", "2"])
        assert (args.batch_size, args.image_size, args.dtype, args.learning_rate) == (2, 512, "bfloat16", 1e-4)
        assert args.freeze_backbone and not args.train_backbone and args.device == "cuda"
