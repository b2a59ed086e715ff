"""The port's HF tokenizer branch (``io/tokenizer.py``,
``HFTokenizerAdapter``) against the JAX package's, on the CPU.

The tokenizer is a tiny byte-level BPE built on the fly with the
``tokenizers`` library, as ``tests/test_tokenizer_hf.py`` builds it, so
nothing is downloaded. Both packages' ``load_tokenizer`` take the
AutoTokenizer branch on its directory; ids, masks, widths, padding side,
truncation and decode are equal to JAX's, and the backbone's
``_prep_text`` goes through it.
"""

import numpy as np
import pytest

from vla_fastvlm_tpu.io import tokenizer as j_tokenizer
from vla_fastvlm_tpu_torch.io import tokenizer as t_tokenizer

TEXTS = ["pick up the red block\n", "close\n", "move the arm to the left " * 6, ""]


@pytest.fixture(scope="module")
def tiny_tokenizer_dir(tmp_path_factory):
    pytest.importorskip("transformers")
    tokenizers = pytest.importorskip("tokenizers")
    Tokenizer, decoders, models, pre_tokenizers, trainers = (
        tokenizers.Tokenizer, tokenizers.decoders, tokenizers.models, tokenizers.pre_tokenizers,
        tokenizers.trainers)

    tok = Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(vocab_size=400, special_tokens=["<|endoftext|>"],
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(["pick up the red block", "move the arm to the left", "push the green button\n",
                             "close the gripper"], trainer)
    out = tmp_path_factory.mktemp("tiny_tok")
    tok.save(str(out / "tokenizer.json"))
    (out / "tokenizer_config.json").write_text(
        '{"tokenizer_class": "PreTrainedTokenizerFast", "eos_token": "<|endoftext|>", "model_max_length": 512}'
    )
    return str(out)


@pytest.mark.parametrize("side", ["right", "left"])
def test_takes_the_hf_branch_like_jax(tiny_tokenizer_dir, side):
    tok = t_tokenizer.load_tokenizer(tiny_tokenizer_dir, padding_side=side)
    ref = j_tokenizer.load_tokenizer(tiny_tokenizer_dir, padding_side=side)
    assert isinstance(tok, t_tokenizer.HFTokenizerAdapter) and isinstance(ref, j_tokenizer.HFTokenizerAdapter)
    # Qwen2-style: no pad token in the vocab, so the pad is the eos.
    assert tok.pad_token_id == ref.pad_token_id == tok._tok.eos_token_id
    assert tok.vocab_size == ref.vocab_size and tok.padding_side == side


@pytest.mark.parametrize("side", ["right", "left"])
@pytest.mark.parametrize("padding,max_length", [("longest", 64), ("longest", 8), ("max_length", 16),
                                                ("max_length", 8)])
def test_batches_equal_jax(tiny_tokenizer_dir, side, padding, max_length):
    tok = t_tokenizer.load_tokenizer(tiny_tokenizer_dir, padding_side=side)
    ref = j_tokenizer.load_tokenizer(tiny_tokenizer_dir, padding_side=side)
    got = tok(TEXTS, padding=padding, truncation=True, max_length=max_length)
    want = ref(TEXTS, padding=padding, truncation=True, max_length=max_length)
    for a, b in ((got.input_ids, want.input_ids), (got.attention_mask, want.attention_mask)):
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
    lens, width = got.attention_mask.sum(axis=1), got.input_ids.shape[1]
    assert width == max_length if padding == "max_length" else (width <= max_length and lens.max() == width)
    for row, n in enumerate(lens):
        valid = slice(0, n) if side == "right" else slice(width - n, None)
        assert (got.attention_mask[row, valid] == 1).all() and got.attention_mask[row].sum() == n


def test_encode_and_decode_equal_jax(tiny_tokenizer_dir):
    tok = t_tokenizer.load_tokenizer(tiny_tokenizer_dir)
    ref = j_tokenizer.load_tokenizer(tiny_tokenizer_dir)
    for text in TEXTS:
        ids = tok.encode(text)
        assert ids == ref.encode(text) and tok.decode(ids) == ref.decode(ids) == text
        assert tok.encode(text, max_length=4) == ref.encode(text, max_length=4)


def test_backbone_prep_text_through_hf_tokenizer(tiny_tokenizer_dir):
    """``_prep_text``: padded to ``tokenizer_max_length``, truncated rows full."""
    from vla_fastvlm_tpu_torch.model import FastVLMBackbone, FastVLMBackboneConfig

    backbone = FastVLMBackbone(FastVLMBackboneConfig(model_id="tiny", tokenizer_max_length=8), device="meta")
    backbone.tokenizer = t_tokenizer.load_tokenizer(tiny_tokenizer_dir)
    ids, mask = backbone._prep_text(["pick up the red block and stack it somewhere far away\n", "x\n"])
    want = j_tokenizer.load_tokenizer(tiny_tokenizer_dir)(
        ["pick up the red block and stack it somewhere far away\n", "x\n"], padding="max_length", truncation=True,
        max_length=8)
    assert ids.shape == mask.shape == (2, 8)
    assert np.array_equal(ids, want.input_ids) and np.array_equal(mask, want.attention_mask)
    assert mask[0].sum() == 8
