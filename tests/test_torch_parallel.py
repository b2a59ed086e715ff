"""The port's device mesh, sharding rules and sharded inference against the
JAX package on the CPU.

- Spec functions: the port's ``spec_for_param``, ``fsdp_spec_for_param``,
  ``param_shardings``, ``fsdp_param_shardings``, ``batch_spec`` and
  ``cache_shardings`` equal JAX's for every leaf of the tiny policy's tree
  and of a 7B decoder built on the ``meta`` device, at several mesh sizes,
  the int8 / int4 row-split scales (0.5B's 7 groups over TP 2) included;
  the 7B FSDP training state a chip holds at data 8, in JAX's numbers.
- Local shards: in gloo ranks (``_torch_dist.RankPool``), each rank's piece
  of every leaf, fused q/k/v and gate/up parts included, equals the
  addressable shard of JAX's placed array on the device of the same index
  (TP at (2, 2) and (1, 4), FSDP at (2, 2) and (4, 1), int8 / int4 decoders
  at TP 2); whole trees gather back bit-equal; sharded decoder logits
  within 2e-5 of JAX's.
- ``ShardedPolicyRuntime``: forward, multi-camera chunked runs through
  ``ActionQueuePolicy`` and ``select_action`` within 2e-5 of JAX's sharded
  runtime; JAX's "not divisible" raise.
- ``sharded_generate``: greedy tokens equal JAX's, plain, pre-placed, with
  one adapter and multi-LoRA over an untied (vocabulary-split) LM head.

Tiny configs in fp32 with numpy-seeded weights through ``io/bridge.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vla_fastvlm_tpu.fastvla import FastVLAConfig as JConfig
from vla_fastvlm_tpu.fastvla import FastVLAPolicy as JPolicy
from vla_fastvlm_tpu.parallel import make_mesh as j_make_mesh
from vla_fastvlm_tpu.parallel import sharding as jsh
from vla_fastvlm_tpu_torch.io.bridge import jax_params_to_torch, torch_params_to_jax
from vla_fastvlm_tpu_torch.parallel import sharding as tsh

from _torch_dist import RankPool
from _torch_parity import jax_adapter, jax_param_shapes, random_params

TINY = dict(vlm_model_name="fastvlm-tiny", bootstrap_model_name="fastvlm-tiny", state_dim=4, action_dim=4,
            hidden_dim=16, fusion_dim=16, tokenizer_max_length=16, dropout=0.0)
ACTION_ATOL = 2e-5
# WIDE's logits reach |60|: fp32 sums of a 896-wide contraction cut in two
# pieces, relative to the largest logit.
LOGIT_RTOL_MAX = 4e-6
# A one-layer decoder at 0.5B's width: o_proj's K = 896 is 7 int4 groups.
WIDE = dict(vocab_size=64, hidden_size=896, num_hidden_layers=1, num_attention_heads=14, num_key_value_heads=2,
            intermediate_size=256)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(4, tmp_path_factory.mktemp("ranks"))
    yield p
    p.close()


def _jmesh(data, model):
    return j_make_mesh(data=data, model=model, devices=jax.devices()[: data * model])


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _jpolicy(seed=0, **kw):
    jp = JPolicy(JConfig(**TINY, fabricate_params=True, **kw))
    params = random_params(jp.params, seed)
    jp.load_params(params)
    return jp, jax.device_get(params)


@pytest.fixture(scope="module")
def tiny():
    return _jpolicy()


def _jqwen(quant, seed=0, tied=True):
    """JAX ``Qwen2ForCausalLM`` at WIDE (its config quantized as the tree) and its numpy params."""
    from vla_fastvlm_tpu.io import quantize as jquantize
    from vla_fastvlm_tpu.models import qwen2 as jq

    cfg = jq.Qwen2Config(**WIDE, tie_word_embeddings=tied)
    params = random_params(jax_param_shapes(jq.Qwen2ForCausalLM(cfg), jnp.ones((1, 4), jnp.int32)), seed)
    if quant:
        params = jquantize.quantize_params(params, mode=quant)
    return jq.Qwen2ForCausalLM(cfg.replace(quantization=quant or "none")), jax.device_get(params)


def _spec(s):
    return tuple(s)


class TestSpecs:
    @pytest.mark.parametrize("model_size", [1, 2, 4])
    def test_every_tiny_leaf_matches_jax(self, tiny, model_size):
        _, params = tiny
        for names, leaf in _leaves(params):
            shape = tuple(leaf.shape)
            want = _spec(jsh.spec_for_param(names, leaf.ndim, shape, model_size=model_size))
            assert tsh.spec_for_param(names, leaf.ndim, shape, model_size=model_size) == want, names
            for data in (2, 4, 8):
                for min_el in (0, None):
                    jspec = jsh.fsdp_spec_for_param(jsh.spec_for_param(names, leaf.ndim, shape, model_size),
                                                    shape, data, min_el)
                    got = tsh.fsdp_spec_for_param(tsh.spec_for_param(names, leaf.ndim, shape, model_size),
                                                  shape, data, min_el)
                    assert got == _spec(jspec), (names, data, min_el)

    def test_trees_and_cache_match_jax(self, tiny):
        _, params = tiny
        jmesh = _jmesh(4, 2)
        mesh = {"data": 4, "model": 2}
        for j, t in ((jsh.param_shardings(jmesh, params), tsh.param_shardings(mesh, params)),
                     (jsh.fsdp_param_shardings(jmesh, params, 0), tsh.fsdp_param_shardings(mesh, params, 0))):
            for (names, js), (tnames, ts) in zip(_leaves(j), _leaves(t)):
                assert names == tnames and ts == _spec(js.spec), names
        cache = {k: np.zeros(1) for k in ("k", "v", "k_scale", "v_scale", "mask", "index")}
        jc = jsh.cache_shardings(jmesh, cache)
        assert {k: _spec(v.spec) for k, v in jc.items()} == tsh.cache_shardings(mesh, cache)
        assert tsh.batch_spec() == _spec(jsh.batch_spec())
        arrays = {"images": np.zeros((8, 3)), "step": np.zeros(())}
        assert tsh.batch_shardings(mesh, arrays) == {k: _spec(v.spec) for k, v in
                                                     jsh.batch_shardings(jmesh, arrays).items()}

    @pytest.mark.parametrize("shape,model_size", [((7, 896), 2), ((28, 896), 4), ((28, 896), 2), ((1, 896), 2),
                                                  ((24, 38, 896), 2), ((24, 7, 896), 2), ((38, 896), None)])
    @pytest.mark.parametrize("site", ["o_proj", "down_proj", "q_proj", "gate_proj"])
    def test_quantized_scales_match_jax(self, shape, model_size, site):
        parent = "self_attn" if site in ("o_proj", "q_proj") else "mlp"
        names = ("layers", parent, site, "scale")
        want = _spec(jsh.spec_for_param(names, len(shape), shape, model_size=model_size))
        assert tsh.spec_for_param(names, len(shape), shape, model_size=model_size) == want

    def test_7b_fsdp_state_per_chip_matches_jax(self):
        """JAX's ``test_per_chip_training_state_fits_v5e`` numbers: the port's
        7B tree (built on ``meta``, JAX layout through the bridge) at data 8."""
        from vla_fastvlm_tpu.models import Qwen2Model as JQwen2, qwen2_7b as j7b
        from vla_fastvlm_tpu_torch.models.qwen2 import Qwen2Model, qwen2_7b

        def per_chip(tree, specs, sizes):
            total = 0
            for (_, leaf), (_, spec) in zip(_leaves(tree), _leaves(specs)):
                spec = tuple(getattr(spec, "spec", spec))
                denom = int(np.prod([sizes[a] for a in spec if a] or [1]))
                total += int(np.prod(leaf.shape)) * 2 / denom
            return total

        with torch.device("meta"):
            port = Qwen2Model(qwen2_7b(dtype=torch.bfloat16, param_dtype=torch.bfloat16))
        tree = torch_params_to_jax(port, scanned=True, as_numpy=False)
        jtree = jax.eval_shape(lambda: JQwen2(j7b(dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32)))["params"]
        sizes = {"data": 8, "model": 1}
        got = per_chip(tree, tsh.fsdp_param_shardings(sizes, tree), sizes)
        want = per_chip(jtree, jsh.fsdp_param_shardings(_jmesh(8, 1), jtree), sizes)
        replicated = sum(int(np.prod(leaf.shape)) * 2 for _, leaf in _leaves(tree))
        assert got == want
        assert replicated > 14e9 and got < replicated / 6 and got * 4 < 9e9


def _jax_shards(params, jmesh, fsdp=False, min_elements=None):
    """Per device index: the tree of each leaf's addressable shard (numpy)."""
    placed = jsh.shard_params(jmesh, params, fsdp=fsdp, fsdp_min_elements=min_elements)
    out = {}
    for device in jmesh.devices.flat:
        def shard(leaf):
            for s in leaf.addressable_shards:
                if s.device == device:
                    return np.asarray(s.data)
        out[device.id] = jax.tree_util.tree_map(shard, placed)
    return out


def _fused(name):
    return ".qkv_proj." in name or ".gate_up_proj." in name


class TestLocalShards:
    @pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
    def test_tp_pieces_equal_jax_shards(self, pool, tiny, shape):
        _, params = tiny
        if shape == (1, 4):  # 2 KV heads do not split over 4: the port raises, JAX pads
            with pytest.raises(RuntimeError, match="whole heads"):
                pool.run("t_local_state", "policy", (TINY, params), *shape)
            return
        got = pool.run("t_local_state", "policy", (TINY, params), *shape)
        shards = _jax_shards(params, _jmesh(*shape))
        for rank, local in enumerate(got):
            for part in ("backbone", "head"):
                expect = jax_params_to_torch(shards[rank][part])
                assert sorted(expect) == sorted(local[part])
                for name, value in expect.items():
                    np.testing.assert_array_equal(local[part][name][0], value.numpy(), err_msg=f"{rank} {name}")

    @pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
    def test_fsdp_shards_equal_jax_shards(self, pool, tiny, shape):
        """Unfused leaves piece by piece (DTensor local shards); every leaf,
        fused ones included, gathers back whole."""
        _, params = tiny
        got = pool.run("t_local_state", "policy", (TINY, params), *shape, True, 0)
        shards = _jax_shards(params, _jmesh(*shape), fsdp=True, min_elements=0)
        sharded = 0
        for rank, local in enumerate(got):
            for part in ("backbone", "head"):
                expect = jax_params_to_torch(shards[rank][part])
                for name, value in expect.items():
                    if _fused(name):
                        continue
                    piece, is_fsdp = local[part][name]
                    sharded += is_fsdp
                    np.testing.assert_array_equal(piece, value.numpy(), err_msg=f"{rank} {name}")
        assert sharded > 0
        whole = dict(_leaves(pool.run("t_whole_state", "policy", (TINY, params), *shape, True, 0)[0]))
        expect = dict(_leaves(params["backbone"]))
        assert sorted(whole) == sorted(expect)
        for names, value in expect.items():
            np.testing.assert_array_equal(whole[names], value, err_msg=str(names))

    @pytest.mark.parametrize("quant", ["int8", "int4"])
    def test_quantized_pieces_and_logits(self, pool, quant):
        """0.5B's width at TP 2: int8 scales of o_proj / down replicate,
        int4's 7 o_proj groups replicate (the rank indexes them by global
        input position) while down's 2 split; codes split K/2 packed."""
        model, params = _jqwen(quant, seed=1)
        got = pool.run("t_local_state", "qwen", (WIDE, params, quant, True), 1, 2)
        shards = _jax_shards(params, _jmesh(1, 2))
        for rank in (0, 1):
            expect = jax_params_to_torch(shards[rank])
            local = got[rank]["model"]
            assert sorted(expect) == sorted(local)
            for name, value in expect.items():
                np.testing.assert_array_equal(local[name][0], value.numpy(), err_msg=f"{rank} {name}")
        scale = shards[0]["model"]["layers"]["self_attn"]["o_proj"]["scale"]
        assert scale.shape[-2] == (7 if quant == "int4" else 1)  # whole on each rank
        ids = np.random.default_rng(2).integers(0, 64, (2, 6)).astype(np.int32)
        logits = pool.run("t_qwen_logits", (WIDE, params, quant, True), 1, 2, ids)[0]
        ref = np.asarray(model.apply({"params": params}, jnp.asarray(ids))[0])
        assert np.abs(logits - ref).max() <= LOGIT_RTOL_MAX * np.abs(ref).max()
        whole = dict(_leaves(pool.run("t_whole_state", "qwen", (WIDE, params, quant, True), 1, 2)[0]))
        expect = dict(_leaves(params))
        assert sorted(whole) == sorted(expect)
        for names, value in expect.items():
            np.testing.assert_array_equal(np.asarray(whole[names], np.float32), np.asarray(value, np.float32),
                                          err_msg=str(names))

    def test_untied_lm_head_splits_by_vocabulary(self, pool):
        model, params = _jqwen(None, seed=3, tied=False)
        ids = np.random.default_rng(4).integers(0, 64, (2, 5)).astype(np.int32)
        got = pool.run("t_local_state", "qwen", (dict(WIDE, tie_word_embeddings=False), params, None, True), 1, 2)
        assert got[0]["model"]["lm_head.weight"][0].shape == (32, 896)
        logits = pool.run("t_qwen_logits", (dict(WIDE, tie_word_embeddings=False), params, None, True), 1, 2, ids)[0]
        ref = np.asarray(model.apply({"params": params}, jnp.asarray(ids))[0])
        assert np.abs(logits - ref).max() <= LOGIT_RTOL_MAX * np.abs(ref).max()

    def test_mesh_layout_and_errors(self, pool):
        got = pool.run("t_mesh")
        assert got[0]["shape"] == {"data": 2, "model": 2}
        assert [g["coord"] for g in got] == [[0, 0], [0, 1], [1, 0], [1, 1]]  # rank r = d * model + m
        assert all(g["errors"] == ["ValueError"] * 3 for g in got)
        assert [g["absorb"] for g in got] == [{"data": 2, "model": 2}] * 4


class TestShardedPolicyRuntime:
    def _obs(self, seed, b=8, ncam=None):
        rng = np.random.default_rng(seed)
        shape = (b, 3, 32, 32) if ncam is None else (b, ncam, 3, 32, 32)
        return rng.random(shape, dtype=np.float32), rng.standard_normal((b, 4)).astype(np.float32)

    def test_forward_queue_and_raise_match_jax(self, pool, tiny):
        from vla_fastvlm_tpu.serving import ShardedPolicyRuntime as JRuntime

        jp, params = tiny
        images, states = self._obs(1)
        tasks = ["move the block"] * 8
        ref = np.asarray(JRuntime(jp, _jmesh(2, 2)).forward(images, states, tasks))
        got = pool.run("t_policy", TINY, params, 2, 2, images, states, tasks, 1)
        for out in got:
            np.testing.assert_allclose(out["forward"], ref, atol=ACTION_ATOL)
            np.testing.assert_allclose(out["queue"][0], ref, atol=ACTION_ATOL)
            assert "not divisible by data-parallel size 2" in out["raise"]
        with pytest.raises(ValueError, match="not divisible"):
            JRuntime(jp, _jmesh(2, 2)).forward(images[:7], states[:7], tasks[:7])

    def test_multicam_chunked_and_select_action(self, pool):
        from vla_fastvlm_tpu.serving import ShardedPolicyRuntime as JRuntime

        kw = dict(num_cameras=2, chunk_size=2)
        jp, params = _jpolicy(seed=5, **kw)
        images, states = self._obs(9, ncam=2)
        tasks = ["stack"] * 8
        jrt = JRuntime(jp, _jmesh(1, 2))
        ref = np.asarray(jrt.forward(images, states, tasks))
        image, state = images[0], states[0]
        ref_one = np.asarray(jrt.select_action(image, state, "go"))
        got = pool.run("t_policy", dict(TINY, **kw), params, 1, 2, images, states, tasks, 2, (image, state, "go"))
        for out in got[:2]:
            assert out["forward"].shape == (8, 2, 4)
            np.testing.assert_allclose(out["forward"], ref, atol=ACTION_ATOL)
            np.testing.assert_allclose(out["queue"][0], ref[:, 0], atol=ACTION_ATOL)
            np.testing.assert_allclose(out["queue"][1], ref[:, 1], atol=ACTION_ATOL)
            np.testing.assert_allclose(out["select"], ref_one, atol=ACTION_ATOL)
        assert got[2] is None and got[3] is None


def _tiny_vlm(seed, tied=True):
    from vla_fastvlm_tpu.models import fastvlm as j_vlm
    from vla_fastvlm_tpu.models import qwen2 as j_qwen

    text_kw = {} if tied else dict(tie_word_embeddings=False)
    jm = j_vlm.FastVLM(j_vlm.fastvlm_tiny().replace(text=j_qwen.qwen2_tiny(**text_kw)))
    params = random_params(jax_param_shapes(jm, jnp.zeros((1, 3, 64, 64)), jnp.ones((1, 8), jnp.int32),
                                            method=j_vlm.FastVLM.forward_logits), seed)  # lm_head too
    params["language_model"]["embed_tokens"]["embedding"] *= 0.1
    return jm, jax.device_get(params), text_kw


def _prompts(b=4, t=10, seed=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 500, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    mask[1, 7:] = 0
    return rng.random((b, 3, 64, 64), dtype=np.float32), ids, mask


class TestShardedGenerate:
    def test_tokens_match_jax_sharded_generate(self, pool):
        from vla_fastvlm_tpu.serving import sharded_generate as j_sharded_generate

        jm, params, text_kw = _tiny_vlm(0)
        images, ids, mask = _prompts()
        ref = np.asarray(j_sharded_generate(jm, params, jnp.asarray(images), jnp.asarray(ids), jnp.asarray(mask),
                                            _jmesh(2, 2), max_new_tokens=6, eos_token_id=-1))
        for placed in (False, True):
            got = pool.run("t_generate", text_kw, params, 2, 2, images, ids, mask, 6, placed=placed)
            for out in got:
                np.testing.assert_array_equal(out, ref)

    def test_lora_tokens_match_jax(self, pool):
        """One adapter at (1, 2); multi-LoRA (rows' ids split over data) at
        (2, 2) over an untied LM head split by vocabulary."""
        from vla_fastvlm_tpu.io import lora as jlora
        from vla_fastvlm_tpu.serving import generate as j_generate

        images, ids, mask = _prompts(seed=5)
        jm, params, text_kw = _tiny_vlm(1)
        adapter = jax.device_get(jax_adapter(params, 4, seed=8))
        ref = np.asarray(j_generate(jm, params, jnp.asarray(images), jnp.asarray(ids), jnp.asarray(mask),
                                    max_new_tokens=6, eos_token_id=-1, lora=adapter))
        got = pool.run("t_generate", text_kw, params, 1, 2, images, ids, mask, 6, lora=adapter)
        for out in got[:2]:
            np.testing.assert_array_equal(out, ref)

        jm, params, text_kw = _tiny_vlm(2, tied=False)
        adapters = [jax.device_get(jax_adapter(params, 4, seed=s)) for s in (11, 12)]
        row_ids = np.array([0, 2, 1, 2], np.int32)
        multi = jlora.lora_with_ids(jlora.stack_loras(adapters), jnp.asarray(row_ids))
        ref = np.asarray(j_generate(jm, params, jnp.asarray(images), jnp.asarray(ids), jnp.asarray(mask),
                                    max_new_tokens=6, eos_token_id=-1, lora=multi))
        got = pool.run("t_generate", text_kw, params, 2, 2, images, ids, mask, 6, lora=adapters, lora_ids=row_ids)
        for out in got:
            np.testing.assert_array_equal(out, ref)
