"""The port's four servers on a TP mesh, against the JAX package on the CPU.

In gloo ranks (``_torch_dist.RankPool``) the dense, paged, speculative and
speculative-paged servers run at mesh (1, 2): the target TP-sharded, its
cache or page pools split over KV heads, the draft and the adapters
replicated. Their greedy tokens equal JAX's ``generate`` on the same
weights (the reference JAX's own TP server tests pin their servers to:
``tests/test_paged_kv.py``, ``test_continuous_batching.py``,
``test_speculative.py::TestSpeculativeTP``), with float and int8 weights
and multi-LoRA routed by ``lora_index``; ``decode_impl`` follows JAX's
rule under a mesh ("auto" is "gathered", "kernel" raises). A (2, 2) mesh
replicates the server over ``data``.

Tiny FastVLM (1 image token at 64 px), fp32, weights and adapters from
numpy seeds through ``io/bridge.py``; tokens compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vla_fastvlm_tpu.io import lora as jlora
from vla_fastvlm_tpu.io import quantize as jquantize
from vla_fastvlm_tpu.models import fastvlm as j_vlm
from vla_fastvlm_tpu.models import qwen2 as j_qwen
from vla_fastvlm_tpu.serving import generate as j_generate

from _torch_dist import RankPool
from _torch_parity import jax_adapter, jax_param_shapes, random_params

PROMPT, NEW, PAGE = 8, 5, 4
DENSE = dict(num_slots=3, prompt_len=PROMPT, max_new_tokens=NEW, eos_token_id=-1, prefill_batch=2)
PAGED = dict(DENSE, page_size=PAGE)
ROUTES = [None, 0, 1, 0]


def _requests(n=len(ROUTES), seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        length = int(rng.integers(3, PROMPT + 1))
        ids = np.zeros((1, PROMPT), np.int32)
        mask = np.zeros((1, PROMPT), np.int32)
        ids[0, :length] = rng.integers(3, 500, length)
        mask[0, :length] = 1
        out.append((ids, mask, rng.random((1, 3, 64, 64), dtype=np.float32)))
    return out


REQS = _requests()


def _tiny(seed, quant=None):
    text_kw = {} if quant is None else dict(quantization=quant)
    jm = j_vlm.FastVLM(j_vlm.fastvlm_tiny().replace(text=j_qwen.qwen2_tiny(**text_kw)))
    params = random_params(jax_param_shapes(jm, jnp.zeros((1, 3, 64, 64)), jnp.ones((1, PROMPT), jnp.int32)), seed)
    params["language_model"]["embed_tokens"]["embedding"] *= 0.1
    if quant:
        params = jquantize.quantize_params(params, mode=quant)
    return jm, jax.device_get(params)


def _jax_tokens(jm, params, lora=None):
    imgs, ids, mask = (jnp.asarray(np.concatenate([r[i] for r in REQS])) for i in (2, 0, 1))
    return np.asarray(j_generate(jm, params, imgs, ids, mask, max_new_tokens=NEW, eos_token_id=-1, lora=lora))


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(4, tmp_path_factory.mktemp("ranks"))
    yield p
    p.close()


@pytest.fixture(scope="module")
def base():
    jm, params = _tiny(3)
    return params, _jax_tokens(jm, params)


def _check(results, ref, ranks=(0, 1)):
    for rank in ranks:
        np.testing.assert_array_equal(np.array(results[rank]["tokens"]), ref, err_msg=f"rank {rank}")


@pytest.mark.parametrize("kind,kw", [("dense", DENSE), ("paged", PAGED)])
def test_plain_servers_match_jax(pool, base, kind, kw):
    params, ref = base
    got = pool.run("t_server", kind, ({}, params), None, 1, 2, REQS, kw=kw)
    _check(got, ref)
    assert got[2] is None and got[3] is None
    if kind == "paged":
        assert got[0]["decode_impl"] == "gathered" and got[0]["pool_heads"] == 1  # 2 KV heads over 2
    else:
        assert got[0]["cache_heads"] == 1


def test_data_axis_replicates_the_server(pool, base):
    params, ref = base
    _check(pool.run("t_server", "paged", ({}, params), None, 2, 2, REQS, kw=PAGED), ref, ranks=range(4))


def test_kernel_decode_under_a_mesh_raises(pool, base):
    from vla_fastvlm_tpu.serving.paged_kv import PagedGenerationServer as JPaged

    params, _ = base
    jm, _ = _tiny(3)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
    with pytest.raises(ValueError, match="gathered"):
        JPaged(jm, params, mesh=mesh, decode_impl="kernel", **PAGED)
    with pytest.raises(RuntimeError, match="decode_impl='gathered'"):
        pool.run("t_server", "paged", ({}, params), None, 1, 2, REQS, kw=dict(PAGED, decode_impl="kernel"))


@pytest.mark.parametrize("kind,kw", [("spec", DENSE), ("spec_paged", PAGED)])
def test_speculative_servers_match_jax(pool, base, kind, kw):
    """Greedy speculative tokens are the target's greedy tokens."""
    params, ref = base
    _, draft = _tiny(5)
    got = pool.run("t_server", kind, ({}, params), ({}, draft), 1, 2, REQS, kw=dict(kw, k=2))
    _check(got, ref)


def test_int8_weights_match_jax(pool):
    jm, params = _tiny(7, quant="int8")
    ref = _jax_tokens(jm, params)
    got = pool.run("t_server", "paged", ({"quantization": "int8"}, params), None, 1, 2, REQS, quant="int8",
                   kw=PAGED)
    _check(got, ref)


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_multi_lora_matches_jax(pool, base, kind):
    params, _ = base
    jm, _ = _tiny(3)
    adapters = [jax.device_get(jax_adapter(params, 4, seed=7 + i)) for i in (1, 2)]
    ids = jnp.asarray([0 if r is None else r + 1 for r in ROUTES], jnp.int32)
    ref = _jax_tokens(jm, params, jlora.lora_with_ids(jlora.stack_loras(adapters), ids))
    got = pool.run("t_server", kind, ({}, params), None, 1, 2, REQS, routes=ROUTES, lora=adapters,
                   kw=PAGED if kind == "paged" else DENSE)
    _check(got, ref)
