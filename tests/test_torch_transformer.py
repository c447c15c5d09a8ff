"""Port parity: the dense decoder (``distriflow_tpu_torch/models/transformer.py``)
and the weight carry-over (``models/convert.py``).

The tiny config of the JAX package's paged-KV tests, initialised once in
JAX and carried over with ``params_from_jax``. At f32 with the kernels off
in both packages, training-mode, prefill and decode logits agree within
1e-4 (same arithmetic; sums in another order). At bf16 with the JAX
kernels on (Pallas interpret) and the port's kernel paths on (their plain
versions on the CPU), logits agree within 0.05: the logits reach about 3,
where bf16's spacing is 2**-6 = 0.016, and the two frameworks round the
projections at different points (measured worst case 0.025).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distriflow_tpu.models.transformer import TransformerConfig as JaxConfig
from distriflow_tpu.models.transformer import TransformerLM as JaxLM
from distriflow_tpu.models.transformer import apply_rope as jax_rope
from distriflow_tpu.models.transformer import transformer_lm
from distriflow_tpu_torch.models.convert import lm_from_jax, params_from_jax
from distriflow_tpu_torch.models.generate import paged_cache, slot_cache
from distriflow_tpu_torch.models.transformer import TransformerConfig, apply_rope

pytestmark = pytest.mark.port
torch.set_num_threads(2)

JCFG = JaxConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=48,
                 dtype=jnp.float32, use_flash_attention=False, use_flash_decode=False)
PCFG = TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=48,
                         dtype=torch.float32, use_flash_attention=False, use_flash_decode=False)
BF16 = {"jax": dataclasses.replace(JCFG, dtype=jnp.bfloat16, use_flash_attention=True,
                                   use_flash_decode=True),
        "port": dataclasses.replace(PCFG, dtype=torch.bfloat16, use_flash_attention=True,
                                    use_flash_decode=True)}


@pytest.fixture(scope="module")
def params():
    p = transformer_lm(JCFG, example_seq=16).init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, p)


def _prompt(b=2, s=11, seed=1):
    return np.random.RandomState(seed).randint(0, 64, (b, s)).astype(np.int32)


def _jax_decode(cfg, params, prompt, steps):
    """JAX prefill + greedy single-token decode steps: logits per call."""
    apply = jax.jit(lambda v, t: JaxLM(cfg, decode=True).apply(v, t, mutable=["cache"]))
    logits, vars_ = apply(params, jnp.asarray(prompt))
    out = [np.asarray(logits, np.float32)]
    tok = jnp.argmax(logits[:, -1], -1)
    for _ in range(steps):
        logits, vars_ = apply({**params, "cache": vars_["cache"]}, tok[:, None])
        out.append(np.asarray(logits, np.float32))
        tok = jnp.argmax(logits[:, -1], -1)
    return out


def _port_decode(model, prompt, steps):
    logits, cache = model.decode(torch.from_numpy(prompt))
    out = [logits.numpy()]
    tok = logits[:, -1].argmax(-1)
    for _ in range(steps):
        logits, cache = model.decode(tok[:, None], cache)
        out.append(logits.numpy())
        tok = logits[:, -1].argmax(-1)
    return out


def test_config_keeps_jax_field_names_and_refuses_unported_paths():
    assert {f.name for f in dataclasses.fields(PCFG)} == {f.name for f in dataclasses.fields(JCFG)}
    hash(PCFG)
    # the sequence-parallel paths are ported: each builds, both at once is
    # JAX's ValueError
    for sp in ("use_ring_attention", "use_ulysses_attention"):
        assert getattr(TransformerConfig(**{sp: True}), sp)
    for cls in (TransformerConfig, JaxConfig):
        with pytest.raises(ValueError, match="mutually exclusive"):
            cls(use_ring_attention=True, use_ulysses_attention=True)
    # MoE builds; its top-k range is JAX's check
    for bad_k in (0, 5):
        with pytest.raises(ValueError):
            TransformerConfig(n_experts=4, moe_top_k=bad_k)
        with pytest.raises(ValueError):
            JaxConfig(n_experts=4, moe_top_k=bad_k)
    assert TransformerConfig(n_experts=4, moe_top_k=4).n_experts == 4
    with pytest.raises(TypeError):
        TransformerConfig(dtype="bfloat16")
    # the pipeline schedules are ported (tests/test_torch_pipeline.py): the
    # config takes any name, as JAX's does; the pipelined LM checks it
    for sched in ("gpipe", "remat", "1f1b"):
        assert TransformerConfig(pipeline_schedule=sched).pipeline_schedule == sched


@pytest.mark.parametrize("per_row", [False, True])
def test_rope_matches_jax(per_row):
    rng = np.random.RandomState(0)
    q, k = rng.randn(2, 3, 5, 8).astype(np.float32), rng.randn(2, 3, 5, 8).astype(np.float32)
    off = np.array([3, 17], np.int32) if per_row else 7
    jq, jk = jax_rope(jnp.asarray(q), jnp.asarray(k), offset=jnp.asarray(off))
    pq, pk = apply_rope(torch.from_numpy(q), torch.from_numpy(k),
                        offset=torch.from_numpy(off) if per_row else off)
    np.testing.assert_allclose(pq.numpy(), np.asarray(jq), rtol=0, atol=1e-5)
    np.testing.assert_allclose(pk.numpy(), np.asarray(jk), rtol=0, atol=1e-5)


def test_carry_over_covers_every_parameter(params):
    sd = params_from_jax(params, PCFG)
    model = lm_from_jax(PCFG, params, device="cpu")
    assert set(sd) == set(model.state_dict())
    np.testing.assert_array_equal(
        model.layers[1].attn.o_proj.numpy(),
        params["params"]["layers_1"]["attn"]["o_proj"]["kernel"].reshape(32, 32))


def test_f32_forward_prefill_and_decode_logits_match_jax(params):
    model = lm_from_jax(PCFG, params, device="cpu")
    prompt = _prompt()
    train = np.asarray(JaxLM(JCFG).apply(params, jnp.asarray(prompt)), np.float32)
    np.testing.assert_allclose(model(torch.from_numpy(prompt)).numpy(), train, rtol=0, atol=1e-4)
    for ours, ref in zip(_port_decode(model, prompt, 4), _jax_decode(JCFG, params, prompt, 4)):
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)


def test_bf16_with_kernels_on_matches_jax_interpret(params):
    model = lm_from_jax(BF16["port"], params, device="cpu")
    prompt = _prompt(b=1, s=13, seed=4)
    ours = _port_decode(model, prompt, 3)
    ref = _jax_decode(BF16["jax"], params, prompt, 3)
    for o, r in zip(ours, ref):
        assert o.dtype == np.float32
        np.testing.assert_allclose(o, r, rtol=0, atol=0.05)


def test_out_of_range_cache_writes_drop(params):
    """JAX scatters drop out-of-range indices; the port masks them."""
    model = lm_from_jax(PCFG, params, device="cpu")
    tok = torch.tensor([[3], [5]])
    # slot slabs: row 1 parked at max_seq (a frozen slot) writes nothing
    cache = slot_cache(PCFG, 2, "cpu")
    cache.index = torch.tensor([4, PCFG.max_seq], dtype=torch.int32)
    model.decode(tok, cache)
    assert cache.k[0][1].abs().sum() == 0 and cache.k[0][0, 4].abs().sum() > 0
    # paged: row 1's table is all sentinel, so its write lands nowhere
    pcache = paged_cache(PCFG, 2, 16, 4, "cpu")
    table = pcache.page_table.clone()
    table[0, :3] = torch.tensor([2, 0, 1])
    pcache.set_page_table(table)
    pcache.index = torch.tensor([17, 5], dtype=torch.int32)
    model.decode(tok, pcache)
    written = [int(p) for p in range(4) if pcache.k[0][p].abs().sum() > 0]
    assert written == [0]  # logical position 17 -> page slot 0, offset 1
    assert pcache.k[0][0, 1].abs().sum() > 0
