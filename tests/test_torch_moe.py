"""Port parity: MoE on one device (``MoEFFN``, ``Block``/``TransformerLM``
with experts, ``apply_with_aux``, the MoE weight carry-over, the FLOP
tally); the trainer in ``test_torch_moe_train.py``, every decoding path
in ``test_torch_moe_decode.py``, both on this file's configs.

Every case starts from JAX's weights (``transformer_lm(...).init`` or
``MoEFFN.init``) carried over with ``params_from_jax``, on inputs drawn
from a numpy seed. Tolerances:

- ``MoEFFN`` alone, at f32 and at bf16 (JAX's promotion: the LayerNorm'd
  input is f32, so the expert contractions run in f32 over bf16-rounded
  weights and the output is f32 on both sides): output atol 1e-5
  (measured 3e-8 to 7e-8, f32 sums in another order), ``dropped_fraction``
  exactly, the load-balance term 1e-6 relative.
- The whole LM at f32: logits atol 1e-4 and the aux term 1e-6 relative
  (the dense LM's limit in ``test_torch_transformer.py``).
- The FLOP tally: ``FlopCounterMode``'s count of one MoE layer's forward
  equals the sum of ``moe_phase_fwd_flops``'s four phases exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from distriflow_tpu.models.transformer import MoEFFN as JaxMoE
from distriflow_tpu.models.transformer import TransformerConfig as JaxConfig
from distriflow_tpu.models.transformer import transformer_lm as jax_transformer_lm
from distriflow_tpu.parallel.ring_attention import _auto_block as jax_auto_block
from distriflow_tpu_torch.models.convert import lm_from_jax, params_from_jax, random_lm_tree
from distriflow_tpu_torch.models.transformer import (
    MoEFFN,
    TransformerConfig,
    TransformerLM,
    _auto_block,
    moe_phase_fwd_flops,
    transformer_lm,
)

pytestmark = pytest.mark.port
torch.set_num_threads(2)

DIMS = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=48,
            n_experts=4, moe_group_size=16)
JCFG = JaxConfig(**DIMS, dtype=jnp.float32, use_flash_attention=False, use_flash_decode=False,
                 loss="sparse_softmax_cross_entropy")
PCFG = TransformerConfig(**DIMS, dtype=torch.float32, use_flash_attention=False,
                         use_flash_decode=False, loss="sparse_softmax_cross_entropy")
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(**kw):
    return dataclasses.replace(JCFG, **kw), dataclasses.replace(PCFG, **kw)


def _lm_params(jcfg, seed=0):
    p = jax_transformer_lm(jcfg, example_seq=16).init(jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, p)


# -- MoEFFN alone --------------------------------------------------------------

# (top_k, capacity_factor, dense dispatch, batch, seq, zero router)
FFN_CASES = {
    "top1_ample": (1, 8.0, False, 2, 16, False),
    "top2_ample": (2, 8.0, False, 2, 16, False),
    "top2_tight_0.3": (2, 0.3, False, 2, 16, False),
    "top1_tight_0.125": (1, 0.125, False, 1, 16, False),
    "top2_tight_0.125": (2, 0.125, False, 1, 16, False),
    "uneven_group": (2, 1.0, False, 2, 21, False),  # 42 tokens: groups of 14
    "ties_top1": (1, 1.0, False, 2, 16, True),
    "ties_top2": (2, 1.0, False, 2, 16, True),
    "dense_k1": (1, 0.125, True, 2, 16, False),
    "dense_k2": (2, 0.125, True, 2, 16, False),
}


def _ffn_pair(case, mode):
    k, factor, dense, b, s, zero_router = FFN_CASES[case]
    jdt, pdt = DTYPES[mode]
    jcfg, pcfg = _cfgs(moe_top_k=k, capacity_factor=factor, moe_dense_dispatch=dense)
    jcfg, pcfg = dataclasses.replace(jcfg, dtype=jdt), dataclasses.replace(pcfg, dtype=pdt)
    x = np.random.RandomState(b * 100 + s).randn(b, s, jcfg.d_model).astype(np.float32)
    jmod = JaxMoE(jcfg)
    params = jax.tree_util.tree_map(
        np.asarray, jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    if zero_router:  # every probability 1/E: every choice is a tie
        params["router"]["kernel"] = np.zeros_like(params["router"]["kernel"])
    port = MoEFFN(pcfg)
    port.load_state_dict({"experts_wi": torch.tensor(params["experts_wi"]).to(pdt),
                          "experts_wo": torch.tensor(params["experts_wo"]).to(pdt),
                          "router.kernel": torch.tensor(params["router"]["kernel"]),
                          "router.bias": torch.tensor(params["router"]["bias"])})
    return jmod, params, port, x


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(FFN_CASES))
def test_moe_ffn_matches_jax(case, mode):
    jmod, params, port, x = _ffn_pair(case, mode)
    want, sown = jmod.apply({"params": params}, jnp.asarray(x), mutable=["aux", "moe_stats"])
    with torch.no_grad():
        got, aux = port(torch.tensor(x))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    if FFN_CASES[case][2]:  # dense dispatch sows nothing
        assert not jax.tree.leaves(sown) and aux is None and port.dropped_fraction is None
        return
    (drop,), (lb,) = jax.tree.leaves(sown["moe_stats"]), jax.tree.leaves(sown["aux"])
    assert port.dropped_fraction.dtype == torch.float32
    assert port.dropped_fraction.numpy() == np.asarray(drop), (port.dropped_fraction, drop)
    np.testing.assert_allclose(float(aux), float(lb), rtol=1e-6)
    if case.startswith("ties"):
        # every token's choices are experts 0 (and 1): the lower index wins,
        # and only those experts' slots fill
        assert float(drop) >= 0.5
    if "tight" in case:
        assert float(drop) > 0.0
    if "ample" in case:
        assert float(drop) == 0.0


def test_auto_block_matches_jax():
    for n in range(1, 300):
        for target in (1, 7, 16, 64, 1024):
            assert _auto_block(n, target) == jax_auto_block(n, target), (n, target)


def test_router_is_f32_in_the_serving_model():
    model = TransformerLM(dataclasses.replace(PCFG, dtype=torch.bfloat16), device="cpu")
    names = dict(model.named_parameters())
    assert names["layers.0.moe.router.kernel"].dtype == torch.float32
    assert names["layers.0.moe.router.bias"].dtype == torch.float32
    assert names["layers.0.moe.experts_wi"].dtype == torch.bfloat16
    assert tuple(names["layers.1.moe.experts_wo"].shape) == (4, 64, 32)
    assert not any(".mlp." in n for n in names)


# -- the whole LM ---------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2])
def test_lm_logits_and_aux_match_jax(k):
    jcfg, pcfg = _cfgs(moe_top_k=k, capacity_factor=1.0)
    params = _lm_params(jcfg)
    jspec = jax_transformer_lm(jcfg, example_seq=16)
    spec = transformer_lm(pcfg, device="cpu")
    assert spec.apply_with_aux is not None
    model = lm_from_jax(pcfg, params, device="cpu")
    tok = np.random.RandomState(2).randint(0, 64, (3, 17)).astype(np.int32)
    x, y = tok[:, :-1], tok[:, 1:]
    jlogits, jaux = jspec.apply_with_aux(params, jnp.asarray(x))
    with torch.no_grad():
        logits, aux = spec.apply_with_aux(model, torch.tensor(x))
        plain = spec.apply(model, torch.tensor(x))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(plain.numpy(), logits.numpy())
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    drops = [float(b.moe.dropped_fraction) for b in model.layers]
    assert any(d > 0 for d in drops), drops  # capacity 1.0 drops some pairs
    # the training loss adds the term; eval metrics leave it out, as JAX's
    with torch.no_grad():
        loss = float(spec.loss_fn(model, torch.tensor(x), torch.tensor(y)))
        (metric,) = spec.metrics_fn(["loss"])(model, torch.tensor(x), torch.tensor(y))
    np.testing.assert_allclose(loss, float(jspec.loss_fn(params, jnp.asarray(x), jnp.asarray(y))),
                               rtol=1e-5)
    np.testing.assert_allclose(loss - float(metric), float(aux), rtol=1e-4)


def test_apply_with_aux_only_for_capacity_routing():
    assert transformer_lm(dataclasses.replace(PCFG, moe_dense_dispatch=True),
                          device="cpu").apply_with_aux is None
    assert transformer_lm(dataclasses.replace(PCFG, router_aux_weight=0.0),
                          device="cpu").apply_with_aux is None
    assert transformer_lm(dataclasses.replace(PCFG, n_experts=0),
                          device="cpu").apply_with_aux is None


def test_random_tree_keeps_the_dense_draw_order_and_loads_moe():
    dense = dataclasses.replace(PCFG, n_experts=0)
    a = random_lm_tree(dense, np.random.default_rng(5))["params"]
    b = random_lm_tree(PCFG, np.random.default_rng(5))["params"]
    # the same draws up to each layer's FFN: the embedding, head and layer 0's attention
    np.testing.assert_array_equal(a["embed"]["embedding"], b["embed"]["embedding"])
    np.testing.assert_array_equal(a["layers_0"]["attn"]["o_proj"]["kernel"],
                                  b["layers_0"]["attn"]["o_proj"]["kernel"])
    moe = b["layers_0"]["moe"]
    assert moe["experts_wi"].shape == (4, 32, 64) and moe["experts_wo"].shape == (4, 64, 32)
    assert not moe["router"]["bias"].any()
    np.testing.assert_allclose(moe["experts_wi"].std(), 1 / np.sqrt(4 * 32), rtol=0.1)
    sd = params_from_jax({"params": b}, PCFG, masters=True)
    assert all(t.dtype == torch.float32 for t in sd.values())
    serving = params_from_jax({"params": b}, dataclasses.replace(PCFG, dtype=torch.bfloat16))
    assert serving["layers.1.moe.experts_wi"].dtype == torch.bfloat16
    assert serving["layers.1.moe.router.kernel"].dtype == torch.float32
    lm_from_jax(PCFG, {"params": b}, device="cpu")  # strict load: every name matches


def test_init_weights_uses_flax_fan_ins():
    params = transformer_lm(PCFG, device="cpu").init(3).state_dict()
    e, d, f = PCFG.n_experts, PCFG.d_model, PCFG.d_ff
    for name, fan_in in (("layers.0.moe.experts_wi", e * d), ("layers.1.moe.experts_wo", e * f),
                         ("layers.0.moe.router.kernel", d)):
        np.testing.assert_allclose(float(params[name].std()), fan_in ** -0.5, rtol=0.1,
                                   err_msg=name)
    assert not params["layers.1.moe.router.bias"].any()


# -- the FLOP tally ------------------------------------------------------------------


@pytest.mark.parametrize("k,b,s,group", [(1, 2, 16, 16), (2, 2, 16, 16), (2, 3, 14, 16)])
def test_flop_counter_sees_the_four_phases(k, b, s, group):
    cfg = dataclasses.replace(PCFG, moe_top_k=k, moe_group_size=group, capacity_factor=1.25)
    mod = MoEFFN(cfg)
    with torch.no_grad():
        for p in mod.parameters():
            p.normal_()
    x = torch.randn(b, s, cfg.d_model)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        mod(x)
    phases = moe_phase_fwd_flops(cfg, b * s)
    assert counter.get_total_flops() == sum(phases.values()), (counter.get_total_flops(), phases)
