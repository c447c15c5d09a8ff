"""Port parity: the pipeline schedules (``distriflow_tpu_torch/parallel/
pipeline.py``) and the pipelined LM (``models/transformer.py::
pipelined_transformer_lm``) trained by ``SyncTrainer`` on a mesh with
``pipe`` > 1, against the JAX package on the CPU (JAX's
``test_pipeline.py`` and ``test_pipelined_transformer.py``).

The port runs every case once, in a spawned gloo world of 4 CPU processes
(``tests/torch_mesh_cases.py::pipeline_cases``); JAX runs here on
``devices[:4]``, f32, the kernels off (vocab 64, d 32, 4 heads, 4 layers,
d_ff 64, B 8, S 16):

- identity stages and an MLP stack through ``gpipe`` on ``{pipe 4}``:
  forward within 1e-6 of JAX's; the MLP's gradients of ``sum(out**2)``
  (stage weights and the input) through ``gpipe``, ``gpipe_remat`` and
  ``gpipe_1f1b`` on ``{pipe 4}`` and ``{data 2, pipe 2}`` within 1e-5 of
  JAX's autodiff ``gpipe``;
- the pipelined LM's logits from JAX's weights on ``{pipe 4}``, ``{data 2,
  pipe 2}`` and ``{pipe 2, model 2}`` within 1e-5;
- 3 sgd steps (lr 0.1) of ``SyncTrainer`` under
  ``PIPELINED_TRANSFORMER_RULES`` for each schedule (ZeRO 0, 1 and 2;
  ``grad_accum=2``): per-step losses within 1e-5 relative and every
  gathered parameter within 2e-5 of JAX's trainer, on every rank (the
  embedding and head, replicated over ``pipe``, come out equal on every
  pipe rank). sgd, as the MoE cases of ``test_torch_sync_mesh.py``: adam
  normalises each element's gradient, so an element whose gradient is
  near 0 turns f32 summation-order noise into a step of up to lr (one
  ``v_proj`` element of the 1F1B case moved 2.04e-5 under adam 1e-3);
- an MoE stage's model holds only parameters and trains a step;
- JAX's validation errors;
- the bytes saved for the backward (``saved_tensors_hooks``): remat below
  gpipe, 1F1B the same at M 4 and M 8;
- ``random_pipelined_lm_tree`` has JAX's pipelined tree's paths and
  shapes, and unstacks to ``random_lm_tree``'s parameters of the seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distriflow_tpu.models.transformer import TransformerConfig as JaxConfig
from distriflow_tpu.models.transformer import pipelined_transformer_lm as jax_pipelined_lm
from distriflow_tpu.parallel import sharding as js
from distriflow_tpu.parallel.mesh import create_mesh
from distriflow_tpu.parallel.pipeline import gpipe as jax_gpipe
from distriflow_tpu.train.sync import SyncTrainer as JaxTrainer
from distriflow_tpu.utils.config import MeshConfig
from distriflow_tpu_torch.models.convert import (
    params_from_jax,
    pipelined_params_from_jax,
    pipelined_to_layers,
    random_lm_tree,
    random_pipelined_lm_tree,
)
from distriflow_tpu_torch.models.transformer import TransformerConfig

from torch_mesh_cases import run_world

pytestmark = pytest.mark.port

DIMS = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=4, d_ff=64, max_seq=32)
STEPS = 3
PP4, DP2PP2, PP2TP2 = {"pipe": 4}, {"data": 2, "pipe": 2}, {"pipe": 2, "model": 2}
MESH_ORDER = [("pp4", PP4), ("dp2pp2", DP2PP2), ("pp2tp2", PP2TP2), ("dp4", {"data": 4})]
STAGE_CASES = [("identity_pp4", PP4, "identity", 4, "gpipe"),
               ("mlp_pp4_m8", PP4, "mlp", 8, "gpipe")]
for _s in ("gpipe", "remat", "1f1b"):
    STAGE_CASES += [(f"mlp_pp4_{_s}", PP4, "mlp", 4, _s), (f"mlp_dp2pp2_{_s}", DP2PP2, "mlp", 2, _s)]
LM_CASES = [
    dict(name="logits_pp4", mesh=PP4, logits=True),
    dict(name="logits_dp2pp2", mesh=DP2PP2, logits=True),
    dict(name="logits_pp2tp2", mesh=PP2TP2, logits=True),
    dict(name="gpipe_dp2pp2_zero1", mesh=DP2PP2, zero=1),
    dict(name="remat_pp2tp2", mesh=PP2TP2, cfg=dict(pipeline_schedule="remat")),
    dict(name="1f1b_pp4", mesh=PP4, cfg=dict(pipeline_schedule="1f1b")),
    dict(name="1f1b_dp2pp2_zero2", mesh=DP2PP2, cfg=dict(pipeline_schedule="1f1b"), zero=2),
    dict(name="gpipe_dp2pp2_accum2", mesh=DP2PP2, grad_accum=2),
    dict(name="moe_dp2pp2", mesh=DP2PP2, cfg=dict(n_experts=2), moe=True),
]
for _c in LM_CASES:
    _c.update(optimizer="sgd", lr=0.1)
TRAIN = [c["name"] for c in LM_CASES if not c.get("logits") and not c.get("moe")]
ERROR_CASES = [("pipe1", {"data": 4}, "lm"), ("layers3", PP4, "lm"), ("zigzag", DP2PP2, "lm"),
               ("microbatches", DP2PP2, "microbatches"), ("stages", PP4, "stages")]
ERROR_CFG = {"pipe1": {}, "layers3": {"n_layers": 3}, "zigzag": {"pipeline_schedule": "zigzag"}}
ERROR_MATCH = {"pipe1": "pipe", "layers3": "divisible", "zigzag": "pipeline_schedule",
               "microbatches": "microbatches", "stages": "stages"}


def _batch():
    tok = np.random.RandomState(0).randint(0, 64, (8, 17)).astype(np.int32)
    return tok[:, :-1], tok[:, 1:]


def _stage_inputs():
    rng = np.random.RandomState(1)
    params, xs = {}, {}
    for name, shape, fn, m, _ in STAGE_CASES:
        n = shape["pipe"]
        if fn == "identity":
            params[name] = {"b": np.arange(n, dtype=np.float32).reshape(n, 1)}
            xs[name] = np.arange(16, dtype=np.float32).reshape(8, 2)
        else:
            params[name] = {"w": (rng.randn(n, 4, 4) * 0.5).astype(np.float32),
                            "b": (rng.randn(n, 4) * 0.1).astype(np.float32)}
            xs[name] = rng.randn(16 if m == 8 else 8, 4).astype(np.float32)
    return params, xs


def _jax_mesh(shape, devices):
    return create_mesh(MeshConfig(**shape), devices[:4])


def _jax_stage(name, shape, fn, m, params, x, devices):
    mesh = _jax_mesh(shape, devices)
    stage = {"identity": lambda p, a: a + p["b"],
             "mlp": lambda p, a: jnp.tanh(a @ p["w"]) + p["b"]}[fn]
    jp = jax.tree.map(jnp.asarray, params)
    out = np.asarray(jax.jit(lambda pp, xx: jax_gpipe(stage, pp, xx, mesh, m))(jp, x))
    if fn == "identity":
        return out, None

    def loss(pp, xx):
        return jnp.sum(jax_gpipe(stage, pp, xx, mesh, m) ** 2)

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(jp, jnp.asarray(x))
    grads = {k: np.asarray(v) for k, v in gp.items()}
    grads["x"] = np.asarray(gx)
    return out, grads


def _jax_cfg(case):
    return JaxConfig(**DIMS, dtype=jnp.float32, use_flash_attention=False, **case.get("cfg", {}))


def _port_cfg(case):
    return TransformerConfig(**DIMS, dtype=torch.float32, use_flash_attention=False,
                             **case.get("cfg", {}))


def _jax_lm(case, devices):
    mesh = _jax_mesh(case["mesh"], devices)
    spec = jax_pipelined_lm(_jax_cfg(case), mesh=mesh, example_seq=16)
    trainer = JaxTrainer(spec, mesh=mesh, optimizer="sgd", learning_rate=0.1,
                         param_rules=js.PIPELINED_TRANSFORMER_RULES,
                         zero_level=case.get("zero", 0), grad_accum=case.get("grad_accum", 1))
    trainer.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, trainer.get_params())
    x, y = _batch()
    if case.get("logits"):
        return {"tree": tree, "logits": np.asarray(jax.jit(spec.apply)(tree, x))}
    losses = [trainer.step((x, y)) for _ in range(STEPS)]
    return {"tree": tree, "losses": losses,
            "params": jax.tree_util.tree_map(np.asarray, trainer.get_params())}


@pytest.fixture(scope="module")
def runs(devices):
    stage_params, stage_x = _stage_inputs()
    jax_stages = {name: _jax_stage(name, shape, fn, m, stage_params[name], stage_x[name],
                                   devices)
                  for name, shape, fn, m, _ in STAGE_CASES}
    jax_lm = {c["name"]: _jax_lm(c, devices) for c in LM_CASES if not c.get("moe")}
    rng = np.random.RandomState(2)
    payload = {
        "mesh_order": MESH_ORDER, "stage_cases": STAGE_CASES, "stage_params": stage_params,
        "stage_x": stage_x, "lm_cases": LM_CASES, "dims": DIMS, "steps": STEPS,
        "trees": {k: v["tree"] for k, v in jax_lm.items()}, "batch": _batch(),
        "error_cases": ERROR_CASES, "error_cfg": ERROR_CFG,
        "wide_params": {"w1": (rng.randn(4, 8, 64) * 0.3).astype(np.float32),
                        "w2": (rng.randn(4, 64, 8) * 0.1).astype(np.float32)},
        "wide_x": rng.randn(16, 8).astype(np.float32),
    }
    return jax_stages, jax_lm, run_world(4, "pipeline_cases", payload)


@pytest.mark.parametrize("name", [c[0] for c in STAGE_CASES])
def test_schedules_match_jax_gpipe(runs, name):
    jax_stages, _, ranks = runs
    want_out, want_grads = jax_stages[name]
    for r in ranks:
        out, grads = r["stages"][name]
        np.testing.assert_allclose(out, want_out, rtol=0, atol=1e-6)
        if want_grads is not None:
            for k, w in want_grads.items():
                np.testing.assert_allclose(grads[k], w, rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", ["logits_pp4", "logits_dp2pp2", "logits_pp2tp2"])
def test_pipelined_logits_match_jax(runs, name):
    _, jax_lm, ranks = runs
    for r in ranks:
        np.testing.assert_allclose(r["logits"][name], jax_lm[name]["logits"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", TRAIN)
def test_pipelined_training_matches_jax(runs, name):
    _, jax_lm, ranks = runs
    case = next(c for c in LM_CASES if c["name"] == name)
    ref = jax_lm[name]
    n_stages = case["mesh"]["pipe"]
    want = {n: t.numpy() for n, t in pipelined_params_from_jax(
        ref["params"], _port_cfg(case), n_stages, masters=True).items()}
    for r in ranks:  # every rank: the pipe-replicated leaves agree everywhere
        got = r["train"][name]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
        assert got["losses"][-1] < got["losses"][0]
        assert set(got["params"]) == set(want)
        for n, w in want.items():
            np.testing.assert_allclose(got["params"][n], w, rtol=0, atol=2e-5, err_msg=n)


def test_pipelined_moe_init_holds_only_params(runs):
    _, _, ranks = runs
    for r in ranks:
        only_params, buffers = r["moe"]
        assert only_params and buffers == []
        assert np.isfinite(r["moe_loss"])


@pytest.mark.parametrize("name", [c[0] for c in ERROR_CASES])
def test_validation_errors(runs, name):
    _, _, ranks = runs
    for r in ranks:
        msg = r["errors"][name]
        assert msg is not None and ERROR_MATCH[name] in msg, msg


def test_saved_bytes_remat_below_gpipe_and_1f1b_flat(runs):
    """JAX's ``test_gpipe_remat_activation_memory_drop`` and
    ``test_gpipe_1f1b_memory_flat_in_microbatches``, counted as the bytes
    autograd saves for the backward on each rank."""
    _, _, ranks = runs
    for r in ranks:
        s = r["saved"]
        for m in (4, 8):
            assert s[("remat", m)] < s[("gpipe", m)], s
        assert s[("1f1b", 4)] == s[("1f1b", 8)], s
        assert s[("1f1b", 8)] < s[("remat", 8)], s


def test_pipeline_schedule_builds_and_unknown_is_jax_valueerror():
    for sched in ("gpipe", "remat", "1f1b", "zigzag"):
        assert TransformerConfig(**DIMS, pipeline_schedule=sched).pipeline_schedule == sched


def test_random_pipelined_tree_is_jax_shaped_and_unstacks_to_the_flat_tree(runs):
    _, jax_lm, _ = runs
    cfg = _port_cfg({})
    tree = random_pipelined_lm_tree(cfg, 4, np.random.default_rng(5))
    want = jax.tree_util.tree_map(np.shape, jax_lm["logits_pp4"]["tree"])
    assert jax.tree_util.tree_map(np.shape, tree) == want
    flat = params_from_jax(random_lm_tree(cfg, np.random.default_rng(5)), cfg, masters=True)
    got = pipelined_to_layers(pipelined_params_from_jax(tree, cfg, 4, masters=True), 4)
    assert set(got) == set(flat)
    for n, t in flat.items():
        assert torch.equal(got[n], t), n
