"""Port parity: ``SyncTrainer`` on a mesh (``distriflow_tpu_torch/train/sync.py``
with the mesh-aware ``TransformerLM``) against the JAX package's trainer on
the same mesh, on the CPU.

JAX trains on ``devices[:4]`` of the 8 virtual CPU devices; the port runs
every case once, in a spawned gloo world of 4 CPU processes
(``tests/torch_mesh_cases.py::sync_cases``), from the same weights (JAX's
init, carried over with ``params_from_jax(..., masters=True)``) on the same
global batches (every rank gets the whole batch and trains on its slice).
f32, the kernels off (vocab 64, d 32, 4 heads, 2 layers, S 16), adam
1e-3, 3 steps (sgd 0.1 for the MoE cases: adam normalises each gradient
element, so an element whose gradient is near 0 turns f32 summation-order
noise into a step of up to 2 x lr; one ``q_proj`` element of the top-1
case moved 1.9e-4 that way):

- ``{data 4}``; ``{data 2, model 2}`` under ``TRANSFORMER_TP_RULES`` at
  ZeRO 0, 1 and 2 and with ``grad_accum=2``; ``{data 2, expert 2}`` MoE
  (4 experts, routing groups of 16) with top-1 and top-2; ``{data 2, seq
  2}`` with ring and with Ulysses attention; ``{data 4}`` ZeRO-2 with the
  EMA: per-step losses within 1e-5 relative, every gathered parameter
  (and the EMA) within 2e-5, ``evaluate``'s loss and accuracy within 1e-5;
- the padded partial batch: an MLP on ``{data 4}`` over
  ``DistributedDataset.next_sharded`` with a 6-row last batch (padded to
  8 with 0-weight rows), against JAX on the same mesh and against JAX's
  unpadded one-device steps, within 1e-5;
- ZeRO holds what it should: on every rank the optimizer state of a leaf
  that ``_zero_extend`` shards is the replicated state's bytes / 2 (the
  ``data`` size), the rest as replicated;
- the unsharded save: rank 0 writes the gathered state of the ZeRO-1
  case and a fresh trainer restores it into its blocks and slices (the
  next step's loss equal on every rank).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distriflow_tpu.models import mnist_mlp as jax_mnist_mlp
from distriflow_tpu.models.transformer import TransformerConfig as JaxConfig
from distriflow_tpu.models.transformer import transformer_lm as jax_transformer_lm
from distriflow_tpu.data.dataset import DistributedDataset as JaxDataset
from distriflow_tpu.parallel import sharding as js
from distriflow_tpu.parallel.mesh import create_mesh, data_parallel_mesh
from distriflow_tpu.train.sync import SyncTrainer as JaxTrainer
from distriflow_tpu.utils.config import MeshConfig
from distriflow_tpu_torch.models.convert import params_from_jax, zoo_params_from_jax
from distriflow_tpu_torch.models.transformer import TransformerConfig

from torch_mesh_cases import run_world

pytestmark = pytest.mark.port

DIMS = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=48)
MOE = dict(n_experts=4, moe_group_size=16)
STEPS = 3
LR = 1e-3
CASES = [
    dict(name="dp4", mesh={"data": 4}),
    dict(name="tp_zero0", mesh={"data": 2, "model": 2}, rules="TRANSFORMER_TP_RULES"),
    dict(name="tp_zero1", mesh={"data": 2, "model": 2}, rules="TRANSFORMER_TP_RULES", zero=1,
         all_ranks=True, save=True),
    dict(name="tp_zero2", mesh={"data": 2, "model": 2}, rules="TRANSFORMER_TP_RULES", zero=2,
         all_ranks=True),
    dict(name="tp_accum2", mesh={"data": 2, "model": 2}, rules="TRANSFORMER_TP_RULES",
         grad_accum=2),
    dict(name="ep_top1", mesh={"data": 2, "expert": 2}, rules="TRANSFORMER_TP_RULES",
         cfg=dict(MOE, moe_top_k=1), optimizer="sgd", lr=0.1),
    dict(name="ep_top2", mesh={"data": 2, "expert": 2}, rules="TRANSFORMER_TP_RULES",
         cfg=dict(MOE, moe_top_k=2), optimizer="sgd", lr=0.1),
    dict(name="ring", mesh={"data": 2, "seq": 2}, cfg=dict(use_ring_attention=True)),
    dict(name="ulysses", mesh={"data": 2, "seq": 2}, cfg=dict(use_ulysses_attention=True)),
    dict(name="dp4_zero2_ema", mesh={"data": 4}, zero=2, ema=0.9, all_ranks=True),
    dict(name="padded_mlp", mesh={"data": 4}, mlp=True, optimizer="sgd", lr=0.01),
]
for _c in CASES:
    _c.setdefault("optimizer", "adam")
    _c.setdefault("lr", LR)
    _c["tree"] = _c["name"]
LM_CASES = [c["name"] for c in CASES if not c.get("mlp")]


def _lm_batch():
    tok = np.random.RandomState(1).randint(0, 64, (8, 17)).astype(np.int32)
    return tok[:, :-1], tok[:, 1:]


def _mlp_data():
    rng = np.random.RandomState(0)
    x = rng.randn(22, 28, 28, 1).astype(np.float32)
    return x, np.eye(10, dtype=np.float32)[rng.randint(0, 10, 22)]


def _jax_case(case, devices):
    mesh = create_mesh(MeshConfig(**case["mesh"]), devices[:4])
    rules = getattr(js, case.get("rules", "REPLICATED_RULES"))
    kw = dict(mesh=mesh, optimizer=case["optimizer"], learning_rate=case["lr"],
              param_rules=rules, zero_level=case.get("zero", 0),
              grad_accum=case.get("grad_accum", 1), ema_decay=case.get("ema"))
    if case.get("mlp"):
        trainer = JaxTrainer(jax_mnist_mlp(hidden=8), **kw)
        trainer.init(jax.random.PRNGKey(1))
        tree = jax.tree_util.tree_map(np.asarray, trainer.get_params())
        x, y = _mlp_data()
        ds = JaxDataset(x, y, {"batch_size": 16, "epochs": 1, "small_last_batch": True})
        losses = []
        while True:
            b = ds.next_sharded(mesh)
            if b is None:
                break
            losses.append(trainer.step(b.xyw))
            ds.complete_batch(b.batch)
        x, y = x[:16], y[:16]  # the evaluation batch: one the mesh divides
    else:
        cfg = JaxConfig(**DIMS, dtype=jnp.float32, use_flash_attention=False,
                        **case.get("cfg", {}))
        trainer = JaxTrainer(jax_transformer_lm(cfg, mesh=mesh, example_seq=16), **kw)
        trainer.init(jax.random.PRNGKey(0))
        tree = jax.tree_util.tree_map(np.asarray, trainer.get_params())
        x, y = _lm_batch()
        losses = [trainer.step((x, y)) for _ in range(STEPS)]
    out = {"tree": tree, "losses": losses, "eval": trainer.evaluate(x, y),
           "params": jax.tree_util.tree_map(np.asarray, trainer.get_params())}
    if case.get("ema"):
        out["ema"] = jax.tree_util.tree_map(np.asarray, trainer.ema_params)
    return out


@pytest.fixture(scope="module")
def runs(devices, tmp_path_factory):
    jax_runs = {c["name"]: _jax_case(c, devices) for c in CASES}
    payload = {"cases": CASES, "dims": DIMS, "steps": STEPS,
               "trees": {k: v["tree"] for k, v in jax_runs.items()},
               "batches": {"lm": _lm_batch()}, "mlp_data": _mlp_data(),
               "ckpt_dir": str(tmp_path_factory.mktemp("mesh_ckpt"))}
    return jax_runs, run_world(4, "sync_cases", payload)


def _port_cfg(case):
    return TransformerConfig(**DIMS, dtype=torch.float32, use_flash_attention=False,
                             **case.get("cfg", {}))


def _want(case, tree):
    if case.get("mlp"):
        return {n: t.numpy() for n, t in zoo_params_from_jax(tree).items()}
    return {n: t.numpy() for n, t in params_from_jax(tree, _port_cfg(case), masters=True).items()}


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_mesh_training_matches_jax(runs, name):
    jax_runs, ranks = runs
    case = next(c for c in CASES if c["name"] == name)
    ref, got = jax_runs[name], ranks[0][name]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    for r in ranks[1:]:  # every rank reports the global loss
        np.testing.assert_allclose(r[name]["losses"], got["losses"], rtol=1e-6)
    if not case.get("mlp"):
        assert got["losses"][-1] < got["losses"][0]
    want = _want(case, ref["params"])
    assert set(got["params"]) == set(want)
    for n, w in want.items():
        np.testing.assert_allclose(got["params"][n], w, rtol=0, atol=2e-5, err_msg=n)
    np.testing.assert_allclose(got["eval"], ref["eval"], rtol=1e-5, atol=1e-6)
    if case.get("ema"):
        for n, w in _want(case, ref["ema"]).items():
            np.testing.assert_allclose(got["ema"][n], w, rtol=0, atol=2e-5, err_msg=n)


def test_padded_partial_batch_is_exact(runs, devices):
    """The padded 4-device steps equal JAX's unpadded one-device steps
    (JAX's ``test_partial_batch_padded_exact``)."""
    _, ranks = runs
    x, y = _mlp_data()
    t1 = JaxTrainer(jax_mnist_mlp(hidden=8), mesh=data_parallel_mesh(devices[:1]),
                    learning_rate=0.01)
    t1.init(jax.random.PRNGKey(1))
    want = [t1.step((x[:16], y[:16])), t1.step((x[16:], y[16:]))]
    np.testing.assert_allclose(ranks[0]["padded_mlp"]["losses"], want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["tp_zero1", "tp_zero2", "dp4_zero2_ema"])
def test_zero_holds_a_data_slice_of_the_moments(runs, name):
    _, ranks = runs
    case = next(c for c in CASES if c["name"] == name)
    dp = case["mesh"]["data"]
    sliced = 0
    for r in ranks:
        got = r[name]
        for n, nbytes in got["opt_bytes"].items():
            replicated = 2 * got["param_bytes"][n]  # adam: mu and nu of the local block
            if got["zslices"][n] is None:
                assert nbytes == replicated, n
            else:
                assert nbytes * dp == replicated, n
                sliced += 1
    assert sliced > 0


def test_pipeline_and_sharded_checkpoints_wait_for_the_next_slice(tmp_path):
    """Both are ported now (``tests/test_torch_pipeline.py``,
    ``tests/test_torch_sharded_checkpoint.py``): every schedule builds,
    ``sharded_checkpoints=True`` gives the sharded store, and a mesh with
    ``pipe`` > 1 needs a spec built on it (the pipelined LM)."""
    from distriflow_tpu_torch.checkpoint import ShardedCheckpointStore
    from distriflow_tpu_torch.models.transformer import transformer_lm
    from distriflow_tpu_torch.train.sync import SyncTrainer

    for sched in ("gpipe", "remat", "1f1b"):
        assert TransformerConfig(**DIMS, pipeline_schedule=sched).pipeline_schedule == sched
    spec = transformer_lm(TransformerConfig(**DIMS, dtype=torch.float32), device="cpu")
    trainer = SyncTrainer(spec, checkpoint_dir=str(tmp_path), sharded_checkpoints=True)
    assert isinstance(trainer.store, ShardedCheckpointStore)

    class _PipeMesh:  # SyncTrainer reads only the axis sizes before refusing
        mesh_dim_names = ("data", "model", "seq", "pipe", "expert")
        shape = (1, 1, 1, 2, 1)

    with pytest.raises(ValueError, match="needs a spec built on it"):
        SyncTrainer(spec, mesh=_PipeMesh())


def test_unsharded_save_restores_blocks_and_zero_slices(runs):
    """``save`` on a mesh: rank 0 writes the gathered state (parameters,
    the ZeRO-1 moments, the step); a fresh trainer on the same mesh
    restores it into its own blocks and slices, and the next step of both
    gives the same loss on every rank."""
    _, ranks = runs
    for r in ranks:
        got = r["tp_zero1"]
        assert got["restored"] and got["restored_params_equal"]
        a, b = got["next_losses"]
        assert a == b
