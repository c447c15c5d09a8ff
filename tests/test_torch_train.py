"""Port parity: the training slice (``distriflow_tpu_torch/train/sync.py``,
``models/base.py``, the trainable ``TransformerLM``, ``checkpoint/``).

The port's ``SyncTrainer`` against JAX's ``SyncTrainer`` on a one-device
mesh, from the same weights (JAX's init, carried over as f32 masters by
``params_from_jax(..., masters=True)``), on one seeded batch: the per-step
losses and every parameter after 3 steps, for sgd and adam,

- at f32 with the kernels off on both sides: losses 1e-5 relative,
  parameters 2e-5 (the same arithmetic, sums in another order; measured
  1.2e-7 and 5.8e-7);
- at bf16 with flash attention and the fused CE on both sides (JAX's
  Pallas in interpret mode, the port's plain versions): losses 2e-3
  relative; parameters 1e-3 with sgd and, with adam, 2 x lr per step
  (6e-3). bf16 rounds the projections at other points in the two
  frameworks, and adam normalises each gradient element, so an element
  whose small gradient changes sign moves by up to 2 x lr per step
  (measured: losses 2.2e-4 relative, parameters 2.6e-4 sgd, 3.5e-3 adam).

Then the trainer's own contracts: ``grad_accum``, the EMA (against JAX's),
``remat``, checkpoint save/restore, and all six optimizers' updates
against optax, including the ``frozen_`` mask and a schedule.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distriflow_tpu.models.base import _optimizer as jax_optimizer
from distriflow_tpu.models.transformer import TransformerConfig as JaxConfig
from distriflow_tpu.models.transformer import transformer_lm as jax_transformer_lm
from distriflow_tpu.parallel import data_parallel_mesh
from distriflow_tpu.train.sync import SyncTrainer as JaxTrainer
from distriflow_tpu_torch.models.base import Optimizer, SpecModel, apply_updates
from distriflow_tpu_torch.models.convert import params_from_jax
from distriflow_tpu_torch.models.transformer import TransformerConfig, transformer_lm
from distriflow_tpu_torch.train.sync import SyncTrainer
from distriflow_tpu_torch.utils.config import CompileConfig

pytestmark = pytest.mark.port
torch.set_num_threads(2)

DIMS = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=48)
JCFG = JaxConfig(**DIMS, dtype=jnp.float32, use_flash_attention=False,
                 loss="sparse_softmax_cross_entropy")
PCFG = TransformerConfig(**DIMS, dtype=torch.float32, use_flash_attention=False,
                         loss="sparse_softmax_cross_entropy")
KERNELS = {"jax": dataclasses.replace(JCFG, dtype=jnp.bfloat16, use_flash_attention=True,
                                      loss="fused_sparse_softmax_cross_entropy"),
           "port": dataclasses.replace(PCFG, dtype=torch.bfloat16, use_flash_attention=True,
                                       loss="fused_sparse_softmax_cross_entropy")}
LR = {"sgd": 0.1, "adam": 1e-3}
STEPS = 3
# (loss rel, param abs) by (mode, optimizer)
TOL = {("f32", "sgd"): (1e-5, 2e-5), ("f32", "adam"): (1e-5, 2e-5),
       ("bf16", "sgd"): (2e-3, 1e-3), ("bf16", "adam"): (2e-3, 2 * LR["adam"] * STEPS)}


def _batch(b=4, s=16, seed=1):
    tok = np.random.RandomState(seed).randint(0, 64, (b, s + 1)).astype(np.int32)
    return tok[:, :-1], tok[:, 1:]


def _jax_run(cfg, optimizer, batch, devices, **kw):
    trainer = JaxTrainer(jax_transformer_lm(cfg, example_seq=16), mesh=data_parallel_mesh(devices[:1]),
                         optimizer=optimizer, learning_rate=LR[optimizer], **kw)
    trainer.init(jax.random.PRNGKey(0))
    init = jax.tree_util.tree_map(np.asarray, trainer.get_params())
    losses = [trainer.step(batch) for _ in range(STEPS)]
    return trainer, init, losses


def _port_trainer(cfg, optimizer, init, **kw):
    trainer = SyncTrainer(transformer_lm(cfg, device="cpu"), optimizer=optimizer,
                          learning_rate=LR[optimizer], **kw)
    trainer.init()
    trainer.set_params(params_from_jax(init, cfg, masters=True))
    return trainer


def _assert_params(port_params, jax_tree, cfg, atol):
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_tree), cfg, masters=True)
    assert set(port_params) == set(want)
    for name, ref in want.items():
        np.testing.assert_allclose(port_params[name].numpy(), ref.numpy(), rtol=0, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_sync_trainer_matches_jax_step_for_step(devices, mode, optimizer):
    jcfg, pcfg = (JCFG, PCFG) if mode == "f32" else (KERNELS["jax"], KERNELS["port"])
    batch = _batch()
    jtrainer, init, jlosses = _jax_run(jcfg, optimizer, batch, devices)
    trainer = _port_trainer(pcfg, optimizer, init)
    assert all(p.dtype == torch.float32 and p.requires_grad for p in trainer.model.parameters())
    losses = [trainer.step(batch) for _ in range(STEPS)]
    loss_rel, param_atol = TOL[mode, optimizer]
    np.testing.assert_allclose(losses, jlosses, rtol=loss_rel)
    assert trainer.version == STEPS and losses[-1] < losses[0]
    _assert_params(trainer.get_params(), jtrainer.get_params(), pcfg, param_atol)


def test_ema_matches_jax(devices):
    batch = _batch(seed=2)
    jtrainer, init, _ = _jax_run(JCFG, "sgd", batch, devices, ema_decay=0.9)
    trainer = _port_trainer(PCFG, "sgd", init, ema_decay=0.9)
    for _ in range(STEPS):
        trainer.step(batch)
    _assert_params(trainer.ema_params, jtrainer.ema_params, PCFG, 2e-5)
    ref = jtrainer.evaluate(*batch, use_ema=True)
    got = trainer.evaluate(*batch, use_ema=True)
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    # the EMA swap leaves the live weights as they were
    _assert_params(trainer.get_params(), jtrainer.get_params(), PCFG, 2e-5)


def test_grad_accum_equals_one_full_batch_step():
    x, y = _batch(b=8, seed=3)
    w = np.array([1, 1, 0, 2, 1, 0.5, 1, 1], np.float32)
    one = SyncTrainer(transformer_lm(PCFG, device="cpu"), optimizer="adam", learning_rate=1e-2)
    acc = SyncTrainer(transformer_lm(PCFG, device="cpu"), optimizer="adam", learning_rate=1e-2,
                      grad_accum=2)
    one.init(5)
    acc.init(5)
    for _ in range(2):
        assert acc.step((x, y, w)) == pytest.approx(one.step((x, y, w)), rel=1e-5)
    for n, p in one.get_params().items():
        torch.testing.assert_close(acc.get_params()[n], p, rtol=0, atol=2e-5)
    with pytest.raises(ValueError, match="not divisible"):
        SyncTrainer(transformer_lm(PCFG, device="cpu"), grad_accum=3).step((x, y))


def test_remat_gives_the_same_gradients():
    x, y = (torch.from_numpy(t) for t in _batch(seed=4))
    grads = []
    for remat in (False, True):
        spec = transformer_lm(dataclasses.replace(PCFG, remat=remat), device="cpu")
        model = spec.init(7)
        grads.append(spec.grad_fn()(model, x, y))
    (l0, g0), (l1, g1) = grads
    assert float(l0) == float(l1)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=0, atol=1e-7)


def test_checkpoint_save_restore_round_trip(tmp_path):
    batch = _batch(seed=5)
    spec = transformer_lm(PCFG, device="cpu")
    trainer = SyncTrainer(spec, optimizer="adam", learning_rate=1e-2, ema_decay=0.5,
                          checkpoint_dir=str(tmp_path), save_every=2)
    trainer.init(3)
    for _ in range(2):
        trainer.step(batch)  # the second step auto-saves version 2
    trainer.flush_saves()
    saved = trainer.get_params()
    ema = trainer.ema_params
    after = [trainer.step(batch) for _ in range(2)]
    trainer.flush_saves()
    assert trainer.store.list() == ["2", "4"]

    fresh = SyncTrainer(spec, optimizer="adam", learning_rate=1e-2, ema_decay=0.5,
                        checkpoint_dir=str(tmp_path))
    assert fresh.restore("2") and fresh.version == 2
    for n, p in saved.items():
        assert torch.equal(fresh.get_params()[n], p)
        assert torch.equal(fresh.ema_params[n], ema[n])
    # the optimizer state came back too: the next steps repeat exactly
    assert [fresh.step(batch) for _ in range(2)] == after
    assert fresh.restore() and fresh.version == 4
    trainer.close()
    fresh.close()


def test_spec_model_fit_update_is_one_trainer_step():
    batch = _batch(seed=6)
    spec = transformer_lm(PCFG, device="cpu")
    trainer = SyncTrainer(spec, optimizer="momentum", learning_rate=0.05)
    trainer.init(2)
    model = SpecModel(spec, learning_rate=0.05, seed=2,
                      compile_config=CompileConfig(optimizer="momentum"))
    for _ in range(2):
        loss = trainer.step(batch)
        model.update(model.fit(*batch))
        assert model.last_loss == pytest.approx(loss, rel=1e-6)
    for n, p in trainer.get_params().items():
        torch.testing.assert_close(model.get_params()[n], p, rtol=0, atol=1e-6)
    assert model.predict(batch[0]).shape == (4, 16, 64)
    assert len(model.evaluate(*batch)) == 2


def test_unported_options_raise():
    spec = transformer_lm(PCFG, device="cpu")
    for kw in (dict(mesh=object()), dict(param_rules=object()), dict(zero_level=1),
               dict(zero_optimizer_sharding=True), dict(sharded_checkpoints=True)):
        with pytest.raises(NotImplementedError):
            SyncTrainer(spec, **kw)
    trainer = SyncTrainer(spec)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        trainer.mfu(_batch())


@pytest.mark.parametrize("name", Optimizer.NAMES)
def test_optimizer_updates_match_optax(name):
    rng = np.random.RandomState(0)
    shapes = {"w": (3, 4), "b": (4,), "layer.frozen_scale": (4,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    lr = (lambda step: 0.1 / (1 + step)) if name == "sgd" else 0.05
    tx = jax_optimizer(name, lr)
    # optax's mask reads a dict's leaf names: nest the dotted name once
    jtree = lambda d: {"w": d["w"], "b": d["b"], "layer": {"frozen_scale": d["layer.frozen_scale"]}}
    jparams = jax.tree_util.tree_map(jnp.asarray, jtree(params))
    jstate = tx.init(jparams)
    opt = Optimizer(name, lr)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = opt.init(tparams)
    assert "layer.frozen_scale" not in state.get("mu", state.get("trace", {}))
    for step in range(3):
        grads = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
        jupd, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, jtree(grads)), jstate, jparams)
        jparams = optax.apply_updates(jparams, jupd)
        upd, state = opt.update({k: torch.from_numpy(v) for k, v in grads.items()}, state, tparams)
        for k in shapes:
            ref = np.asarray(_leaf(jupd, k))
            np.testing.assert_allclose(upd[k].numpy(), ref, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{name} step {step} {k}")
        apply_updates(tparams, upd)
    # a frozen_ leaf's update is its gradient, passed through as optax.masked does
    np.testing.assert_array_equal(upd["layer.frozen_scale"].numpy(), grads["layer.frozen_scale"])


def _leaf(tree, dotted):
    for part in dotted.split("."):
        tree = tree[part]
    return tree


def test_trainable_and_serving_models_store_weights_as_built():
    from distriflow_tpu_torch.models.transformer import TransformerLM

    cfg = KERNELS["port"]
    serve = TransformerLM(cfg, device="cpu")
    train = TransformerLM(cfg, device="cpu", trainable=True)
    assert all(not p.requires_grad for p in serve.parameters())
    assert serve.embed.dtype == torch.bfloat16 and serve.ln_f.scale.dtype == torch.float32
    assert all(p.requires_grad and p.dtype == torch.float32 for p in train.parameters())
    tokens = torch.from_numpy(_batch()[0])
    # training logits feed the fused CE in bf16, every other loss in f32
    assert train(tokens).dtype == torch.bfloat16
    plain = dataclasses.replace(cfg, loss="sparse_softmax_cross_entropy")
    assert TransformerLM(plain, device="cpu", trainable=True)(tokens).dtype == torch.float32
    assert plain.resolved_loss_for("cpu") == "sparse_softmax_cross_entropy"
    assert dataclasses.replace(plain, loss=None).resolved_loss_for("cpu") == "sparse_softmax_cross_entropy"
    assert dataclasses.replace(plain, loss=None).resolved_loss_for("cuda") == \
        "fused_sparse_softmax_cross_entropy"
