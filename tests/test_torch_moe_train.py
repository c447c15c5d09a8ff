"""Port parity: MoE training (``SyncTrainer`` over an MoE ``transformer_lm``)
against JAX's ``SyncTrainer``, from JAX's init carried over as f32
masters, on one seeded batch: 3 steps of sgd and adam at top-1 and top-2
with ``router_aux_weight`` 0.01, within ``test_torch_train.py``'s limits
(f32: losses 1e-5 relative, parameters 2e-5; bf16 with the kernels' plain
versions on one MoE layer, so that an upstream bf16 rounding difference
cannot flip a later layer's router: losses 2e-3 relative, parameters 1e-3
with sgd and 2 x lr a step with adam); ``grad_accum=2`` against JAX's
(f32 limits); ``remat=True`` against ``remat=False`` (loss 1e-6
relative, gradients 1e-5 relative + 1e-7), the aux term counted once.
Shared configs and helpers: ``test_torch_moe.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distriflow_tpu.models.transformer import transformer_lm as jax_transformer_lm
from distriflow_tpu.parallel import data_parallel_mesh
from distriflow_tpu.train.sync import SyncTrainer as JaxTrainer
from distriflow_tpu_torch.models.convert import lm_from_jax, params_from_jax, random_lm_tree
from distriflow_tpu_torch.models.transformer import transformer_lm
from distriflow_tpu_torch.train.sync import SyncTrainer
from test_torch_moe import PCFG, _cfgs

pytestmark = pytest.mark.port
torch.set_num_threads(2)

LR = {"sgd": 0.1, "adam": 1e-3}
STEPS = 3
TOL = {("f32", "sgd"): (1e-5, 2e-5), ("f32", "adam"): (1e-5, 2e-5),
       ("bf16", "sgd"): (2e-3, 1e-3), ("bf16", "adam"): (2e-3, 2 * LR["adam"] * STEPS)}


def _batch(b=4, s=16, seed=1):
    tok = np.random.RandomState(seed).randint(0, 64, (b, s + 1)).astype(np.int32)
    return tok[:, :-1], tok[:, 1:]


def _jax_run(jcfg, optimizer, batch, devices, **kw):
    trainer = JaxTrainer(jax_transformer_lm(jcfg, example_seq=16),
                         mesh=data_parallel_mesh(devices[:1]), optimizer=optimizer,
                         learning_rate=LR[optimizer], **kw)
    trainer.init(jax.random.PRNGKey(0))
    init = jax.tree_util.tree_map(np.asarray, trainer.get_params())
    losses = [trainer.step(batch) for _ in range(STEPS)]
    return trainer, init, losses


def _port_run(pcfg, optimizer, init, batch, **kw):
    trainer = SyncTrainer(transformer_lm(pcfg, device="cpu"), optimizer=optimizer,
                          learning_rate=LR[optimizer], **kw)
    trainer.init()
    trainer.set_params(params_from_jax(init, pcfg, masters=True))
    return trainer, [trainer.step(batch) for _ in range(STEPS)]


def _assert_params(port_params, jax_tree, pcfg, atol):
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_tree), pcfg, masters=True)
    assert set(port_params) == set(want)
    for name, ref in want.items():
        np.testing.assert_allclose(port_params[name].numpy(), ref.numpy(), rtol=0, atol=atol,
                                   err_msg=name)


KERNELS = dict(n_layers=1, use_flash_attention=True, loss="fused_sparse_softmax_cross_entropy")


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_sync_trainer_matches_jax_step_for_step(devices, mode, k, optimizer):
    jcfg, pcfg = _cfgs(moe_top_k=k, capacity_factor=1.0, router_aux_weight=0.01)
    if mode == "bf16":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16, **KERNELS)
        pcfg = dataclasses.replace(pcfg, dtype=torch.bfloat16, **KERNELS)
    batch = _batch()
    jtrainer, init, jlosses = _jax_run(jcfg, optimizer, batch, devices)
    trainer, losses = _port_run(pcfg, optimizer, init, batch)
    loss_rel, param_atol = TOL[mode, optimizer]
    np.testing.assert_allclose(losses, jlosses, rtol=loss_rel)
    assert losses[-1] < losses[0]
    _assert_params(trainer.get_params(), jtrainer.get_params(), pcfg, param_atol)
    # the router learned: its gradient (the gate scaling and the aux term) arrived
    moved = trainer.get_params()["layers.0.moe.router.kernel"].numpy()
    assert not np.array_equal(moved, init["params"]["layers_0"]["moe"]["router"]["kernel"])


def test_grad_accum_matches_jax(devices):
    jcfg, pcfg = _cfgs(moe_top_k=2, capacity_factor=1.0)
    batch = _batch(b=8, seed=4)
    jtrainer, init, jlosses = _jax_run(jcfg, "adam", batch, devices, grad_accum=2)
    trainer, losses = _port_run(pcfg, "adam", init, batch, grad_accum=2)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    _assert_params(trainer.get_params(), jtrainer.get_params(), pcfg, 2e-5)
    # each micro-batch routes in its own groups: not the full batch's step
    full, _ = _port_run(pcfg, "adam", init, batch)
    assert not np.allclose(full.get_params()["layers.0.moe.router.kernel"].numpy(),
                           trainer.get_params()["layers.0.moe.router.kernel"].numpy(),
                           rtol=0, atol=1e-7)


@pytest.mark.parametrize("k", [1, 2])
def test_remat_counts_the_aux_term_once(k):
    pcfg = dataclasses.replace(PCFG, moe_top_k=k, capacity_factor=1.0, router_aux_weight=0.5)
    tree = random_lm_tree(pcfg, np.random.default_rng(3))
    x, y = (torch.tensor(a) for a in _batch(seed=6))
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(pcfg, remat=remat)
        model = lm_from_jax(cfg, tree, device="cpu", trainable=True)
        spec = transformer_lm(cfg, device="cpu")
        out[remat] = spec.grad_fn()(model, x, y)
        with torch.no_grad():
            _, aux = model(x, with_aux=True)
        assert float(aux) > 0
    (l0, g0), (l1, g1) = out[False], out[True]
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
    for name in g0:
        np.testing.assert_allclose(g1[name].numpy(), g0[name].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    # the aux term's own gradient reaches the router through the recompute
    model = lm_from_jax(dataclasses.replace(pcfg, remat=True), tree, device="cpu",
                        trainable=True)
    _, aux = model(x, with_aux=True)
    (g,) = torch.autograd.grad(aux, [model.layers[1].moe.router.kernel])
    assert float(g.abs().max()) > 0
