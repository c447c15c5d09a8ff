"""Port parity: the kernels' FLOP tally (``distriflow_tpu_torch/ops/flop_count.py``)
and the trainers' ``cost_analysis``/``mfu``.

Each wrapper family records JAX's analytic cost at JAX's record site,
whichever path runs (here the plain versions, on CPU tensors); the tally
of one forward (and backward) must equal JAX's ``pallas_cost_of`` at the
same shapes and dtypes exactly, field by field and by category: the flash
forward, its fused and its two-kernel backward (``bwd_block_k`` pins JAX's
KV tile), the fused CE on labels and on dense targets, the depthwise
forward and backward, and the transformer LM with and without remat. Under
remat JAX's trace records the recomputed forward as model FLOPs too; the
port files it under ``hw_flops`` only (with its bytes and
transcendentals), so there the port's ``flops`` must equal JAX's less the
recomputed forward (JAX's own non-remat figure) and every other field
JAX's.

Then ``cost_analysis``: on the CPU the tally is reported but not added to
``flops`` (the plain versions' aten ops are counted already), on CUDA it
is (the rule of ``step_cost``, driven here with a CUDA device argument);
``grad_accum`` multiplies one micro-batch's counts; the async trainer's
per-batch figure is the sync trainer's; ``mfu`` divides by the peak and
sets the gauge; an unknown device kind raises.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distriflow_tpu.models.base import init_params as jax_init_params
from distriflow_tpu.models.transformer import TransformerConfig as JaxConfig
from distriflow_tpu.models.transformer import transformer_lm as jax_transformer_lm
from distriflow_tpu.ops.flop_count import pallas_cost_of
from distriflow_tpu_torch.data.dataset import DistributedDataset
from distriflow_tpu_torch.models.transformer import TransformerConfig, transformer_lm
from distriflow_tpu_torch.obs.telemetry import get_telemetry
from distriflow_tpu_torch.ops import depthwise_gn as dg
from distriflow_tpu_torch.ops import flash_attention as fa
from distriflow_tpu_torch.ops import flop_count
from distriflow_tpu_torch.ops import fused_ce as ce
from distriflow_tpu_torch.train.async_sgd import AsyncSGDTrainer
from distriflow_tpu_torch.train.sync import SyncTrainer

jfa = importlib.import_module("distriflow_tpu.ops.flash_attention")
jce = importlib.import_module("distriflow_tpu.ops.fused_ce")
jdg = importlib.import_module("distriflow_tpu.ops.depthwise_gn")

pytestmark = pytest.mark.port
torch.set_num_threads(2)

FIELDS = ("flops", "bytes_accessed", "transcendentals", "hw_flops")
DIMS = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=48)


def _jax_tally(fn, *args):
    jax.clear_caches()  # a warm trace cache replays past the wrappers
    return pallas_cost_of(fn, *args)


def _port_tally(run):
    with flop_count.tally_kernel_cost() as tally:
        run()
    return tally


def _assert_same(got, want):
    for f in FIELDS:
        assert got[f] == want[f], (f, got[f], want[f])
    assert set(got["by_category"]) == set(want["by_category"])
    for cat, cost in want["by_category"].items():
        for f in FIELDS:
            assert got["by_category"][cat][f] == cost[f], (cat, f)


def _arrays(rng, *shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _attention_inputs(s, seed=0):
    q, k, v = _arrays(np.random.default_rng(seed), *[(2, 2, s, 64)] * 3)
    jx = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    px = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    return jx, px


@pytest.mark.parametrize("causal", [True, False])
def test_flash_forward_tally(causal):
    jx, px = _attention_inputs(40)
    want = _jax_tally(lambda q, k, v: jfa.flash_attention(q, k, v, causal), *jx)
    _assert_same(_port_tally(lambda: fa.flash_attention(*px, causal=causal)), want)


@pytest.mark.parametrize("causal", [True, False])
def test_f32_flash_forward_tally_files_its_products_as_split_tf32(causal):
    """In f32 the forward's tally is JAX's, field for field, and its
    hardware FLOPs (both products) go under ``tf32x3_hw_flops``: the kernel
    runs S = Q K^T and P V as split-precision TF32, so none is left under
    ``f32_hw_flops``; under remat the recompute's go there too."""
    q, k, v = _arrays(np.random.default_rng(1), *[(2, 2, 40, 32)] * 3)
    want = _jax_tally(lambda q, k, v: jfa.flash_attention(q, k, v, causal),
                      *(jnp.asarray(a) for a in (q, k, v)))
    px = [torch.from_numpy(a) for a in (q, k, v)]
    got = _port_tally(lambda: fa.flash_attention(*px, causal=causal))
    _assert_same(got, want)
    fwd = got["by_category"]["attention_fwd"]
    assert fwd[flop_count.TF32X3_FIELD] == fwd["hw_flops"] > 0
    assert fwd[flop_count.F32_FIELD] == 0
    with flop_count.tally_kernel_cost() as tally:
        with flop_count.recompute():
            fa.flash_attention(*px, causal=causal)
    fwd = tally["by_category"]["attention_fwd"]
    assert fwd["flops"] == 0 and fwd[flop_count.TF32X3_FIELD] == fwd["hw_flops"] > 0


@pytest.mark.parametrize("s,bwd_block_k,layout", [(40, None, "fused"), (128, 8, "split")])
def test_flash_backward_tally(s, bwd_block_k, layout):
    """The fused layout (one KV block) and the two-kernel one (JAX's KV
    tile pinned at 8: 16 blocks) record different bytes, transcendentals
    and hw_flops."""
    assert fa.bwd_layout(s, 64, torch.bfloat16, bwd_block_k) == layout
    jx, px = _attention_inputs(s, seed=1)

    def jloss(q, k, v):
        return jfa.flash_attention(q, k, v, True, bwd_block_k=bwd_block_k).astype(
            jnp.float32).sum()

    want = _jax_tally(jax.grad(jloss, argnums=(0, 1, 2)), *jx)
    leaves = [t.requires_grad_() for t in px]
    got = _port_tally(lambda: fa.flash_attention(
        *leaves, causal=True, bwd_block_k=bwd_block_k).float().sum().backward())
    _assert_same(got, want)
    assert got["hw_flops"] > got["flops"]


@pytest.mark.parametrize("sparse", [True, False])
def test_fused_ce_tally(sparse):
    rng = np.random.default_rng(2)
    (logits,) = _arrays(rng, (24, 37))
    labels = rng.integers(0, 37, 24)
    targets = np.eye(37, dtype=np.float32)[labels]
    jfn = jce.fused_sparse_softmax_cross_entropy if sparse else jce.fused_softmax_cross_entropy
    pfn = ce.fused_sparse_softmax_cross_entropy if sparse else ce.fused_softmax_cross_entropy
    t = labels.astype(np.int32) if sparse else targets
    want = _jax_tally(jax.grad(lambda lg: jfn(lg, jnp.asarray(t))), jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_()
    _assert_same(_port_tally(lambda: pfn(lg, torch.from_numpy(t)).backward()), want)


@pytest.mark.parametrize("stride,h", [(1, 8), (2, 9)])
def test_depthwise_tally(stride, h):
    rng = np.random.default_rng(3)
    x, w = _arrays(rng, (2, h, h, 16), (3, 3, 1, 16))
    scale, bias = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32), \
        (0.1 * rng.standard_normal(16)).astype(np.float32)
    jargs = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), jnp.asarray(scale),
             jnp.asarray(bias))

    def jloss(x, w, s, b):
        return jdg.depthwise3x3_groupnorm(x, w, s, b, stride).astype(jnp.float32).sum()

    want = _jax_tally(jax.grad(jloss, argnums=(0, 1, 2, 3)), *jargs)
    px = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_(),
          torch.from_numpy(w).to(torch.bfloat16).requires_grad_(),
          torch.from_numpy(scale).requires_grad_(), torch.from_numpy(bias).requires_grad_()]
    got = _port_tally(lambda: dg.depthwise3x3_groupnorm(*px, stride).float().sum().backward())
    _assert_same(got, want)
    fwd_only = _port_tally(lambda: dg.depthwise3x3_groupnorm(*[t.detach() for t in px], stride))
    _assert_same(fwd_only, _jax_tally(
        lambda *a: jdg.depthwise3x3_groupnorm(*a, stride), *jargs))


def _lm_tallies(remat):
    jcfg = JaxConfig(**DIMS, dtype=jnp.bfloat16, use_flash_attention=True,
                     loss="fused_sparse_softmax_cross_entropy", remat=remat)
    spec = jax_transformer_lm(jcfg)
    params = jax_init_params(spec, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(4).integers(0, 64, (2, 48)).astype(np.int32)
    want = _jax_tally(jax.value_and_grad(spec.loss_fn), params, jnp.asarray(tokens),
                      jnp.asarray(tokens))
    pcfg = TransformerConfig(**DIMS, dtype=torch.bfloat16, use_flash_attention=True,
                             loss="fused_sparse_softmax_cross_entropy", remat=remat)
    pspec = transformer_lm(pcfg, device="cpu")
    model = pspec.init(0)
    x = torch.from_numpy(tokens)
    return _port_tally(lambda: pspec.grad_fn()(model, x, x)), want


def test_lm_tally():
    got, want = _lm_tallies(remat=False)
    _assert_same(got, want)


def test_remat_lm_tally_counts_the_recompute_as_hardware_flops():
    got, want = _lm_tallies(remat=True)
    _, plain = _lm_tallies(remat=False)
    recompute = (want["by_category"]["attention_fwd"]["flops"]
                 - plain["by_category"]["attention_fwd"]["flops"])
    assert recompute > 0  # JAX's trace records the recomputed forward as model FLOPs
    assert got["flops"] == want["flops"] - recompute == plain["flops"]
    for f in ("bytes_accessed", "transcendentals", "hw_flops"):
        assert got[f] == want[f], f
    assert got["by_category"]["attention_fwd"]["flops"] == \
        plain["by_category"]["attention_fwd"]["flops"]


def _lm_trainer(grad_accum=1):
    cfg = TransformerConfig(**DIMS, dtype=torch.bfloat16, use_flash_attention=True,
                            loss="fused_sparse_softmax_cross_entropy")
    trainer = SyncTrainer(transformer_lm(cfg, device="cpu"), grad_accum=grad_accum)
    trainer.init(0)
    return trainer


def _tokens(b, seed=5):
    t = np.random.default_rng(seed).integers(0, 64, (b, 49)).astype(np.int32)
    return t[:, :-1], t[:, 1:]


def test_cpu_cost_analysis_reports_but_does_not_add_the_tally():
    trainer = _lm_trainer()
    before = trainer.get_params()
    batch = _tokens(4)
    cost = trainer.cost_analysis(batch)
    assert cost["kernel_flops"] > 0 and cost["aten_flops"] > 0
    assert cost["flops"] == cost["aten_flops"] and not cost["kernel_tally_added"]
    assert cost["pallas_flops"] == cost["kernel_flops"]
    # the tally is one step's: one forward and one backward of the kernels
    model = trainer.model
    x, y = (torch.from_numpy(a) for a in batch)
    tally = _port_tally(lambda: trainer.spec.grad_fn()(model, x, y))
    assert cost["kernel_flops"] == tally["flops"] and cost["kernel_hw_flops"] == tally["hw_flops"]
    # no update and no state change
    assert trainer.version == 0
    for n, p in trainer.get_params().items():
        assert torch.equal(p, before[n])
    assert trainer.cost_analysis(batch) is cost  # cached per batch signature


def test_cuda_rule_adds_the_tally_once():
    x = torch.ones(4, 8, requires_grad=True)

    def run():
        (ce.fused_softmax_cross_entropy(x @ torch.ones(8, 10), torch.eye(10)[:4])).backward()

    cpu = flop_count.step_cost(run, torch.device("cpu"))
    card = flop_count.step_cost(run, torch.device("cuda"))
    assert cpu["aten_flops"] == card["aten_flops"] == cpu["flops"] > 0
    assert card["kernel_flops"] == (5 + 3) * 4 * 10
    assert card["flops"] == card["aten_flops"] + card["kernel_flops"]
    assert card["kernel_tally_added"] and not cpu["kernel_tally_added"]


def test_grad_accum_multiplies_one_micro_batch():
    whole = _lm_trainer(grad_accum=2).cost_analysis(_tokens(4))
    half = _lm_trainer().cost_analysis(_tokens(2))
    for k in ("flops", "aten_flops", "kernel_flops", "kernel_hw_flops", "kernel_bytes_accessed",
              "kernel_transcendentals"):
        assert whole[k] == 2 * half[k], k
    for cat, cost in half["kernel_by_category"].items():
        assert whole["kernel_by_category"][cat]["flops"] == 2 * cost["flops"]


def test_mfu_and_unknown_device_kind():
    trainer = _lm_trainer()
    batch = _tokens(4)
    with pytest.raises(ValueError, match="unknown device kind 'cpu'"):
        trainer.mfu(batch, step_seconds=0.1)
    value = trainer.mfu(batch, step_seconds=0.5, peak_flops_per_chip=1e12)
    assert value == trainer.cost_analysis(batch)["flops"] / (0.5 * 1e12) > 0
    gauge = get_telemetry().gauge("train_mfu", mode="sync")
    assert gauge.value == value
    with pytest.raises(ValueError, match="no steps timed"):
        trainer.mfu(batch)


def test_async_cost_is_the_sync_per_batch_cost():
    tokens = np.random.default_rng(6).integers(0, 64, (8, 49)).astype(np.int32)
    cfg = TransformerConfig(**DIMS, dtype=torch.bfloat16, use_flash_attention=True,
                            loss="fused_sparse_softmax_cross_entropy")
    spec = transformer_lm(cfg, device="cpu")
    ds = DistributedDataset(tokens[:, :-1], tokens[:, 1:], {"batch_size": 4})
    trainer = AsyncSGDTrainer(spec, ds)
    cost = trainer.cost_analysis(4)
    sync = _lm_trainer().cost_analysis((tokens[:4, :-1], tokens[:4, 1:]))
    for k in ("flops", "aten_flops", "kernel_flops", "kernel_hw_flops"):
        assert cost[k] == sync[k], k
    with pytest.raises(ValueError, match="unknown device kind"):
        trainer.mfu(4, step_seconds=0.1)
    assert trainer.mfu(4, 0.25, peak_flops_per_chip=1e12) == cost["flops"] / 0.25e12
    assert trainer.version == 0


def test_async_cost_analysis_refuses_while_a_worker_runs():
    """A first ``cost_analysis`` made from inside a worker's round raises
    (the process-wide tally would take in the worker's records); after
    ``train`` it answers, and the cost equals a fresh trainer's."""
    tokens = np.random.default_rng(6).integers(0, 64, (8, 49)).astype(np.int32)
    cfg = TransformerConfig(**DIMS, dtype=torch.bfloat16, use_flash_attention=True,
                            loss="fused_sparse_softmax_cross_entropy")
    spec = transformer_lm(cfg, device="cpu")

    def trainer():
        return AsyncSGDTrainer(spec, DistributedDataset(
            tokens[:, :-1], tokens[:, 1:], {"batch_size": 4, "epochs": 1}))

    busy, seen = trainer(), []

    def during(*_):
        try:
            busy.cost_analysis(4)
        except RuntimeError as e:
            seen.append(str(e))

    busy.callbacks.register("upload", during)
    assert busy.train(num_workers=1)["applied"] == 2
    assert len(seen) == 2 and all("worker(s) run" in m for m in seen), seen
    fresh = trainer()
    fresh.init()
    fresh.set_params(busy.snapshot()[0])
    assert busy.cost_analysis(4)["flops"] == fresh.cost_analysis(4)["flops"]


def test_tally_sees_other_threads_and_nests():
    """The tally is one per process (a CUDA backward records on autograd
    threads); an inner tally takes the records while it is open."""
    import threading

    logits = torch.zeros(3, 5)
    with flop_count.tally_kernel_cost() as outer:
        t = threading.Thread(target=lambda: ce.fused_ce_dense_forward(logits, logits))
        t.start()
        t.join(10)
        assert not t.is_alive()
        with flop_count.tally_kernel_cost() as inner:
            ce.fused_ce_dense_forward(logits, logits)
        ce.fused_ce_dense_backward(logits, logits, torch.zeros(3), torch.ones(3))
    assert inner["flops"] == 5 * 15
    assert outer["flops"] == 5 * 15 + 3 * 15
    assert outer["by_category"]["fused_ce"]["transcendentals"] == 2 * 15
    with flop_count.recompute():
        with flop_count.tally_kernel_cost() as re:
            ce.fused_ce_dense_forward(logits, logits)
    assert re["flops"] == 0 and re["hw_flops"] == 5 * 15
    assert flop_count.record_pallas_cost is flop_count.record_kernel_cost
