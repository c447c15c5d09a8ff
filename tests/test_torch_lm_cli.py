"""Port parity: the JAX LM CLI's own model (``experiments/lm/train.py`` at
its defaults: d_model 256 over 8 heads, so head dim 32) and the kernels it
runs that the port adds for it.

On CPU tensors every wrapper runs its plain version; the JAX side runs its
Pallas kernels in interpret mode, as the JAX package's own tests do, on
inputs made from one numpy seed.

- The attention backward at head dim 32 in both layouts (the fused one
  at the CLI's S 512 tiles, the two-kernel one pinned with ``bwd_block_k``
  as ``test_torch_flash_attention_split.py`` pins it), bf16, against
  ``jax.grad`` of JAX's ``flash_attention``: 0.016, the D 64 tests' bf16
  limit (one output step of gradients that reach ~4; both sides round P
  and dS to bf16 from scores summed in another order).
- f32 attention forward (O and lse) and backward at head dims 32 and 64
  against JAX's f32 kernels: atol 1e-5. The inputs are drawn at scale
  0.25, the size of a model's activations at init; there the first-order
  f32 error bound of the recipe, doubled for two sides
  (``test_torch_flash_attention_split.py::_f32_error_bound``), is at most
  3.3e-5, and the sums of both sides are far from its worst case.
- f32 fused CE, sparse and dense, loss and gradient at V 256 (the CLI's
  vocab, the narrow layout) and V 1000 (one block a row), against JAX's
  fused CE in f32: per-row losses 1e-6 relative, gradients 1e-6.
- The CLI's model at a small size (d_model 64, 2 heads of 32, 2 layers,
  S 64, V 256, adam at the CLI's 3e-3, windows of the CLI's corpus):
  ``SyncTrainer`` 3 steps on both sides from JAX's init carried over as
  f32 masters, flash attention and the fused CE on. f32: losses 1e-5
  relative (the same f32 arithmetic, sums in other orders). bf16: 2e-3
  relative, the bf16 limit of ``test_torch_train.py`` (bf16 rounds at
  other points in the two frameworks).
- The small CLI model in f32 decoding (``--dtype float32 --generate``
  and ``--serve``), flash attention and flash decode on, so that the port
  runs the f32 decode kernels' plain versions and JAX its Pallas decode
  kernels in interpret mode on f32 caches (both round q, K, V and p to
  bf16 alike): greedy ``generate`` and the streams the port's
  ``InferenceServer`` serves at its default page size 128 equal JAX's
  ``generate`` token for token; a beam's tokens equal JAX's and its
  scores, and a served score, lie within 1e-4 of JAX's, the limit of
  ``test_torch_beam_score.py`` (the same log-softmax sums in another
  order; measured 1.9e-6 and 0.0).
- The gate rule on ``torch.device("cuda")``: ``check_kernels_take`` reads
  the config only, and a model is built with its ``.to`` stubbed, so no
  card is needed. The CLI's defaults train at S 512 and at S 16384 with
  remat, ``--dtype float32`` trains at S 512 and at S 16384 with remat
  (the f32 two-kernel backward) and decodes through slab and pages of 128;
  each case without a kernel (an f32 cache at pages under 128 or a slab
  JAX cannot tile, an f32 model with an int8 cache) is refused by name.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distriflow_tpu.models.generate import beam_search as jax_beam_search
from distriflow_tpu.models.generate import generate as jax_generate
from distriflow_tpu.models.generate import sequence_logprob as jax_sequence_logprob
from distriflow_tpu.models.transformer import TransformerConfig as JaxConfig
from distriflow_tpu.models.transformer import transformer_lm as jax_transformer_lm
from distriflow_tpu.ops.fused_ce import (
    fused_softmax_cross_entropy_per_example as jax_dense_ce_rows,
    fused_sparse_softmax_cross_entropy_per_example as jax_sparse_ce_rows,
)
from distriflow_tpu.parallel import data_parallel_mesh
from distriflow_tpu.train.sync import SyncTrainer as JaxTrainer
from distriflow_tpu_torch.client.inference_client import InferenceClient
from distriflow_tpu_torch.models import generate as port_generate
from distriflow_tpu_torch.models import transformer as port_tf
from distriflow_tpu_torch.models.convert import lm_from_jax, params_from_jax
from distriflow_tpu_torch.models.transformer import TransformerConfig, transformer_lm
from distriflow_tpu_torch.ops import fused_ce as port_ce
from distriflow_tpu_torch.ops import flash_attention as port_fa
from distriflow_tpu_torch.server.inference_server import InferenceServer
from distriflow_tpu_torch.train.sync import SyncTrainer
from distriflow_tpu_torch.utils.config import ServingConfig
from experiments.lm.data import batches, generate_corpus
from test_torch_flash_attention_split import _f32_error_bound

pytestmark = pytest.mark.port
torch.set_num_threads(2)

# the flash_attention module (distriflow_tpu.ops rebinds the name to the function)
jfa = importlib.import_module("distriflow_tpu.ops.flash_attention")

BF16_TOL = 0.016
F32_TOL = 1e-5
F32_SCALE = 0.25


def _inputs(shape, dtype_name, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    arrs = [(rng.randn(*shape) * scale).astype(np.float32) for _ in range(4)]
    jx = [jnp.asarray(a, dtype=getattr(jnp, dtype_name)) for a in arrs]
    # widen the rounded JAX values so both sides start from the same bits
    tt = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(getattr(torch, dtype_name))
          for a in jx]
    return jx, tt, arrs


def _jax_grads(q, k, v, do, causal, block=None):
    # flash_attention is a custom_vjp with nondiff_argnums: positional
    # arguments (causal, block_q, block_k, interpret, bwd_block_q,
    # bwd_block_k, bwd_compute_dtype)
    def f(q, k, v):
        o = jfa.flash_attention(q, k, v, causal, 1024, 1024, True, block, block, None)
        return jnp.sum(o.astype(jnp.float32) * do.astype(jnp.float32))

    return [np.asarray(g.astype(jnp.float32)) for g in jax.grad(f, argnums=(0, 1, 2))(q, k, v)]


def _port_grads(q, k, v, do, causal, block=None):
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    o = port_fa.flash_attention(q, k, v, causal=causal, bwd_block_q=block, bwd_block_k=block)
    (o.float() * do.float()).sum().backward()
    for t in (q, k, v):
        assert t.grad.dtype == q.dtype and t.grad.shape == q.shape
    return [t.grad.float().numpy() for t in (q, k, v)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("layout,shape,block", [
    ("fused", (1, 8, 96, 32), None),   # the CLI's 8 heads of 32, JAX's autotuned tiles
    ("split", (1, 2, 96, 32), 8),      # 12 KV blocks of 8: past the fused backward's 8
])
def test_d32_backward_matches_jax_in_both_layouts(layout, shape, block, causal):
    _, _, s, d = shape
    assert port_fa.bwd_layout(s, d, torch.bfloat16, block) == layout
    (q, k, v, do), (tq, tk, tv, tdo), _ = _inputs(shape, "bfloat16", seed=1)
    ref = _jax_grads(q, k, v, do, causal, block)
    ours = _port_grads(tq, tk, tv, tdo, causal, block)
    for name, a, r in zip(("dq", "dk", "dv"), ours, ref):
        np.testing.assert_allclose(a, r, rtol=0, atol=BF16_TOL, err_msg=name)


def test_cli_shapes_take_jax_layouts_at_d32():
    """S 512 D 32 bf16 (the CLI's defaults) takes the fused backward and
    S 16384 (``--seq 16384 --remat``) the two kernels, on both sides; f32
    at S 512 (``--dtype float32``) the fused one."""
    for s, dtype, want in ((512, "bfloat16", "fused"), (16384, "bfloat16", "split"),
                           (512, "float32", "fused"), (4096, "float32", "split")):
        _, bk = jfa._bwd_autotune(s, 32, getattr(jnp, dtype))
        jax_layout = "fused" if s // bk <= jfa._FUSED_BWD_MAX_KV_BLOCKS else "split"
        assert jax_layout == want == port_fa.bwd_layout(s, 32, getattr(torch, dtype)), (s, dtype)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64])
def test_f32_forward_matches_jax(d, causal):
    (q, k, v, _), (tq, tk, tv, _), _ = _inputs((2, 2, 64, d), "float32", seed=2, scale=F32_SCALE)
    o, lse = jfa.flash_attention_with_lse(q, k, v, causal, 1024, 1024, True, None, None, None)
    got_o, got_lse = port_fa.flash_attention(tq, tk, tv, causal=causal, return_lse=True)
    assert got_o.dtype == torch.float32
    np.testing.assert_allclose(got_o.numpy(), np.asarray(o), rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse), rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64])
def test_f32_backward_matches_jax(d, causal):
    shape = (2, 2, 64, d)
    assert port_fa.bwd_layout(64, d, torch.float32) == "fused"
    (q, k, v, do), (tq, tk, tv, tdo), _ = _inputs(shape, "float32", seed=3, scale=F32_SCALE)
    ref = _jax_grads(q, k, v, do, causal)
    ours = _port_grads(tq, tk, tv, tdo, causal)
    for name, a, r in zip(("dq", "dk", "dv"), ours, ref):
        np.testing.assert_allclose(a, r, rtol=0, atol=F32_TOL, err_msg=name)


def test_f32_limit_against_the_error_bound():
    """At the f32 tests' inputs the worst-case first-order bound of the
    recipe, doubled for two sides, stays within a few times the limit:
    the limit is not looser than f32 needs."""
    for d in (32, 64):
        *_, arrs = _inputs((2, 2, 64, d), "float32", seed=3, scale=F32_SCALE)
        glse = np.zeros((2, 2, 64), np.float32)
        bound = max(max(_f32_error_bound(*arrs, glse, c, False)) for c in (True, False))
        assert F32_TOL < bound < 4 * F32_TOL, (d, bound)


def test_f32_attention_is_bounded_at_the_f32_peak():
    """The f32 kernels file their hardware FLOPs as f32 work, and the
    roofline bounds it at the rate each kernel runs it, not the bf16 tensor
    cores': the fused backward's five products and the forward's two, all
    in split-precision TF32, under ``tf32x3_hw_flops`` at a third of the
    TF32 peak, none left at the f32 peak; the categories and JAX's four
    fields stay as they are."""
    from distriflow_tpu_torch.ops import flop_count, roofline

    _, (q, k, v, _), _ = _inputs((1, 2, 64, 32), "float32", seed=4)
    q.requires_grad_()
    with flop_count.tally_kernel_cost() as tally:
        port_fa.flash_attention(q, k, v, causal=True).sum().backward()
    cats = tally["by_category"]
    assert set(cats) == {"attention_fwd", "attention_bwd"}
    bwd, fwd = cats["attention_bwd"], cats["attention_fwd"]
    assert bwd[flop_count.TF32X3_FIELD] == bwd["hw_flops"] > 0
    assert bwd[flop_count.F32_FIELD] == 0
    assert fwd[flop_count.TF32X3_FIELD] == fwd["hw_flops"] > 0
    assert fwd[flop_count.F32_FIELD] == 0
    for name, cat, peak in (("attention_bwd", bwd, roofline.H100_SPLIT_TF32_FLOPS),
                            ("attention_fwd", fwd, roofline.H100_SPLIT_TF32_FLOPS)):
        leg = roofline.phase_time_s(cat["hw_flops"], 0.0, name,
                                    f32_hw_flops=cat[flop_count.F32_FIELD],
                                    tf32x3_hw_flops=cat.get(flop_count.TF32X3_FIELD, 0.0))
        eff = roofline.PHASE_EFFICIENCY[name]
        assert leg["compute_s"] == pytest.approx(cat["hw_flops"] / (peak * eff))
    with flop_count.tally_kernel_cost() as bf16:
        port_fa.flash_attention(q.detach().bfloat16(), k.bfloat16(), v.bfloat16())
    assert flop_count.F32_FIELD not in bf16["by_category"]["attention_fwd"]


def _ce_inputs(n, v, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, v) * 3).astype(np.float32)
    labels = rng.randint(0, v, n).astype(np.int32)
    soft = rng.rand(n, v).astype(np.float32)
    return x, labels, soft / soft.sum(-1, keepdims=True)


@pytest.mark.parametrize("v", [256, 1000])
@pytest.mark.parametrize("kind", ["sparse", "dense"])
def test_f32_fused_ce_matches_jax(kind, v):
    n = 48
    x, labels, soft = _ce_inputs(n, v, seed=v)
    g = np.random.RandomState(7).rand(n).astype(np.float32)
    target = labels if kind == "sparse" else soft
    jax_rows = jax_sparse_ce_rows if kind == "sparse" else jax_dense_ce_rows

    def f(xx):
        return jnp.sum(jax_rows(xx, jnp.asarray(target)) * jnp.asarray(g))

    jx = jnp.asarray(x)
    ref_rows = np.asarray(jax_rows(jx, jnp.asarray(target)))
    ref_grad = np.asarray(jax.grad(f)(jx))
    port_rows = (port_ce.fused_sparse_softmax_cross_entropy_per_example if kind == "sparse"
                 else port_ce.fused_softmax_cross_entropy_per_example)
    tx = torch.from_numpy(x).requires_grad_()
    rows = port_rows(tx, torch.from_numpy(target))
    (rows * torch.from_numpy(g)).sum().backward()
    assert rows.dtype == torch.float32 and tx.grad.dtype == torch.float32
    np.testing.assert_allclose(rows.detach().numpy(), ref_rows, rtol=1e-6, atol=0)
    np.testing.assert_allclose(tx.grad.numpy(), ref_grad, rtol=0, atol=1e-6)
    # the narrow layout takes the CLI's V 256; V 1000 one block a row
    assert (port_ce._row_tile(v) is not None) == (v <= port_ce.NARROW_MAX_V)


# the CLI's model at a small size: its defaults but for the widths and depth
SMALL = dict(vocab_size=256, d_model=64, n_heads=2, n_layers=2, d_ff=256, max_seq=64)
CLI_LR = 3e-3
STEPS = 3


def _cli_batches(seq, b=4):
    corpus = generate_corpus(20_000, seed=0)
    return list(batches(corpus, b, seq, STEPS, 0))


@pytest.mark.parametrize("dtype_name,loss_rel", [("float32", 1e-5), ("bfloat16", 2e-3)])
def test_small_cli_model_trains_as_jax(devices, dtype_name, loss_rel):
    jcfg = JaxConfig(**SMALL, dtype=getattr(jnp, dtype_name), use_flash_attention=True,
                     loss="fused_sparse_softmax_cross_entropy")
    pcfg = TransformerConfig(**SMALL, dtype=getattr(torch, dtype_name), use_flash_attention=True,
                             loss="fused_sparse_softmax_cross_entropy")
    assert pcfg.head_dim == 32
    data = [(np.asarray(x), np.asarray(y)) for x, y in _cli_batches(SMALL["max_seq"])]
    jt = JaxTrainer(jax_transformer_lm(jcfg, example_seq=SMALL["max_seq"]),
                    mesh=data_parallel_mesh(devices[:1]), optimizer="adam", learning_rate=CLI_LR)
    jt.init(jax.random.PRNGKey(0))
    init = jax.tree_util.tree_map(np.asarray, jt.get_params())
    jlosses = [float(jt.step(batch)) for batch in data]
    pt = SyncTrainer(transformer_lm(pcfg, device="cpu"), optimizer="adam", learning_rate=CLI_LR)
    pt.init()
    pt.set_params(params_from_jax(init, pcfg, masters=True))
    losses = [pt.step(batch) for batch in data]
    np.testing.assert_allclose(losses, jlosses, rtol=loss_rel)
    assert losses[-1] < losses[0]


DECODE_ATOL = 1e-4
DECODE_NEW = 24


def test_small_f32_cli_model_generates_and_serves_as_jax():
    """``--dtype float32 --generate`` and ``--serve`` on the small CLI
    model: JAX's f32 flash decode (Pallas, interpret mode) against the
    port's f32 decode kernels' plain versions, slab and paged."""
    jcfg = JaxConfig(**SMALL, dtype=jnp.float32, use_flash_attention=True, use_flash_decode=True)
    pcfg = TransformerConfig(**SMALL, dtype=torch.float32, use_flash_attention=True,
                             use_flash_decode=True)
    params = jax.tree_util.tree_map(
        np.asarray, jax_transformer_lm(jcfg, example_seq=16).init(jax.random.PRNGKey(3)))
    model = lm_from_jax(pcfg, params, device="cpu")
    corpus = generate_corpus(20_000, seed=0)
    # 16-token prompts from the held-out tail, as the CLI's --generate takes them
    prompts = np.stack([corpus[-1000 + 100 * i:-1000 + 100 * i + 16]
                        for i in range(4)]).astype(np.int32)
    ref = np.asarray(jax_generate(jcfg, params, jnp.asarray(prompts), DECODE_NEW))
    np.testing.assert_array_equal(port_generate.generate(model, prompts, DECODE_NEW).numpy(), ref)
    ref_toks, ref_beam = jax_beam_search(jcfg, params, jnp.asarray(prompts[:1]), 8, beam_size=4)
    tokens = corpus[-500:-452][None].astype(np.int32)
    ref_score = np.asarray(jax_sequence_logprob(jcfg, params, jnp.asarray(tokens), 8))
    server = InferenceServer(model, serving=ServingConfig(batch_window_s=0.05)).setup()
    assert server.serving.page_size == 128
    try:
        with InferenceClient(server.address).setup() as c:
            for i in range(len(prompts)):
                np.testing.assert_array_equal(c.generate(prompts[i:i + 1], DECODE_NEW), ref[i:i + 1])
            toks, beam = c.beam_search(prompts[:1], 8, beam_size=4)
            np.testing.assert_array_equal(np.asarray(toks), np.asarray(ref_toks))
            np.testing.assert_allclose(np.asarray(beam, np.float32), np.asarray(ref_beam),
                                       rtol=0, atol=DECODE_ATOL)
            np.testing.assert_allclose(np.asarray(c.score(tokens, from_pos=8), np.float32),
                                       ref_score, rtol=0, atol=DECODE_ATOL)
        assert server.decode_batches > 0
    finally:
        server.stop()


# the CLI's defaults (experiments/lm/train.py:54-66, data.py:20)
CLI = TransformerConfig(vocab_size=256, d_model=256, n_heads=8, n_layers=4, d_ff=1024,
                        max_seq=512)
CUDA = torch.device("cuda")


@pytest.mark.parametrize("kw", [
    {},                                           # the defaults: bf16, S 512
    dict(max_seq=16384, remat=True),              # --seq 16384 --remat
    dict(dtype=torch.float32),                    # --dtype float32
    dict(dtype=torch.float32, max_seq=16384, remat=True),  # both: the f32 two-kernel backward
])
def test_cli_configurations_build_on_cuda(monkeypatch, kw):
    """The CLI's training configurations build a trainable model on CUDA
    (``TransformerLM``'s own check, its move to the card stubbed) with the
    fused sparse CE."""
    cfg = dataclasses.replace(CLI, **kw)
    assert cfg.head_dim == 32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(port_tf.TransformerLM, "to", lambda self, *a, **k: self)
    port_tf.TransformerLM(cfg, device="cuda", trainable=True)
    spec = transformer_lm(cfg, device="cuda")
    assert spec.loss == "fused_sparse_softmax_cross_entropy"
    port_ce.check_model(spec.loss, CUDA, cfg.dtype)


@pytest.mark.parametrize("kw,call", [
    (dict(dtype=torch.float32), dict()),                   # --dtype float32 --generate
    (dict(dtype=torch.float32), dict(page_size=128)),      # --dtype float32 --serve
    # --dtype float32 --seq 16384 --remat: past JAX's fused range, the f32
    # two-kernel backward
    (dict(dtype=torch.float32, max_seq=16384, remat=True), dict(training=True, decode=False)),
])
def test_f32_cli_paths_are_taken_on_cuda(kw, call):
    cfg = dataclasses.replace(CLI, **kw)
    port_tf.check_kernels_take(cfg, CUDA, **call)
    if call.get("training"):
        assert port_fa.bwd_layout(cfg.max_seq, cfg.head_dim, cfg.dtype) == "split"
        assert port_fa.backward_supported(cfg.head_dim, cfg.dtype)


@pytest.mark.parametrize("kw,call,what", [
    # an f32 slab that no JAX tile divides (2056 = 8 x 257): JAX decodes it
    # through XLA in true f32, which no kernel here computes
    (dict(dtype=torch.float32, max_seq=2056), dict(), "slab decode"),
    # an f32 model with an int8 cache: the int8 kernel reads a bf16 query
    (dict(dtype=torch.float32, kv_cache_dtype="int8_force"), dict(page_size=128),
     "paged decode at page_size 128"),
    # head dim 128: no kernel, forward or backward
    (dict(d_model=256, n_heads=2, max_seq=16384, remat=True), dict(training=True, decode=False),
     "the attention backward"),
    (dict(d_model=256, n_heads=2), dict(training=True, decode=False), "prefill attention"),
    (dict(kv_cache_dtype="int8_force"), dict(page_size=128), "slab decode \\(int8 cache\\)"),
    (dict(), dict(page_size=512), "paged decode at page_size 512"),
])
def test_cases_without_a_kernel_are_refused_by_name(kw, call, what):
    cfg = dataclasses.replace(CLI, **kw)
    with pytest.raises(NotImplementedError, match=what):
        port_tf.check_kernels_take(cfg, CUDA, **call)
    port_tf.check_kernels_take(cfg, torch.device("cpu"), **call)  # the CPU runs the plain path


def test_f32_model_trains_but_refuses_a_decode_cache(monkeypatch):
    """An f32 model passes its build check; the f32 decode caches it
    generates and serves through are built on CUDA (allocation stubbed to
    the meta device: no card here), the slab and pages of 128; a pool of
    pages of 16, where JAX decodes in true f32 through XLA, is refused by
    name before anything is allocated."""
    cfg = dataclasses.replace(CLI, dtype=torch.float32)
    port_tf.check_kernels_take(cfg, CUDA, training=True, decode=False)
    port_ce.check_model("fused_sparse_softmax_cross_entropy", CUDA, torch.float32)
    allocated = []
    for name in ("zeros", "full"):
        real = getattr(torch, name)

        def on_meta(*a, real=real, device=None, **k):
            allocated.append(str(device))
            return real(*a, device="meta" if str(device).startswith("cuda") else device, **k)
        monkeypatch.setattr(torch, name, on_meta)
    k, v, ks, vs = port_tf.cache_buffers(cfg, (1, cfg.max_seq), False, CUDA)
    assert k[0].shape == (1, cfg.max_seq, cfg.d_model) and k[0].dtype == torch.float32
    assert ks is None and len(v) == cfg.n_layers
    cache = port_generate.paged_cache(cfg, 8, 128, 16, CUDA)
    assert cache.k[0].shape == (16, 128, cfg.d_model) and cache.k[0].dtype == torch.float32
    n = len(allocated)
    with pytest.raises(NotImplementedError, match="paged decode at page_size 16"):
        port_generate.paged_cache(cfg, 8, 16, 16, CUDA)
    assert len(allocated) == n
    # bf16 at the CLI's defaults: every decode kernel takes it
    port_tf.check_kernels_take(CLI, CUDA, page_size=128, training=True)
