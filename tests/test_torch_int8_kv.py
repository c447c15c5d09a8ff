"""Port parity: the int8 KV cache (``distriflow_tpu_torch/models/transformer.py``,
``models/generate.py``, ``ops/flash_decode.py``).

- the int8 decode wrappers' plain versions (CPU tensors) against the JAX
  Pallas int8 kernels in interpret mode on seeded int8 K/V, f32 scales,
  per-row lengths, sentinel table entries, a zero q row and a zero K row.
  Tolerance: one bf16 step of the output (rtol 2**-7, atol 1e-6): the
  integer dot is exact on both sides and the f32 products are taken in the
  same order, but JAX's slab tile is ``pick_block_k(S)``, not 128, so its
  online-softmax sums run in another order;
- the int8 K/V and scales a prefill stores, against the JAX module's
  ``cached_k``/``k_scale`` at f32 from the same weights: int8 equal except
  +-1 where the two frameworks' projections fall on either side of a
  rounding tie, scales within 1e-6 relative;
- ``kv_cache_dtype_for`` and ``_gate_kv_dtype`` equal JAX's over a grid;
- greedy ``generate`` with ``int8_force`` at f32 equals JAX's token for
  token (both on their plain dequantizing decode paths);
- the paged int8 engine, the slab int8 engine and solo decode give the
  same tokens, through copy-on-write, with the page pool conserved;
- a CUDA model with an int8 cache is accepted at head dim 64 and pages of
  at most 256, and refused elsewhere.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distriflow_tpu.models.generate import _gate_kv_dtype as jax_gate
from distriflow_tpu.models.generate import generate as jax_generate
from distriflow_tpu.models.transformer import TransformerConfig as JaxConfig
from distriflow_tpu.models.transformer import TransformerLM as JaxLM
from distriflow_tpu.models.transformer import transformer_lm
from distriflow_tpu.ops.flash_decode import flash_decode as jax_flash_decode
from distriflow_tpu.ops.flash_decode import flash_decode_paged as jax_flash_decode_paged
from distriflow_tpu_torch.analysis.witness import POOL_ENV_VAR
from distriflow_tpu_torch.client.inference_client import InferenceClient
from distriflow_tpu_torch.models.convert import lm_from_jax
from distriflow_tpu_torch.models.generate import _gate_kv_dtype, generate
from distriflow_tpu_torch.models.transformer import TransformerConfig, check_kernels_take
from distriflow_tpu_torch.obs.telemetry import Telemetry
from distriflow_tpu_torch.ops import flash_decode as port_fd
from distriflow_tpu_torch.server.inference_server import InferenceServer
from distriflow_tpu_torch.utils.config import ServingConfig

pytestmark = pytest.mark.port
torch.set_num_threads(2)

RTOL, ATOL = 2 ** -7, 1e-6  # one bf16 output step
DIMS = dict(vocab_size=64, d_model=128, n_heads=2, n_layers=2, d_ff=128, max_seq=64)
JCFG = JaxConfig(**DIMS, dtype=jnp.float32, use_flash_attention=False, use_flash_decode=False,
                 kv_cache_dtype="int8_force")
PCFG = TransformerConfig(**DIMS, dtype=torch.float32, use_flash_attention=False,
                         use_flash_decode=False, kv_cache_dtype="int8_force")
PS = 16


@pytest.fixture(scope="module")
def params():
    p = transformer_lm(dataclasses.replace(JCFG, kv_cache_dtype=None), example_seq=16).init(
        jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def model(params):
    return lm_from_jax(PCFG, params, device="cpu")


def _prompt(seed, n, b=1):
    return np.random.RandomState(seed).randint(0, 64, (b, n)).astype(np.int32)


def _int8_inputs(rng, lead, h, d):
    """Seeded int8 K/V and U(0.005, 0.05) scales of shape ``lead + ...``."""
    k8 = rng.randint(-127, 128, lead + (h * d,)).astype(np.int8)
    v8 = rng.randint(-127, 128, lead + (h * d,)).astype(np.int8)
    ks = rng.uniform(0.005, 0.05, lead + (h,)).astype(np.float32)
    vs = rng.uniform(0.005, 0.05, lead + (h,)).astype(np.float32)
    return k8, v8, ks, vs


def _q(rng, b, h, d):
    """bf16 q with row 1 all zeros (its scale clamps at 1e-20), as JAX and
    torch arrays holding the same bits."""
    q = rng.randn(b, h, d).astype(np.float32)
    q[1] = 0.0
    jq = jnp.asarray(q, jnp.bfloat16)
    return jq, torch.from_numpy(np.array(jq.astype(jnp.float32))).to(torch.bfloat16)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("ps,pp", [(16, 3), (128, 2)])
def test_plain_paged_int8_matches_pallas_interpret(ps, pp):
    b, h, d, n_pages = 3, 2, 64, 7
    rng = np.random.RandomState(11)
    jq, q = _q(rng, b, h, d)
    k8, v8, ks, vs = _int8_inputs(rng, (n_pages, ps), h, d)
    k8[5, 2] = 0  # a zero K row (its stored scale is 0 too)
    ks[5, 2] = 0.0
    table = np.full((b, pp), n_pages, np.int32)  # sentinel tails
    table[0, :pp] = [5, 0, 3][:pp]               # scattered, unordered
    table[1, :2] = [6, 2]
    table[2, :1] = [4]
    valid = np.array([pp * ps - 3, ps + 1, 1], np.int32)
    ref = jax_flash_decode_paged(jq, *map(jnp.asarray, (k8, v8, table, valid)),
                                 k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
                                 interpret=True)
    tk8, tv8, tks, tvs, tt, tl = _t(k8, v8, ks, vs, table, valid)
    out = port_fd.flash_decode_paged(q, tk8, tv8, tt, tl, k_scale=tks, v_scale=tvs)
    assert out.shape == (b, h, d) and out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("per_row", [False, True])
def test_plain_slab_int8_matches_pallas_interpret(per_row):
    b, h, d, s = 3, 2, 64, 136  # past one 128-position tile
    rng = np.random.RandomState(12)
    jq, q = _q(rng, b, h, d)
    k8, v8, ks, vs = _int8_inputs(rng, (b, s), h, d)
    k8[0, 7] = 0
    ks[0, 7] = 0.0
    valid = np.array([130, 9, 136], np.int32) if per_row else np.int32(100)
    ref = jax_flash_decode(jq, jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(valid),
                           k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), interpret=True)
    tk8, tv8, tks, tvs = _t(k8, v8, ks, vs)
    lens = torch.from_numpy(np.atleast_1d(valid)) if per_row else int(valid)
    out = port_fd.flash_decode(q, tk8, tv8, lens, k_scale=tks, v_scale=tvs)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=RTOL, atol=ATOL)


def test_int8_paged_and_slab_accumulate_in_the_same_order():
    """At page_size == SLAB_TILE the int8 slab and the same positions in
    scattered pages give the same bits (engine decode == solo decode)."""
    h, d, ps = 2, 64, port_fd.SLAB_TILE
    rng = np.random.RandomState(13)
    q = torch.from_numpy(rng.randn(1, h, d).astype(np.float32)).to(torch.bfloat16)
    k8, v8, ks, vs = _t(*_int8_inputs(rng, (1, 3 * ps), h, d))
    order = [2, 0, 1]
    pools = [torch.zeros((3, ps) + t.shape[2:], dtype=t.dtype) for t in (k8, v8, ks, vs)]
    for j, pg in enumerate(order):
        for pool, t in zip(pools, (k8, v8, ks, vs)):
            pool[pg] = t[0, j * ps:(j + 1) * ps]
    table = torch.tensor([order], dtype=torch.int32)
    for n in (1, 200, 3 * ps):
        slab = port_fd.flash_decode_int8(q, k8, v8, ks, vs, n)
        paged = port_fd.flash_decode_paged_int8(q, pools[0], pools[1], pools[2], pools[3], table,
                                                torch.tensor([n], dtype=torch.int32))
        assert torch.equal(slab, paged)


def test_prefill_stores_the_jax_int8_cache(params, model):
    prompt = _prompt(3, 21, b=2)
    _, jvars = JaxLM(JCFG, decode=True).apply(params, jnp.asarray(prompt), mutable=["cache"])
    _, cache = model.decode(torch.from_numpy(prompt))
    assert cache.quant
    for i in range(PCFG.n_layers):
        ref = jvars["cache"][f"layers_{i}"]["attn"]
        for name, ours in (("cached_k", cache.k[i]), ("cached_v", cache.v[i])):
            diff = np.abs(ours.numpy().astype(np.int32) - np.asarray(ref[name], np.int32))
            assert ours.dtype == torch.int8 and diff.max() <= 1, name
            assert (diff > 0).mean() < 0.01, name  # only values at a rounding tie
        for name, ours in (("k_scale", cache.k_scale[i]), ("v_scale", cache.v_scale[i])):
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref[name]), rtol=1e-6, atol=0)
        assert float(cache.k_scale[i][:, 21:].abs().max()) == 0.0  # unwritten positions


# (kv_cache_dtype, max_seq, context): a fixed literal grid
GATE_GRID = [
    (None, 16384, 100), (None, 16384, 16384),
    ("int8", 2048, 1000), ("int8", 2048, 2048), ("int8", 8192, 8191), ("int8", 8192, 8192),
    ("int8", 16384, 1088), ("int8", 16384, 8192), ("int8", 16384, 16384),
    ("int8_force", 2048, 100), ("int8_force", 16384, 16384),
]


@pytest.mark.parametrize("kv,max_seq,context", GATE_GRID)
def test_kv_dtype_gate_matches_jax(kv, max_seq, context):
    jc = JaxConfig(max_seq=max_seq, kv_cache_dtype=kv)
    pc = TransformerConfig(max_seq=max_seq, kv_cache_dtype=kv)
    assert pc.kv_cache_dtype_for(context) == jc.kv_cache_dtype_for(context)
    assert pc.resolved_kv_cache_dtype == jc.resolved_kv_cache_dtype
    assert _gate_kv_dtype(pc, context).kv_cache_dtype == jax_gate(jc, context).kv_cache_dtype


def test_config_refuses_unknown_kv_dtype():
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        TransformerConfig(kv_cache_dtype="fp8")


def test_greedy_int8_generate_matches_jax_token_for_token(params, model):
    prompt = _prompt(1, 9, b=2)
    ref = np.asarray(jax_generate(JCFG, params, jnp.asarray(prompt), 12))
    np.testing.assert_array_equal(generate(model, prompt, 12).numpy(), ref)


def test_int8_engine_paged_and_slab_equal_solo(model, monkeypatch):
    monkeypatch.setenv(POOL_ENV_VAR, "1")  # verify_pool_conservation checks
    base = _prompt(5, 33)
    fork = base.copy()
    fork[0, 20:] = (fork[0, 20:] + 7) % 64  # diverges inside page 2: copy-on-write
    short = _prompt(6, 7)
    solo = {k: generate(model, p, 8).numpy() for k, p in
            (("base", base), ("fork", fork), ("short", short))}
    for layout in ("paged", "slab"):
        srv = InferenceServer(model, telemetry=Telemetry(), serving=ServingConfig(
            batch_window_s=0.05, decode_chunk=3, page_size=PS, kv_layout=layout)).setup()
        try:
            if layout == "paged":
                assert srv._slot_cache is None
            with InferenceClient(srv.address).setup() as c:
                for key, prompt in (("base", base), ("fork", fork), ("short", short),
                                    ("base", base)):
                    np.testing.assert_array_equal(c.generate(prompt, 8), solo[key], err_msg=layout)
                    assert c.last_serving_meta["path"] == "slots"
            assert srv._slot_cache.quant
            if layout == "paged":
                assert srv.prefix_hits >= 2  # the fork's first page, the repeated base
                srv.release_prefix_cache()
                assert srv._pool.free_pages == srv._pool.n_pages
        finally:
            srv.stop()
        if layout == "paged":
            assert srv._pool_witness.checks > 0 and srv._pool_witness.trips == 0


@pytest.mark.parametrize("kw,page_size,ok", [
    (dict(kv_cache_dtype="int8_force"), 128, True),
    (dict(kv_cache_dtype="int8", max_seq=16384), 256, True),
    (dict(kv_cache_dtype="int8_force"), 512, False),
    (dict(kv_cache_dtype="int8_force", d_model=256, n_heads=2), 128, False),
    (dict(kv_cache_dtype="int8_force", dtype=torch.float32, use_flash_attention=False), None, False),
])
def test_cuda_int8_model_accepted_only_where_the_kernels_take_it(kw, page_size, ok):
    cfg = TransformerConfig(**{**dict(vocab_size=64, d_model=128, n_heads=2, n_layers=1,
                                      d_ff=64, max_seq=256), **kw})
    if ok:
        check_kernels_take(cfg, torch.device("cuda"), page_size)
    else:
        with pytest.raises(NotImplementedError, match="int8 cache"):
            check_kernels_take(cfg, torch.device("cuda"), page_size)
    check_kernels_take(cfg, torch.device("cpu"), page_size)  # the CPU runs the plain path
