"""Port parity: speculative decoding (``distriflow_tpu_torch/models/generate.py``
``draft_k``/``verify``/``commit``, ``server/inference_server.py``'s
speculative plane, ``models/zoo.py::draft_config_for``).

The cases of ``tests/test_speculative.py`` on the port, at the same tiny
f32 config with the kernels off, plus:

- JAX parity: the same numpy weights, carried over with the converters,
  serve the same greedy streams from the JAX package's speculative server
  and the port's; the three device programs, run on the same caches,
  give the same drafts, acceptances, emitted tokens and positions;
- the sampled round's law: over 4000 seeds the first token a round emits
  follows the target's truncated softmax (total variation below
  ``TV_BOUND``), and a residual of p in place of ``max(p - q, 0)`` fails
  that bound.
"""

import dataclasses
import importlib
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distriflow_tpu.client import InferenceClient as JaxClient
from distriflow_tpu.models.transformer import TransformerConfig as JaxConfig
from distriflow_tpu.models.transformer import transformer_lm
from distriflow_tpu.models.zoo import draft_config_for as jax_draft_config_for
from distriflow_tpu.server import InferenceServer as JaxServer
from distriflow_tpu.utils.config import ServingConfig as JaxServing
from distriflow_tpu_torch.client.inference_client import InferenceClient
from distriflow_tpu_torch.comm.transport import ConnectionLost
from distriflow_tpu_torch.models import generate as gen
from distriflow_tpu_torch.models.convert import lm_from_jax
from distriflow_tpu_torch.models.transformer import TransformerConfig, check_kernels_take
from distriflow_tpu_torch.models.zoo import draft_config_for, draft_lm_config
from distriflow_tpu_torch.obs import get_telemetry
from distriflow_tpu_torch.server.inference_server import InferenceServer
from distriflow_tpu_torch.utils.config import ServingConfig

pytestmark = pytest.mark.port
torch.set_num_threads(2)
# the module, not the function the package re-exports under its name
jax_gen = importlib.import_module("distriflow_tpu.models.generate")

JCFG = JaxConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=48,
                 dtype=jnp.float32, use_flash_attention=False, use_flash_decode=False)
CFG = TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=48,
                        dtype=torch.float32, use_flash_attention=False, use_flash_decode=False)
PS = 16  # 3 pages per slot
#: total variation the sampled round's first token may show against the
#: target's law over 4000 seeds: sampling noise alone gives ~0.02 at
#: vocab 8 (the mean of 0.5 * sum |f - p| with sd sqrt(p (1 - p) / 4000))
TV_BOUND = 0.05


def _jax_params(cfg, seed):
    return jax.tree_util.tree_map(
        np.asarray, transformer_lm(cfg, example_seq=16).init(jax.random.PRNGKey(seed)))


@pytest.fixture(scope="module")
def params():
    return _jax_params(JCFG, 0)


@pytest.fixture(scope="module")
def model(params):
    return lm_from_jax(CFG, params, device="cpu")


def _server(model, k, draft="lm_draft", draft_lm=None, **kw):
    return InferenceServer(
        model,
        serving=ServingConfig(batch_window_s=0.1, decode_chunk=4, kv_layout="paged",
                              page_size=PS, speculate_k=k, draft_model=draft, **kw),
        draft=draft_lm,
    ).setup()


def _client(server):
    return InferenceClient(server.address).setup()


def _solo(model, prompt, n, **kw):
    return gen.generate(model, prompt, n, **kw).numpy()


# -- config surface ------------------------------------------------------------


def test_speculate_k_validation():
    with pytest.raises(ValueError):
        ServingConfig(speculate_k=-1).validate()
    with pytest.raises(ValueError):  # speculation needs the page pool
        ServingConfig(speculate_k=2, kv_layout="slab").validate()
    with pytest.raises(ValueError):  # a dangling draft without speculation
        ServingConfig(draft_model="lm_draft").validate()
    srv = ServingConfig(speculate_k=3, kv_layout="paged", draft_model="self").validate()
    assert srv.speculate_k == 3


def test_draft_config_resolution():
    assert draft_config_for("self", CFG) is CFG
    d = draft_config_for("lm_draft", CFG)
    # the fields a draft/target pair must share come from the target
    assert (d.vocab_size, d.max_seq, d.dtype) == (CFG.vocab_size, CFG.max_seq, CFG.dtype)
    assert d.use_flash_attention == CFG.use_flash_attention
    assert d.use_flash_decode == CFG.use_flash_decode
    # ... while the draft keeps its own depth and width, JAX's
    full = draft_lm_config()
    jd = jax_draft_config_for("lm_draft", JCFG)
    assert (d.n_layers, d.d_model, d.n_heads, d.d_ff) == (full.n_layers, full.d_model,
                                                          full.n_heads, full.d_ff)
    assert (d.n_layers, d.d_model, d.n_heads, d.d_ff) == (jd.n_layers, jd.d_model, jd.n_heads,
                                                          jd.d_ff)
    assert d.head_dim == 32
    with pytest.raises(ValueError):
        draft_config_for("no_such_draft", CFG)


def test_draft_runs_on_the_kernels_on_cuda():
    """The draft's head dim 32 has its kernel builds: a bf16 draft on CUDA
    is accepted with both kernels on (paged at the engine's page size),
    and so is training it, over the attention backward's D 32 build."""
    target = TransformerConfig(vocab_size=64, d_model=128, n_heads=2, n_layers=1, d_ff=64,
                               max_seq=256)
    d = draft_config_for("lm_draft", target)
    assert d.head_dim == 32 and d.use_flash_attention is None and d.use_flash_decode is None
    check_kernels_take(d, torch.device("cuda"), 128)
    check_kernels_take(d, torch.device("cuda"), training=True)


def test_server_refuses_a_mismatched_draft(model):
    wrong = lm_from_jax(dataclasses.replace(draft_config_for("lm_draft", CFG), vocab_size=32),
                        _jax_params(dataclasses.replace(
                            jax_draft_config_for("lm_draft", JCFG), vocab_size=32), 1),
                        device="cpu")
    with pytest.raises(ValueError, match="share"):
        InferenceServer(model, serving=ServingConfig(kv_layout="paged", page_size=PS,
                                                     speculate_k=2), draft=wrong)


# -- greedy bit-identity -------------------------------------------------------


@pytest.mark.parametrize("k,draft", [(1, "lm_draft"), (4, "lm_draft"), (2, "self")])
def test_spec_greedy_bit_identical_to_solo(params, model, k, draft):
    """Whatever the draft proposes (a near-perfect self-draft, or a random
    draft rejected almost every round) the greedy stream equals solo
    decode, the port's and JAX's."""
    server = _server(model, k, draft)
    try:
        rs = np.random.RandomState(3)
        for plen, n in [(5, 9), (20, 12), (33, 7)]:
            prompt = rs.randint(0, 64, (1, plen)).astype(np.int32)
            solo = _solo(model, prompt, n)
            np.testing.assert_array_equal(
                solo, np.asarray(jax_gen.generate(JCFG, params, jnp.asarray(prompt), n)))
            with _client(server) as c:
                got = c.generate(prompt, n_tokens=n)
            np.testing.assert_array_equal(got, solo)
    finally:
        server.stop()


def test_spec_multi_row_and_single_token(model):
    """Row-independent greedy batches ride speculation too, and an
    n_tokens=1 request (no round at all) still round-trips."""
    server = _server(model, 2, "self")
    try:
        prompt = np.random.RandomState(11).randint(0, 64, (3, 8)).astype(np.int32)
        with _client(server) as c:
            np.testing.assert_array_equal(c.generate(prompt, n_tokens=6), _solo(model, prompt, 6))
            np.testing.assert_array_equal(c.generate(prompt[:1], n_tokens=1),
                                          _solo(model, prompt[:1], 1))
    finally:
        server.stop()


def test_spec_eos_freezes_mid_round(model):
    """An eos inside a verify window cuts the round where solo freezes;
    the host pads the rest of the budget with eos."""
    server = _server(model, 3, "self")
    try:
        prompt = np.random.RandomState(9).randint(0, 64, (1, 10)).astype(np.int32)
        eos_tok = int(_solo(model, prompt, 10)[0, 12])  # the third generated token
        with _client(server) as c:
            got = c.generate(prompt, n_tokens=10, eos_id=eos_tok)
        np.testing.assert_array_equal(got, _solo(model, prompt, 10, eos_id=eos_tok))
    finally:
        server.stop()


def test_spec_greedy_streams_equal_jax_server(params, model):
    """The same numpy weights, target and draft, through the converters:
    the JAX package's speculative server and the port's answer the same
    prompts with the same greedy tokens."""
    dparams = _jax_params(jax_draft_config_for("lm_draft", JCFG), 1)
    draft_lm = lm_from_jax(draft_config_for("lm_draft", CFG), dparams, device="cpu")
    port = _server(model, 3, draft_lm=draft_lm)
    jax_srv = JaxServer(JCFG, params, port=0, draft_params=dparams, serving=JaxServing(
        batch_window_s=0.1, decode_chunk=4, kv_layout="paged", page_size=PS, speculate_k=3,
        draft_model="lm_draft")).setup()
    try:
        rs = np.random.RandomState(4)
        for plen, n in [(6, 10), (19, 14)]:
            prompt = rs.randint(0, 64, (2, plen)).astype(np.int32)
            with _client(port) as c:
                got = c.generate(prompt, n_tokens=n)
            with JaxClient(jax_srv.address).setup() as c:
                want = c.generate(prompt, n_tokens=n)
            np.testing.assert_array_equal(got, want)
    finally:
        port.stop()
        jax_srv.stop()


@pytest.mark.parametrize("noise", [0.0, 0.05])
def test_spec_programs_match_jax(params, model, noise):
    """``draft_k``, ``verify`` and ``commit`` against JAX's
    ``_build_spec_fns`` programs on the same prefilled paged caches, for a
    draft equal to the target (every draft accepted) and one with noised
    weights (acceptance varies by row and round): the same drafts, n_acc,
    emitted tokens, n_emit, next tokens and positions, round after round."""
    k, slots_n, n_pages = 3, 2, 8
    rng = np.random.RandomState(12)
    dparams = jax.tree_util.tree_map(
        lambda a: a + noise * rng.randn(*a.shape).astype(a.dtype) if a.dtype.kind == "f" else a,
        params)
    dmodel = lm_from_jax(CFG, dparams, device="cpu")
    prompt = rng.randint(0, 64, (slots_n, 11)).astype(np.int32)
    table = np.full((slots_n, 3 + 1), n_pages, np.int32)
    table[0, :3], table[1, :3] = [5, 0, 3], [6, 2, 7]
    slots = np.arange(slots_n, dtype=np.int32)
    plen = prompt.shape[1]

    # JAX: prefill, insert, then the jitted round
    j_prefill, _ = jax_gen._build_prefill(JCFG)
    j_insert, _ = jax_gen._build_paged_fns(JCFG, PS)
    j_draft_k, j_verify, j_commit = jax_gen._build_spec_fns(JCFG, JCFG, k, False)
    jl, jrow = j_prefill(params, jnp.asarray(prompt))
    jcache = j_insert(jax_gen.paged_cache(JCFG, params, slots_n, PS, n_pages), jrow,
                      jnp.asarray(slots), np.int32(plen), np.int32(0), jnp.asarray(table))
    _, jdrow = j_prefill(dparams, jnp.asarray(prompt))
    jdcache = j_insert(jax_gen.paged_cache(JCFG, dparams, slots_n, PS, n_pages), jdrow,
                       jnp.asarray(slots), np.int32(plen), np.int32(0), jnp.asarray(table))
    # the port: the same
    pl, prow = gen.prefill(model, prompt)
    pcache = gen.paged_insert(gen.paged_cache(CFG, slots_n, PS, n_pages, "cpu"), prow, slots,
                              plen, 0, table)
    _, pdrow = gen.prefill(dmodel, prompt)
    pdcache = gen.paged_insert(gen.paged_cache(CFG, slots_n, PS, n_pages, "cpu"), pdrow, slots,
                               plen, 0, table)

    tok = np.asarray(jnp.argmax(jl, -1), np.int32)
    np.testing.assert_array_equal(tok, torch.argmax(pl, -1).numpy())
    zeros = np.zeros((slots_n,), np.float32)
    ks = np.zeros((slots_n,), np.int32)
    ps_ = np.ones((slots_n,), np.float32)
    seeds = np.zeros((slots_n,), np.int32)
    done = np.zeros((slots_n,), bool)
    eos = np.full((slots_n,), -1, np.int32)
    accepted = []
    for _ in range(4):
        jdcache, jdrafts, jq = j_draft_k(dparams, jdcache, tok, zeros, ks, ps_, seeds)
        jout = j_verify(params, jcache, tok, jdrafts, jq, zeros, ks, ps_, seeds, done, eos)
        jcache = jout[0]
        jdcache = j_commit(dparams, jdcache, jdrafts[:, -1], jout[6], jout[7])

        pdcache, pdrafts, pq = gen.draft_k(dmodel, pdcache, tok, zeros, ks, ps_, seeds, k)
        pout = gen.verify(model, pcache, tok, pdrafts, pq, zeros, ks, ps_, seeds, done, eos, k)
        pcache = pout[0]
        pdcache = gen.commit(dmodel, pdcache, pdrafts[:, -1], pout[6], pout[7])

        np.testing.assert_array_equal(pdrafts.numpy(), np.asarray(jdrafts))
        for j, name in enumerate(("emit", "n_emit", "n_acc", "new_tok", "new_done",
                                  "catch_up", "new_idx"), start=1):
            np.testing.assert_array_equal(pout[j].numpy(), np.asarray(jout[j]), err_msg=name)
        np.testing.assert_array_equal(pcache.index.numpy(), np.asarray(jout[7]))
        np.testing.assert_array_equal(pdcache.index.numpy(),
                                      np.asarray(jax_gen._cache_positions(jdcache)))
        accepted.append(pout[3].numpy().copy())
        tok = pout[4].numpy()
    if noise == 0.0:
        assert (np.stack(accepted) == k).all()
    else:
        assert len({int(a) for a in np.stack(accepted).ravel()}) > 1, accepted


def test_verify_pass_sees_per_row_windows(model):
    """The verify's s = k + 1 pass over a paged cache whose rows sit at
    different positions: each row's logits equal its own solo cache
    extended by the same tokens (every position attends exactly its
    row's prefix and the window's earlier tokens)."""
    rng = np.random.RandomState(13)
    lens, k = [7, 29], 3
    table = np.full((2, 3 + 1), 8, np.int32)
    table[0, :3], table[1, :3] = [4, 1, 6], [0, 7, 2]
    cache = gen.paged_cache(CFG, 2, PS, 8, "cpu")
    prompts = [rng.randint(0, 64, (1, n)).astype(np.int32) for n in lens]
    for slot, prompt in enumerate(prompts):
        _, row = gen.prefill(model, prompt)
        cache = gen.paged_insert(cache, row, [slot], lens[slot], 0, table)
    seq = rng.randint(0, 64, (2, k + 1)).astype(np.int32)
    logits, cache = model.decode(torch.as_tensor(seq), cache)
    assert cache.index.tolist() == [n + k + 1 for n in lens]
    for slot, prompt in enumerate(prompts):
        _, solo = model.decode(torch.as_tensor(prompt))
        want, _ = model.decode(torch.as_tensor(seq[slot:slot + 1]), solo)
        torch.testing.assert_close(logits[slot], want[0], rtol=0, atol=1e-5)


# -- sampled path ----------------------------------------------------------------


def test_spec_sampled_deterministic_per_seed(model):
    """The sampled stream is a function of (request, seed): the draft
    sample, the accept coin and the residual draw each take their own
    tagged stream under (seed, position)."""
    server = _server(model, 3, "lm_draft")
    try:
        prompt = np.random.RandomState(5).randint(0, 64, (1, 10)).astype(np.int32)
        with _client(server) as c:
            a = c.generate(prompt, n_tokens=12, temperature=0.9, top_k=20, seed=42)
            b = c.generate(prompt, n_tokens=12, temperature=0.9, top_k=20, seed=42)
            d = c.generate(prompt, n_tokens=12, temperature=0.9, top_k=20, seed=43)
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(a, d)  # 12 tokens over 20 survivors
        assert (a[:, :10] == prompt).all() and a.shape == (1, 22)
        assert (a[:, 10:] < CFG.vocab_size).all() and (a[:, 10:] >= 0).all()
    finally:
        server.stop()


def test_stream_tags_are_separate_streams():
    """Tag 0 is the plain sampling stream; each speculative tag its own."""
    seeds = {gen._stream_seed(7, 100, tag) for tag in (0, 1, 2, 3)}
    assert len(seeds) == 4
    assert gen._stream_seed(7, 100) == gen._stream_seed(7, 100, 0)


def _first_token_law(monkeypatch=None):
    """(empirical law of the first emitted token over 4000 seeds, the
    target's truncated softmax) at vocab 8, temperature 1, top-k 6."""
    cfg = TransformerConfig(vocab_size=8, d_model=16, n_heads=2, n_layers=1, d_ff=32,
                            max_seq=8, dtype=torch.float32, use_flash_attention=False,
                            use_flash_decode=False)
    jcfg = JaxConfig(vocab_size=8, d_model=16, n_heads=2, n_layers=1, d_ff=32, max_seq=8,
                     dtype=jnp.float32)
    target = lm_from_jax(cfg, _jax_params(jcfg, 20), device="cpu")
    draft_tree = _jax_params(jcfg, 21)
    # a confident draft that disagrees with the target: the residual matters
    draft_tree["params"]["lm_head"]["kernel"] = draft_tree["params"]["lm_head"]["kernel"] * 4
    draft = lm_from_jax(cfg, draft_tree, device="cpu")
    n, k, top_k = 4000, 2, 6
    prefix = np.tile(np.array([[3, 1, 4]], np.int32), (n, 1))
    tok = np.full((n,), 5, np.int32)
    caches = []
    for m in (target, draft):
        _, row = gen.prefill(m, prefix)
        caches.append(gen.slot_insert(gen.slot_cache(cfg, n, "cpu"), row, np.arange(n), 3))
    temps = np.ones((n,), np.float32)
    top_ks = np.full((n,), top_k, np.int32)
    top_ps = np.ones((n,), np.float32)
    seeds = np.arange(n, dtype=np.int32)
    dcache, drafts, q = gen.draft_k(draft, caches[1], tok, temps, top_ks, top_ps, seeds, k)
    out = gen.verify(target, caches[0], tok, drafts, q, temps, top_ks, top_ps, seeds,
                     np.zeros((n,), bool), np.full((n,), -1, np.int32), k)
    first = out[1][:, 0].numpy()
    freq = np.bincount(first, minlength=8) / n
    logits, _ = target.decode(torch.as_tensor(np.array([[3, 1, 4, 5]], np.int32)))
    p = torch.softmax(gen._truncate_logits(logits[0, -1], top_k, None), -1).numpy()
    return freq, p, q[0, 0].numpy()


def test_spec_sampled_round_follows_the_target_law(monkeypatch):
    freq, p, q = _first_token_law()
    tv = 0.5 * np.abs(freq - p).sum()
    assert tv < TV_BOUND, (tv, freq, p)
    # the law a residual of p in place of max(p - q, 0) would give is far
    # from p here, and the sampler shows it
    accept = np.minimum(p, q).sum()
    wrong = np.minimum(p, q) + (1 - accept) * p
    assert 0.5 * np.abs(wrong - p).sum() > 2 * TV_BOUND
    monkeypatch.setattr(gen, "_residual", lambda p_, q_: p_)
    bad, _, _ = _first_token_law()
    assert 0.5 * np.abs(bad - p).sum() > TV_BOUND


# -- accounting --------------------------------------------------------------------


def test_spec_counters_and_acceptance_ceiling(model):
    """Counters reconcile (0 <= accepted <= proposed) and self-speculation
    sits at the ceiling: every draft matches the verify argmax."""
    tel = get_telemetry()
    p0 = tel.counter_value("serving_spec_proposed_total")
    a0 = tel.counter_value("serving_spec_accepted_total")
    server = _server(model, 2, "self")
    try:
        prompt = np.random.RandomState(6).randint(0, 64, (1, 8)).astype(np.int32)
        with _client(server) as c:
            c.generate(prompt, n_tokens=13)  # 4 full rounds of 2 + 1
        prop = tel.counter_value("serving_spec_proposed_total") - p0
        acc = tel.counter_value("serving_spec_accepted_total") - a0
        assert prop > 0 and 0 <= acc <= prop
        assert acc == prop
        assert 0.0 <= tel.gauge("serving_spec_accepted_per_step").value <= 2.0
    finally:
        server.stop()


def test_spec_fleet_stats_report_speculation(model):
    server = _server(model, 2, "self")
    try:
        prompt = np.random.RandomState(6).randint(0, 64, (1, 8)).astype(np.int32)
        with _client(server) as c:
            c.generate(prompt, n_tokens=7)
        stats = server._on_fleet_stats("probe", {})
        assert stats["speculate_k"] == 2
        assert stats["spec_accept_per_step"] == 2.0
    finally:
        server.stop()


def test_spec_disconnect_reclaims_draft_and_target_pages(model):
    """A client vanishing mid-round returns both models' pages exactly
    once: the shared pool ends all-free with zero refcounts and the
    allocated/released counters match."""
    tel = get_telemetry()
    server = _server(model, 3, "lm_draft", prefix_sharing=False)
    try:
        a0 = tel.counter_value("serving_pages_allocated_total")
        r0 = tel.counter_value("serving_pages_released_total")
        prompt = np.random.RandomState(7).randint(0, 64, (1, 20)).astype(np.int32)
        c = _client(server)
        def run():
            try:
                c.generate(prompt, n_tokens=25)
            except ConnectionLost:
                pass  # the disconnect below cuts this request off

        t = threading.Thread(target=run, daemon=True)
        t.start()
        deadline = time.time() + 30
        while not any(server._draft_pages) and time.time() < deadline:
            time.sleep(0.01)  # until a slot holds committed pages
        assert server._pool.used_pages > 0
        held = [len(server._slot_pages[s]) + len(server._draft_pages[s])
                for s in range(server.serving.max_slots)]
        c.close()  # mid-decode disconnect
        deadline = time.time() + 30
        while time.time() < deadline:
            if all(r is None for r in server._slot_req) and server._pool.used_pages == 0:
                break
            time.sleep(0.02)
        pool = server._pool
        assert pool.free_pages == pool.n_pages
        assert (pool._refs == 0).all()
        assert all(not p for p in server._slot_pages)
        assert all(not p for p in server._draft_pages)
        alloc = tel.counter_value("serving_pages_allocated_total") - a0
        freed = tel.counter_value("serving_pages_released_total") - r0
        assert alloc > 0 and alloc == freed
        assert max(held) > 0 and max(held) % 2 == 0  # target + an equal draft share
    finally:
        server.stop()


def test_spec_retirement_releases_both_pools(model):
    """After normal completion no slot holds target or draft pages and the
    pool reconciles without any disconnect."""
    server = _server(model, 2, "lm_draft")
    try:
        prompt = np.random.RandomState(8).randint(0, 64, (1, 12)).astype(np.int32)
        with _client(server) as c:
            c.generate(prompt, n_tokens=8)
        deadline = time.time() + 10
        while time.time() < deadline:
            server.release_prefix_cache()
            if server._pool.used_pages == 0:
                break
            time.sleep(0.02)
        assert server._pool.free_pages == server._pool.n_pages
        assert (server._pool._refs == 0).all()
    finally:
        server.stop()
