"""Port: the continuous-batching engine's contracts
(``distriflow_tpu_torch/server/inference_server.py`` and the device half in
``models/generate.py``), mirroring the JAX package's paged-KV tests.

- greedy decode through the paged pool at scattered pages, the slab slot
  cache and solo ``generate`` give the same tokens;
- copy-on-write: a request diverging inside a shared page never perturbs
  its donor; eos freezing and chunked prefill match solo decode;
- every page a request takes is returned exactly once, also when its
  client vanishes mid-flight or a hedge cancels it;
- the fleet-router handlers: drain refusal, request-id dedup, fleet_stats.

The tiny config of the JAX package's paged tests at f32; weights come
from the JAX initialiser through ``params_from_jax``.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distriflow_tpu.models.generate import generate as jax_generate
from distriflow_tpu.models.transformer import TransformerConfig as JaxConfig
from distriflow_tpu.models.transformer import transformer_lm
from distriflow_tpu_torch.client.inference_client import InferenceClient, RequestRefused
from distriflow_tpu_torch.models.convert import lm_from_jax
from distriflow_tpu_torch.models.generate import (
    decode_chunk,
    generate,
    paged_cache,
    paged_insert,
    pages_per_slot,
    prefill,
    slot_cache,
    slot_insert,
)
from distriflow_tpu_torch.models.transformer import TransformerConfig
from distriflow_tpu_torch.obs.telemetry import Telemetry
from distriflow_tpu_torch.server.inference_server import InferenceServer, _PagePool
from distriflow_tpu_torch.utils.config import ServingConfig

pytestmark = pytest.mark.port
torch.set_num_threads(2)

JCFG = JaxConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=48,
                 dtype=jnp.float32, use_flash_attention=False, use_flash_decode=False)
PCFG = TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=48,
                         dtype=torch.float32, use_flash_attention=False, use_flash_decode=False)
PS = 16


@pytest.fixture(scope="module")
def params():
    p = transformer_lm(JCFG, example_seq=16).init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def model(params):
    return lm_from_jax(PCFG, params, device="cpu")


@pytest.fixture()
def server(model):
    tel = Telemetry()
    srv = InferenceServer(model, telemetry=tel, serving=ServingConfig(
        batch_window_s=0.05, decode_chunk=4, page_size=PS)).setup()
    srv.tel = tel
    yield srv
    srv.stop()


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, 64, (1, n)).astype(np.int32)


def _solo(model, prompt, n, **kw):
    return generate(model, prompt, n, **kw).numpy()


def test_page_pool_allocator_contracts():
    pool = _PagePool(4)
    a = pool.alloc(3)
    assert len(set(a)) == 3 and pool.free_pages == 1
    with pytest.raises(RuntimeError):
        pool.alloc(2)
    pool.ref(a[:1])
    assert pool.refcount(a[0]) == 2
    assert pool.unref(a[:1]) == 0
    assert pool.unref(a) == 3 and pool.free_pages == 4
    with pytest.raises(RuntimeError):
        pool.unref(a[:1])  # double free
    with pytest.raises(RuntimeError):
        pool.ref(a[:1])  # ref of a free page


def test_paged_equals_slab_equals_solo(model):
    """Device half: one row decoded through scattered, unordered pages,
    through the slab slot cache and solo give the same tokens."""
    max_slots, n_pages, n_tokens, slot = 4, 12, 10, 2
    prompt = _prompt(1, 5)
    solo = list(_solo(model, prompt, n_tokens)[0, 5:])
    logits, row = prefill(model, prompt)
    first = int(logits.argmax(-1)[0])
    pp = pages_per_slot(PCFG.max_seq, PS)
    table = np.full((max_slots, pp + 1), n_pages, np.int32)
    table[slot, :pp] = [5, 0, 7]
    caches = {
        "slab": slot_insert(slot_cache(PCFG, max_slots, "cpu"), row, [slot], 5),
        "paged": paged_insert(paged_cache(PCFG, max_slots, PS, n_pages, "cpu"),
                              row, [slot], 5, 0, table),
    }
    for name, cache in caches.items():
        tok = np.zeros(max_slots, np.int32)
        tok[slot] = first
        done = np.ones(max_slots, bool)
        done[slot] = False
        off = dict(temps=np.zeros(max_slots, np.float32), top_ks=np.zeros(max_slots, np.int32),
                   top_ps=np.ones(max_slots, np.float32), seeds=np.zeros(max_slots, np.int64),
                   eos=np.full(max_slots, -1, np.int32))
        cache, _, _, toks = decode_chunk(model, cache, tok, done, chunk=n_tokens - 1, **off)
        assert [first] + list(toks[slot]) == solo, name


def test_copy_on_write_divergence(model, server):
    base = _prompt(5, 33)
    fork = base.copy()
    fork[0, 20:] = (fork[0, 20:] + 7) % 64  # diverges inside page 2
    with InferenceClient(server.address).setup() as c:
        np.testing.assert_array_equal(c.generate(base, 8), _solo(model, base, 8))
        np.testing.assert_array_equal(c.generate(fork, 8), _solo(model, fork, 8))
        assert c.last_serving_meta.get("prefix_tokens") == PS  # shared page 0 only
        np.testing.assert_array_equal(c.generate(base, 8), _solo(model, base, 8))


def test_eos_freeze_and_chunked_prefill_match_solo(params, model):
    prompt = _prompt(9, 21)
    greedy = _solo(model, prompt, 10)
    eos = int(greedy[0, 21 + 3])  # a token the stream does emit
    want = np.asarray(jax_generate(JCFG, params, jnp.asarray(prompt), 10, eos_id=eos))
    np.testing.assert_array_equal(_solo(model, prompt, 10, eos_id=eos), want)
    srv = InferenceServer(model, telemetry=Telemetry(), serving=ServingConfig(
        batch_window_s=0.05, decode_chunk=3, page_size=PS, prefill_chunk=8)).setup()
    try:
        with InferenceClient(srv.address).setup() as c:
            np.testing.assert_array_equal(c.generate(prompt, 10, eos_id=eos), want)
            np.testing.assert_array_equal(c.generate(prompt[:, :19], 1),
                                          _solo(model, prompt[:, :19], 1))
    finally:
        srv.stop()


def _pages_settle(server):
    deadline = time.time() + 30
    while time.time() < deadline:
        if (all(r is None for r in server._slot_req) and not server._backlog
                and server._pool.used_pages == len(server._prefix_map)):
            return
        time.sleep(0.01)
    raise AssertionError("engine did not settle")


def _assert_pool_reconciles(server):
    server.release_prefix_cache()
    pool = server._pool
    assert pool.free_pages == pool.n_pages and (pool._refs == 0).all()
    alloc = server.tel.counter_value("serving_pages_allocated_total")
    freed = server.tel.counter_value("serving_pages_released_total")
    assert alloc > 0 and alloc == freed


def _start_paused(server, client, **kw):
    """Start a generate while the engine is held at its device lock, and
    wait until its pages are reserved."""
    errors = []

    def run():
        try:
            client.generate(_prompt(6, 20), 25, **kw)
        except Exception as e:  # the cancelled request errors by design
            errors.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    deadline = time.time() + 30
    while server._pool.used_pages == 0 and time.time() < deadline:
        time.sleep(0.005)
    assert server._pool.used_pages > 0
    return t, errors


def test_disconnect_mid_flight_reclaims_pages(server):
    c = InferenceClient(server.address).setup()
    with server._device_lock:  # the engine stops at its next device call
        t, _ = _start_paused(server, c)
        c.close()
        deadline = time.time() + 30
        while time.time() < deadline:
            with server._inflight_lock:
                reqs = [r for rs in server._inflight.values() for r in rs]
            if reqs and all(r.cancelled for r in reqs):
                break
            time.sleep(0.005)
        else:
            raise AssertionError("disconnect never cancelled the request")
    _pages_settle(server)
    t.join(timeout=30)
    assert not t.is_alive()
    _assert_pool_reconciles(server)


def test_hedge_cancel_reclaims_and_counts(server):
    c = InferenceClient(server.address).setup()
    try:
        with server._device_lock:
            t, errors = _start_paused(server, c, request_id="hedge-1")
            ack = server._on_hedge_cancel("router", {"request_id": "hedge-1"})
            assert ack == {"request_id": "hedge-1", "cancelled": 1}
        t.join(timeout=30)
        assert errors, "a cancelled request must not complete"
        _pages_settle(server)
    finally:
        c.close()
    assert server.tel.counter_value("serving_hedge_cancelled_total") == 1
    _assert_pool_reconciles(server)


def test_drain_dedup_and_fleet_stats(model, server):
    prompt = _prompt(3, 12)
    with InferenceClient(server.address).setup() as c:
        server.begin_drain()
        with pytest.raises(RequestRefused, match="draining"):
            c.generate(prompt, 4)
        server.end_drain()
        first = c.generate(prompt, 4, request_id="r-1")
        again = c.generate(prompt, 4, request_id="r-1")
    np.testing.assert_array_equal(first, _solo(model, prompt, 4))
    np.testing.assert_array_equal(again, first)
    assert server.tel.counter_value("serving_dedup_hits_total") == 1
    stats = server._on_fleet_stats("router", {})
    assert stats["max_slots"] == 8 and stats["page_size"] == PS and stats["prefix_sharing"]
    assert stats["slots_active"] == 0 and stats["queue_depth"] == 0
    assert all(row["pages"] == 0 for row in server.fleet.snapshot().values())
