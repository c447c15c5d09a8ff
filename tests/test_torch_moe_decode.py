"""Port parity: every decoding path over an MoE model, from JAX's init
carried over with ``params_from_jax``: teacher-forced cached decode
against the dense-dispatch training forward (2e-4, JAX's own limit in
``tests/test_generate.py``, with its tight-capacity divergence bound),
the port's dense forward against JAX's (atol 1e-4), greedy ``generate``
and beam tokens exactly and beam scores and ``sequence_logprob`` within
atol 1e-4 of JAX's, the paged server's routed output equal to solo and to
JAX's ``generate``, and a self-draft speculative round equal to plain
decode. Shared configs and helpers: ``test_torch_moe.py``.
"""

import dataclasses
import importlib
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distriflow_tpu.models.transformer import TransformerLM as JaxLM
from distriflow_tpu_torch.client.inference_client import InferenceClient
from distriflow_tpu_torch.models import generate as gen
from distriflow_tpu_torch.models.convert import lm_from_jax
from distriflow_tpu_torch.server.inference_server import InferenceServer
from distriflow_tpu_torch.utils.config import ServingConfig
from test_torch_moe import _cfgs, _lm_params

jax_gen = importlib.import_module("distriflow_tpu.models.generate")
pytestmark = pytest.mark.port
torch.set_num_threads(2)

PS = 16


def _teacher_forced(model, x, split=5):
    logits, cache = model.decode(torch.tensor(x[:, :split]))
    got = [logits]
    for t in range(split, x.shape[1]):
        lt, cache = model.decode(torch.tensor(x[:, t:t + 1]), cache)
        got.append(lt)
    return torch.cat(got, dim=1).numpy()


def test_cached_decode_equals_training_forward_at_ample_capacity():
    jcfg, pcfg = _cfgs(capacity_factor=8.0, router_aux_weight=0.0)
    params = _lm_params(jcfg)
    model = lm_from_jax(pcfg, params, device="cpu")
    x = np.random.RandomState(0).randint(0, 64, (2, 12)).astype(np.int32)
    with torch.no_grad():
        full = model(torch.tensor(x)).numpy()
    np.testing.assert_allclose(_teacher_forced(model, x), full, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(full, np.asarray(JaxLM(jcfg).apply(params, jnp.asarray(x))),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("k", [1, 2])
def test_tight_capacity_divergence_is_bounded_by_dense_dispatch(k):
    jcfg, pcfg = _cfgs(moe_top_k=k, capacity_factor=0.3, router_aux_weight=0.0)
    params = _lm_params(jcfg)
    model = lm_from_jax(pcfg, params, device="cpu")
    dense = lm_from_jax(dataclasses.replace(pcfg, moe_dense_dispatch=True), params,
                        device="cpu")
    x = np.random.RandomState(1).randint(0, 64, (2, 12)).astype(np.int32)
    with torch.no_grad():
        capacity_logits = model(torch.tensor(x)).numpy()
        dense_logits = dense(torch.tensor(x)).numpy()
    diff = np.max(np.abs(capacity_logits - dense_logits), axis=-1)
    assert np.any(diff > 1e-4), "capacity_factor=0.3 dropped nothing?"
    if k == 1:
        # drops are per token, not global (at k 2 the second choices queue
        # behind every first choice, so position 0 loses its second expert
        # and attention carries that to every later position)
        assert np.any(diff < 1e-5), "every position diverged; the bound is vacuous"
    np.testing.assert_allclose(_teacher_forced(model, x), dense_logits, rtol=2e-4, atol=2e-4)
    jdense = JaxLM(dataclasses.replace(jcfg, moe_dense_dispatch=True))
    np.testing.assert_allclose(dense_logits, np.asarray(jdense.apply(params, jnp.asarray(x))),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("k", [1, 2])
def test_generate_beam_and_score_match_jax(k):
    jcfg, pcfg = _cfgs(moe_top_k=k, capacity_factor=1.0)
    params = _lm_params(jcfg)
    model = lm_from_jax(pcfg, params, device="cpu")
    prompt = np.random.RandomState(3).randint(0, 64, (2, 9)).astype(np.int32)
    ref = np.asarray(jax_gen.generate(jcfg, params, jnp.asarray(prompt), 12))
    np.testing.assert_array_equal(gen.generate(model, prompt, 12).numpy(), ref)
    toks, scores = gen.beam_search(model, prompt[:1], 6, beam_size=3)
    ref_toks, ref_scores = jax_gen.beam_search(jcfg, params, jnp.asarray(prompt[:1]), 6,
                                               beam_size=3)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(ref_toks))
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores), rtol=0, atol=1e-4)
    seq = np.random.RandomState(4).randint(0, 64, (3, 20)).astype(np.int32)
    np.testing.assert_allclose(
        gen.sequence_logprob(model, seq, 4).numpy(),
        np.asarray(jax_gen.sequence_logprob(jcfg, params, seq, 4)), rtol=0, atol=1e-4)


def _prompts():
    rng = np.random.RandomState(7)
    prefix = rng.randint(0, 64, 2 * PS)
    return {"short": rng.randint(0, 64, (1, 5)), "mid": rng.randint(0, 64, (1, 20)),
            "donor": np.concatenate([prefix, rng.randint(0, 64, 5)])[None],
            "sharer": np.concatenate([prefix, rng.randint(0, 64, 3)])[None]}


@pytest.mark.parametrize("k", [1, 2])
def test_server_routes_as_solo_and_jax(k):
    jcfg, pcfg = _cfgs(moe_top_k=k, capacity_factor=1.0)
    params = _lm_params(jcfg)
    model = lm_from_jax(pcfg, params, device="cpu")
    n = 8
    ps = _prompts()
    solo = {name: gen.generate(model, p, n).numpy() for name, p in ps.items()}
    for name, p in ps.items():
        np.testing.assert_array_equal(
            solo[name], np.asarray(jax_gen.generate(jcfg, params, jnp.asarray(p), n)))
    server = InferenceServer(model, serving=ServingConfig(
        batch_window_s=0.2, decode_chunk=4, page_size=PS)).setup()
    try:
        with InferenceClient(server.address).setup() as c:
            np.testing.assert_array_equal(c.generate(ps["donor"], n), solo["donor"])
        clients = [InferenceClient(server.address).setup() for _ in ps]
        try:
            got, errs = {}, []

            def run(c, name):
                try:
                    got[name] = c.generate(ps[name], n)
                except Exception as e:  # surfaced below
                    errs.append(e)

            threads = [threading.Thread(target=run, args=(c, name))
                       for c, name in zip(clients, ps)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not errs, errs
            toks, scores = clients[0].beam_search(ps["short"], 3, beam_size=2)
            ref_toks, _ = jax_gen.beam_search(jcfg, params, jnp.asarray(ps["short"]), 3,
                                              beam_size=2)
            np.testing.assert_array_equal(toks, np.asarray(ref_toks))
        finally:
            for c in clients:
                c.close()
        for name in ps:
            np.testing.assert_array_equal(got[name], solo[name], err_msg=name)
        assert server.prefix_hits >= 1 and server.decode_batches > 0
    finally:
        server.stop()


def test_self_draft_speculation_equals_plain_decode():
    jcfg, pcfg = _cfgs(moe_top_k=2, capacity_factor=1.0)
    params = _lm_params(jcfg)
    model = lm_from_jax(pcfg, params, device="cpu")
    server = InferenceServer(model, serving=ServingConfig(
        batch_window_s=0.1, decode_chunk=4, kv_layout="paged", page_size=PS, speculate_k=2,
        draft_model="self")).setup()
    try:
        rs = np.random.RandomState(3)
        for plen, n in [(5, 9), (20, 12)]:
            prompt = rs.randint(0, 64, (1, plen)).astype(np.int32)
            with InferenceClient(server.address).setup() as c:
                got = c.generate(prompt, n_tokens=n)
            np.testing.assert_array_equal(got, gen.generate(model, prompt, n).numpy())
    finally:
        server.stop()
