"""Port parity: beam search and sequence scoring
(``distriflow_tpu_torch/models/generate.py::beam_search``/``sequence_logprob``
and the server's ``beam``/``score`` handlers).

At f32, from weights carried over with ``params_from_jax``, on the plain
paths of both packages (bf16 and int8 caches):

- ``beam_search`` gives JAX's tokens exactly and its scores within 1e-4
  (the same log-softmax sums, taken in another order), with and without
  eos freezing and a length penalty;
- ``sequence_logprob`` gives JAX's scores within 1e-4;
- the port's server answers ``beam`` and ``score`` over loopback, from the
  port's client and from the JAX package's client, with those same
  results, keeps the payload defaults (an explicit ``beam_size=0`` reaches
  validation) and echoes ``trace_id``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distriflow_tpu.client import InferenceClient as JaxClient
from distriflow_tpu.models.generate import beam_search as jax_beam_search
from distriflow_tpu.models.generate import sequence_logprob as jax_sequence_logprob
from distriflow_tpu.models.transformer import TransformerConfig as JaxConfig
from distriflow_tpu.models.transformer import transformer_lm
from distriflow_tpu_torch.client.inference_client import InferenceClient
from distriflow_tpu_torch.models.convert import lm_from_jax
from distriflow_tpu_torch.models.generate import beam_search, sequence_logprob
from distriflow_tpu_torch.models.transformer import TransformerConfig
from distriflow_tpu_torch.obs.telemetry import Telemetry
from distriflow_tpu_torch.server.inference_server import InferenceServer
from distriflow_tpu_torch.utils.config import ServingConfig
from distriflow_tpu_torch.utils.serialization import (
    deserialize_array,
    pack_bytes,
    serialize_array,
    unpack_bytes,
)

pytestmark = pytest.mark.port
torch.set_num_threads(2)

ATOL = 1e-4
DIMS = dict(vocab_size=64, d_model=128, n_heads=2, n_layers=2, d_ff=128, max_seq=48)
JCFG = JaxConfig(**DIMS, dtype=jnp.float32, use_flash_attention=False, use_flash_decode=False)
PCFG = TransformerConfig(**DIMS, dtype=torch.float32, use_flash_attention=False,
                         use_flash_decode=False)


@pytest.fixture(scope="module")
def params():
    p = transformer_lm(JCFG, example_seq=16).init(jax.random.PRNGKey(1))
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def models(params):
    return {kv: lm_from_jax(dataclasses.replace(PCFG, kv_cache_dtype=kv), params, device="cpu")
            for kv in (None, "int8_force")}


def _prompt(seed, n, b=2):
    return np.random.RandomState(seed).randint(0, 64, (b, n)).astype(np.int32)


@pytest.mark.parametrize("kv", [None, "int8_force"])
@pytest.mark.parametrize("kw", [{}, dict(eos_id=5, length_penalty=0.6)])
def test_beam_search_matches_jax(params, models, kv, kw):
    prompt = _prompt(2, 7)
    ref_toks, ref_scores = jax_beam_search(dataclasses.replace(JCFG, kv_cache_dtype=kv), params,
                                           jnp.asarray(prompt), 6, beam_size=3, **kw)
    toks, scores = beam_search(models[kv], prompt, 6, beam_size=3, **kw)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(ref_toks))
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores), rtol=0, atol=ATOL)


def test_beam_search_validates_like_jax(models):
    m = models[None]
    with pytest.raises(ValueError, match="beam_size"):
        beam_search(m, _prompt(1, 4), 3, beam_size=0)
    with pytest.raises(ValueError, match="eos_id"):
        beam_search(m, _prompt(1, 4), 3, eos_id=64)
    toks, scores = beam_search(m, _prompt(1, 4), 0)
    assert toks.shape == (2, 4) and float(scores.abs().sum()) == 0.0


@pytest.mark.parametrize("from_pos", [1, 9])
def test_sequence_logprob_matches_jax(params, models, from_pos):
    tokens = _prompt(4, 20)
    ref = np.asarray(jax_sequence_logprob(JCFG, params, jnp.asarray(tokens), from_pos))
    ours = sequence_logprob(models[None], tokens, from_pos)
    assert ours.dtype == torch.float32 and ours.shape == (2,)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="from_pos"):
        sequence_logprob(models[None], tokens, 20)
    with pytest.raises(ValueError, match="vocab_size"):
        sequence_logprob(models[None], tokens + 64, from_pos)


def test_beam_and_score_over_loopback_from_both_clients(params, models):
    model = models["int8_force"]
    jcfg = dataclasses.replace(JCFG, kv_cache_dtype="int8_force")
    prompt, tokens = _prompt(6, 9, b=1), _prompt(7, 16)
    ref_toks, ref_beam = jax_beam_search(jcfg, params, jnp.asarray(prompt), 5, beam_size=4)
    ref_score = np.asarray(jax_sequence_logprob(jcfg, params, jnp.asarray(tokens), 4))
    server = InferenceServer(model, telemetry=Telemetry(), serving=ServingConfig(
        batch_window_s=0.05, page_size=16)).setup()
    try:
        for cls in (InferenceClient, JaxClient):
            c = cls(server.address).setup()
            try:
                toks, beam_scores = c.beam_search(prompt, 5, beam_size=4)
                np.testing.assert_array_equal(np.asarray(toks), np.asarray(ref_toks))
                np.testing.assert_allclose(np.asarray(beam_scores, np.float32),
                                           np.asarray(ref_beam), rtol=0, atol=ATOL)
                np.testing.assert_allclose(np.asarray(c.score(tokens, from_pos=4), np.float32),
                                           ref_score, rtol=0, atol=ATOL)
                with pytest.raises(RuntimeError, match="beam"):
                    c.beam_search(prompt, 5, beam_size=0)  # reaches validation
            finally:
                c.close()
        wire = {"prompt": pack_bytes({"tokens": serialize_array(tokens)}), "trace_id": "t-9"}
        ack = server._on_score("direct", wire)  # from_pos defaults to 1
        assert ack["trace_id"] == "t-9"
        got = deserialize_array(unpack_bytes(ack["result"])["scores"])
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(jax_sequence_logprob(jcfg, params, jnp.asarray(tokens))),
            rtol=0, atol=ATOL)
        ack = server._on_beam("direct", {**wire, "n_tokens": 2})  # beam_size defaults to 4
        assert ack["trace_id"] == "t-9"
        assert np.asarray(deserialize_array(unpack_bytes(ack["result"])["tokens"])).shape == (2, 18)
    finally:
        server.stop()
