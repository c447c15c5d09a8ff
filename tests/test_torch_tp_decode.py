"""Port parity: TP-sharded decoding (``TransformerLM.decode`` on a mesh,
``models/generate.py`` run SPMD) and the mesh-aware ``InferenceServer``
(rank 0 serves, the other ranks follow) against the JAX package on the
CPU (JAX's ``test_tp_decode.py``).

The port runs in a spawned gloo world of 4 CPU processes
(``tests/torch_mesh_cases.py::tp_decode_cases``) on ``{data 2, model 2}``
under ``TRANSFORMER_TP_RULES`` (rows replicated over ``data``, as JAX's
prompt is), f32, the kernels off (vocab 64, d 32, 4 heads, 2 layers,
d_ff 64, max_seq 32), from JAX's weights:

- greedy ``generate``, ``beam_search`` (scores within 1e-5) and
  ``int8_force`` token for token against JAX's one-device ``generate``;
- sampled TP decoding against the port's one rank, bit for bit (sampling
  bits differ from JAX's by design: each ``(seed, position)`` seeds its
  own ``torch.Generator``); TP ``sequence_logprob`` against the port's one
  rank within ``SCORE_RTOL`` and against JAX's within ``JAX_SCORE_RTOL``
  (JAX's ``test_tp_decode.py`` holds TP scores at 1e-5): a Megatron split
  sums ``o_proj`` and the MLP's down projection as two half-contractions
  plus an all-reduce, another f32 summation order than one full
  contraction, so the scores may differ from one rank's by an ulp (the
  tokens do not);
- each rank's cache holds H/2 heads (K/V ``[B, max_seq, H/2 * D]``, int8
  scales ``[B, max_seq, H/2]``);
- dense MoE decoding over ``{data 2, expert 2}`` (4 experts, top-2) token
  for token against JAX;
- the mesh ``InferenceServer`` answers engine (greedy and sampled),
  direct, ``beam`` and ``score`` requests as the one-rank server does,
  and again after ``set_params`` of other weights (JAX's ``generate``
  on them); a refused request, a device program that raises on every
  rank and a client disconnect mid-decode leave no follower behind (the
  next request is served, and every follower exits at ``stop``);
- a rank 0 that idles for more than twice the control group's timeout
  between two requests keeps its followers (its no-op programs), and
  serves the second request as the first;
- a program that fails on one follower only stops every rank at once:
  the request errors, rank 0's ``mesh_error`` names the rank and its
  error, the next request is refused and every follower raises;
- new weights are cut by the rule table the model carries (the TP
  model's own blocks, a replicated model's full tensors; a mesh model
  cut some other way refuses);
- a follower whose rank 0 never serves (no program, no no-op) raises
  within the control group's timeout;
- speculative serving over the mesh (k 3, paged), with ``lm_draft`` (whole
  on every rank) and with ``"self"`` (the TP target on its local heads):
  greedy answers equal JAX's one-device ``generate`` token for token
  (JAX's contract: greedy speculation equals solo decode), also after
  ``set_params``; a sampled answer equals the one-rank speculative
  server's under the same seed; a refused request and a client that
  disconnects mid-round leave no follower behind (every follower ran
  programs and exits at ``stop``); both servers' pools end all free with
  zero refcounts; each rank's target cache holds H/2 heads, the
  self-draft's H/2, ``lm_draft``'s all of its heads;
- a follower whose drafts differ from rank 0's (rank 2 alters them before
  the verify) stops every rank: the request errors, rank 0's
  ``mesh_error`` names rank 2, the next request is refused and every
  follower raises.
"""

import dataclasses

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

from distriflow_tpu_torch.models.convert import params_from_jax
from distriflow_tpu_torch.models.transformer import TransformerConfig as PortConfig

from torch_mesh_cases import run_world

pytestmark = pytest.mark.port

DIMS = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=32)
MOE = dict(n_experts=4, moe_top_k=2)
CFG = JaxConfig(**DIMS, dtype=jnp.float32, use_flash_attention=False)


def _prompt(b, p, seed):
    return np.random.RandomState(seed).randint(0, 64, (b, p)).astype(np.int32)


PROMPTS = {"greedy": _prompt(2, 8, 0), "beam": _prompt(2, 8, 2), "int8": _prompt(2, 8, 7),
           "sampled": _prompt(2, 8, 1), "disconnect": _prompt(1, 6, 9)}
REQUESTS = {"greedy": [(_prompt(2, 8, 3), 6), (_prompt(1, 5, 4), 7)],
            "sampled": _prompt(1, 6, 5), "direct": _prompt(2, 5, 6), "beam": _prompt(1, 6, 8),
            "score": _prompt(2, 9, 10)}


# TP scores against the port's one rank, and against JAX's
SCORE_RTOL = 1e-6
JAX_SCORE_RTOL = 1e-5
# the idle scenario: the control group's timeout, and rank 0's idle time
IDLE = {"timeout_s": 3.0, "idle_s": 6.5}


def _port_cfg():
    return PortConfig(**DIMS, dtype=torch.float32, use_flash_attention=False,
                      use_flash_decode=False)


@pytest.fixture(scope="module")
def runs():
    params = jax_transformer_lm(CFG, example_seq=16).init(jax.random.PRNGKey(0))
    moe_cfg = dataclasses.replace(CFG, **MOE)
    moe_params = jax_transformer_lm(moe_cfg, example_seq=16).init(jax.random.PRNGKey(1))
    tree = jax.tree_util.tree_map(np.asarray, params)
    moe_tree = jax.tree_util.tree_map(np.asarray, moe_params)
    other = jax_transformer_lm(CFG, example_seq=16).init(jax.random.PRNGKey(2))
    weights = params_from_jax(jax.tree_util.tree_map(np.asarray, other), _port_cfg())
    prompt, n = REQUESTS["greedy"][0]
    ref = {
        "greedy": np.asarray(jax_generate(CFG, params, jnp.asarray(PROMPTS["greedy"]), 8)),
        "beam": tuple(np.asarray(a) for a in jax_beam_search(
            CFG, params, jnp.asarray(PROMPTS["beam"]), 5, beam_size=3)),
        "int8": np.asarray(jax_generate(dataclasses.replace(CFG, kv_cache_dtype="int8_force"),
                                        params, jnp.asarray(PROMPTS["int8"]), 8)),
        "moe": np.asarray(jax_generate(moe_cfg, moe_params, jnp.asarray(PROMPTS["greedy"]), 8)),
        "reloaded": np.asarray(jax_generate(CFG, other, jnp.asarray(prompt), n)),
        "score": np.asarray(jax_sequence_logprob(CFG, params, jnp.asarray(PROMPTS["greedy"]), 2)),
        "served_score": np.asarray(jax_sequence_logprob(
            CFG, params, jnp.asarray(REQUESTS["score"]), 2)),
        "spec_greedy": [np.asarray(jax_generate(CFG, params, jnp.asarray(pr), k))
                        for pr, k in REQUESTS["greedy"]],
    }
    payload = {"dims": DIMS, "moe": MOE, "tree": tree, "moe_tree": moe_tree,
               "prompts": PROMPTS, "requests": dict(REQUESTS, weights=weights), "idle": IDLE}
    return ref, run_world(4, "tp_decode_cases", payload)


@pytest.mark.parametrize("key", ["greedy", "int8", "moe"])
def test_tp_decode_token_for_token_against_jax(runs, key):
    ref, ranks = runs
    for r in ranks:
        np.testing.assert_array_equal(r[key], ref[key])


def test_tp_beam_search_against_jax(runs):
    ref, ranks = runs
    for r in ranks:
        toks, scores = r["beam"]
        np.testing.assert_array_equal(toks, ref["beam"][0])
        np.testing.assert_allclose(scores, ref["beam"][1], rtol=1e-5)


@pytest.mark.parametrize("key", ["sampled", "score"])
def test_tp_equals_one_rank_bit_for_bit(runs, key):
    ref, ranks = runs
    for r in ranks:
        tp, one = r[key]
        if key == "score":  # f32 sums in another order (the module docstring)
            np.testing.assert_allclose(tp, one, rtol=SCORE_RTOL)
            np.testing.assert_allclose(tp, ref["score"], rtol=JAX_SCORE_RTOL)
        else:
            np.testing.assert_array_equal(tp, one)


def test_each_rank_caches_half_the_heads(runs):
    _, ranks = runs
    for r in ranks:
        heads, kv_shape, scale_shape = r["cache"]
        assert heads == 2
        assert kv_shape == (2, 32, 2 * 8)
        assert scale_shape == (2, 32, 2)


@pytest.mark.parametrize("key", ["greedy", "sampled", "direct", "beam", "score", "after",
                                 "reloaded"])
def test_mesh_server_answers_as_the_one_rank_server(runs, key):
    ref, ranks = runs
    got, want = ranks[0]["served"][key], ranks[0]["served_ref"][key]
    if key == "greedy":
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    elif key == "beam":
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    elif key == "score":  # f32 sums in another order (the module docstring)
        np.testing.assert_allclose(got, want, rtol=SCORE_RTOL)
        np.testing.assert_allclose(got, ref["served_score"], rtol=JAX_SCORE_RTOL)
    else:
        np.testing.assert_array_equal(got, want)


def test_mesh_server_set_params_serves_the_new_weights(runs):
    ref, ranks = runs
    np.testing.assert_array_equal(ranks[0]["served"]["reloaded"], ref["reloaded"])


def test_refusal_and_disconnect_leave_no_follower_blocked(runs):
    _, ranks = runs
    served = ranks[0]["served"]
    assert served["refused"] and "failed to handle" in served["refused"]
    assert served["errored"] and "failed to handle" in served["errored"]
    assert served["disconnected"]
    for r in ranks[1:]:  # every follower ran programs and exited at stop
        assert r["follower_ops"] > 0


def test_follower_that_loses_rank_0_raises(runs):
    _, ranks = runs
    for r in ranks[1:]:
        name, waited = r["lost"]
        assert name in ("RuntimeError", "DistBackendError"), name
        assert waited < 30.0


def test_an_idle_rank_0_keeps_its_followers(runs):
    ref, ranks = runs
    assert IDLE["idle_s"] > 2 * IDLE["timeout_s"]
    first, second = ranks[0]["idle"]
    want = ref["reloaded"]  # the model holds the weights the served scenario loaded
    for outcome in (first, second):
        assert outcome[0] == "ok", outcome
        np.testing.assert_array_equal(outcome[1], want)
    for r in ranks[1:]:
        error, ops = r["idle"]
        assert error is None, error
        assert ops > 0


def test_a_failure_on_one_follower_stops_every_rank(runs):
    _, ranks = runs
    hurt = ranks[0]["hurt"]
    assert hurt["first"][0] == "raised" and hurt["next"][0] == "raised"
    assert hurt["first_s"] < 30.0
    assert "rank 2 raised RuntimeError: planted follower fault" in hurt["mesh_error"]
    for r in ranks[1:]:
        error, ops = r["hurt"]
        assert error is not None and "planted follower fault" in error, error
        assert ops > 0


@pytest.mark.parametrize("key", ["tp_table", "tp", "replicated", "replicated_full", "uncut"])
def test_new_weights_are_cut_by_the_models_own_table(runs, key):
    _, ranks = runs
    for r in ranks:
        assert r["cut"][key], (key, r["cut"])


SPEC_DRAFTS = ["lm_draft", "self"]


@pytest.mark.parametrize("draft", SPEC_DRAFTS)
def test_spec_mesh_greedy_equals_jax_generate(runs, draft):
    ref, ranks = runs
    got = ranks[0]["spec"][draft]
    for a, b in zip(got["greedy"], ref["spec_greedy"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got["after"], ref["spec_greedy"][0])
    np.testing.assert_array_equal(got["reloaded"], ref["reloaded"])  # after set_params
    assert got["rounds"] > 0


@pytest.mark.parametrize("draft", SPEC_DRAFTS)
def test_spec_mesh_sampled_equals_one_rank_server(runs, draft):
    _, ranks = runs
    got = ranks[0]["spec"][draft]
    np.testing.assert_array_equal(got["sampled"], got["sampled_ref"])


@pytest.mark.parametrize("draft", SPEC_DRAFTS)
def test_spec_mesh_leaves_no_follower_behind_and_frees_both_pools(runs, draft):
    _, ranks = runs
    got = ranks[0]["spec"][draft]
    assert got["refused"] and "failed to handle" in got["refused"]
    assert got["mid_round"] and got["disconnected"]
    assert got["pool_free"] and got["ref_pool_free"]
    for r in ranks[1:]:
        error, ops = r["spec"][draft]["followed"]
        assert error is None, error
        assert ops > 0


@pytest.mark.parametrize("draft", SPEC_DRAFTS)
def test_spec_mesh_caches_hold_local_heads(runs, draft):
    _, ranks = runs
    d = DIMS["d_model"] // DIMS["n_heads"]
    for r in ranks:
        target, draft_width, draft_local = r["spec"][draft]["widths"]
        assert target == DIMS["n_heads"] // 2 * d
        if draft == "self":
            assert draft_width == target
        else:  # lm_draft: whole on every rank, 4 heads of 32
            assert draft_width == draft_local == 4 * 32
    assert ranks[0]["spec"][draft]["widths"][1] == draft_width


def test_spec_mesh_follower_drafting_apart_stops_every_rank(runs):
    _, ranks = runs
    hurt = ranks[0]["spec"]["hurt"]
    assert hurt["first"][0] == "raised" and hurt["next"][0] == "raised"
    assert "spec_round: rank 2 drafted" in hurt["mesh_error"], hurt["mesh_error"]
    assert "rank 1" not in hurt["mesh_error"] and "rank 3" not in hurt["mesh_error"]
    for r in ranks[1:]:
        error, ops = r["spec"]["hurt"]
        assert error is not None and "rank 2 drafted" in error, error
        assert ops > 0
