"""Port parity: decoding and serving (``distriflow_tpu_torch/models/generate.py``,
``server/inference_server.py``, ``client/inference_client.py``).

- the port's greedy ``generate`` equals the JAX ``generate`` token for token
  at f32, from weights carried over with ``params_from_jax``;
- the port's paged continuous-batching server, driven over loopback by the
  port's client AND the JAX package's client, answers mixed prompt lengths
  (one of them a prefix-cache hit) with exactly the solo decode; the slab
  layout and the direct path do too;
- sampled output depends only on (seed, position): the same request gives
  the same tokens alone, in a mixed batch, and through solo ``generate``;
- the wire bytes equal the JAX package's ``pack_bytes``;
- importing the port loads no JAX module.
"""

import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distriflow_tpu.client import InferenceClient as JaxClient
from distriflow_tpu.models.generate import beam_search as jax_beam_search
from distriflow_tpu.models.generate import generate as jax_generate
from distriflow_tpu.models.transformer import TransformerConfig as JaxConfig
from distriflow_tpu.models.transformer import transformer_lm
from distriflow_tpu.utils import serialization as jax_ser
from distriflow_tpu_torch.client.inference_client import InferenceClient
from distriflow_tpu_torch.models.convert import lm_from_jax
from distriflow_tpu_torch.models.generate import generate
from distriflow_tpu_torch.models.transformer import TransformerConfig
from distriflow_tpu_torch.server.inference_server import InferenceServer
from distriflow_tpu_torch.utils import serialization as port_ser
from distriflow_tpu_torch.utils.config import ServingConfig

pytestmark = pytest.mark.port
torch.set_num_threads(2)

JCFG = JaxConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=48,
                 dtype=jnp.float32, use_flash_attention=False, use_flash_decode=False)
PCFG = TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=48,
                         dtype=torch.float32, use_flash_attention=False, use_flash_decode=False)
PS = 16  # 3 pages per slot


@pytest.fixture(scope="module")
def params():
    p = transformer_lm(JCFG, example_seq=16).init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def model(params):
    return lm_from_jax(PCFG, params, device="cpu")


def _prompts():
    rng = np.random.RandomState(7)
    prefix = rng.randint(0, 64, 2 * PS)
    return {
        "short": rng.randint(0, 64, (1, 5)),
        "mid": rng.randint(0, 64, (1, 20)),
        "donor": np.concatenate([prefix, rng.randint(0, 64, 5)])[None],
        "sharer": np.concatenate([prefix, rng.randint(0, 64, 3)])[None],
    }


def _solo(model, prompt, n, **kw):
    return generate(model, prompt, n, **kw).numpy()


def _concurrent(calls):
    out, errs = [None] * len(calls), []
    barrier = threading.Barrier(len(calls))

    def run(i, fn):
        try:
            barrier.wait(timeout=30)
            out[i] = fn()
        except Exception as e:  # surfaced below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i, f)) for i, f in enumerate(calls)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errs, errs
    assert not any(t.is_alive() for t in threads)
    return out


def test_greedy_generate_matches_jax_token_for_token(params, model):
    prompt = np.random.RandomState(1).randint(0, 64, (2, 9)).astype(np.int32)
    ref = np.asarray(jax_generate(JCFG, params, jnp.asarray(prompt), 12))
    np.testing.assert_array_equal(_solo(model, prompt, 12), ref)


def test_paged_server_matches_solo_for_both_clients(params, model):
    ps = _prompts()
    n = 8
    solo = {k: _solo(model, p, n) for k, p in ps.items()}
    server = InferenceServer(model, serving=ServingConfig(
        batch_window_s=0.2, decode_chunk=4, page_size=PS)).setup()
    try:
        with InferenceClient(server.address).setup() as c:
            # the donor registers its two full prompt pages first
            np.testing.assert_array_equal(c.generate(ps["donor"], n), solo["donor"])
        port_c = InferenceClient(server.address).setup()
        jax_c = JaxClient(server.address).setup()
        try:
            got = _concurrent([
                lambda: port_c.generate(ps["short"], n),
                lambda: jax_c.generate(ps["mid"], n),
                lambda: port_c.generate(ps["sharer"], n),
                lambda: jax_c.generate(ps["donor"], n),
            ])
            assert port_c.model_info()["n_layers"] == 2
            # beam search on the direct path beside the engine equals JAX's
            toks, scores = port_c.beam_search(ps["short"], 2)
            ref_toks, ref_scores = jax_beam_search(JCFG, params, jnp.asarray(ps["short"]), 2)
            np.testing.assert_array_equal(toks, np.asarray(ref_toks))
            np.testing.assert_allclose(scores, np.asarray(ref_scores), rtol=0, atol=1e-4)
        finally:
            port_c.close()
            jax_c.close()
        for key, out in zip(("short", "mid", "sharer", "donor"), got):
            np.testing.assert_array_equal(out, solo[key])
        assert server.prefix_hits >= 2  # the sharer and the repeated donor
        assert server.decode_batches > 0
    finally:
        server.stop()


def test_slab_layout_and_direct_path_match_solo(model):
    ps = _prompts()
    server = InferenceServer(model, serving=ServingConfig(
        batch_window_s=0.1, decode_chunk=3, kv_layout="slab", max_slots=2)).setup()
    try:
        with InferenceClient(server.address).setup() as c:
            np.testing.assert_array_equal(c.generate(ps["mid"], 7), _solo(model, ps["mid"], 7))
            assert c.last_serving_meta["path"] == "slots"
            wide = np.concatenate([ps["short"]] * 3)  # 3 rows > 2 slots: direct
            np.testing.assert_array_equal(c.generate(wide, 4), _solo(model, wide, 4))
            assert c.last_serving_meta["path"] == "direct"
    finally:
        server.stop()


def test_sampled_rows_depend_only_on_seed_and_position(model):
    ps = _prompts()
    kw = dict(temperature=0.8, top_k=20, top_p=0.9)
    solo = _solo(model, ps["mid"], 8, seed=11, **kw)
    assert not np.array_equal(solo, _solo(model, ps["mid"], 8, seed=12, **kw))
    server = InferenceServer(model, serving=ServingConfig(
        batch_window_s=0.2, decode_chunk=4, page_size=PS)).setup()
    try:
        with InferenceClient(server.address).setup() as c:
            alone = c.generate(ps["mid"], 8, seed=11, **kw)
        c1, c2, c3 = (InferenceClient(server.address).setup() for _ in range(3))
        try:
            batched = _concurrent([
                lambda: c1.generate(ps["short"], 8, seed=3, **kw),
                lambda: c2.generate(ps["mid"], 8, seed=11, **kw),
                lambda: c3.generate(ps["donor"], 8),
            ])[1]
        finally:
            for c in (c1, c2, c3):
                c.close()
    finally:
        server.stop()
    np.testing.assert_array_equal(alone, solo)
    np.testing.assert_array_equal(batched, solo)


def test_speculative_serving_is_refused_at_construction(model):
    """Speculative serving is ported (``tests/test_torch_speculative.py``):
    a paged server with ``speculate_k`` builds its draft; what construction
    still refuses is a draft model without speculation, a draft beside
    ``draft_model="self"``, and speculation on the slab layout."""
    server = InferenceServer(model, serving=ServingConfig(speculate_k=2, page_size=PS))
    assert server.draft_model.config.head_dim == 32
    with pytest.raises(ValueError, match="speculate_k"):
        InferenceServer(model, serving=ServingConfig(page_size=PS), draft=model)
    with pytest.raises(ValueError, match="self"):
        InferenceServer(model, serving=ServingConfig(speculate_k=2, page_size=PS,
                                                     draft_model="self"), draft=model)
    with pytest.raises(ValueError, match="paged"):
        InferenceServer(model, serving=ServingConfig(speculate_k=2, kv_layout="slab"))


@pytest.mark.parametrize("arr", [
    np.arange(12, dtype=np.int32).reshape(3, 4),
    np.linspace(-1, 1, 7).astype(np.float32),
    np.array([True, False]),
])
def test_wire_bytes_match_jax_pack_bytes(arr):
    ours = port_ser.pack_bytes({"tokens": port_ser.serialize_array(arr), "x": port_ser.serialize_array(arr)})
    ref = jax_ser.pack_bytes({"tokens": jax_ser.serialize_array(arr), "x": jax_ser.serialize_array(arr)})
    assert ours == ref
    back = port_ser.deserialize_array(port_ser.unpack_bytes(ref)["tokens"])
    np.testing.assert_array_equal(back, arr)


def test_bf16_tensor_bytes_match_jax():
    vals = np.linspace(-3, 3, 10).astype(np.float32)
    ref = jax_ser.pack_bytes({"w": jax_ser.serialize_array(jnp.asarray(vals, jnp.bfloat16))})
    ours = port_ser.pack_bytes({"w": port_ser.serialize_array(torch.from_numpy(vals).to(torch.bfloat16))})
    assert ours == ref
    back = port_ser.deserialize_array(port_ser.unpack_bytes(ref)["w"])
    assert back.dtype == torch.bfloat16
    np.testing.assert_array_equal(back.float().numpy(), np.asarray(jnp.asarray(vals, jnp.bfloat16), np.float32))


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import distriflow_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'distriflow_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        # the serving fleet and its control plane, through their packages
        "from distriflow_tpu_torch.fleet import (FleetAutoscaler, FleetRouter, HashRing,\n"
        "    ReplicaRegistry, ReplicaState, RouterClient, page_hashes, shareable_pages)\n"
        "from distriflow_tpu_torch.obs import (HealthSentinel, SLOBand, TimelineStore,\n"
        "    assemble, default_bands)\n"
        # the doctor and what it drives
        "from distriflow_tpu_torch.fleet import (AdaptiveController, SoakConfig, SoakModel,\n"
        "    run_soak)\n"
        "from distriflow_tpu_torch.obs import BenchLedger, install_cuda_hooks\n"
        "from distriflow_tpu_torch.obs.dump import main, summarize_timeline\n"
        "from distriflow_tpu_torch.parallel import collective_latency_us, data_parallel_mesh\n"
        "from distriflow_tpu_torch.doctor import main\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'distriflow_tpu', 'experiments'))\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
    # every import statement, the ones inside functions included, of the
    # port and of chip_smoke.py (which the card runs without the rest)
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent
    forbidden = {"jax", "jaxlib", "flax", "optax", "distriflow_tpu", "experiments"}
    for path in [*sorted((root / "distriflow_tpu_torch").rglob("*.py")), root / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            bad = [n for n in names if n.split(".")[0] in forbidden]
            assert not bad, f"{path.relative_to(root)} imports {bad}"
