"""Port parity: ``SyncTrainer.cost_analysis`` and ``mfu`` on a mesh
(``distriflow_tpu_torch/train/sync.py``) against the JAX package's
per-device figures on the CPU.

JAX runs its trainer on ``devices[:4]`` of the 8 virtual CPU devices; the
port runs each case in a spawned gloo world of 4 CPU processes
(``tests/torch_mesh_cases.py::cost_cases``). The LM (vocab 64, d 64, 4
heads of 16, 2 layers, S 64, B 8, f32) runs the flash attention wrappers
(JAX's Pallas kernels in interpret mode, the port's plain versions) on
``{data 4}`` with the fused sparse CE and on ``{data 2, model 2}`` under
``TRANSFORMER_TP_RULES`` (2 local heads; the vocab-parallel CE is no
kernel), each at ``grad_accum`` 1 and 2. On every rank:

- ``kernel_flops``, ``kernel_hw_flops``, the bytes, the transcendentals and
  ``kernel_by_category`` equal JAX's per-device ``pallas_*`` fields
  exactly (JAX divides its fused CE's global rows by the ``data`` degree
  and multiplies its scan body by ``grad_accum``; the port counts its own
  shard's micro-batch at its shapes and multiplies by ``grad_accum``);
- on the CPU the tally is reported but not added (``flops`` is the aten
  count), as in ``tests/test_torch_flop_count.py``;
- ``mfu`` is ``flops / (step_seconds * peak)``, one card's peak.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distriflow_tpu.models.transformer import TransformerConfig as JaxConfig
from distriflow_tpu.models.transformer import transformer_lm as jax_transformer_lm
from distriflow_tpu.parallel import sharding as js
from distriflow_tpu.parallel.mesh import create_mesh
from distriflow_tpu.train.sync import SyncTrainer as JaxTrainer
from distriflow_tpu.utils.config import MeshConfig

from torch_mesh_cases import run_world

pytestmark = pytest.mark.port

DIMS = dict(vocab_size=64, d_model=64, n_heads=4, n_layers=2, d_ff=64, max_seq=64)
B, S = 8, 64
FIELDS = ("flops", "bytes_accessed", "transcendentals", "hw_flops")
CASES = {
    "dp4": dict(mesh={"data": 4}, rules="REPLICATED_RULES",
                loss="fused_sparse_softmax_cross_entropy"),
    "dp2_tp2": dict(mesh={"data": 2, "model": 2}, rules="TRANSFORMER_TP_RULES",
                    loss="sparse_softmax_cross_entropy"),
}
ACCUMS = (1, 2)
MFU = (0.5, 1e12)  # step seconds, peak FLOP/s


def _batch():
    tok = np.random.RandomState(3).randint(0, 64, (B, S + 1)).astype(np.int32)
    return tok[:, :-1], tok[:, 1:]


def _jax_cost(name, accum, devices):
    case = CASES[name]
    mesh = create_mesh(MeshConfig(**case["mesh"]), devices[:4])
    cfg = JaxConfig(**DIMS, dtype=jnp.float32, use_flash_attention=True, loss=case["loss"])
    t = JaxTrainer(jax_transformer_lm(cfg, mesh=mesh, example_seq=S), mesh=mesh,
                   param_rules=getattr(js, case["rules"]), grad_accum=accum)
    t.init(jax.random.PRNGKey(0))
    jax.clear_caches()  # a warm trace cache replays past the kernel wrappers
    return t.cost_analysis(_batch())


@pytest.fixture(scope="module")
def runs(devices):
    want = {(n, a): _jax_cost(n, a, devices) for n in CASES for a in ACCUMS}
    payload = {"dims": DIMS, "cases": CASES, "accums": ACCUMS, "batch": _batch(), "mfu": MFU}
    return want, run_world(4, "cost_cases", payload)


@pytest.mark.parametrize("accum", ACCUMS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_each_rank_tallies_jax_per_device_cost(runs, name, accum):
    want, ranks = runs
    ref = want[(name, accum)]
    cats = ref["pallas_by_category"]
    assert cats and ref["pallas_flops"] == sum(c["flops"] for c in cats.values()) > 0
    assert ("fused_ce" in cats) == (name == "dp4")
    for r in ranks:
        got = r[(name, accum)]["cost"]
        assert got["kernel_flops"] == ref["pallas_flops"]
        assert got["kernel_hw_flops"] == ref["pallas_hw_flops"]
        assert got["kernel_bytes_accessed"] == sum(c["bytes_accessed"] for c in cats.values())
        assert got["kernel_transcendentals"] == sum(c["transcendentals"] for c in cats.values())
        assert set(got["kernel_by_category"]) == set(cats)
        for cat, cost in cats.items():
            for f in FIELDS:
                assert got["kernel_by_category"][cat][f] == cost[f], (cat, f)


@pytest.mark.parametrize("name", sorted(CASES))
def test_cpu_reports_the_tally_and_mfu_divides_by_one_card(runs, name):
    _, ranks = runs
    seconds, peak = MFU
    for r in ranks:
        for accum in ACCUMS:
            got = r[(name, accum)]
            cost = got["cost"]
            assert cost["aten_flops"] > 0 and cost["flops"] == cost["aten_flops"]
            assert not cost["kernel_tally_added"]
            assert got["mfu"] == cost["flops"] / (seconds * peak)
            assert got["cached"]
        # grad_accum multiplies one micro-batch of the same shard
        one, two = r[(name, 1)]["cost"], r[(name, 2)]["cost"]
        assert two["aten_flops"] == one["aten_flops"]
        assert two["kernel_flops"] == one["kernel_flops"]
    # on every rank the same per-device figures (equal shards)
    for accum in ACCUMS:
        assert len({r[(name, accum)]["cost"]["flops"] for r in ranks}) == 1
