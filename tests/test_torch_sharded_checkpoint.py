"""Port parity: the sharded checkpoint store (``distriflow_tpu_torch/
checkpoint/sharded.py``) and ``SyncTrainer(sharded_checkpoints=True)``
against the JAX package's store (JAX's ``test_sharded_checkpoint.py`` and
``test_distributed_checkpoint.py``), on the CPU.

The port runs in a spawned gloo world of 4 CPU processes (``tests/
torch_mesh_cases.py::checkpoint_cases``, each rank a process that writes
its own shard file), then in a world of 2 (``checkpoint_small_cases``);
JAX runs here on ``devices[:4]``. The tree is JAX's test tree (``w``
``[8, 4]`` over ``(data, model)``, ``b`` over ``model``, ``scale``
replicated, a 0-d ``step``, a host ``host_note``) and a bf16 ``h`` over
``(None, model)``:

- round trip on ``{data 2, model 2}``, bit for bit;
- replicas written once: the shard files hold the tree's unique bytes, one
  record for a replicated leaf, one per block for a sharded one, each
  written by the lowest rank holding it;
- restore into another layout (``{data 4}``) and onto 2 ranks, bit for bit;
- version semantics, a shape mismatch refused, a snapshot's save is pure
  file I/O;
- a rank whose write fails: nothing is published and every rank raises;
- a ZeRO-1 adam trainer on ``{data 4}`` restored on ``{data 2}``: the
  gathered parameters and moments bit for bit, the step, the moments
  still sliced over ``data``, and the next step's loss equal;
- the cross-package oracle: JAX's store loads the port's checkpoint, and
  the port loads JAX's, bit for bit.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from distriflow_tpu.checkpoint import ShardedCheckpointStore as JaxStore

from torch_mesh_cases import run_world

pytestmark = pytest.mark.port

JAX_SPECS = {"w": P("data", "model"), "b": P("model"), "scale": P(), "step": P(),
             "h": P(None, "model")}


def _tree():
    r = np.random.RandomState(3)
    h = r.randn(4, 8).astype(np.float32)
    return {"w": r.randn(8, 4).astype(np.float32), "b": r.randn(4).astype(np.float32),
            "scale": r.randn(8, 4).astype(np.float32), "step": np.int32(3),
            "host_note": np.float32(3.0),
            # bf16 values: exact in f32, so both packages hold the same bits
            "h": np.asarray(jnp.asarray(h, jnp.bfloat16).astype(jnp.float32))}


def _jax_tree(mesh, tree):
    out = {}
    for k, v in tree.items():
        if k == "host_note":
            out[k] = v
        elif k == "h":
            out[k] = jax.device_put(jnp.asarray(v, jnp.bfloat16), NamedSharding(mesh, JAX_SPECS[k]))
        else:
            out[k] = jax.device_put(v, NamedSharding(mesh, JAX_SPECS[k]))
    return out


def _as_np(tree):
    return {k: np.asarray(jnp.asarray(v).astype(jnp.float32)) if k == "h" else np.asarray(v)
            for k, v in tree.items()}


def _block(full, spec, coords, sizes):
    idx = []
    for dim, n in enumerate(full.shape):
        ax = spec[dim] if dim < len(spec) else None
        if ax is None:
            idx.append(slice(None))
        else:
            size = n // sizes[ax]
            idx.append(slice(coords[ax] * size, (coords[ax] + 1) * size))
    return full[tuple(idx)]


def _mlp_batch():
    rng = np.random.RandomState(0)
    x = rng.randn(16, 28, 28, 1).astype(np.float32)
    return x, np.eye(10, dtype=np.float32)[rng.randint(0, 10, 16)]


@pytest.fixture(scope="module")
def runs(devices, tmp_path_factory):
    tree = _tree()
    dirs = {k: str(tmp_path_factory.mktemp(k)) for k in
            ("jax_dir", "port_dir", "version_dir", "fail_dir", "trainer_dir")}
    mesh = Mesh(np.array(devices[:4]).reshape(2, 2), ("data", "model"))
    JaxStore(dirs["jax_dir"]).save(_jax_tree(mesh, tree), version="7")
    payload = dict(dirs, tree=tree, mlp_batch=_mlp_batch())
    four = run_world(4, "checkpoint_cases", payload)
    two = run_world(2, "checkpoint_small_cases", payload)
    # JAX loads the port's checkpoint into its own shardings
    like = _jax_tree(mesh, {k: np.zeros_like(v) for k, v in tree.items()})
    from_port = _as_np(JaxStore(dirs["port_dir"]).load("7", like))
    return tree, dirs, four, two, from_port


def _coords(rank, shape):
    names = list(shape)
    pos = np.unravel_index(rank, tuple(shape.values()))
    return dict(zip(names, (int(i) for i in pos)))


@pytest.mark.parametrize("key", ["from_jax", "roundtrip", "relayout"])
def test_each_rank_reads_its_blocks_bit_for_bit(runs, key):
    tree, _, four, _, _ = runs
    shape = {"data": 4} if key == "relayout" else {"data": 2, "model": 2}
    specs = ({"w": ("data",), "h": ("data",)} if key == "relayout" else
             {"w": ("data", "model"), "b": ("model",), "h": (None, "model")})
    for rank, r in enumerate(four):
        got = r[key]
        for k, full in tree.items():
            want = _block(np.asarray(full), specs.get(k, ()), _coords(rank, shape), shape)
            np.testing.assert_array_equal(got[k], want, err_msg=f"{key} {k} rank {rank}")


def test_jax_loads_the_port_checkpoint_bit_for_bit(runs):
    tree, _, _, _, from_port = runs
    for k, v in tree.items():
        np.testing.assert_array_equal(from_port[k], np.asarray(v), err_msg=k)


def test_replicas_written_once(runs):
    tree, dirs, four, _, _ = runs
    d = os.path.join(dirs["port_dir"], "7")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    assert meta["sharded"] and meta["format"] == 1 and meta["processes"] == 4
    logical = sum(np.asarray(v).nbytes // (2 if k == "h" else 1) for k, v in tree.items())
    on_disk = sum(os.path.getsize(os.path.join(d, f"shards.{p}.bin")) for p in range(4))
    assert on_disk == logical
    leaves = meta["leaves"]
    assert len(leaves["['scale']"]["shards"]) == 1
    assert len(leaves["['w']"]["shards"]) == 4
    # b is split over model only: its two blocks belong to ranks 0 and 1
    assert sorted(r["process"] for r in leaves["['b']"]["shards"]) == [0, 1]
    assert leaves["['h']"]["dtype"] == "bfloat16"
    assert all(r["version"] == "7" for r in four)


def test_restore_onto_two_ranks(runs):
    tree, _, _, two, _ = runs
    for rank, r in enumerate(two):
        for k, full in tree.items():
            spec = {"w": ("data",), "b": ("data",)}.get(k, ())
            want = _block(np.asarray(full), spec, {"data": rank}, {"data": 2})
            np.testing.assert_array_equal(r["onto2"][k], want, err_msg=k)


def test_version_semantics_mismatch_and_snapshot(runs):
    tree, dirs, four, _, _ = runs
    for r in four:
        assert r["versions"] == (["100", "200"], "200")
        assert r["latest"] == ("200", 2)
        assert "shape mismatch" in r["mismatch"]
        snap, meta = r["snapshot"]
        assert meta == {"note": "async"}
        assert float(np.abs(snap["scale"]).sum()) > 0  # the snapshot's, not the zeroed
    assert os.readlink(os.path.join(dirs["version_dir"], "current")) == "200"


def test_failed_write_commits_nothing_and_every_rank_raises(runs):
    _, dirs, four, _, _ = runs
    for r in four:
        assert r["fail"] is not None
    assert "planted" in four[2]["fail"]
    published = [n for n in os.listdir(dirs["fail_dir"])
                 if not n.startswith(".") and n != "current"]
    assert published == []


def test_trainer_zero1_restores_on_fewer_ranks(runs):
    _, _, four, two, _ = runs
    saved = four[0]["trainer"]
    for r in two:
        assert r["restored"] and r["step"] == 2
        assert r["count"] == (False, 2)  # the optimizer's count comes back a host value
        for n, v in saved["params"].items():
            np.testing.assert_array_equal(r["params"][n], v, err_msg=n)
        for k, d in saved["opt"].items():
            for n, v in d.items():
                np.testing.assert_array_equal(r["opt"][k][n], v, err_msg=f"{k} {n}")
        # the moments stay sliced over the smaller data axis where ZeRO cuts them
        assert any(r["moment_bytes"][n] * 2 == r["param_numel"][n] for n in r["param_numel"])
        np.testing.assert_allclose(r["next_loss"], saved["next_loss"], rtol=1e-6)
