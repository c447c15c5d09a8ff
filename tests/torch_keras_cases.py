"""Shared pieces of the Keras-import parity tests (``tests/test_torch_keras_*.py``,
``tests/test_torch_url_model.py``, ``tests/test_torch_dynamic.py``): topology
builders, a writer of ``model.json`` plus one weight shard, and the
cross-package oracle that loads one file through JAX's importer and the
port's and compares forward outputs and gradients.

Tolerances: f32 within ``F32_TOL`` (1e-5, absolute plus relative), bf16
within ``BF16_TOL`` (2e-2)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from distriflow_tpu.models import keras_import as jk
from distriflow_tpu_torch.models import keras_import as tk

F32_TOL = 1e-5
BF16_TOL = 2e-2


def layer(cls, name, batch_input=None, **cfg):
    cfg = {"name": name, **cfg}
    if batch_input is not None:
        cfg["batch_input_shape"] = batch_input
    return {"class_name": cls, "config": cfg}


def sequential(layers):
    return {"modelTopology": {"model_config": {"class_name": "Sequential",
                                               "config": {"name": "seq", "layers": layers}}}}


def functional(layers, inputs, outputs):
    return {"modelTopology": {"model_config": {"class_name": "Model", "config": {
        "name": "graph", "layers": layers, "input_layers": [[n, 0, 0] for n in inputs],
        "output_layers": [[n, 0, 0] for n in outputs]}}}}


def node(cls, name, parents, **cfg):
    return {"name": name, "class_name": cls, "config": {"name": name, **cfg},
            "inbound_nodes": [[[p, 0, 0, {}] for p in parents]]}


def graph_input(name, shape):
    return {"name": name, "class_name": "InputLayer",
            "config": {"name": name, "batch_input_shape": [None, *shape]},
            "inbound_nodes": []}


def write_model(root, topology, weights=None, shards=("group1-shard1of1",)):
    """Write ``model.json`` (and, given ``weights`` as ``[(name, array)]``,
    one weight group split evenly over ``shards``) under ``root``."""
    root = str(root)
    os.makedirs(root, exist_ok=True)
    topology = dict(topology)
    if weights is not None:
        buf = b"".join(np.ascontiguousarray(a).tobytes() for _, a in weights)
        topology["weightsManifest"] = [{
            "paths": list(shards),
            "weights": [{"name": n, "shape": list(a.shape), "dtype": str(a.dtype)}
                        for n, a in weights]}]
        cut = -(-len(buf) // len(shards))
        for i, shard in enumerate(shards):
            dst = os.path.join(root, shard)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            with open(dst, "wb") as f:
                f.write(buf[i * cut:(i + 1) * cut])
    path = os.path.join(root, "model.json")
    with open(path, "w") as f:
        json.dump(topology, f)
    return path


def random_weights(topology, seed=0, scale=0.5, input_shape=None):
    """``[(layer/weight, f32 array)]`` for every weight JAX's importer
    declares for ``topology``, drawn from a seeded normal."""
    kind, config = jk._model_config(topology)
    b = jk._Builder()
    if kind == "Sequential":
        if input_shape is not None:
            b.shape = tuple(input_shape)
        for lay in config:
            b.add(lay["class_name"], dict(lay.get("config", {})))
    else:
        jk._build_graph(config, b, input_shape)
    rng = np.random.default_rng(seed)
    out = []
    for lname in sorted(b.inits):
        for wname, (shape, _) in sorted(b.inits[lname].items()):
            a = (rng.standard_normal(shape) * scale).astype(np.float32)
            if wname == "moving_variance":
                a = np.abs(a) + 0.5
            out.append((f"{lname}/{wname}", a))
    return out


def _tree_np(tree):
    return {k: (_tree_np(v) if isinstance(v, dict) else np.asarray(v, np.float32))
            for k, v in tree.items()}


def _as_jax(x):
    if isinstance(x, (tuple, list)):
        return tuple(jnp.asarray(v) for v in x)
    return jnp.asarray(x)


def _as_torch(x):
    if isinstance(x, (tuple, list)):
        return tuple(torch.as_tensor(v) for v in x)
    return torch.as_tensor(x)


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [np.asarray(jnp.asarray(o, jnp.float32)) if not isinstance(o, torch.Tensor)
                else o.detach().float().numpy() for o in out]
    return _flat([out])


def assert_close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want)
    lim = tol + tol * np.abs(want)
    assert np.all(err <= lim), f"{what}: max err {err.max()} (tol {tol})"


def both(path, x, y=None, loader="json", dtype="float32", tol=None, **kw):
    """Load ``path`` through JAX's and the port's importer (the port on the
    CPU), run both forwards on ``x`` and, given targets ``y``, both
    gradients, and hold them within ``tol``. Returns the two specs."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tol = tol if tol is not None else (F32_TOL if dtype == "float32" else BF16_TOL)
    jload = {"json": jk.spec_from_keras_json, "h5": jk.spec_from_keras_h5}[loader]
    tload = {"json": tk.spec_from_keras_json, "h5": tk.spec_from_keras_h5}[loader]
    jspec = jload(path, dtype=jdt, **kw)
    tspec = tload(path, dtype=tdt, device="cpu", **kw)
    assert tspec.name == jspec.name
    assert tspec.input_shape == jspec.input_shape
    assert tspec.output_shape == jspec.output_shape
    jp = jspec.init(jax.random.PRNGKey(0))
    model = tspec.init(0)
    want = jspec.apply(jp, _as_jax(x))
    got = tspec.apply(model, _as_torch(x))
    for i, (g, w) in enumerate(zip(_flat(got), _flat(want))):
        assert_close(g, w, tol, f"output {i}")
    if y is not None:
        jl, jg = jspec.grad_fn()(jp, _as_jax(x), _as_jax(y))
        tl, tg = tspec.grad_fn()(model, _as_torch(x), _as_torch(y))
        assert_close(float(tl), float(jl), tol, "loss")
        want_g = tk.keras_tree_to_params(_tree_np(jg))
        assert set(tg) == set(want_g)
        for n in tg:
            assert_close(tg[n].float().numpy(), want_g[n], tol, f"grad {n}")
    return jspec, tspec


def two_input_graph():
    """Two inputs through ``Concatenate``: tokens -> Embedding -> GAP and
    floats -> Dense, one softmax head (``[B, 3]``)."""
    return functional([
        graph_input("tokens", (5,)), graph_input("feats", (3,)),
        node("Embedding", "emb", ["tokens"], input_dim=11, output_dim=4),
        node("GlobalAveragePooling1D", "pool", ["emb"]),
        node("Dense", "proj", ["feats"], units=4, activation="tanh"),
        node("Concatenate", "cat", ["pool", "proj"], axis=-1),
        node("Dense", "head", ["cat"], units=3, activation="softmax"),
    ], ["tokens", "feats"], ["head"])


def two_output_graph():
    """Two output heads of other per-example shapes: tokens -> Embedding,
    then a softmax head at every position (``[B, 5, 3]``, a ``[B, 5]``
    per-example loss) and a pooled softmax head (``[B, 2]``, a ``[B]``
    loss)."""
    return functional([
        graph_input("tokens", (5,)),
        node("Embedding", "emb", ["tokens"], input_dim=11, output_dim=4),
        node("Dense", "head_a", ["emb"], units=3, activation="softmax"),
        node("GlobalAveragePooling1D", "pool", ["emb"]),
        node("Dense", "head_b_pre", ["pool"], units=2),
        node("Softmax", "head_b", ["head_b_pre"], axis=-1),
    ], ["tokens"], ["head_a", "head_b"])


def multi_io_data(graph, n, seed):
    """``(x, y)`` for :func:`two_input_graph` or :func:`two_output_graph`:
    ``n`` rows drawn from ``seed``, one-hot targets."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 11, (n, 5)).astype(np.int32)
    if graph == "two_inputs":
        return ((tokens, rng.standard_normal((n, 3)).astype(np.float32)),
                np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)])
    return tokens, (np.eye(3, dtype=np.float32)[rng.integers(0, 3, (n, 5))],
                    np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)])


MULTI_IO_GRAPHS = {"two_inputs": two_input_graph, "two_outputs": two_output_graph}
