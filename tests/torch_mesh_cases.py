"""Rank bodies of the port's mesh tests (``tests/test_torch_parallel.py``,
``test_torch_ring_attention.py``, ``test_torch_ulysses.py``,
``test_torch_sync_mesh.py``, ``test_torch_federated_mesh.py`` and the
other ``test_torch_*`` files that run a world).

:func:`run_world` spawns a gloo world of CPU processes (spawn start
method, a file store, :data:`~distriflow_tpu_torch.parallel.mesh.GROUP_TIMEOUT`
on every group) that runs one of the ``*_cases`` functions below on every
rank, joins it within a deadline and returns each rank's results. A rank
that raises exits non-zero and fails the world. This module imports no JAX,
so the children never load it: the JAX side of each test runs in the
pytest process on the virtual CPU devices of ``tests/conftest.py``.
"""

from __future__ import annotations

import os
import tempfile
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD_DEADLINE_S = 300


def _rank_main(rank, world, store, out_dir, case, payload):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    try:
        result = globals()[case](rank, payload)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def run_world(n: int, case: str, payload, deadline_s: float = WORLD_DEADLINE_S):
    """Run ``case(rank, payload)`` on every rank of an ``n``-process gloo
    world; returns the per-rank results. Raises if a rank fails or the
    world outlives ``deadline_s``."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, args=(r, n, store, tmp, case, payload))
                 for r in range(n)]
        for p in procs:
            p.start()
        end = time.monotonic() + deadline_s
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        if hung:
            raise RuntimeError(f"ranks {hung} of the {case} world outlived {deadline_s} s")
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"the {case} world failed: exit codes {codes}")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(n)]


def _np(t):
    return t.detach().cpu().numpy()


# -- tests/test_torch_parallel.py ------------------------------------------


def _shard_slices(mesh, spec, shape):
    """(start, size) per dim of this rank's block of a ``shape`` array."""
    from distriflow_tpu_torch.parallel.mesh import axis_index, axis_size

    out = []
    for dim, n in enumerate(shape):
        ax = spec[dim] if dim < len(spec) else None
        if ax is None:
            out.append((0, n))
        else:
            size = n // axis_size(mesh, ax)
            out.append((axis_index(mesh, ax) * size, size))
    return out


def parallel_cases(rank, p):
    from distriflow_tpu_torch.data.dataset import DistributedDataset
    from distriflow_tpu_torch.data.prefetch import prefetch_to_device
    from distriflow_tpu_torch.models.convert import lm_flax_path
    from distriflow_tpu_torch.parallel import collectives as C
    from distriflow_tpu_torch.parallel import distributed, sharding
    from distriflow_tpu_torch.parallel.mesh import (
        axis_index,
        create_mesh,
        mesh_shape,
        replicate,
        shard_batch,
        shard_batch_padded,
    )

    res = {"process": (distributed.process_index(), distributed.process_count(),
                       distributed.is_coordinator())}
    distributed.initialize()  # a group is up: a no-op
    meshes = {}
    res["coords"] = {}
    for key, shape in p["mesh_shapes"].items():
        mesh = meshes[key] = create_mesh(shape, "cpu")
        res["coords"][key] = ({ax: axis_index(mesh, ax) for ax in mesh.mesh_dim_names},
                              mesh_shape(mesh))
    # collectives and their gradients: this rank's block of x (the whole
    # x for copy_to), the cotangent the first elements of c (times rank + 1
    # where the output varies over the axis)
    res["collectives"] = {}
    invariant = ("psum", "pmean", "all_gather_invariant")
    for name, key, axis in p["collectives"]:
        mesh = meshes[key]
        n, i = mesh_shape(mesh)[axis], axis_index(mesh, axis)
        rows = p["x"].shape[0] // n
        x = torch.tensor(p["x"] if name == "copy_to" else p["x"][i * rows:(i + 1) * rows],
                         requires_grad=True)
        out = {"psum": lambda: C.psum(x, axis, mesh),
               "pmean": lambda: C.pmean(x, axis, mesh),
               "copy_to": lambda: C.copy_to(x, axis, mesh),
               "all_gather": lambda: C.all_gather(x, axis, mesh),
               "all_gather_invariant": lambda: C.all_gather_invariant(x, axis, mesh),
               "reduce_scatter": lambda: C.reduce_scatter(x, axis, mesh),
               "ppermute": lambda: C.ppermute_ring(x, axis, mesh),
               "all_to_all": lambda: C.all_to_all(x, axis, mesh, split_axis=1, concat_axis=0),
               }[name]()
        c = torch.tensor(p["c"].reshape(-1)[:out.numel()].reshape(out.shape))
        if name not in invariant:
            c = c * (i + 1)
        (out * c).sum().backward()
        res["collectives"][(name, key, axis)] = (_np(out), _np(x.grad))
    res["allreduce_mean"] = _np(C.allreduce_mean(meshes["data4"], torch.tensor(
        p["x"][rank * 2:(rank + 1) * 2])))
    res["ordered_sum"] = _np(C.gather_ordered_sum(torch.tensor(p["x"][rank]), "data",
                                                  meshes["data4"]))
    # placements of the flagship and MoE trees (shapes only) under TP rules
    res["slices"] = {}
    for tree_key, key in p["slice_cases"]:
        mesh = meshes[key]
        specs = {n: sharding.spec_for(n, len(shape), sharding.TRANSFORMER_TP_RULES, lm_flax_path)
                 for n, shape in p["shapes"][tree_key].items()}
        res["slices"][(tree_key, key)] = {
            n: (specs[n], _shard_slices(mesh, specs[n], shape),
                sharding.zero_dim(specs[n], shape, mesh, "data"))
            for n, shape in p["shapes"][tree_key].items()}
    # the values of small trees: blocks, and gather_params' round trip
    res["blocks"] = {}
    for tree_key, key in p["value_cases"]:
        mesh = meshes[key]
        full = {n: torch.tensor(v) for n, v in p["trees"][tree_key].items()}
        blocks = sharding.shard_params(full, mesh, sharding.TRANSFORMER_TP_RULES, lm_flax_path)
        back = sharding.gather_params(blocks, mesh, sharding.TRANSFORMER_TP_RULES, lm_flax_path)
        res["blocks"][(tree_key, key)] = (
            {n: _np(b) for n, b in blocks.items()},
            all(torch.equal(back[n], full[n]) for n in full))
    # batches: shard_batch, the padded form, next_sharded and prefetch
    mesh = meshes["data4"]
    x, y = p["batch"]
    res["shard_batch"] = [_np(t) for t in shard_batch(mesh, (x, y))]
    res["replicate"] = [_np(t) for t in replicate(mesh, (x, y))]
    res["shard_batch_seq"] = [_np(t) for t in shard_batch(meshes["data2_seq2"], (x, y),
                                                          seq_axis="seq")]
    res["padded"] = [_np(t) for t in shard_batch_padded(mesh, x[:6], y[:6])]
    ds = DistributedDataset(x, y, {"batch_size": 6, "epochs": 1, "small_last_batch": True})
    res["next_sharded"] = []
    while True:
        b = ds.next_sharded(mesh)
        if b is None:
            break
        res["next_sharded"].append((b.batch, _np(b.x), _np(b.y), _np(b.weight)))
        ds.complete_batch(b.batch)
    res["prefetch"] = [[_np(t) for t in b] for b in prefetch_to_device(
        iter([(x, y), (x[::-1].copy(), y[::-1].copy())]), mesh=mesh)]
    return res


# -- tests/test_torch_ring_attention.py and test_torch_ulysses.py ----------


def attention_cases(rank, p):
    from distriflow_tpu_torch.ops import flop_count
    from distriflow_tpu_torch.parallel.mesh import Placement, create_mesh
    from distriflow_tpu_torch.parallel.ring_attention import ring_attention
    from distriflow_tpu_torch.parallel.ulysses import ulysses_attention

    res = {}
    meshes = {}
    for key, fn_name, shape, causal, use_flash in p["cases"]:
        if key not in meshes:
            meshes[key] = create_mesh(shape, "cpu")
        mesh = meshes[key]
        fn = ring_attention if fn_name == "ring" else ulysses_attention
        place = Placement(mesh, ("data", "model", "seq"))
        q, k, v, c = (place.shard(torch.tensor(a)).clone() for a in p["qkvc"])
        for t in (q, k, v):
            t.requires_grad_(True)
        with flop_count.tally_kernel_cost() as tally:
            out = fn(q, k, v, mesh, causal=causal, use_flash=use_flash)
            (out * c).sum().backward()
        res[(key, fn_name, causal, use_flash)] = (
            _np(out), _np(q.grad), _np(k.grad), _np(v.grad), tally["flops"])
    res["errors"] = {}
    for key, shape, heads in p["bad_ulysses"]:
        mesh = create_mesh(shape, "cpu")
        q = torch.zeros(1, heads, 4, 8)
        try:
            ulysses_attention(q, q, q, mesh)
            res["errors"][key] = None
        except ValueError as e:
            res["errors"][key] = str(e)
    return res


# -- tests/test_torch_sync_mesh.py -----------------------------------------


def sync_cases(rank, p):
    from distriflow_tpu_torch.data.dataset import DistributedDataset
    from distriflow_tpu_torch.models.convert import params_from_jax, zoo_params_from_jax
    from distriflow_tpu_torch.models.transformer import TransformerConfig, transformer_lm
    from distriflow_tpu_torch.models.zoo import mnist_mlp
    from distriflow_tpu_torch.parallel import sharding
    from distriflow_tpu_torch.parallel.mesh import create_mesh
    from distriflow_tpu_torch.train.sync import SyncTrainer

    res = {}
    for case in p["cases"]:
        name = case["name"]
        mesh = create_mesh(case["mesh"], "cpu")
        rules = getattr(sharding, case.get("rules", "REPLICATED_RULES"))
        kw = dict(mesh=mesh, optimizer=case["optimizer"], learning_rate=case["lr"],
                  param_rules=rules, zero_level=case.get("zero", 0),
                  grad_accum=case.get("grad_accum", 1), ema_decay=case.get("ema"))
        if case.get("save"):
            kw["checkpoint_dir"] = os.path.join(p["ckpt_dir"], name)
        if case.get("mlp"):
            trainer = SyncTrainer(mnist_mlp(hidden=8, device="cpu"), **kw)
            trainer.init()
            trainer.set_params(zoo_params_from_jax(p["trees"][case["tree"]]))
            x, y = p["mlp_data"]
            ds = DistributedDataset(x, y, {"batch_size": 16, "epochs": 1,
                                           "small_last_batch": True})
            losses = []
            while True:
                b = ds.next_sharded(mesh)
                if b is None:
                    break
                losses.append(trainer.step(b.xyw))
                ds.complete_batch(b.batch)
            x, y = x[:16], y[:16]  # the evaluation batch: one the mesh divides
        else:
            cfg = TransformerConfig(**p["dims"], dtype=torch.float32, use_flash_attention=False,
                                    **case.get("cfg", {}))
            trainer = SyncTrainer(transformer_lm(cfg, device="cpu", mesh=mesh), **kw)
            trainer.init()
            trainer.set_params(params_from_jax(p["trees"][case["tree"]], cfg, masters=True))
            x, y = p["batches"][case.get("batch", "lm")]
            losses = [trainer.step((x, y)) for _ in range(p["steps"])]
        out = {"losses": losses, "params": {n: _np(t) for n, t in trainer.get_params().items()},
               "eval": trainer.evaluate(x, y)}
        if case.get("save"):
            # rank 0 writes the gathered state; a second trainer restores it
            # into its own blocks and slices, and both take one more step
            trainer.save(wait=True)
            dist.barrier()
            again = SyncTrainer(transformer_lm(cfg, device="cpu", mesh=mesh), **kw)
            again.init(seed=5)
            out["restored"] = again.restore()
            out["restored_params_equal"] = all(
                torch.equal(a, b) for a, b in zip(again.get_params().values(),
                                                  trainer.get_params().values()))
            out["next_losses"] = (trainer.step((x, y)), again.step((x, y)))
            trainer.close()
            again.close()
        if case.get("ema"):
            out["ema"] = {n: _np(t) for n, t in trainer.ema_params.items()}
        st = trainer.state.opt_state
        out["opt_bytes"] = {n: sum(st[k][n].numel() * st[k][n].element_size()
                                   for k in st if isinstance(st[k], dict))
                            for n in trainer.state.params}
        out["zslices"] = dict(trainer._zslices)
        out["param_bytes"] = {n: t.numel() * t.element_size()
                              for n, t in trainer.state.params.items()}
        res[name] = out if rank == 0 or case.get("all_ranks") else {
            "opt_bytes": out["opt_bytes"], "zslices": out["zslices"],
            "param_bytes": out["param_bytes"], "losses": losses}
    return res


# -- tests/test_torch_multi_io.py ------------------------------------------


def multi_io_cases(rank, p):
    """Each Keras graph of several inputs or outputs on ``{data 4}``: a
    partial batch padded to the axis size, trained at ``grad_accum`` 1 and
    2 (and the two-input model's weighted ``evaluate``)."""
    from distriflow_tpu_torch.models import keras_import as tk
    from distriflow_tpu_torch.parallel.mesh import create_mesh, pad_partial_batch, shard_batch
    from distriflow_tpu_torch.train.sync import SyncTrainer

    mesh = create_mesh({"data": 4}, "cpu")
    res = {}
    for name, path in p["paths"].items():
        xp, yp, w = pad_partial_batch(4, *p["data"][name])
        res["rows_per_rank"] = len(shard_batch(mesh, w))
        for accum in (1, 2):
            t = SyncTrainer(tk.spec_from_keras_json(path, device="cpu"), mesh=mesh,
                            learning_rate=p["lr"], grad_accum=accum)
            t.init()
            out = {"losses": [t.step((xp, yp, w)) for _ in range(p["steps"])],
                   "params": {n: _np(v) for n, v in t.get_params().items()}}
            if name == "two_inputs":
                out["eval"] = t.evaluate(xp, yp, weight=w)
            res[f"{name}_accum{accum}"] = out
    return res


# -- tests/test_torch_mesh_cost.py -----------------------------------------


def cost_cases(rank, p):
    """Each case's ``cost_analysis`` and ``mfu`` on this rank, at every
    ``grad_accum`` (and whether a second call came from the cache)."""
    from distriflow_tpu_torch.models.transformer import TransformerConfig, transformer_lm
    from distriflow_tpu_torch.parallel import sharding
    from distriflow_tpu_torch.parallel.mesh import create_mesh
    from distriflow_tpu_torch.train.sync import SyncTrainer

    res = {}
    seconds, peak = p["mfu"]
    for name, case in p["cases"].items():
        mesh = create_mesh(case["mesh"], "cpu")
        cfg = TransformerConfig(**p["dims"], dtype=torch.float32, use_flash_attention=True,
                                loss=case["loss"])
        for accum in p["accums"]:
            t = SyncTrainer(transformer_lm(cfg, device="cpu", mesh=mesh), mesh=mesh,
                            param_rules=getattr(sharding, case["rules"]), grad_accum=accum)
            t.init()
            cost = t.cost_analysis(p["batch"])
            res[(name, accum)] = {
                "cost": cost, "cached": t.cost_analysis(p["batch"]) is cost,
                "mfu": t.mfu(p["batch"], step_seconds=seconds, peak_flops_per_chip=peak)}
    return res


# -- tests/test_torch_federated_mesh.py ------------------------------------


def federated_cases(rank, p):
    from distriflow_tpu_torch.models.convert import zoo_params_from_jax
    from distriflow_tpu_torch.models.zoo import mnist_mlp
    from distriflow_tpu_torch.parallel.mesh import create_mesh
    from distriflow_tpu_torch.train.federated import FederatedAveragingTrainer

    res = {}
    mesh = create_mesh({"data": dist.get_world_size()}, "cpu")
    for case in p["cases"]:
        t = FederatedAveragingTrainer(mnist_mlp(hidden=8, device="cpu"), mesh=mesh,
                                      local_steps=case["k"], local_batch_size=case["b"],
                                      optimizer=case["optimizer"], learning_rate=case["lr"])
        t.init()
        t.set_params(zoo_params_from_jax(p["tree"]))
        losses = [t.round(xs, ys) for xs, ys in p["rounds"][case["name"]]]
        res[case["name"]] = {"losses": losses, "num_workers": t.num_workers,
                             "params": {n: _np(v) for n, v in t.params.items()}}
    return res


# -- tests/test_torch_pipeline.py ------------------------------------------


def _mlp_stage(params, a):
    return torch.tanh(a @ params["w"]) + params["b"]


def _wide_stage(params, a):
    return torch.tanh(torch.tanh(a @ params["w1"]) @ params["w2"]) + a


def _saved_bytes(run):
    """Bytes autograd saves for the backward while ``run()`` builds its
    graph (every pack of ``saved_tensors_hooks``)."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = run()
    return total[0], out


def pipeline_cases(rank, p):
    from distriflow_tpu_torch.models.convert import pipelined_params_from_jax
    from distriflow_tpu_torch.models.transformer import (
        TransformerConfig,
        pipelined_transformer_lm,
    )
    from distriflow_tpu_torch.parallel import pipeline as pl
    from distriflow_tpu_torch.parallel import sharding
    from distriflow_tpu_torch.parallel.collectives import _all_gather, _all_reduce
    from distriflow_tpu_torch.parallel.mesh import axis_index, axis_size, create_mesh, shard_batch
    from distriflow_tpu_torch.train.sync import SyncTrainer

    res = {}
    meshes = {}

    def mesh_of(shape):
        key = tuple(sorted(shape.items()))
        if key not in meshes:
            meshes[key] = create_mesh(shape, "cpu")
        return meshes[key]

    for key, shape in p["mesh_order"]:
        mesh_of(shape)

    def rows(mesh, x):
        return shard_batch(mesh, torch.as_tensor(x))

    def full_rows(mesh, t):
        return _all_gather(t.contiguous(), mesh, "data", 0)

    # the schedules on plain stages: forward and gradients
    res["stages"] = {}
    for name, shape, fn_name, m, sched in p["stage_cases"]:
        mesh = mesh_of(shape)
        fn = {"identity": lambda prm, a: a + prm["b"], "mlp": _mlp_stage}[fn_name]
        params = {k: torch.tensor(v, requires_grad=True) for k, v in p["stage_params"][name].items()}
        pi = axis_index(mesh, "pipe")
        local = {k: v[pi:pi + 1] for k, v in params.items()}
        x = rows(mesh, p["stage_x"][name]).clone().requires_grad_(True)
        out = pl.SCHEDULES[sched](fn, local, x, mesh, m)
        grads = None
        if fn_name == "mlp":
            (out ** 2).sum().backward()
            # every stage's rows, summed over the data ranks' partials
            grads = {k: _np(_all_reduce(v.grad, mesh, ("data", "pipe"))) for k, v in params.items()}
            grads["x"] = _np(full_rows(mesh, x.grad))
        res["stages"][name] = (_np(full_rows(mesh, out.detach())), grads)
    # saved-for-backward bytes: the three schedules at M 4 and 8
    mesh = mesh_of({"pipe": 4})
    pi = axis_index(mesh, "pipe")
    res["saved"] = {}
    for sched in ("gpipe", "remat", "1f1b"):
        for m in (4, 8):
            params = {k: torch.tensor(v[pi:pi + 1], requires_grad=True)
                      for k, v in p["wide_params"].items()}
            x = torch.tensor(p["wide_x"], requires_grad=True)
            nbytes, out = _saved_bytes(lambda: pl.SCHEDULES[sched](_wide_stage, params, x, mesh, m))
            out.sum().backward()
            res["saved"][(sched, m)] = nbytes
    # validation errors
    res["errors"] = {}
    for name, shape, kind in p["error_cases"]:
        mesh = mesh_of(shape)
        try:
            if kind == "microbatches":
                pl.gpipe(lambda prm, a: a, {"w": torch.zeros(1, 1)}, torch.zeros(10 // axis_size(
                    mesh, "data"), 2), mesh, 3)
            elif kind == "stages":
                pl.gpipe(lambda prm, a: a, {"w": torch.zeros(3, 1)}, torch.zeros(8, 2), mesh, 4)
            else:
                cfg = TransformerConfig(**dict(p["dims"], **p["error_cfg"][name]),
                                        dtype=torch.float32, use_flash_attention=False)
                pipelined_transformer_lm(cfg, device="cpu", mesh=mesh)
            res["errors"][name] = None
        except ValueError as e:
            res["errors"][name] = str(e)
    # the pipelined LM: logits, then training against JAX
    res["logits"] = {}
    res["train"] = {}
    for case in p["lm_cases"]:
        name, mesh = case["name"], mesh_of(case["mesh"])
        cfg = TransformerConfig(**p["dims"], dtype=torch.float32, use_flash_attention=False,
                                **case.get("cfg", {}))
        spec = pipelined_transformer_lm(cfg, device="cpu", mesh=mesh,
                                        num_microbatches=case.get("m"))
        trainer = SyncTrainer(spec, mesh=mesh, optimizer=case.get("optimizer", "adam"),
                              learning_rate=case.get("lr", 1e-3),
                              param_rules=sharding.PIPELINED_TRANSFORMER_RULES,
                              zero_level=case.get("zero", 0),
                              grad_accum=case.get("grad_accum", 1))
        trainer.init()
        n_stages = axis_size(mesh, "pipe")
        if case.get("moe"):
            model = trainer.model
            res["moe"] = (sorted(model.state_dict()) == sorted(n for n, _ in
                                                                model.named_parameters()),
                          sorted(n for n, _ in model.named_buffers()))
            x, y = p["batch"]
            res["moe_loss"] = trainer.step((x, y))
            continue
        trainer.set_params(pipelined_params_from_jax(p["trees"][name], cfg, n_stages,
                                                     masters=True))
        x, y = p["batch"]
        if case.get("logits"):
            with torch.no_grad():
                logits = trainer.model(rows(mesh, x))
            if trainer.model.vocab_parallel:
                logits = _all_gather(logits, mesh, "model", logits.dim() - 1)
            res["logits"][name] = _np(full_rows(mesh, logits))
            continue
        losses = [trainer.step((x, y)) for _ in range(p["steps"])]
        res["train"][name] = {"losses": losses,
                              "params": {n: _np(t) for n, t in trainer.get_params().items()}}
    return res


# -- tests/test_torch_sharded_checkpoint.py --------------------------------

#: the placements of the checkpoint tests' tree, by leaf: JAX's test tree
#: (``w``, ``b``, ``scale``, ``step``, ``host_note``) and a bf16 leaf
CKPT_SPECS = {"w": ("data", "model"), "b": ("model",), "h": (None, "model")}


def _ckpt_tree(mesh, tree, specs=CKPT_SPECS):
    """(this rank's tree, its placements): tensors cut by ``specs``, the
    rest whole."""
    from distriflow_tpu_torch.parallel.mesh import Placement

    local, places = {}, {}
    for k, v in tree.items():
        if k == "host_note":
            local[k] = np.float32(v)
            continue
        t = torch.as_tensor(v) if k != "h" else torch.as_tensor(v).to(torch.bfloat16)
        spec = specs.get(k, ())
        local[k] = Placement(mesh, spec).shard(t).clone() if spec else t.clone()
        places[k] = Placement(mesh, spec)
    return local, places


def _np_tree(tree):
    return {k: (v.float().numpy() if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16
                else _np(v) if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in tree.items()}


def _mlp_trainer(mesh, ckpt_dir, seed=0):
    from distriflow_tpu_torch.models.zoo import mnist_mlp
    from distriflow_tpu_torch.train.sync import SyncTrainer

    t = SyncTrainer(mnist_mlp(hidden=8, device="cpu"), mesh=mesh, optimizer="adam",
                    learning_rate=1e-3, zero_level=1, checkpoint_dir=ckpt_dir,
                    sharded_checkpoints=True)
    t.init(seed)
    return t


def checkpoint_cases(rank, p):
    from distriflow_tpu_torch.checkpoint import ShardedCheckpointStore
    from distriflow_tpu_torch.parallel.mesh import create_mesh

    res = {}
    mesh = create_mesh({"data": 2, "model": 2}, "cpu")
    dp4 = create_mesh({"data": 4}, "cpu")
    tree, places = _ckpt_tree(mesh, p["tree"])
    # the port reads JAX's checkpoint (written on JAX's {data 2, model 2})
    jax_store = ShardedCheckpointStore(p["jax_dir"])
    like = {k: torch.zeros_like(v) if isinstance(v, torch.Tensor) else v for k, v in tree.items()}
    res["from_jax"] = _np_tree(jax_store.load("7", like, places))
    # round trip and what lands on disk
    store = ShardedCheckpointStore(p["port_dir"])
    res["version"] = store.save(tree, version="7", placements=places)
    res["roundtrip"] = _np_tree(store.load("7", like, places))
    # another layout: every tensor over data on {data 4}
    tree4, places4 = _ckpt_tree(dp4, p["tree"], {"w": ("data",), "h": ("data",)})
    like4 = {k: torch.zeros_like(v) if isinstance(v, torch.Tensor) else v for k, v in tree4.items()}
    res["relayout"] = _np_tree(store.load("7", like4, places4))
    # version semantics
    vstore = ShardedCheckpointStore(p["version_dir"])
    for step in (1, 2):
        t = dict(tree, step=torch.tensor(step, dtype=torch.int32))
        vstore.save(t, version=str(step * 100), placements=places)
    res["versions"] = (vstore.list(), vstore.last())
    version, out = vstore.restore_latest(like, places)
    res["latest"] = (version, int(out["step"]))
    # a shape mismatch is refused
    bad = dict(like, w=torch.zeros(1, 2))
    try:
        store.load("7", bad, places)
        res["mismatch"] = None
    except ValueError as e:
        res["mismatch"] = str(e)
    # snapshot, then change the live tensors: the save is the snapshot's
    snap = store.snapshot(tree, extra_meta={"note": "async"}, placements=places)
    for v in tree.values():
        if isinstance(v, torch.Tensor):
            v.zero_()
    store.save(snap, version="42")
    res["snapshot"] = (_np_tree(store.load("42", like, places)), store.meta("42"))
    # a rank whose write fails: nothing is published, every rank raises
    fstore = ShardedCheckpointStore(p["fail_dir"])
    if rank == 2:
        def broken(build_dir, snap):
            raise OSError("disk full (planted)")

        fstore._write_shards = broken
    try:
        fstore.save(dict(tree), version="9", placements=places)
        res["fail"] = None
    except (OSError, RuntimeError) as e:
        res["fail"] = f"{type(e).__name__}: {e}"
    # a ZeRO-1 trainer on {data 4} saves; the 2-rank world restores it
    t = _mlp_trainer(dp4, p["trainer_dir"])
    x, y = p["mlp_batch"]
    t.step((x, y))
    t.step((x, y))
    t.save(wait=True)
    res["trainer"] = {"params": {n: _np(v) for n, v in t.get_params().items()},
                      "opt": {k: {n: _np(v) for n, v in t._gather(d, True).items()}
                              for k, d in t.state.opt_state.items() if isinstance(d, dict)},
                      "next_loss": t.step((x, y))}
    t.close()
    return res


def checkpoint_small_cases(rank, p):
    """The 2-rank world: the 4-rank world's checkpoints restored onto fewer
    ranks (the reshard path)."""
    from distriflow_tpu_torch.checkpoint import ShardedCheckpointStore
    from distriflow_tpu_torch.parallel.mesh import create_mesh

    res = {}
    mesh = create_mesh({"data": 2}, "cpu")
    tree, places = _ckpt_tree(mesh, p["tree"], {"w": ("data",), "b": ("data",)})
    like = {k: torch.zeros_like(v) if isinstance(v, torch.Tensor) else v for k, v in tree.items()}
    res["onto2"] = _np_tree(ShardedCheckpointStore(p["port_dir"]).load("7", like, places))
    t = _mlp_trainer(mesh, p["trainer_dir"], seed=5)
    res["restored"] = t.restore()
    res["step"] = t.version
    count = t.state.opt_state["count"]
    res["count"] = (isinstance(count, torch.Tensor), int(count))
    res["params"] = {n: _np(v) for n, v in t.get_params().items()}
    res["opt"] = {k: {n: _np(v) for n, v in t._gather(d, True).items()}
                  for k, d in t.state.opt_state.items() if isinstance(d, dict)}
    res["moment_bytes"] = {n: t.state.opt_state["mu"][n].numel() for n in t.state.params}
    res["param_numel"] = {n: t.state.params[n].numel() for n in t.state.params}
    x, y = p["mlp_batch"]
    res["next_loss"] = t.step((x, y))
    t.close()
    return res


# -- tests/test_torch_tp_decode.py -----------------------------------------


def _tp_model(cfg, tree, mesh):
    """A serving model on ``mesh`` holding this rank's blocks of ``tree``
    under ``TRANSFORMER_TP_RULES`` (``mesh`` None: the one-rank model)."""
    from distriflow_tpu_torch.models.convert import lm_from_jax

    return lm_from_jax(cfg, tree, device="cpu", mesh=mesh)


def _served(rank, server, requests, disconnect_prompt):
    """Rank 0's side of the served scenario: the requests through a
    client (the results), a refused request, a client that disconnects
    mid-decode, then one more request."""
    import threading
    import time

    from distriflow_tpu_torch.client.inference_client import InferenceClient

    out = {}
    with InferenceClient(server.address).setup() as c:
        box = {}

        def greedy(key, prompt, n):
            box[key] = c.generate(prompt, n_tokens=n)

        threads = [threading.Thread(target=greedy, args=(f"g{i}", p, n))
                   for i, (p, n) in enumerate(requests["greedy"])]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        out["greedy"] = [box[f"g{i}"] for i in range(len(threads))]
        out["sampled"] = c.generate(requests["sampled"], n_tokens=6, temperature=0.8,
                                    top_k=8, seed=7)
        out["direct"] = c.generate(requests["direct"], n_tokens=5, temperature=0.8, seed=3)
        out["beam"] = c.beam_search(requests["beam"], n_tokens=4, beam_size=2)
        out["score"] = c.score(requests["score"], from_pos=2)
        try:  # refused on rank 0 before any device program
            c.generate(requests["beam"], n_tokens=10_000)
            out["refused"] = None
        except Exception as e:
            out["refused"] = str(e)
        try:  # a device program that raises on every rank (beam_size 0)
            c.beam_search(requests["beam"], n_tokens=4, beam_size=0)
            out["errored"] = None
        except Exception as e:
            out["errored"] = str(e)
    # a client that disconnects while its request holds a slot
    c2 = InferenceClient(server.address).setup()
    errors = []

    def doomed():
        try:
            c2.generate(disconnect_prompt, n_tokens=20)
        except Exception as e:
            errors.append(e)

    with server._device_lock:  # the engine stops at its next device program
        t = threading.Thread(target=doomed, daemon=True)
        t.start()
        deadline = time.time() + 30
        while server._pool.used_pages == 0 and time.time() < deadline:
            time.sleep(0.005)
        c2.close()
        while time.time() < deadline:
            with server._inflight_lock:
                reqs = [r for rs in server._inflight.values() for r in rs]
            if reqs and all(r.cancelled for r in reqs):
                break
            time.sleep(0.005)
    t.join(timeout=30)
    out["disconnected"] = bool(errors)
    with InferenceClient(server.address).setup() as c:
        out["after"] = c.generate(requests["greedy"][0][0], n_tokens=requests["greedy"][0][1])
        # new weights (every rank keeps its blocks of them), then a request
        server.set_params(requests["weights"])
        out["reloaded"] = c.generate(requests["greedy"][0][0], n_tokens=requests["greedy"][0][1])
    return out


def _outcome(call):
    """``("ok", result)`` or ``("raised", message)``."""
    try:
        return ("ok", call())
    except Exception as e:
        return ("raised", str(e))


def _followed(server):
    """A follower's side of a served scenario: how ``follow`` ended (None,
    or the error it raised) and the programs it ran."""
    try:
        server.follow()
        return (None, server.follower_ops)
    except Exception as e:
        return (f"{type(e).__name__}: {e}", server.follower_ops)


def _cut_cases(cfg, tree, model, mesh):
    """New weights are cut by the table the model's blocks were cut by:
    the TP model's own blocks, a replicated model's full tensors, and a
    mesh model cut some other way refuses."""
    from distriflow_tpu_torch.models.base import cut_blocks, shard_state
    from distriflow_tpu_torch.models.convert import lm_flax_path, lm_from_jax, params_from_jax
    from distriflow_tpu_torch.models.transformer import TransformerLM
    from distriflow_tpu_torch.parallel import sharding

    full = params_from_jax(tree, cfg)
    fresh = lm_from_jax(cfg, tree, device="cpu", mesh=mesh)  # ``model`` has served other weights
    repl = TransformerLM(cfg, device="cpu", mesh=mesh)
    cut_blocks(repl, full, mesh, sharding.REPLICATED_RULES, lm_flax_path)

    def same(m, blocks):
        own = m.state_dict()
        return sorted(blocks) == sorted(own) and all(torch.equal(blocks[n], own[n]) for n in own)

    try:
        shard_state(TransformerLM(cfg, device="cpu", mesh=mesh), full)
        uncut = None
    except ValueError as e:
        uncut = str(e)
    return {"tp_table": model.block_cut[1] is sharding.TRANSFORMER_TP_RULES,
            "tp": same(fresh, shard_state(model, full)),
            "replicated": same(repl, shard_state(repl, full)),
            "replicated_full": all(tuple(v.shape) == tuple(full[n].shape)
                                   for n, v in repl.state_dict().items()),
            "uncut": uncut}


def _spec_served(server, requests, disconnect_prompt):
    """Rank 0's side of a speculative mesh scenario: the greedy requests,
    a sampled one, a refused request, a client that disconnects while its
    request is mid-round, one more greedy request, then new weights and a
    request on them."""
    import threading

    from distriflow_tpu_torch.client.inference_client import InferenceClient

    out = {}
    with InferenceClient(server.address).setup() as c:
        out["greedy"] = [c.generate(pr, n_tokens=n) for pr, n in requests["greedy"]]
        out["sampled"] = c.generate(requests["sampled"], n_tokens=6, temperature=0.8, top_k=8,
                                    seed=7)
        try:  # refused on rank 0 before any device program
            c.generate(requests["beam"], n_tokens=10_000)
            out["refused"] = None
        except Exception as e:
            out["refused"] = str(e)
    c2 = InferenceClient(server.address).setup()
    errors = []

    def doomed():
        try:
            c2.generate(disconnect_prompt, n_tokens=20)
        except Exception as e:
            errors.append(e)

    rounds = server.decode_batches
    t = threading.Thread(target=doomed, daemon=True)
    t.start()
    deadline = time.time() + 30
    while server.decode_batches == rounds and time.time() < deadline:
        time.sleep(0.0005)  # until the request's first round ran
    with server._device_lock:  # the engine stops at its next round
        out["mid_round"] = any(r is not None for r in server._slot_req)
        c2.close()
        while time.time() < deadline:  # cancelled (or already retired: the
            with server._inflight_lock:  # engine retires between rounds unlocked)
                reqs = [r for rs in server._inflight.values() for r in rs]
            if all(r.cancelled for r in reqs):
                break
            time.sleep(0.005)
    t.join(timeout=30)
    out["disconnected"] = bool(errors)
    with InferenceClient(server.address).setup() as c:
        prompt, n = requests["greedy"][0]
        out["after"] = c.generate(prompt, n_tokens=n)
        server.set_params(requests["weights"])
        out["reloaded"] = c.generate(prompt, n_tokens=n)
    out["rounds"] = server.decode_batches
    return out


def _pool_free(server):
    """The server's page pool after its prefix cache is released: all
    pages free, every refcount 0, no slot holding target or draft pages."""
    server.release_prefix_cache()
    pool = server._pool
    return (pool.free_pages == pool.n_pages and not pool._refs.any()
            and not any(server._slot_pages) and not any(server._draft_pages))


def _spec_cases(rank, cfg, p, tp):
    """The speculative mesh server (k 3) with ``lm_draft`` and with
    ``"self"``, each on a fresh TP model of the tree: rank 0 serves
    :func:`_spec_served`, the others follow; each rank's cache widths;
    the one-rank speculative server's sampled answer. Then a follower
    whose drafts differ from rank 0's (rank 2 alters them before the
    verify) stops every rank."""
    from distriflow_tpu_torch.client.inference_client import InferenceClient
    from distriflow_tpu_torch.server.inference_server import InferenceServer
    from distriflow_tpu_torch.utils.config import ServingConfig

    res = {}
    for draft in ("lm_draft", "self"):
        serving = ServingConfig(kv_layout="paged", page_size=8, speculate_k=3,
                                draft_model=draft, batch_window_s=0.02)
        server = InferenceServer(_tp_model(cfg, p["tree"], tp), port=0, serving=serving)
        out = {}
        if rank == 0:
            server.setup()
            try:
                out = _spec_served(server, p["requests"], p["prompts"]["disconnect"])
            finally:
                server.stop()
            out["pool_free"] = _pool_free(server)
            ref = InferenceServer(_tp_model(cfg, p["tree"], None), port=0, serving=serving)
            ref.setup()
            try:
                with InferenceClient(ref.address).setup() as c:
                    out["sampled_ref"] = c.generate(p["requests"]["sampled"], n_tokens=6,
                                                    temperature=0.8, top_k=8, seed=7)
            finally:
                ref.stop()
            out["ref_pool_free"] = _pool_free(ref)
        else:
            out["followed"] = _followed(server)
        out["widths"] = (server._slot_cache.k[0].shape[-1], server._draft_cache.k[0].shape[-1],
                         server.draft_model.local_heads * server.draft_model.config.head_dim)
        res[draft] = out
    # a follower that drafts apart: rank 2 alters its drafts before the verify
    serving = ServingConfig(kv_layout="paged", page_size=8, speculate_k=3,
                            draft_model="lm_draft", batch_window_s=0.02)
    hurt = InferenceServer(_tp_model(cfg, p["tree"], tp), port=0, serving=serving)
    if rank == 2:
        real = hurt._draft

        def altered(*a, **kw):
            drafts, qprobs = real(*a, **kw)
            return (drafts + 1) % cfg.vocab_size, qprobs

        hurt._draft = altered
    prompt0, n0 = p["requests"]["greedy"][1]
    if rank == 0:
        hurt.setup()
        try:
            with InferenceClient(hurt.address).setup() as c:
                first = _outcome(lambda: c.generate(prompt0, n_tokens=n0))
                res["hurt"] = {"first": first,
                               "next": _outcome(lambda: c.generate(prompt0, n_tokens=n0))}
        finally:
            hurt.stop()
        res["hurt"]["mesh_error"] = hurt.mesh_error
    else:
        res["hurt"] = _followed(hurt)
    return res


def tp_decode_cases(rank, p):
    import dataclasses

    from distriflow_tpu_torch.client.inference_client import InferenceClient
    from distriflow_tpu_torch.models.generate import beam_search, generate, sequence_logprob
    from distriflow_tpu_torch.models.transformer import TransformerConfig
    from distriflow_tpu_torch.parallel.mesh import create_mesh
    from distriflow_tpu_torch.server.inference_server import InferenceServer

    res = {}
    tp = create_mesh({"data": 2, "model": 2}, "cpu")
    ep = create_mesh({"data": 2, "expert": 2}, "cpu")
    cfg = TransformerConfig(**p["dims"], dtype=torch.float32, use_flash_attention=False,
                            use_flash_decode=False)
    model = _tp_model(cfg, p["tree"], tp)
    solo = _tp_model(cfg, p["tree"], None)
    prompt = p["prompts"]
    res["greedy"] = _np(generate(model, prompt["greedy"], 8))
    toks, scores = beam_search(model, prompt["beam"], 5, beam_size=3)
    res["beam"] = (_np(toks), _np(scores))
    int8 = dataclasses.replace(cfg, kv_cache_dtype="int8_force")
    res["int8"] = _np(generate(_tp_model(int8, p["tree"], tp), prompt["int8"], 8))
    kw = dict(temperature=0.8, top_k=8, seed=7)
    res["sampled"] = (_np(generate(model, prompt["sampled"], 6, **kw)),
                      _np(generate(solo, prompt["sampled"], 6, **kw)))
    res["score"] = (_np(sequence_logprob(model, prompt["greedy"], 2)),
                    _np(sequence_logprob(solo, prompt["greedy"], 2)))
    cache = model.new_cache(2)
    res["cache"] = (model.local_heads, tuple(cache.k[0].shape),
                    tuple(model.new_cache(2, int8=True).k_scale[0].shape))
    # dense MoE decoding over sharded experts
    moe_cfg = dataclasses.replace(cfg, **p["moe"])
    res["moe"] = _np(generate(_tp_model(moe_cfg, p["moe_tree"], ep), prompt["greedy"], 8))
    # the served scenario: rank 0 serves, the others follow
    server = InferenceServer(model, port=0)
    if rank == 0:
        server.setup()
        try:
            res["served"] = _served(rank, server, p["requests"], prompt["disconnect"])
        finally:
            server.stop()
        # the one-rank server's answers to the same requests
        ref = InferenceServer(solo, port=0).setup()
        try:
            res["served_ref"] = _served(rank, ref, p["requests"], prompt["disconnect"])
        finally:
            ref.stop()
    else:
        server.follow()
        res["follower_ops"] = server.follower_ops
    res["cut"] = _cut_cases(cfg, p["tree"], model, tp)
    prompt0, n0 = p["requests"]["greedy"][0]
    # an idle rank 0 is not a lost one: it serves, idles for more than
    # twice the control timeout, then serves again
    idle = InferenceServer(model, port=0, control_timeout_s=p["idle"]["timeout_s"])
    if rank == 0:
        idle.setup()
        try:
            with InferenceClient(idle.address).setup() as c:
                first = _outcome(lambda: c.generate(prompt0, n_tokens=n0))
                time.sleep(p["idle"]["idle_s"])
                res["idle"] = (first, _outcome(lambda: c.generate(prompt0, n_tokens=n0)))
        finally:
            idle.stop()
    else:
        res["idle"] = _followed(idle)
    # a program that fails on one follower only (after its collectives, so
    # no partner waits in a psum) stops every rank at once
    hurt = InferenceServer(model, port=0)
    if rank == 2:
        real = hurt._op_decode

        def failing(**kw):
            real(**kw)
            raise RuntimeError("planted follower fault")

        hurt._op_decode = failing
    if rank == 0:
        hurt.setup()
        try:
            with InferenceClient(hurt.address).setup() as c:
                t0 = time.monotonic()
                first = _outcome(lambda: c.generate(prompt0, n_tokens=n0))
                res["hurt"] = {"first": first, "first_s": time.monotonic() - t0,
                               "next": _outcome(lambda: c.generate(prompt0, n_tokens=n0))}
        finally:
            hurt.stop()
        res["hurt"]["mesh_error"] = hurt.mesh_error
    else:
        res["hurt"] = _followed(hurt)
    # a follower whose rank 0 never serves (no program, no no-op) raises
    # within the control timeout
    lost = InferenceServer(model, port=0, control_timeout_s=3.0)
    if rank == 0:
        res["lost"] = "leader left"
    else:
        t0 = time.monotonic()
        try:
            lost.follow()
            res["lost"] = None
        except Exception as e:
            res["lost"] = (type(e).__name__, time.monotonic() - t0)
    dist.barrier()  # rank 0 waits for the lost followers before it leads again
    res["spec"] = _spec_cases(rank, cfg, p, tp)
    return res
