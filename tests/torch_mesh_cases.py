"""Rank bodies of the port's mesh tests (``tests/test_torch_parallel.py``,
``test_torch_ring_attention.py``, ``test_torch_ulysses.py``,
``test_torch_sync_mesh.py``, ``test_torch_federated_mesh.py``).

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
