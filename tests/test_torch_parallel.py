"""Port parity: the five-axis mesh, the collectives and their gradients,
the sharding rules and batch placement (``distriflow_tpu_torch/parallel``)
against the JAX package on the CPU.

The port side runs once, in a spawned gloo world of 4 CPU processes
(``tests/torch_mesh_cases.py::parallel_cases``); the JAX side runs here on
``devices[:4]`` of the 8 virtual CPU devices. Rank *r* of a port mesh must
hold what JAX's device *r* holds:

- each rank's coordinates on every axis of six mesh shapes, and the mesh's
  five axes with their sizes;
- every collective's output and the gradient of ``sum(out * c)`` against
  JAX's ``shard_map`` (tolerance 1e-6; copies are exact), over the whole
  ``data`` axis and over the ``model`` sub-axis of ``{data 2, model 2}``;
- every leaf of the flagship tree (vocab 32000, d 512, 8 x 64 heads, d_ff
  2048, 8 layers) and of an MoE tree under ``TRANSFORMER_TP_RULES``: the
  rule the port resolves through the leaf's JAX keystr against JAX's
  ``spec_for_path``, and this rank's block (dims and offsets) against
  ``devices_indices_map`` of JAX's device r; at small widths the blocks'
  values against JAX's ``addressable_shards`` (exact), and
  ``gather_params`` inverts ``shard_params`` exactly;
- ``_zero_extend``'s dim choice against JAX's on the same specs and shapes;
- ``shard_batch`` (also sequence-sharded), ``replicate``, ``shard_batch_padded``,
  ``DistributedDataset.next_sharded`` and ``prefetch_to_device(mesh=)``
  against JAX's shards (exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from distriflow_tpu.data.dataset import DistributedDataset as JaxDataset
from distriflow_tpu.data.prefetch import prefetch_to_device as jax_prefetch
from distriflow_tpu.models.transformer import TransformerConfig as JaxConfig
from distriflow_tpu.models.transformer import transformer_lm as jax_transformer_lm
from distriflow_tpu.parallel import collectives as jc
from distriflow_tpu.parallel import sharding as js
from distriflow_tpu.parallel.mesh import create_mesh as jax_create_mesh
from distriflow_tpu.parallel.mesh import replicate as jax_replicate
from distriflow_tpu.parallel.mesh import shard_batch as jax_shard_batch
from distriflow_tpu.parallel.mesh import shard_batch_padded as jax_shard_batch_padded
from distriflow_tpu.utils.compat import shard_map
from distriflow_tpu.utils.config import MeshConfig as JaxMeshConfig
from distriflow_tpu_torch.models.convert import lm_flax_path, lm_param_shapes, params_from_jax
from distriflow_tpu_torch.models.transformer import TransformerConfig
from distriflow_tpu_torch.parallel import sharding as ps
from distriflow_tpu_torch.parallel.mesh import AXES

from torch_mesh_cases import run_world

pytestmark = pytest.mark.port

MESHES = {"data4": {"data": 4}, "data2_model2": {"data": 2, "model": 2},
          "model2_seq2": {"model": 2, "seq": 2}, "data2_seq2": {"data": 2, "seq": 2},
          "model2_expert2": {"model": 2, "expert": 2}, "data2_expert2": {"data": 2, "expert": 2}}
COLLECTIVES = [(name, "data4", "data") for name in (
    "psum", "pmean", "copy_to", "all_gather", "all_gather_invariant", "reduce_scatter",
    "ppermute", "all_to_all")] + [(name, "data2_model2", "model") for name in (
        "psum", "copy_to", "all_gather", "reduce_scatter", "ppermute", "all_to_all")]
FLAGSHIP = dict(vocab_size=32000, d_model=512, n_heads=8, n_layers=8, d_ff=2048, max_seq=2048)
MOE = dict(vocab_size=32000, d_model=512, n_heads=8, n_layers=2, d_ff=2048, max_seq=1024,
           n_experts=8, moe_top_k=2)
SMALL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=48)
SMALL_MOE = dict(SMALL, n_experts=4, moe_top_k=2)
SLICE_CASES = [("flagship", "data2_model2"), ("moe", "model2_expert2"), ("moe", "data2_expert2")]
VALUE_CASES = [("small", "data2_model2"), ("small_moe", "model2_expert2")]
# [d, H, D] / [H, D, d] in flax, [d, H*D] / [H*D, d] in the port
MERGED = {"q_proj": [[0], [1, 2]], "k_proj": [[0], [1, 2]], "v_proj": [[0], [1, 2]],
          "o_proj": [[0, 1], [2]]}


def _jmesh(devices, key):
    return jax_create_mesh(JaxMeshConfig(**MESHES[key]), devices[:4])


def _jax_tree(dims, seed=0):
    cfg = JaxConfig(**dims, dtype=jnp.float32)
    tree = jax_transformer_lm(cfg, example_seq=8).init(jax.random.PRNGKey(seed))
    return cfg, jax.tree_util.tree_map(np.asarray, tree)


def _batch():
    rng = np.random.RandomState(5)
    return rng.randint(0, 64, (8, 12)).astype(np.int32), rng.randn(8, 12).astype(np.float32)


@pytest.fixture(scope="module")
def world():
    rng = np.random.RandomState(0)
    trees = {}
    for key, dims in (("small", SMALL), ("small_moe", SMALL_MOE)):
        _, tree = _jax_tree(dims)
        pcfg = TransformerConfig(**dims, dtype=torch.float32)
        trees[key] = {n: t.numpy() for n, t in params_from_jax(tree, pcfg, masters=True).items()}
    payload = {
        "mesh_shapes": MESHES, "collectives": COLLECTIVES,
        "x": rng.randn(16, 8).astype(np.float32), "c": rng.randn(16, 8).astype(np.float32),
        "slice_cases": SLICE_CASES,
        "shapes": {k: {n: s for n, (s, _) in lm_param_shapes(TransformerConfig(**d)).items()}
                   for k, d in (("flagship", FLAGSHIP), ("moe", MOE))},
        "value_cases": VALUE_CASES, "trees": trees, "batch": _batch(),
    }
    return payload, run_world(4, "parallel_cases", payload)


def _device_block(arr_sharding, shape, device):
    """(start, size) per dim of ``device``'s block under a JAX sharding."""
    idx = arr_sharding.devices_indices_map(tuple(shape))[device]
    return [(s.start or 0, (s.stop if s.stop is not None else n) - (s.start or 0))
            for s, n in zip(idx, shape)]


def _shard_of(arr, device):
    return next(np.asarray(s.data) for s in arr.addressable_shards if s.device == device)


def test_process_index_and_mesh_axes(world):
    _, ranks = world
    assert [r["process"] for r in ranks] == [(i, 4, i == 0) for i in range(4)]
    for key, shape in MESHES.items():
        for r in ranks:
            coords, sizes = r["coords"][key]
            assert tuple(sizes) == AXES
            assert sizes == {ax: shape.get(ax, 1) for ax in AXES}


@pytest.mark.parametrize("key", list(MESHES))
def test_rank_r_sits_where_jax_device_r_sits(world, devices, key):
    _, ranks = world
    mesh = _jmesh(devices, key)
    for r, res in enumerate(ranks):
        pos = np.argwhere(mesh.devices == devices[r])[0]
        assert res["coords"][key][0] == dict(zip(mesh.axis_names, map(int, pos)))


def _jax_collective(name, mesh, axis, x, c):
    """Per axis index i: (output, gradient block) of JAX's collective."""
    n = mesh.shape[axis]
    rows = x.shape[0] // n
    if name == "all_gather_invariant":  # the replicated gather: identity on the global x
        return [(x, c[i * rows:(i + 1) * rows]) for i in range(n)]
    if name in ("psum", "pmean"):
        op = lax.psum if name == "psum" else lax.pmean
        f = shard_map(lambda v: op(v, axis), mesh=mesh, in_specs=P(axis), out_specs=P())
        out = f(x)
        ct = c.reshape(-1)[:out.size].reshape(out.shape)
        g = jax.grad(lambda v: jnp.sum(f(v) * ct))(x)
        return [(np.asarray(out), np.asarray(g[i * rows:(i + 1) * rows])) for i in range(n)]
    if name == "copy_to":
        f = shard_map(lambda v: jc.pvary(v, axis), mesh=mesh, in_specs=P(), out_specs=P(axis))
        out = f(x)
        ct = np.concatenate([c.reshape(-1)[:x.size].reshape(x.shape) * (i + 1) for i in range(n)])
        g = jax.grad(lambda v: jnp.sum(f(v) * ct))(x)
        blk = out.shape[0] // n
        return [(np.asarray(out[i * blk:(i + 1) * blk]), np.asarray(g)) for i in range(n)]
    body = {"all_gather": lambda v: lax.all_gather(v, axis, tiled=True),
            "reduce_scatter": lambda v: lax.psum_scatter(v, axis, scatter_dimension=0, tiled=True),
            "ppermute": lambda v: lax.ppermute(v, axis, [(j, (j + 1) % n) for j in range(n)]),
            "all_to_all": lambda v: lax.all_to_all(v, axis, 1, 0, tiled=True)}[name]
    f = shard_map(body, mesh=mesh, in_specs=P(axis), out_specs=P(axis))
    out = np.asarray(f(x))
    blk = out.shape[0] // n
    shape = (blk,) + out.shape[1:]
    ct = np.concatenate([c.reshape(-1)[:int(np.prod(shape))].reshape(shape) * (i + 1)
                         for i in range(n)])
    g = np.asarray(jax.grad(lambda v: jnp.sum(f(v) * ct))(x))
    return [(out[i * blk:(i + 1) * blk], g[i * rows:(i + 1) * rows]) for i in range(n)]


@pytest.mark.parametrize("name,key,axis", COLLECTIVES)
def test_collective_and_its_gradient_match_shard_map(world, devices, name, key, axis):
    payload, ranks = world
    mesh = _jmesh(devices, key)
    want = _jax_collective(name, mesh, axis, payload["x"], payload["c"])
    for r, res in enumerate(ranks):
        i = res["coords"][key][0][axis]
        out, grad = res["collectives"][(name, key, axis)]
        np.testing.assert_allclose(out, want[i][0], rtol=0, atol=1e-6, err_msg=f"{name} rank {r}")
        np.testing.assert_allclose(grad, want[i][1], rtol=0, atol=1e-6, err_msg=f"{name} rank {r}")


def test_allreduce_mean_and_ordered_sum(world):
    payload, ranks = world
    x = payload["x"]
    for res in ranks:  # the mean of every rank's 2 rows
        np.testing.assert_allclose(res["allreduce_mean"], x[:8].mean(0), rtol=0, atol=1e-6)
        want = x[0].copy()
        for i in range(1, 4):
            want = want + x[i]
        np.testing.assert_array_equal(res["ordered_sum"], want)  # rank order, every rank


def _jax_leaves(dims):
    cfg = JaxConfig(**dims)
    shapes = jax.eval_shape(jax_transformer_lm(cfg, example_seq=8).init, jax.random.PRNGKey(0))
    return {jax.tree_util.keystr(p): tuple(v.shape)
            for p, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}


@pytest.mark.parametrize("tree_key,key", SLICE_CASES)
def test_every_leaf_resolves_and_shards_as_jax(world, devices, tree_key, key):
    _, ranks = world
    dims = FLAGSHIP if tree_key == "flagship" else MOE
    jax_leaves = _jax_leaves(dims)
    names = list(lm_param_shapes(TransformerConfig(**dims)))
    assert sorted(ps.jax_keystr(n, lm_flax_path) for n in names) == sorted(jax_leaves)  # one leaf each
    mesh = _jmesh(devices, key)
    for n in names:
        path = ps.jax_keystr(n, lm_flax_path)
        jshape = jax_leaves[path]
        jspec = js._fit_spec_to_rank(js.spec_for_path(path, js.TRANSFORMER_TP_RULES), len(jshape))
        sh = NamedSharding(mesh, jspec)
        groups = MERGED.get(n.rsplit(".", 1)[-1], [[d] for d in range(len(jshape))])
        for r, res in enumerate(ranks):
            pspec, pblock, _ = res["slices"][(tree_key, key)][n]
            assert pspec == tuple(jspec), (n, pspec, jspec)
            jblock = _device_block(sh, jshape, devices[r])
            want = []
            for grp in groups:  # a merged port dim: the first flax dim's block, scaled
                rest = int(np.prod([jshape[d] for d in grp[1:]]))
                assert all(jblock[d] == (0, jshape[d]) for d in grp[1:])
                want.append((jblock[grp[0]][0] * rest, jblock[grp[0]][1] * rest))
            assert pblock == want, (n, r, pblock, want)


@pytest.mark.parametrize("tree_key,key", VALUE_CASES)
def test_rank_r_holds_jax_device_r_block(world, devices, tree_key, key):
    _, ranks = world
    dims = SMALL if tree_key == "small" else SMALL_MOE
    _, tree = _jax_tree(dims)
    mesh = _jmesh(devices, key)
    placed = js.shard_params(tree, mesh, js.TRANSFORMER_TP_RULES)
    flat = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(placed)[0]}
    for r, res in enumerate(ranks):
        blocks, roundtrip = res["blocks"][(tree_key, key)]
        assert roundtrip
        for n, block in blocks.items():
            want = _shard_of(flat[ps.jax_keystr(n, lm_flax_path)], devices[r])
            np.testing.assert_array_equal(block, want.reshape(block.shape), err_msg=f"{n} r{r}")


ZERO_CASES = [((None, "model"), (512, 8, 64)), (("model", None), (8, 64, 512)),
              (("expert", None, "model"), (8, 512, 2048)), ((), (512,)), ((), (7, 3)),
              (("data",), (8, 4)), ((None, "model"), (6, 16)), ((), (3, 8))]


@pytest.mark.parametrize("spec,shape", ZERO_CASES)
def test_zero_extend_picks_jax_dim(world, devices, spec, shape):
    mesh = _jmesh(devices, "data2_model2")
    want = js._zero_extend(NamedSharding(mesh, P(*spec)), shape, mesh, "data").spec
    got = ps._zero_extend(spec, shape, _Sizes(), "data")
    assert tuple(got) == tuple(want) + (None,) * (len(got) - len(tuple(want)))


def test_zero_dims_of_the_port_layouts(world):
    """The dim each flagship leaf's moments shard over on {data 2, model 2}:
    the first unsharded dim that data divides (o_proj, [H*D, d] here,
    takes d where flax's [H, D, d] takes D: the bytes are the same)."""
    _, ranks = world
    got = ranks[0]["slices"][("flagship", "data2_model2")]
    assert got["layers.0.attn.q_proj"][2] == 0
    assert got["layers.0.attn.o_proj"][2] == 1
    assert got["embed"][2] == 0 and got["lm_head"][2] == 0
    assert got["layers.0.mlp.wo"][2] == 1 and got["ln_f.scale"][2] == 0


def test_batches_shard_as_jax(world, devices):
    payload, ranks = world
    x, y = payload["batch"]
    mesh = _jmesh(devices, "data4")
    jx, jy = jax_shard_batch(mesh, (x, y))
    jp = jax_shard_batch_padded(mesh, x[:6], y[:6])
    smesh = _jmesh(devices, "data2_seq2")
    seq = [jax.device_put(v, NamedSharding(smesh, P("data", "seq"))) for v in (x, y)]
    ds = JaxDataset(x, y, {"batch_size": 6, "epochs": 1, "small_last_batch": True})
    nexts = []
    while True:
        b = ds.next_sharded(mesh)
        if b is None:
            break
        nexts.append(b)
        ds.complete_batch(b.batch)
    pre = list(jax_prefetch(iter([(x, y), (x[::-1].copy(), y[::-1].copy())]), mesh))
    for r, res in enumerate(ranks):
        d = devices[r]
        for got, want in zip(res["shard_batch"], (jx, jy)):
            np.testing.assert_array_equal(got, _shard_of(want, d))
        for got, want in zip(res["replicate"], jax_replicate(mesh, (x, y))):
            np.testing.assert_array_equal(got, _shard_of(want, d))
        for got, want in zip(res["shard_batch_seq"], seq):
            np.testing.assert_array_equal(got, _shard_of(want, d))
        for got, want in zip(res["padded"], jp):
            np.testing.assert_array_equal(got, _shard_of(want, d))
        assert len(res["next_sharded"]) == len(nexts) == 2
        for (batch, bx, by, bw), want in zip(res["next_sharded"], nexts):
            assert batch == want.batch
            for got, w in zip((bx, by, bw), (want.x, want.y, want.weight)):
                np.testing.assert_array_equal(got, _shard_of(w, d))
        for got, want in zip(res["prefetch"], pre):
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, _shard_of(b, d))


def test_rule_tables_are_jax_verbatim():
    for name in ("REPLICATED_RULES", "TRANSFORMER_TP_RULES", "PIPELINED_TRANSFORMER_RULES"):
        port, ref = getattr(ps, name), getattr(js, name)
        assert [(p, tuple(s)) for p, s in port] == [(p, tuple(s)) for p, s in ref], name


class _Sizes:
    """A stand-in for a {data 2, model 2} mesh where only the axis sizes
    are read (the spec-level helpers)."""
    mesh_dim_names = AXES
    shape = tuple(MESHES["data2_model2"].get(a, 1) for a in AXES)


def test_tree_and_opt_state_shardings_mirror_jax(devices):
    """``tree_shardings`` gives every leaf its resolved spec;
    ``opt_state_shardings`` gives each moment leaf its parameter's spec,
    extended over ``data`` (ZeRO-1) as JAX's ``_zero_extend`` extends it,
    and replicates the count; ``describe_shardings`` lists every leaf by
    its JAX keystr."""
    from distriflow_tpu_torch.models.base import Optimizer

    cfg = TransformerConfig(**SMALL, dtype=torch.float32)
    shapes = {n: s for n, (s, _) in lm_param_shapes(cfg).items()}
    params = {n: torch.zeros(s) for n, s in shapes.items()}
    placed = ps.tree_shardings(params, _Sizes(), ps.TRANSFORMER_TP_RULES, lm_flax_path)
    specs = {n: p.spec for n, p in placed.items()}
    mesh = _jmesh(devices, "data2_model2")
    for n, spec in specs.items():
        jpath = ps.jax_keystr(n, lm_flax_path)
        assert spec == tuple(js._fit_spec_to_rank(
            js.spec_for_path(jpath, js.TRANSFORMER_TP_RULES), len(shapes[n])))
    state = Optimizer("adam", 1e-3).init(params)
    opt = ps.opt_state_shardings(state, specs, shapes, _Sizes(), zero_axis="data")
    assert opt["count"].spec == ()
    for key in ("mu", "nu"):
        for n, pl in opt[key].items():
            want = js._zero_extend(NamedSharding(mesh, P(*specs[n])), shapes[n], mesh, "data").spec
            assert pl.spec == tuple(want) + (None,) * (len(pl.spec) - len(tuple(want))), n
    text = ps.describe_shardings(params, _Sizes(), ps.TRANSFORMER_TP_RULES, lm_flax_path)
    assert ([ln.split()[0] for ln in text.splitlines()]
            == [ps.jax_keystr(n, lm_flax_path) for n in params])


@pytest.mark.parametrize("n,divisor", [(6, 4), (8, 4), (5, 2), (1, 8)])
def test_batch_helpers_match_jax(n, divisor):
    from distriflow_tpu.parallel.mesh import local_batch_size as jax_local_batch_size
    from distriflow_tpu.parallel.mesh import pad_partial_batch as jax_pad
    from distriflow_tpu_torch.parallel.mesh import local_batch_size, pad_partial_batch

    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    got, want = pad_partial_batch(divisor, x, x[:, 0]), jax_pad(divisor, x, x[:, 0])
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)

    class _Data:
        mesh_dim_names = AXES
        shape = (divisor, 1, 1, 1, 1)

    class _JaxData:
        shape = {"data": divisor}

    if n % divisor:
        with pytest.raises(ValueError, match="not divisible"):
            local_batch_size(n, _Data())
    else:
        assert local_batch_size(n, _Data()) == jax_local_batch_size(n, _JaxData())


def test_the_spec_carries_its_flax_paths():
    """The LM's spec names its flax paths (the sharding rules match them);
    a model without one, such as the zoo's, keeps its dotted names, so a
    leaf it calls ``embed`` is not read as the LM's."""
    from distriflow_tpu_torch.models.transformer import transformer_lm
    from distriflow_tpu_torch.models.zoo import mnist_mlp

    spec = transformer_lm(TransformerConfig(**SMALL, dtype=torch.float32), device="cpu")
    assert spec.flax_path("layers.1.attn.q_proj") == ("layers_1", "attn", "q_proj", "kernel")
    assert ps.spec_for("layers.1.attn.q_proj", 2, ps.TRANSFORMER_TP_RULES,
                       spec.flax_path) == (None, "model")
    assert mnist_mlp(device="cpu").flax_path is None
    assert ps.jax_keystr("embed") == "['params']['embed']"
    assert ps.jax_keystr("embed", spec.flax_path) == "['params']['embed']['embedding']"


# (kind, world, process, cards, ranks_per_device, LOCAL_WORLD_SIZE, LOCAL_RANK)
#   -> (backend, card)
PLACEMENTS = [
    (("cpu", 4, 2, 0, None, None, None), ("gloo", None)),
    (("cuda", 1, 0, 1, None, None, None), ("nccl", 0)),
    (("cuda", 4, 3, 8, None, None, None), ("nccl", 3)),  # one host, a card a rank
    (("cuda", 4, 3, 1, 4, None, None), ("gloo", 0)),  # four ranks share the card
    (("cuda", 16, 11, 8, None, 8, 3), ("nccl", 3)),  # two hosts of 8 cards (torchrun)
    (("cuda", 16, 11, 8, None, 16, 11), ("gloo", 5)),  # one host, two ranks a card
    (("cuda", 16, 11, 8, 1, None, None), ("nccl", 3)),  # told: a card a rank
]


@pytest.mark.parametrize("args,want", PLACEMENTS)
def test_backend_and_card_follow_the_placement(args, want):
    """nccl only where each rank has a card of its own, decided from the
    ranks that share each card of this host, never from the global world
    size against this host's cards."""
    from distriflow_tpu_torch.parallel.distributed import placement

    assert placement(*args) == want


def test_placement_refuses_to_guess():
    """More ranks than this host's cards, and nothing saying how many are
    on this host: an error, not a silent gloo."""
    from distriflow_tpu_torch.parallel.distributed import placement

    with pytest.raises(ValueError, match="ranks_per_device"):
        placement("cuda", 16, 11, 8)
