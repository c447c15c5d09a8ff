"""Port parity: Ulysses attention (``distriflow_tpu_torch/parallel/ulysses.py``)
against the JAX package on the CPU.

The port runs once, in a spawned gloo world of 4 CPU processes
(``tests/torch_mesh_cases.py::attention_cases``): each rank holds its
``[B/dp, H/tp, S/n, D]`` chunk of the same numpy q, k, v and a cotangent
c; the all-to-all gives it ``H/tp/n`` heads over the whole sequence, where
attention runs (blockwise, and the flash attention's CPU version), and a
second all-to-all swaps back; ``sum(out * c)`` is backpropagated through
both. JAX runs ``ulysses_attention`` (blockwise) on ``devices[:4]`` of the
same mesh. On ``{seq 4}``, ``{data 2, seq 2}`` and ``{model 2, seq 2}``
(local heads H / model / seq), causal and not: outputs and q, k, v
gradients within 1e-5 (f32). The local-heads validation raises JAX's
message, word for word.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distriflow_tpu.parallel.mesh import create_mesh
from distriflow_tpu.parallel.ring_attention import dense_attention
from distriflow_tpu.parallel.ulysses import ulysses_attention
from distriflow_tpu.utils.config import MeshConfig

from torch_mesh_cases import run_world

pytestmark = pytest.mark.port

B, H, S, D = 2, 4, 32, 8
MESHES = {"seq4": {"seq": 4}, "data2_seq2": {"data": 2, "seq": 2},
          "model2_seq2": {"model": 2, "seq": 2}}
CASES = [(key, "ulysses", MESHES[key], causal, flash)
         for key in MESHES for causal in (True, False) for flash in (False, True)]
BAD = [("heads2_seq4", {"seq": 4}, 2), ("heads1_model2_seq2", {"model": 2, "seq": 2}, 1)]
ATOL = 1e-5


def _qkvc():
    rng = np.random.RandomState(4)
    return [rng.randn(B, H, S, D).astype(np.float32) for _ in range(4)]


@pytest.fixture(scope="module")
def world():
    payload = {"cases": CASES, "qkvc": _qkvc(), "bad_ulysses": BAD}
    return payload, run_world(4, "attention_cases", payload)


def _block(arr, mesh, device):
    """``device``'s [B/dp, H/tp, S/n, D] block of a global array."""
    pos = dict(zip(mesh.axis_names, map(int, np.argwhere(mesh.devices == device)[0])))
    b = arr.shape[0] // mesh.shape["data"]
    h = arr.shape[1] // mesh.shape["model"]
    s = arr.shape[2] // mesh.shape["seq"]
    return arr[pos["data"] * b:(pos["data"] + 1) * b, pos["model"] * h:(pos["model"] + 1) * h,
               pos["seq"] * s:(pos["seq"] + 1) * s]


@pytest.mark.parametrize("flash", [False, True], ids=["blockwise", "flash"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("key", list(MESHES))
def test_ulysses_matches_jax_forward_and_grads(world, devices, key, causal, flash):
    payload, ranks = world
    q, k, v, c = payload["qkvc"]
    mesh = create_mesh(MeshConfig(**MESHES[key]), devices[:4])

    def f(q, k, v):
        return ulysses_attention(q, k, v, mesh, causal=causal, use_flash=False)

    want = [np.asarray(jax.jit(f)(q, k, v))] + [np.asarray(g) for g in jax.jit(jax.grad(
        lambda q, k, v: jnp.sum(f(q, k, v) * c), argnums=(0, 1, 2)))(q, k, v)]
    np.testing.assert_allclose(want[0], np.asarray(dense_attention(q, k, v, causal=causal)),
                               rtol=0, atol=ATOL)
    for r, res in enumerate(ranks):
        got = res[(key, "ulysses", causal, flash)][:4]
        for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(g, _block(w, mesh, devices[r]), rtol=0, atol=ATOL,
                                       err_msg=f"{name} rank {r}")


@pytest.mark.parametrize("key,shape,heads", BAD)
def test_local_head_validation_is_jax_message(world, devices, key, shape, heads):
    _, ranks = world
    mesh = create_mesh(MeshConfig(**shape), devices[:4])
    q = jnp.zeros((1, heads * shape.get("model", 1), 16, 8))
    with pytest.raises(ValueError) as err:
        ulysses_attention(q, q, q, mesh)
    for res in ranks:
        assert res["errors"][key] == str(err.value)
