"""Port parity: ring attention (``distriflow_tpu_torch/parallel/ring_attention.py``)
against the JAX package on the CPU.

The port runs once, in a spawned gloo world of 4 CPU processes
(``tests/torch_mesh_cases.py::attention_cases``): each rank holds its
``[B/dp, H/tp, S/n, D]`` chunk of the same numpy q, k, v and a cotangent
c, runs the ring (the plain body, and the flash body through the flash
attention's CPU version with its lse), and backpropagates ``sum(out * c)``.
JAX runs ``ring_attention`` (its plain body) on ``devices[:4]`` of the
same mesh, and its gradients of the same sum. On ``{seq 4}`` and
``{data 2, seq 2}``, causal and not: the output chunks and the q, k, v
gradient chunks within 1e-5 (f32; the merge order differs from JAX's
online recurrence).

The kernels' FLOP tally on a rank of ``{seq 4}`` (causal, fwd + bwd) is
the value JAX's ``test_ring_flash_flop_tally_compensates_loop`` asserts:
the causal diagonal (6 u) plus the n - 1 off-diagonal chunks (12 u each),
u = b h s_c^2 d. The port records each executed chunk attention once, so
it needs no trace-multiplicity correction; JAX's corrected tally on the
same shapes is the same number.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distriflow_tpu.ops.flop_count import tally_pallas_cost
from distriflow_tpu.parallel.mesh import create_mesh
from distriflow_tpu.parallel.ring_attention import dense_attention, ring_attention
from distriflow_tpu.utils.config import MeshConfig

from torch_mesh_cases import run_world

pytestmark = pytest.mark.port

B, H, S, D = 2, 4, 32, 8
MESHES = {"seq4": {"seq": 4}, "data2_seq2": {"data": 2, "seq": 2}}
CASES = [(key, "ring", MESHES[key], causal, flash)
         for key in MESHES for causal in (True, False) for flash in (False, True)]
ATOL = 1e-5


def _qkvc():
    rng = np.random.RandomState(3)
    return [rng.randn(B, H, S, D).astype(np.float32) for _ in range(4)]


@pytest.fixture(scope="module")
def world():
    payload = {"cases": CASES, "qkvc": _qkvc(), "bad_ulysses": []}
    return payload, run_world(4, "attention_cases", payload)


def _jax_ring(devices, key, causal, q, k, v, c):
    mesh = create_mesh(MeshConfig(**MESHES[key]), devices[:4])

    def f(q, k, v):
        return ring_attention(q, k, v, mesh, causal=causal, use_flash=False)

    out = jax.jit(f)(q, k, v)
    grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(f(q, k, v) * c), argnums=(0, 1, 2)))(q, k, v)
    return mesh, [np.asarray(out)] + [np.asarray(g) for g in grads]


def _block(arr, mesh, device):
    """``device``'s [B/dp, H, S/n, D] block of a global array."""
    pos = dict(zip(mesh.axis_names, map(int, np.argwhere(mesh.devices == device)[0])))
    b, s = arr.shape[0] // mesh.shape["data"], arr.shape[2] // mesh.shape["seq"]
    return arr[pos["data"] * b:(pos["data"] + 1) * b, :, pos["seq"] * s:(pos["seq"] + 1) * s]


@pytest.mark.parametrize("flash", [False, True], ids=["plain", "flash"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("key", list(MESHES))
def test_ring_matches_jax_forward_and_grads(world, devices, key, causal, flash):
    payload, ranks = world
    q, k, v, c = payload["qkvc"]
    mesh, want = _jax_ring(devices, key, causal, q, k, v, c)
    np.testing.assert_allclose(want[0], np.asarray(dense_attention(q, k, v, causal=causal)),
                               rtol=0, atol=ATOL)
    for r, res in enumerate(ranks):
        got = res[(key, "ring", causal, flash)][:4]
        for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(g, _block(w, mesh, devices[r]), rtol=0, atol=ATOL,
                                       err_msg=f"{name} rank {r}")


def test_ring_flash_flop_tally_is_the_executed_work(world, devices):
    payload, ranks = world
    n, s_c = 4, S // 4
    u = B * H * s_c * s_c * D
    expected = 6 * u + (n - 1) * 12 * u  # JAX's asserted value
    mesh = create_mesh(MeshConfig(seq=n), devices[:4])
    q = jnp.zeros((B, H, S, D), jnp.float32)
    with tally_pallas_cost() as tally:
        jax.eval_shape(jax.grad(lambda q: jnp.sum(ring_attention(q, q, q, mesh, causal=True,
                                                                 use_flash=True))), q)
    assert tally["flops"] == expected
    for res in ranks:
        assert res[("seq4", "ring", True, True)][4] == expected
