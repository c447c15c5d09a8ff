"""Port parity: the limits the bf16 two-kernel backward is held to on the
card (``chip_smoke.py``'s ``_flip_atols``, the note above its ``TOL``):
atol 1e-3 + rtol 2**-7 of the plain version, plus ``BWD_FLIPS`` flips of a
bf16 term by element, each charged at the heaviest term of the element's
sum: 2**-7 scale max_j |dS_ij K_jd| for dQ, 2**-7 scale max_i |dS_ij Q_id|
for dK and 2**-7 max_i |P_ij dO_id| for dV (at head dims 32 and 64), P and
dS from the recipe in f64.

At B 1, H 2, S 200, head dims 32 and 64, causal and not, over several
numpy seeds (K and V drawn around 1, as the smoke draws them):

- the plain gradients with their sums taken in f64 (the same bf16
  roundings of P, dS and the outputs, the sums in another order, as a
  kernel takes them) hold the limits around the plain versions;
- so do the plain gradients with P taken as exp2 of the folded argument,
  s (scale log2 e) - lse log2 e (a kernel's rounding of P, emulated);
- a dQ with delta taken as 0 and a dK without its scale put more than
  half of the elements outside them;
- each limit equals its formula written out in numpy float64.
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from distriflow_tpu_torch.ops import flash_attention as port_fa

pytestmark = pytest.mark.port
torch.set_num_threads(2)

NAME = {"dq": "flash_attention_dq_d32", "dk": "flash_attention_dkv_d32",
        "dv": "flash_attention_dkv_d32"}
B, H, S = 1, 2, 200
SEEDS = (0, 1, 2)
LOG2E = 1.4426950408889634


def _inputs(d, causal, seed):
    """q, K, V, dO in bf16 from one numpy seed (K and V around 1), lse and
    delta from the plain forward: the backward's arguments."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, H, S, d), dtype=np.float32) + mean)
                   .to(torch.bfloat16) for mean in (0.0, 1.0, 1.0, 0.0))
    o, lse = port_fa.flash_attention_reference(q, k, v, causal)
    return q, k, v, do, lse, (do.float() * o.float()).sum(-1), causal


def _grads(args, probs):
    """(dQ, dK, dV) of the plain recipe with P from ``probs(s_raw, lse,
    scale)`` and every sum in f64, P, dS and the outputs rounded to bf16
    as the plain versions round them."""
    q, k, v, do, lse, delta, causal = args
    bf = lambda t: t.float().to(torch.bfloat16).double()  # noqa: E731
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = probs(q.double() @ k.double().transpose(-1, -2), lse.double()[..., None], scale)
    if causal:
        p = torch.where(port_fa._causal_keep(S, "cpu"), p, torch.zeros_like(p))
    ds = bf(p * (do.double() @ v.double().transpose(-1, -2) - delta.double()[..., None]))
    out = (ds @ k.double() * scale, ds.transpose(-1, -2) @ q.double() * scale,
           bf(p).transpose(-1, -2) @ do.double())
    return dict(zip(("dq", "dk", "dv"), (x.float().to(torch.bfloat16) for x in out)))


def _plain_in_f64(s, lse, scale):
    return torch.exp((s.float() * scale).double() - lse)


def _exp2_folded(s, lse, scale):
    return torch.exp2(s.float() * (scale * LOG2E) - lse.float() * LOG2E).double()


def _plain(args):
    dk, dv = port_fa.flash_attention_dkv_reference(*args)
    return {"dq": port_fa.flash_attention_dq_reference(*args), "dk": dk, "dv": dv}


def _atols(args):
    (dq,) = chip_smoke._flip_atols(NAME["dq"], ("dq",), *args)
    dk, dv = chip_smoke._flip_atols(NAME["dk"], ("dk", "dv"), *args)
    return {"dq": dq, "dk": dk, "dv": dv}


def _outside(got, want, atol):
    rtol = chip_smoke.TOL[NAME["dq"]][1]
    return float(((got.float() - want.float()).abs() > atol + rtol * want.float().abs())
                 .float().mean())


def _numpy_atol(which, q, k, v, do, lse, delta, causal):
    q, k, v, do, lse, delta = (t.double().numpy() for t in (q, k, v, do, lse, delta))
    scale = 1 / math.sqrt(q.shape[-1])
    keep = np.tril(np.ones((S, S), bool)) if causal else np.ones((S, S), bool)
    p = np.where(keep, np.exp(np.einsum("bhid,bhjd->bhij", q, k) * scale - lse[..., None]), 0.0)
    ds = p * (np.einsum("bhid,bhjd->bhij", do, v) - delta[..., None])
    if which == "dq":
        heavy = scale * (np.abs(ds)[..., None] * np.abs(k)[:, :, None]).max(axis=3)
    elif which == "dk":
        heavy = scale * (np.abs(ds)[..., None] * np.abs(q)[:, :, :, None]).max(axis=2)
    else:
        heavy = (np.abs(p)[..., None] * np.abs(do)[:, :, :, None]).max(axis=2)
    return chip_smoke.TOL[NAME[which]][0] + chip_smoke.BWD_FLIPS * 2 ** -7 * heavy


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64])
def test_honest_gradients_hold_the_flip_limits(d, causal, seed):
    args = _inputs(d, causal, seed)
    plain, atols = _plain(args), _atols(args)
    for probs in (_plain_in_f64, _exp2_folded):
        got = _grads(args, probs)
        for which in ("dq", "dk", "dv"):
            assert _outside(got[which], plain[which], atols[which]) == 0.0, (which, probs)
            assert chip_smoke._flips_needed(NAME[which], got[which], plain[which],
                                            atols[which]) <= chip_smoke.BWD_FLIPS


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64])
def test_wrong_gradients_fail_the_flip_limits(d, causal, seed):
    args = _inputs(d, causal, seed)
    q, k, v, do, lse, delta, _ = args
    plain, atols = _plain(args), _atols(args)
    no_delta = port_fa.flash_attention_dq_reference(q, k, v, do, lse, torch.zeros_like(delta), causal)
    assert _outside(no_delta, plain["dq"], atols["dq"]) > 0.5
    assert _outside(plain["dk"].float() * math.sqrt(d), plain["dk"], atols["dk"]) > 0.5


@pytest.mark.parametrize("which", ["dq", "dk", "dv"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64])
def test_flip_limit_is_its_formula(d, causal, which):
    args = _inputs(d, causal, seed=7)
    got = _atols(args)[which]
    assert got.dtype == torch.float32 and got.shape == args[0].shape
    np.testing.assert_allclose(got.numpy(), _numpy_atol(which, *args), rtol=1e-6, atol=0)
