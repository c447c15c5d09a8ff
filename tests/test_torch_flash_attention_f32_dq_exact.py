"""Port parity: the reference f32 dQ is held to on the card
(``chip_smoke.py``'s ``_dq_f64_recipe`` and
``TOL["flash_attention_dq_f32_exact"]``): the dQ recipe in f64 from the
same f32 inputs, which shares no f32 rounding with the kernel or its plain
version.

- The smoke's f64 recipe equals the recipe written out in numpy float64
  (P = exp(s * scale - lse), masked pairs 0, dS = P (dP - delta), dQ =
  scale dS K) to 1e-12.
- At B 1, H 2, S 200, head dims 32 and 64, causal and not, on the inputs
  of ``test_torch_flash_attention_f32_split.py`` (one numpy seed, K and V
  around 1, an lse cotangent folded into delta): the dQ kernel's mirror
  (``flash_attention_split_tf32_reference``) and the f32 plain version
  (``flash_attention_dq_reference``) both hold the exact limit; two
  planted faults, delta taken as 0 and one TF32 pass of the mirror's
  products (``passes=1``), put more than half of dQ's elements outside it.
- The limit stays below 1/100 of what one TF32 pass needs at the JAX LM
  CLI's path (d) shape on the H100 (3.1e-3, ``tools/f32_dq_limit_probe.py``).
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from distriflow_tpu_torch.ops import flash_attention as port_fa
from test_torch_flash_attention_f32_split import _inputs

pytestmark = pytest.mark.port
torch.set_num_threads(2)

NAME = "flash_attention_dq_f32_exact"
LIMIT = chip_smoke.TOL[NAME]
TF32_ONE_PASS_NEED = 3.1e-3  # at B8 H8 S16384 D32 on the H100


def _outside(got, want, limit=LIMIT):
    atol, rtol = limit
    err = (got.double() - want.double()).abs()
    return float((err > atol + rtol * want.double().abs()).double().mean())


def _numpy_recipe(q, k, v, do, lse, delta, causal):
    q, k, v, do, lse, delta = (t.double().numpy() for t in (q, k, v, do, lse, delta))
    s = q.shape[2]
    keep = np.tril(np.ones((s, s), bool)) if causal else np.ones((s, s), bool)
    scale = 1 / math.sqrt(q.shape[-1])
    p = np.where(keep, np.exp(np.einsum("bhid,bhjd->bhij", q, k) * scale - lse[..., None]), 0.0)
    ds = p * (np.einsum("bhid,bhjd->bhij", do, v) - delta[..., None])
    return np.einsum("bhij,bhjd->bhid", ds, k) * scale


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64])
def test_smoke_f64_recipe_is_the_recipe(d, causal):
    _, _, args = _inputs(d, causal, seed=20 + d + causal)
    got = chip_smoke._dq_f64_recipe(*args)
    assert got.dtype == torch.float64 and got.shape == args[0].shape
    np.testing.assert_allclose(got.numpy(), _numpy_recipe(*args), rtol=0, atol=1e-12)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64])
def test_mirror_and_plain_version_hold_the_exact_limit(d, causal):
    _, _, args = _inputs(d, causal, seed=10 + d + causal)
    exact = chip_smoke._dq_f64_recipe(*args)
    assert _outside(port_fa.flash_attention_dq_reference(*args), exact) == 0.0
    assert _outside(port_fa.flash_attention_split_tf32_reference(*args)[0], exact) == 0.0


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64])
def test_planted_faults_fail_the_exact_limit(d, causal):
    _, _, args = _inputs(d, causal, seed=10 + d + causal)
    q, k, v, do, lse, delta, _ = args
    exact = chip_smoke._dq_f64_recipe(*args)
    no_delta = port_fa.flash_attention_dq_reference(q, k, v, do, lse, torch.zeros_like(delta),
                                                    causal)
    one_pass = port_fa.flash_attention_split_tf32_reference(*args, passes=1)[0]
    assert _outside(no_delta, exact) > 0.5
    assert _outside(one_pass, exact) > 0.5


def test_exact_limit_sits_below_one_tf32_pass():
    atol, rtol = LIMIT
    assert rtol == chip_smoke.TOL["flash_attention_dq_f32"][1]
    assert chip_smoke.TOL["flash_attention_dq_f32"][0] < atol < TF32_ONE_PASS_NEED / 100
