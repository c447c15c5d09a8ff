"""Port checks around kernel 1 at head dim 32 (``csrc/flash_attention.cu``
namespace ``d32``), on the CPU:

- the source: the C entry takes the d32 kernel at D 32; P is one
  ``ex2.approx.ftz`` of the folded argument (no ``exp2f``); a NaN l is
  kept; no atomics;
- ``chip_smoke.py``'s planted forward faults, which the card's limits
  must reject at path (b)'s shape: the correction held at 1
  (``_fwd_no_correction``) equals the kernel's tile recurrence written
  out in numpy float64 with the correction left out, and with a single
  key tile it is the plain forward; it and lse without log(l)
  (``_row_max``) put most of lse outside ``LSE_ATOL`` at S 2048.
"""

import math
import re

import numpy as np
import pytest
import torch

import chip_smoke
from distriflow_tpu_torch.ops import build
from distriflow_tpu_torch.ops import flash_attention as port_fa

pytestmark = pytest.mark.port
torch.set_num_threads(2)


def _d32_namespace():
    text = (build.CSRC / "flash_attention.cu").read_text()
    start = re.search(r"\bnamespace\s+d32\s*{", text).end()
    depth = 1
    for i in range(start, len(text)):
        depth += {"{": 1, "}": -1}.get(text[i], 0)
        if depth == 0:
            return text, text[start:i]
    raise AssertionError("namespace d32 is not closed")


def test_d32_forward_source():
    text, body = _d32_namespace()
    assert re.search(r"D == 32\) return d32::launch\(", text)
    assert "ex2.approx.ftz.f32" in body and "exp2f(" not in body and "expf(" not in body
    assert "1e-30f ? 1e-30f :" in body
    assert "atomic" not in body and "red.global" not in body
    assert re.search(r"__global__[^;{]*\bfwd_kernel\s*\(", body)


def _inputs(s, seed, h=2):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((1, h, s, 32), dtype=np.float32))
                 .to(torch.bfloat16) for _ in range(3))


def _numpy_no_correction(q, k, v, block):
    """The kernel's recurrence over key tiles with corr = 1, in f64 (causal)."""
    q, k, v = (t.double().numpy()[0] for t in (q, k, v))
    h, s, d = q.shape
    scale = 1 / math.sqrt(d)
    o, lse = np.zeros_like(q), np.zeros((h, s))
    for i in range(s):
        m = np.full(h, -np.inf)
        l, acc = np.zeros(h), np.zeros((h, d))
        for k0 in range(0, i + 1, block):
            kk = np.arange(k0, min(k0 + block, i + 1))
            sc = np.einsum("hd,hjd->hj", q[:, i], k[:, kk]) * scale
            m = np.maximum(m, sc.max(-1))
            p = np.exp(sc - m[:, None])
            l, acc = l + p.sum(-1), acc + np.einsum("hj,hjd->hd", p, v[:, kk])
        o[:, i], lse[:, i] = acc / l[:, None], m + np.log(l)
    return o, lse


@pytest.mark.parametrize("block", [16, 64])
def test_no_correction_fault_is_the_recurrence_without_correction(block):
    q, k, v = _inputs(96, seed=3)
    o, lse = chip_smoke._fwd_no_correction(q, k, v, block=block)
    want_o, want_lse = _numpy_no_correction(q, k, v, block)
    np.testing.assert_allclose(o.float().numpy()[0], want_o, rtol=2 ** -7, atol=2e-3)
    np.testing.assert_allclose(lse.numpy()[0], want_lse, rtol=0, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_no_correction_fault_with_one_tile_is_the_plain_forward(causal):
    q, k, v = _inputs(300, seed=4)
    o, lse = chip_smoke._fwd_no_correction(q, k, v, causal=causal, block=512)
    ro, rl = port_fa.flash_attention_reference(q, k, v, causal)
    np.testing.assert_allclose(o.float().numpy(), ro.float().numpy(), rtol=2 ** -7, atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), rl.numpy(), rtol=0, atol=1e-6)


def test_planted_forward_faults_fail_the_lse_limit():
    q, k, v = _inputs(2048, seed=5)
    name = "flash_attention_fwd"
    _, rl = port_fa.flash_attention_reference(q, k, v, True)
    no_corr = chip_smoke._fwd_no_correction(q, k, v)[1]
    no_log = port_fa._per_head(lambda *x: (chip_smoke._row_max(*x),), q, k, v)[0]
    assert chip_smoke._rejected(name, no_corr, rl, atol=chip_smoke.LSE_ATOL) > 0.5
    assert chip_smoke._rejected(name, no_log, rl, atol=chip_smoke.LSE_ATOL) > 0.99
