"""Port: the fused attention backward's dQ partial layout
(``distriflow_tpu_torch/csrc/flash_attention_bwd.cu``, ``dkv::live_kv_tiles``).

The fused backward kernel writes, for each live (128-key KV tile, 64-row Q
tile) pair, the f32 partial ``dS[q rows, KV tile] @ K[KV tile]`` once, and a
second pass sums each Q tile's partials over the KV tiles ``live_kv_tiles``
names, in ascending order, then scales and casts to bf16 (the JAX
package's ``[n_kv, BH, S, D]`` partials, summed outside its kernel). The
rule lives only in the CUDA source, where the kernel and its second pass
share it; the CUDA kernels run only on the card. This test holds
:func:`_live_kv_tiles`, a Python mirror of that rule, not the kernel: over
exactly the mirror's range, the plain version's partials sum to the plain
dQ (:func:`flash_attention_dq_reference`), and every KV tile past the range
holds only masked pairs, so its partial is exactly zero and need be neither
written nor read. The kernel's own partials are held against the plain
version only on the card, by ``chip_smoke.py`` (row 6, with ragged and
non-causal lengths).

Tolerance: the sum of partials and the one product of the plain version
add the same S terms per element in two orders. Before the scale and cast
they are held within the first-order bound of f32 reordering, 2 * S *
2**-24 * (|dS| @ |K|) elementwise (both orders lie within half of it of
the exact sum). After the cast to bf16, where a last-bit difference can
flip a rounding, within that bound plus one rounding step of the output
(rtol 2**-7), both widened by one rounding (factor 1 + 2**-7): rounding
a and b to 8 significant bits leaves them at most (1 + 2**-8) |a - b| +
2**-7 |b| apart. The bound matters where dS.K nearly cancels (|dQ| ~ 1e-7
against a bound ~ 1e-4 at S 1000).
"""

import math

import numpy as np
import pytest
import torch

from distriflow_tpu_torch.ops import flash_attention as port_fa

pytestmark = pytest.mark.port
torch.set_num_threads(2)

B, H, D = 1, 2, 64
BLOCK_Q, BLOCK_KV = 64, 128  # kBQ and kBKV of the CUDA source's dkv namespace


def _live_kv_tiles(q_tile, s, causal):
    """Mirror of ``live_kv_tiles`` in csrc/flash_attention_bwd.cu: the KV
    tiles whose partial the fused kernel writes for the 64-row Q tile
    ``q_tile``, in the order its second pass adds them: every KV tile
    unless ``causal``, else those that start at or before the Q tile's
    last row."""
    n_kv = -(-s // BLOCK_KV)
    stop = (q_tile * BLOCK_Q + BLOCK_Q - 1) // BLOCK_KV + 1
    return range(stop if causal and stop < n_kv else n_kv)


def _inputs(s, causal, seed):
    rng = np.random.default_rng(seed)
    # K and V around 1, as a trained layer's: the delta term of dS matters
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, H, s, D)) + mean).to(torch.bfloat16)
                   for mean in (0.0, 1.0, 1.0, 0.0))
    o, lse = port_fa.flash_attention_reference(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1)
    return q, k, v, do, lse, delta


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [1, 37, 128, 1000, 1024])
def test_partials_over_live_kv_tiles_sum_to_the_plain_dq(s, causal):
    q, k, v, do, lse, delta = _inputs(s, causal, seed=s)
    _, ds = port_fa._probs_and_dscores(q, k, v, do, lse, delta, causal)
    kf = k.float()
    bq, bkv = BLOCK_Q, BLOCK_KV
    n_kv = -(-s // bkv)
    partials = [torch.matmul(ds[..., j * bkv:(j + 1) * bkv], kf[..., j * bkv:(j + 1) * bkv, :])
                for j in range(n_kv)]
    summed = torch.empty(B, H, s, D)
    for t in range(-(-s // bq)):
        rows = slice(t * bq, min(s, (t + 1) * bq))
        tiles = _live_kv_tiles(t, s, causal)
        assert tiles.start == 0 and tiles.step == 1 and 1 <= len(tiles) <= n_kv
        acc = partials[tiles[0]][..., rows, :].clone()
        for j in tiles[1:]:
            acc += partials[j][..., rows, :]
        summed[..., rows, :] = acc
        for j in range(tiles.stop, n_kv):  # fully masked pairs
            assert torch.equal(partials[j][..., rows, :], torch.zeros_like(acc))

    scale = 1.0 / math.sqrt(D)
    exact = torch.matmul(ds, kf) * scale
    bound = 2 * s * 2.0 ** -24 * torch.matmul(ds.abs(), kf.abs()) * scale
    assert bool(((summed * scale - exact).abs() <= bound).all())
    want = port_fa.flash_attention_dq_reference(q, k, v, do, lse, delta, causal).float()
    got = (summed * scale).to(torch.bfloat16).float()
    assert bool(((got - want).abs() <= (1 + 2.0 ** -7) * (bound + 2.0 ** -7 * want.abs())).all())


def test_every_kv_tile_is_live_for_the_last_q_tile():
    # the wrapper sizes the partial buffer at ceil(S / 128) KV tiles
    assert port_fa._FUSED_BWD_BLOCK_KV == BLOCK_KV
    for s in (1, 37, 64, 65, 128, 129, 1000, 1024, 8192):
        n_q, n_kv = -(-s // BLOCK_Q), -(-s // BLOCK_KV)
        for causal in (True, False):
            assert len(_live_kv_tiles(n_q - 1, s, causal)) == n_kv
    # live pairs at the training shape and the fused layout's longest S
    assert sum(len(_live_kv_tiles(t, 1024, True)) for t in range(16)) == 72
    assert sum(len(_live_kv_tiles(t, 8192, True)) for t in range(128)) == 4160
