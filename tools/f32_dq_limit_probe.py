"""Readings behind the f32 two-kernel attention backward's design
(``distriflow_tpu_torch/csrc/flash_attention_f32.cu``, namespace ``split3``)
on one CUDA card. Prints one JSON object:

- ``tf32_sum_ulps``: the ulps above 1 that a TF32 product on the tensor
  cores returns for an exact sum of 1 + 1.75 ulp: 2 where the sum rounds to
  nearest, 1 where it is truncated (why the split kernels keep each
  accumulator to 24 mma at most);
- ``path`` (B8 H8 S16384 D32 causal, ``chip_smoke.py``'s inputs for row
  ``flash_attention_dq_f32``) and ``d64_ragged`` (B1 H8 D64 at
  ``chip_smoke.RAGGED_F32_D64``, the inputs of ``chip_smoke._ragged_f32_d64``):
  the atol above dQ's rtol that each recipe needs against the f32 plain
  version (``flash_attention_dq_reference``), one (b, h) slice at a time:
  the exact recipe in f64, the f32 recipe with one of its three products
  (dP, S or dS K) in split-precision TF32, one TF32 pass of every product,
  and the kernel itself;
- ``vs_f64`` at those shapes and at ``d64`` (B1 H8 S16384 D64, drawn after
  the path's inputs as ``chip_smoke._lm_cli_f32_rows`` draws them): the
  atol above the rtol that the f32 plain version and the kernel need
  against the exact recipe in f64, the reference dQ is held to
  (``chip_smoke.TOL["flash_attention_dq_f32_exact"]``); and at the path's
  shape and ``d64``, the share of elements two planted faults put outside
  a few candidate atols around it: ``no_delta`` (delta taken as 0) and
  one TF32 pass of the plain recipe.

Run from the repository's root: ``python3 tools/f32_dq_limit_probe.py``.
"""

import json
import math
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from distriflow_tpu_torch.ops import flash_attention as fa  # noqa: E402

NAME = "flash_attention_dq_f32"
#: candidate atols of the exact-recipe limit at which the planted faults'
#: shares outside are read
CANDIDATES = (5e-6, 6e-6, 7e-6, 8e-6, 1e-5)


def tf32_sum_ulps():
    a = torch.zeros(64, 64, device="cuda")
    b = torch.zeros(64, 64, device="cuda")
    a[0, 0], a[0, 1], b[0, 0], b[1, 0] = 1.0, 1.75 * 2 ** -23, 1.0, 1.0
    return float(cs._tf32_run(lambda: a @ b)[0, 0] - 1.0) / 2 ** -23


def recipe(q, k, v, do, lse, delta, causal, mm):
    n = q.shape[0]
    keep = torch.ones(n, n, dtype=torch.bool, device=q.device)
    keep = keep.tril() if causal else keep
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.where(keep, torch.exp(mm(q, k.T, "S") * scale - lse[:, None]), 0.0)
    return mm(p * (mm(do, v.T, "dP") - delta[:, None]), k, "dSK") * scale


def split_only(name):
    return lambda a, b, which: fa._split_tf32_matmul(a, b) if which == name else a @ b


def needs(args, controls=False):
    """The atol each recipe and the kernel need above dQ's rtol against
    the plain version (``flash_attention_dq_reference``), and (``vs_f64``)
    the plain version's and the kernel's need against the f64 recipe; with
    ``controls``, the planted faults' shares outside :data:`CANDIDATES`
    around the f64 recipe."""
    rtol = cs.TOL[NAME][1]
    q, k, v, do, lse, delta, causal = args
    kernel, want = fa.flash_attention_dq(*args), fa.flash_attention_dq_reference(*args)
    no_delta = fa.flash_attention_dq_reference(q, k, v, do, lse, torch.zeros_like(delta), causal)
    need, vs_f64 = {}, {}
    outside = {c: {n: 0 for n in ("no_delta", "tf32_one_pass")} for c in CANDIDATES}
    for i in range(q.shape[0]):
        for j in range(q.shape[1]):
            sl = (q[i, j], k[i, j], v[i, j], do[i, j], lse[i, j], delta[i, j])
            plain = want[i, j].double()
            exact = recipe(*(t.double() for t in sl), causal, lambda a, b, _: a @ b)
            got = {"f64_recipe": exact,
                   **{f"{n}_split": recipe(*sl, causal, split_only(n)) for n in ("dP", "S", "dSK")},
                   "tf32_one_pass": cs._tf32_run(lambda: recipe(*sl, causal, lambda a, b, _: a @ b)),
                   "kernel": kernel[i, j]}
            for n, x in got.items():
                x = float(((x.double() - plain).abs() - rtol * plain.abs()).max())
                need[n] = max(need.get(n, x), x)
            for n, x in (("plain", plain), ("kernel", kernel[i, j])):
                x = float(((x.double() - exact).abs() - rtol * exact.abs()).max())
                vs_f64[n] = max(vs_f64.get(n, x), x)
            if controls:
                for n, x in (("no_delta", no_delta[i, j]), ("tf32_one_pass", got["tf32_one_pass"])):
                    over = (x.double() - exact).abs() - rtol * exact.abs()
                    for c in CANDIDATES:
                        outside[c][n] += int((over > c).sum())
            del got, exact
    need["vs_f64"] = vs_f64
    if controls:
        need["outside_share"] = {f"{c:g}": {n: x / want.numel() for n, x in o.items()}
                                 for c, o in outside.items()}
    return need


def main() -> int:
    if not torch.cuda.is_available():
        print("f32_dq_limit_probe: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    h = cs.LM_CLI["n_heads"]
    out = {"card": cs._card(), "atol": cs.TOL[NAME][0], "tf32_sum_ulps": tf32_sum_ulps()}
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 44)
    out["path"] = needs(cs._bwd_inputs(g, cs.LM_CLI_B, h, cs.LM_CLI_LONG_S, True,
                                       cs.LM_CLI["d_model"] // h, torch.float32), True)
    out["d64"] = needs(cs._bwd_inputs(g, 1, h, cs.LM_CLI_LONG_S, True, 64, torch.float32), True)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 45)
    out["d64_ragged"] = {
        f"S={s} {'causal' if causal else 'non-causal'}":
            needs(cs._bwd_inputs(g, 1, h, s, causal, 64, torch.float32))
        for s, causal in cs.RAGGED_F32_D64}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
