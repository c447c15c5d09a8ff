"""Readings behind the f32 attention forward's design
(``distriflow_tpu_torch/csrc/flash_attention_f32.cu``, ``split3::fwd_kernel``)
on one CUDA card. Prints one JSON object.

For O and for lse it gives the atol above the forward's rtol
(``chip_smoke.TOL["flash_attention_fwd_f32"]``) that each recipe needs
against the f32 plain forward (``flash_attention_reference``, TF32 off),
one (b, h) slice at a time:

- ``f64_recipe``: the same recipe in f64 (exact to f32's eye);
- ``s_split``: S = Q K^T in split-precision TF32 (three TF32 products per
  f32 product), P V in f32;
- ``pv_split``: P V split, S in f32;
- ``both_split``: both products split (the design the kernel takes when
  this holds);
- ``tf32_one_pass``: one TF32 pass of both products (``passes=1``);
- ``kernel``: the forward kernel this checkout builds.

Each recipe is the kernel's plain mirror,
``flash_attention_forward_split_tf32_reference``, with its products split
or not (:data:`PASSES`). The shapes: the JAX LM CLI's path (d)
(``--dtype float32 --seq 16384 --remat``: B8 H8 S16384 D32 causal, all
64 slices, drawn as ``chip_smoke._f32_fwd_long_row`` draws its inputs),
path (c)'s B8 H8 S512 causal at D 32 and D 64, and
``chip_smoke.RAGGED_BWD``'s lengths at B1 H8, D 32 and D 64. ``choice`` names the first design of the list above
(both split, P V split) that holds the limit at every shape, or none.

Run from the repository's root: ``python3 tools/f32_fwd_limit_probe.py``.
"""

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from distriflow_tpu_torch.ops import flash_attention as fa  # noqa: E402

NAME = "flash_attention_fwd_f32"
RECIPES = ("f64_recipe", "s_split", "pv_split", "both_split", "tf32_one_pass", "kernel")
#: the mirror's passes (S's, P V's) of each recipe: 0 unsplit, 3 split, 1 one TF32 pass
PASSES = {"s_split": (3, 0), "pv_split": (0, 3), "both_split": 3, "tf32_one_pass": 1}


def needs(q, k, v, causal):
    """The atol each recipe needs above the rtol, for O and lse, the most
    over the (b, h) slices of [B, H, S, D] q, k, v."""
    rtol = cs.TOL[NAME][1]
    o_k, lse_k = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    need = {}
    for i in range(q.shape[0]):
        for j in range(q.shape[1]):
            sl = tuple(t[i:i + 1, j:j + 1] for t in (q, k, v))
            want = [w.double() for w in fa.flash_attention_reference(*sl, causal)]
            got = {n: fa.flash_attention_forward_split_tf32_reference(*sl, causal, passes=p)
                   for n, p in PASSES.items()}
            got["f64_recipe"] = fa.flash_attention_forward_split_tf32_reference(
                *(t.double() for t in sl), causal, passes=0)
            got["kernel"] = (o_k[i:i + 1, j:j + 1], lse_k[i:i + 1, j:j + 1])
            for n, outs in got.items():
                for part, x, w in zip(("o", "lse"), outs, want):
                    x = float(((x.double() - w).abs() - rtol * w.abs()).max())
                    cur = need.setdefault(n, {})
                    cur[part] = max(cur.get(part, x), x)
            del got, want
    return need


def main() -> int:
    if not torch.cuda.is_available():
        print("f32_fwd_limit_probe: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    atol = cs.TOL[NAME][0]
    h, d = cs.LM_CLI["n_heads"], cs.LM_CLI["d_model"] // cs.LM_CLI["n_heads"]
    out = {"card": cs._card(), "atol": atol, "rtol": cs.TOL[NAME][1]}
    shapes = {}
    g = torch.Generator(device="cuda").manual_seed(cs.F32_FWD_LONG_SEED)
    shapes["path"] = (cs._f32_fwd_long_inputs(g), True)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 47)
    for dd in (d, 64):
        qkv = tuple(torch.randn(cs.LM_CLI_B, h, cs.LM_CLI["max_seq"], dd, generator=g,
                                device="cuda") for _ in range(3))
        shapes[f"S512_D{dd}"] = (qkv, True)
    for dd in (d, 64):
        for s, causal in cs.RAGGED_BWD:
            qkv = tuple(torch.randn(1, h, s, dd, generator=g, device="cuda") for _ in range(3))
            shapes[f"D{dd} S={s} {'causal' if causal else 'non-causal'}"] = (qkv, causal)
    for label, (qkv, causal) in shapes.items():
        out[label] = needs(*qkv, causal)
    holds = {n: all(out[label][n][part] <= atol for label in shapes for part in ("o", "lse"))
             for n in RECIPES}
    out["holds"] = holds
    out["choice"] = next((n for n in ("both_split", "pv_split") if holds[n]), None)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
