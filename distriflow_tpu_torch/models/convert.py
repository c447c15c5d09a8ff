"""Weight carry-over from the JAX package (no JAX counterpart).

:func:`params_from_jax` maps a flax ``TransformerLM`` params tree, given as
nested dicts of numpy arrays (``{"params": {...}}`` or the inner dict), to
a ``state_dict`` of :class:`~distriflow_tpu_torch.models.transformer.TransformerLM`.
Matmul weights and the embedding are cast to ``config.dtype`` once here —
the same values flax produces by casting the f32 master params on every
call; LayerNorm parameters stay f32, as flax keeps them.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from distriflow_tpu_torch.models.transformer import TransformerConfig, TransformerLM


def _arr(x: Any, dtype: torch.dtype, shape) -> torch.Tensor:
    a = np.array(x, dtype=np.float32)  # a copy; bf16 leaves widen exactly
    return torch.from_numpy(a).reshape(shape).to(dtype)


def params_from_jax(tree: Mapping[str, Any], config: TransformerConfig) -> Dict[str, torch.Tensor]:
    """Flax params -> the port's ``state_dict`` (CPU tensors)."""
    p = tree["params"] if "params" in tree else tree
    cfg = config
    hd = cfg.n_heads * cfg.head_dim
    out: Dict[str, torch.Tensor] = {
        "embed": _arr(p["embed"]["embedding"], cfg.dtype, (cfg.vocab_size, cfg.d_model)),
        "lm_head": _arr(p["lm_head"]["kernel"], cfg.dtype, (cfg.d_model, cfg.vocab_size)),
        "ln_f.scale": _arr(p["ln_f"]["scale"], torch.float32, (cfg.d_model,)),
        "ln_f.bias": _arr(p["ln_f"]["bias"], torch.float32, (cfg.d_model,)),
    }
    for i in range(cfg.n_layers):
        lp = p[f"layers_{i}"]
        pre = f"layers.{i}."
        for ln in ("ln_attn", "ln_mlp"):
            out[pre + ln + ".scale"] = _arr(lp[ln]["scale"], torch.float32, (cfg.d_model,))
            out[pre + ln + ".bias"] = _arr(lp[ln]["bias"], torch.float32, (cfg.d_model,))
        attn = lp["attn"]
        for name in ("q_proj", "k_proj", "v_proj"):
            out[pre + "attn." + name] = _arr(attn[name]["kernel"], cfg.dtype, (cfg.d_model, hd))
        out[pre + "attn.o_proj"] = _arr(attn["o_proj"]["kernel"], cfg.dtype, (hd, cfg.d_model))
        out[pre + "mlp.wi"] = _arr(lp["mlp"]["wi"]["kernel"], cfg.dtype, (cfg.d_model, cfg.d_ff))
        out[pre + "mlp.wo"] = _arr(lp["mlp"]["wo"]["kernel"], cfg.dtype, (cfg.d_ff, cfg.d_model))
    return out


def lm_from_jax(config: TransformerConfig, tree: Mapping[str, Any],
                device: Optional[Union[str, torch.device]] = None) -> TransformerLM:
    """A :class:`TransformerLM` on ``device`` (``cuda`` by default) that
    computes the same function as the flax module with params ``tree``."""
    model = TransformerLM(config, device=device)
    model.load_state_dict(params_from_jax(tree, config), strict=True)
    return model
