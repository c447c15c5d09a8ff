"""Port parity: the analytic roofline (``distriflow_tpu_torch/ops/roofline.py``).

- with JAX's efficiency table patched into the port's module, the port's
  ``roofline_report`` equals JAX's to 1e-12 on the same category dict (the
  remainder phase is JAX's ``xla`` under the port's name ``aten``);
- the defaults are the H100 SXM's published peaks, and no TPU number is in
  the module;
- ``bound_by`` follows the phase whose leg is longest, and flips where the
  legs cross; ``model_error`` is (projected - measured) / measured;
- the report runs on the port's real ``SyncTrainer.cost_analysis`` output
  for a tiny LM on the CPU;
- the f32 two-kernel backward files five of its seven products as
  split-precision TF32, bounded at a third of the TF32 peak, and the dQ
  kernel's S and dP at the f32 peak; the fused f32 backward files all
  five of its products as split-precision TF32;
- the f32 forward files both its products as split-precision TF32,
  bounded at a third of the TF32 peak.
"""

import importlib

import numpy as np
import pytest
import torch

from distriflow_tpu_torch.models.transformer import TransformerConfig, transformer_lm
from distriflow_tpu_torch.ops import roofline as port_rl
from distriflow_tpu_torch.train.sync import SyncTrainer

pytestmark = pytest.mark.port
torch.set_num_threads(2)
jax_rl = importlib.import_module("distriflow_tpu.ops.roofline")

CATS = {
    "attention_fwd": {"flops": 3.0e12, "hw_flops": 3.0e12, "bytes_accessed": 2.1e9},
    "attention_bwd": {"flops": 6.0e12, "hw_flops": 10.5e12, "bytes_accessed": 4.2e9},
    "fused_ce": {"flops": 4.2e9, "hw_flops": 4.2e9, "bytes_accessed": 1.05e9},
    "depthwise_gn": {"flops": 2.0e9, "hw_flops": 2.0e9, "bytes_accessed": 3.0e8},
}


@pytest.mark.parametrize("xla_flops,xla_bytes,measured", [
    (4.6e12, 0.0, None), (4.6e12, 7.0e9, 0.095), (0.0, 0.0, 0.01)])
def test_report_equals_jax_with_its_efficiencies(monkeypatch, xla_flops, xla_bytes, measured):
    table = {k: v for k, v in jax_rl.PHASE_EFFICIENCY.items()}
    table[port_rl.REMAINDER] = table.pop("xla")
    monkeypatch.setattr(port_rl, "PHASE_EFFICIENCY", table)
    peaks = dict(peak_flops=jax_rl.V5E_PEAK_BF16_FLOPS, hbm_bw=jax_rl.V5E_HBM_BYTES_PER_S)
    model_flops = 1.1e13
    got = port_rl.roofline_report(CATS, model_flops, xla_flops, xla_bytes,
                                  measured_step_s=measured, **peaks)
    want = jax_rl.roofline_report(CATS, model_flops, xla_flops, xla_bytes,
                                  measured_step_s=measured, **peaks)
    assert set(got) == set(want)
    names = {n: (port_rl.REMAINDER if n == "xla" else n) for n in want["phases"]}
    assert set(got["phases"]) == set(names.values())
    for jn, pn in names.items():
        for key in ("time_s", "compute_s", "memory_s"):
            assert abs(got["phases"][pn][key] - want["phases"][jn][key]) <= 1e-12
        assert got["phases"][pn]["bound"] == want["phases"][jn]["bound"]
    for key in ("step_time_s", "mfu_roofline", "peak_flops", "hbm_bw", "model_error"):
        if key in want:
            assert abs(got[key] - want[key]) <= 1e-12 * max(1.0, abs(want[key])), key
    assert got["bound_by"] == names.get(want["bound_by"], want["bound_by"])


def test_defaults_are_the_h100_peaks():
    assert port_rl.H100_PEAK_BF16_FLOPS == 989e12
    assert port_rl.H100_HBM_BYTES_PER_S == 3.35e12
    rep = port_rl.roofline_report(CATS, 1e12)
    assert rep["peak_flops"] == 989e12 and rep["hbm_bw"] == 3.35e12
    one = port_rl.phase_time_s(989e12, 0.0, "no_such_phase")
    assert one["compute_s"] == pytest.approx(1.0 / port_rl._DEFAULT_EFFICIENCY)
    # the TPU's numbers and the pre-round-18 counterfactuals are not carried
    assert not hasattr(port_rl, "V5E_PEAK_BF16_FLOPS")
    assert not any(k.endswith("_unfused") for k in port_rl.PHASE_EFFICIENCY)
    assert set(port_rl.PHASE_EFFICIENCY) == {"attention_fwd", "attention_bwd", "fused_ce",
                                             "depthwise_gn", port_rl.REMAINDER}
    assert all(0.0 < e <= 1.0 for e in port_rl.PHASE_EFFICIENCY.values())


def test_bound_flips_where_the_legs_cross():
    eff = port_rl.PHASE_EFFICIENCY["fused_ce"]
    peak, bw = port_rl.H100_PEAK_BF16_FLOPS, port_rl.H100_HBM_BYTES_PER_S
    nbytes = 1e9
    cross = nbytes / bw * peak * eff  # the FLOPs at which the legs are equal
    below = port_rl.phase_time_s(0.5 * cross, nbytes, "fused_ce")
    above = port_rl.phase_time_s(2.0 * cross, nbytes, "fused_ce")
    assert below["bound"] == "memory" and below["time_s"] == pytest.approx(nbytes / bw)
    assert above["bound"] == "compute" and above["time_s"] == pytest.approx(2 * nbytes / bw)
    # the binding phase of a step moves with the largest phase
    small = {"attention_fwd": {"hw_flops": 1e9, "bytes_accessed": 1e6}}
    assert port_rl.roofline_report(small, 1e9, xla_flops=1e12)["bound_by"] == port_rl.REMAINDER
    assert port_rl.roofline_report(small, 1e9, xla_flops=1e6)["bound_by"] == "attention_fwd"


def test_model_error_and_mfu():
    rep = port_rl.roofline_report(CATS, 5e12, xla_flops=2e12, measured_step_s=0.05)
    step = rep["step_time_s"]
    assert step == pytest.approx(sum(p["time_s"] for p in rep["phases"].values()))
    assert rep["model_error"] == pytest.approx((step - 0.05) / 0.05)
    assert rep["mfu_roofline"] == pytest.approx(5e12 / (step * 989e12))
    assert "model_error" not in port_rl.roofline_report(CATS, 5e12)
    assert port_rl.roofline_report({}, 0.0) == {
        "phases": {}, "step_time_s": 0.0, "mfu_roofline": 0.0, "bound_by": "",
        "peak_flops": 989e12, "hbm_bw": 3.35e12}


def test_report_on_a_real_cost_analysis():
    """A tiny LM's ``cost_analysis`` on the CPU: the tally's categories and
    the aten remainder become phases, and the projection is positive."""
    cfg = TransformerConfig(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                            max_seq=32, dtype=torch.float32, use_flash_attention=True)
    trainer = SyncTrainer(transformer_lm(cfg, device="cpu", example_seq=16),
                          optimizer="adam", learning_rate=1e-3)
    trainer.init(0)
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 64, (2, 17)).astype(np.int32)
    cost = trainer.cost_analysis((tokens[:, :-1], tokens[:, 1:]))
    assert "attention_fwd" in cost["kernel_by_category"]
    assert "attention_bwd" in cost["kernel_by_category"]
    rep = port_rl.roofline_report(cost["kernel_by_category"], cost["flops"],
                                  xla_flops=cost["aten_flops"], measured_step_s=1e-3)
    assert set(rep["phases"]) >= {"attention_fwd", "attention_bwd", port_rl.REMAINDER}
    assert rep["step_time_s"] > 0 and 0 < rep["mfu_roofline"] < 1
    assert rep["bound_by"] in rep["phases"]
    assert np.isfinite(rep["model_error"])


@pytest.mark.parametrize("layout", ["split", "fused"])
def test_f32_backward_bounded_at_the_rate_its_kernels_use(layout):
    from distriflow_tpu_torch.ops import flash_attention as fa
    from distriflow_tpu_torch.ops import flop_count

    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 96, 32).astype(np.float32)).requires_grad_()
               for _ in range(3))
    pin = 8 if layout == "split" else None  # 12 KV blocks of JAX's tile 8, or one
    assert fa.bwd_layout(96, 32, torch.float32, pin) == layout
    with flop_count.tally_kernel_cost() as tally:
        fa.flash_attention(q, k, v, causal=True, bwd_block_k=pin).sum().backward()
    bwd = tally["by_category"]["attention_bwd"]
    eff = port_rl.PHASE_EFFICIENCY["attention_bwd"]
    leg = port_rl.roofline_report({"attention_bwd": bwd}, 1.0)["phases"]["attention_bwd"]
    if layout == "fused":  # all five products split
        assert bwd[flop_count.TF32X3_FIELD] == bwd["hw_flops"] > 0
        assert bwd[flop_count.F32_FIELD] == 0
        assert leg["compute_s"] == pytest.approx(bwd["hw_flops"] / (495e12 / 3 * eff))
        return
    unit = bwd["hw_flops"] / 7
    assert bwd[flop_count.TF32X3_FIELD] == pytest.approx(5 * unit)
    assert bwd[flop_count.F32_FIELD] == pytest.approx(2 * unit)
    assert port_rl.H100_SPLIT_TF32_FLOPS == pytest.approx(495e12 / 3)
    assert leg["compute_s"] == pytest.approx((2 * unit / 67e12 + 5 * unit / (495e12 / 3)) / eff)
    assert leg["compute_s"] == pytest.approx(port_rl.phase_time_s(
        bwd["hw_flops"], 0.0, "attention_bwd", f32_hw_flops=2 * unit,
        tf32x3_hw_flops=5 * unit)["compute_s"])


@pytest.mark.parametrize("causal", [True, False])
def test_f32_forward_bounded_at_the_split_tf32_rate(causal):
    from distriflow_tpu_torch.ops import flash_attention as fa
    from distriflow_tpu_torch.ops import flop_count

    rng = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 96, 32).astype(np.float32)) for _ in range(3))
    with flop_count.tally_kernel_cost() as tally:
        fa.flash_attention(q, k, v, causal=causal)
    fwd = tally["by_category"]["attention_fwd"]
    assert fwd[flop_count.TF32X3_FIELD] == fwd["hw_flops"] > 0
    eff = port_rl.PHASE_EFFICIENCY["attention_fwd"]
    leg = port_rl.roofline_report({"attention_fwd": fwd}, 1.0)["phases"]["attention_fwd"]
    assert leg["compute_s"] == pytest.approx(fwd["hw_flops"] / (495e12 / 3 * eff))
    with flop_count.tally_kernel_cost() as bf16:
        fa.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), causal=causal)
    assert flop_count.TF32X3_FIELD not in bf16["by_category"]["attention_fwd"]
