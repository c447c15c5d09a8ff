"""Port of ``distriflow_tpu/ops/roofline.py``: the analytic roofline over
the kernel tally, with the H100's peaks and the port's own efficiencies.

It reads the two-column FLOP ledger of :mod:`~distriflow_tpu_torch.ops.flop_count`
(model FLOPs, the MFU numerator, and ``hw_flops``, what the kernels
execute, recompute included) and projects each phase of a step as
``max(compute, memory)``:

    t_phase = max(hw_flops / (peak * efficiency),  bytes / hbm_bw)

The phases are the tally's categories (``attention_fwd``,
``attention_bwd``, ``fused_ce``, ``depthwise_gn``) and :data:`REMAINDER`,
``aten``: everything outside the kernels, the matmuls and convolutions
``FlopCounterMode`` counts (``cost_analysis``'s ``aten_flops``). It is
the JAX module's ``xla`` phase, and :func:`roofline_report` takes it
through JAX's ``xla_flops``/``xla_bytes`` arguments. No counter of the
port counts the remainder's bytes (FlopCounterMode counts FLOPs only):
a caller who knows them passes ``xla_bytes``; left at 0, the remainder
is projected as compute-bound.

Differences from the JAX module, whose TPU numbers do not carry over:

- the default peaks are the H100 SXM's published dense bf16 rate and
  HBM bandwidth (:data:`H100_PEAK_BF16_FLOPS`, :data:`H100_HBM_BYTES_PER_S`);
  the share of a category's ``hw_flops`` that its kernels run in f32 on
  the CUDA cores (the tally's ``f32_hw_flops``: the f32 dQ kernel's S and
  dP) goes at the f32 peak instead (:data:`H100_PEAK_F32_FLOPS`), and the
  share they run as split-precision TF32 (``tf32x3_hw_flops``: the f32
  forward, the f32 fused backward and the rest of the f32 two-kernel
  backward, three TF32 products for each f32 one) at a third of
  the TF32 peak (:data:`H100_SPLIT_TF32_FLOPS`), at the phase's efficiency;
- each :data:`PHASE_EFFICIENCY` is the port's own fraction of peak, bound
  over time from ``chip_smoke.py``'s kernel table on an H100 (the rows,
  shapes and times beside each). As in JAX the fraction scales the compute leg only,
  so a category its kernels leave bytes-bound projects at its byte bound;
- JAX's ``*_unfused`` counterfactual entries serve ``bench.py``'s
  ``BENCH_ROOFLINE=pre18`` mode, which the port does not have; they are
  left out.

The model's value is differential, as in JAX: with the efficiencies held,
swapping one kernel's (hw_flops, bytes) for another's shows how much of a
step's time a rework can take and which phase then binds. Where a
measured step time is given, ``model_error`` says how far the projection
is from it. A projection is model output, never a measurement.
"""

from __future__ import annotations

from typing import Dict, Optional

from distriflow_tpu_torch.ops.flop_count import F32_FIELD, TF32X3_FIELD

#: H100 SXM, NVIDIA's data sheet: dense bf16 tensor-core rate and HBM3
#: bandwidth (the figures ``train/sync.py`` keeps for MFU)
H100_PEAK_BF16_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12
#: H100 SXM, NVIDIA's data sheet: f32 outside the tensor cores
H100_PEAK_F32_FLOPS = 67e12
#: H100 SXM, NVIDIA's data sheet: dense TF32 on the tensor cores
H100_PEAK_TF32_FLOPS = 495e12
#: f32 products taken as three TF32 products each (split precision)
H100_SPLIT_TF32_FLOPS = H100_PEAK_TF32_FLOPS / 3

#: the phase of everything outside the kernel tally (JAX's ``xla``)
REMAINDER = "aten"

#: fraction of peak a phase sustains: each is bound over time of the
#: kernel-table rows it names, as ``chip_smoke.py`` measures them on an
#: H100 80GB HBM3 at 700 W (its ``roofline:`` line prints a run's values
#: under ``calibration``; ``PERF.md`` names the run these came from)
PHASE_EFFICIENCY: Dict[str, float] = {
    # row 1 at B1 H8 S16000 D64 causal: 0.2651 ms bound (operations) over
    # 0.6508 ms
    "attention_fwd": 0.407,
    # rows 6 (B8 H8 S1024), 7 and 8 (B1 H8 S16384), all D64 causal: bounds
    # 0.0217 + 0.4169 + 0.5559 ms (operations) over 0.1602 + 1.2408 +
    # 1.4349 ms, the sum of the bounds over the sum of the times
    "attention_bwd": 0.351,
    # rows 9 and 10 at N 8192, V 32000: 0.1565 + 0.3130 ms bound (bytes)
    # over 0.1877 + 0.3649 ms
    "fused_ce": 0.850,
    # rows 11 and 12 over a MobileNet step's 17 blocks (B 256, 96 px):
    # their step bounds (bytes) over their step times
    "depthwise_gn": 0.122,
    # one cuBLAS bf16 matmul at the 16k LM step's projection shape,
    # [16384, 512] x [512, 512]: 0.01017 ms bound (operations) over
    # 0.02168 ms
    REMAINDER: 0.469,
}
_DEFAULT_EFFICIENCY = 0.40


def phase_time_s(
    hw_flops: float,
    bytes_accessed: float,
    phase: str,
    peak_flops: float = H100_PEAK_BF16_FLOPS,
    hbm_bw: float = H100_HBM_BYTES_PER_S,
    f32_hw_flops: float = 0.0,
    tf32x3_hw_flops: float = 0.0,
) -> Dict[str, float]:
    """One phase's roofline: the compute and memory legs and which binds.
    ``f32_hw_flops`` of the ``hw_flops`` run at :data:`H100_PEAK_F32_FLOPS`,
    ``tf32x3_hw_flops`` at :data:`H100_SPLIT_TF32_FLOPS`."""
    eff = PHASE_EFFICIENCY.get(phase, _DEFAULT_EFFICIENCY)
    rest = hw_flops - f32_hw_flops - tf32x3_hw_flops
    t_compute = (rest / (peak_flops * eff) + f32_hw_flops / (H100_PEAK_F32_FLOPS * eff)
                 + tf32x3_hw_flops / (H100_SPLIT_TF32_FLOPS * eff)) if hw_flops else 0.0
    t_memory = bytes_accessed / hbm_bw if bytes_accessed else 0.0
    return {
        "time_s": max(t_compute, t_memory),
        "compute_s": t_compute,
        "memory_s": t_memory,
        "bound": "compute" if t_compute >= t_memory else "memory",
    }


def roofline_report(
    by_category: Dict[str, Dict[str, float]],
    model_flops: float,
    xla_flops: float = 0.0,
    xla_bytes: float = 0.0,
    peak_flops: float = H100_PEAK_BF16_FLOPS,
    hbm_bw: float = H100_HBM_BYTES_PER_S,
    measured_step_s: Optional[float] = None,
) -> Dict[str, object]:
    """Project a step's phase times, MFU and binding phase.

    ``by_category`` is the tally's breakdown (``cost_analysis``'s
    ``kernel_by_category``: each entry carries ``hw_flops`` and
    ``bytes_accessed``); ``xla_flops``/``xla_bytes`` are the remainder
    outside the kernels (``aten_flops``; bytes where the caller knows
    them), projected as the :data:`REMAINDER` phase. ``model_flops`` is
    the MFU numerator of the whole step. Returns ``phases``,
    ``step_time_s``, ``mfu_roofline``, ``bound_by`` (the phase with the
    largest projected time), ``peak_flops``, ``hbm_bw`` and, given
    ``measured_step_s``, ``model_error`` = (projected - measured) /
    measured."""
    phases: Dict[str, Dict[str, float]] = {}
    for name, cat in by_category.items():
        phases[name] = phase_time_s(
            float(cat.get("hw_flops", cat.get("flops", 0.0))),
            float(cat.get("bytes_accessed", 0.0)),
            name, peak_flops, hbm_bw, float(cat.get(F32_FIELD, 0.0)),
            float(cat.get(TF32X3_FIELD, 0.0)),
        )
    if xla_flops or xla_bytes:
        phases[REMAINDER] = phase_time_s(
            float(xla_flops), float(xla_bytes), REMAINDER, peak_flops, hbm_bw)
    step_s = sum(p["time_s"] for p in phases.values())
    bound_by = max(phases, key=lambda n: phases[n]["time_s"]) if phases else ""
    report: Dict[str, object] = {
        "phases": phases,
        "step_time_s": step_s,
        "mfu_roofline": float(model_flops) / (step_s * peak_flops) if step_s else 0.0,
        "bound_by": bound_by,
        "peak_flops": peak_flops,
        "hbm_bw": hbm_bw,
    }
    if measured_step_s:
        report["model_error"] = (step_s - measured_step_s) / measured_step_s
    return report
