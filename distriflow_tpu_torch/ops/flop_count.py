"""Port of ``distriflow_tpu/ops/flop_count.py``: the tally of the kernels'
analytic cost.

``torch.utils.flop_counter.FlopCounterMode`` counts the matmuls and
convolutions of the aten ops it sees, and a hand-written kernel launched
through ``ctypes`` is opaque to it (as a Pallas custom call is to XLA's
``cost_analysis``). So each kernel wrapper records its analytic cost with
:func:`record_kernel_cost`, and the trainers' ``cost_analysis`` adds the
tally to FlopCounterMode's count on CUDA. The wrappers record whichever
path runs, the kernel on CUDA or its plain version on the CPU, with JAX's
formulas at JAX's record sites, so the tally is held against JAX's on the
CPU; on the CPU ``cost_analysis`` does not add it, because the plain
versions' aten ops are counted already (JAX's interpret-mode rule).

Three differences from JAX's module:

- The tally is one per process, not a context variable: PyTorch runs a
  CUDA backward on autograd threads of its own, which a context variable
  does not reach. A tally collects every record made while it is open, on
  any thread, so open one only while no other thread runs the wrappers.
- A forward run again by ``torch.utils.checkpoint`` (remat) records inside
  :func:`recompute`: its FLOPs are hardware work, not model work, so they
  go to ``hw_flops`` (and its bytes and transcendentals, which the card
  does move and compute, to theirs), never to ``flops``. JAX's trace of a
  ``nn.remat`` model records the recomputed forward as model FLOPs too.
- A kernel that computes in f32 (the f32 attention kernels) also files
  its ``hw_flops`` under its category's ``f32_hw_flops``, so that
  :mod:`~distriflow_tpu_torch.ops.roofline` bounds that work by the f32
  peak and not the bf16 tensor-core peak; the part of them that it runs
  on the tensor cores in split-precision TF32 (three TF32 products for
  each f32 one: the f32 two-kernel backward) goes under
  ``tf32x3_hw_flops`` instead, bounded by a third of the TF32 peak. The
  four fields and the categories stay JAX's.

The JAX names stay as aliases: :func:`record_pallas_cost`,
:func:`tally_pallas_cost`.

The JAX module's description follows.

Convention: recorded FLOPs are **model FLOPs** (the algorithmic forward +
backward work), not hardware FLOPs — the flash backward's score recompute is
rematerialization overhead and is excluded, per the standard MFU definition
(PaLM appendix B): MFU compares achieved *useful* FLOP/s against peak, so a
kernel that recomputes does not get credit for the recompute.
``hw_flops`` is the FLOPs the kernel actually executes — model FLOPs PLUS
recompute. ``category`` files a cost under ``tally["by_category"]`` as well.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, Optional

_FIELDS = ("flops", "bytes_accessed", "transcendentals", "hw_flops")
#: a category's hardware FLOPs that ran in f32 on the CUDA cores
F32_FIELD = "f32_hw_flops"
#: a category's f32 hardware FLOPs that ran as split-precision TF32 (each
#: f32 product three TF32 products on the tensor cores)
TF32X3_FIELD = "tf32x3_hw_flops"

_lock = threading.Lock()
_active: Optional[Dict[str, float]] = None  # guarded-by: _lock
_local = threading.local()


def record_kernel_cost(
    flops: float = 0.0,
    bytes_accessed: float = 0.0,
    transcendentals: float = 0.0,
    category: Optional[str] = None,
    hw_flops: Optional[float] = None,
    f32: bool = False,
    tf32x3: float = 0.0,
) -> None:
    """Add one kernel call's analytic cost to the open tally (a no-op when
    none is open). ``hw_flops`` defaults to ``flops``; inside
    :func:`recompute` the call's model FLOPs count as hardware FLOPs only.
    ``f32``: the kernel computes in f32, so its ``hw_flops`` also go to its
    category's ``f32_hw_flops``, but for ``tf32x3`` of them, which it runs
    as split-precision TF32 on the tensor cores and which go to its
    ``tf32x3_hw_flops``."""
    if _active is None:  # the common case: no lock, no dict
        return
    hw = float(flops if hw_flops is None else hw_flops)
    cost = {"flops": 0.0 if getattr(_local, "recompute", False) else float(flops),
            "bytes_accessed": float(bytes_accessed),
            "transcendentals": float(transcendentals), "hw_flops": hw}
    with _lock:
        tally = _active
        if tally is None:
            return
        cat = None if category is None else tally["by_category"].setdefault(
            category, {f: 0.0 for f in _FIELDS})
        for f, v in cost.items():
            tally[f] += v
            if cat is not None:
                cat[f] += v
        if f32 and cat is not None:
            cat[F32_FIELD] = cat.get(F32_FIELD, 0.0) + hw - float(tf32x3)
            if tf32x3:
                cat[TF32X3_FIELD] = cat.get(TF32X3_FIELD, 0.0) + float(tf32x3)


@contextlib.contextmanager
def tally_kernel_cost() -> Iterator[Dict[str, float]]:
    """Collect the kernel costs recorded inside the block (an inner tally
    takes the records while it is open, as in JAX)."""
    global _active
    tally: Dict[str, float] = {f: 0.0 for f in _FIELDS}
    tally["by_category"] = {}  # type: ignore[assignment]
    with _lock:
        outer, _active = _active, tally
    try:
        yield tally
    finally:
        with _lock:
            _active = outer


@contextlib.contextmanager
def recompute() -> Iterator[None]:
    """Mark the wrappers called inside the block, on this thread, as a
    remat recompute (``torch.utils.checkpoint``'s ``context_fn``)."""
    was = getattr(_local, "recompute", False)
    _local.recompute = True
    try:
        yield
    finally:
        _local.recompute = was


def remat_contexts():
    """``context_fn`` for ``torch.utils.checkpoint.checkpoint``: nothing
    around the first forward, :func:`recompute` around the second."""
    return contextlib.nullcontext(), recompute()


def scale_tally(tally: Dict[str, float], factor: float) -> None:
    """Multiply every field of ``tally`` and of its categories by
    ``factor`` in place (a pass traced once and run ``factor`` times)."""
    for f in _FIELDS:
        tally[f] *= factor
    for cat in tally["by_category"].values():
        for f in cat:
            cat[f] *= factor


def step_cost(run, device, multiplicity: int = 1) -> Dict[str, object]:
    """The cost of one forward and backward: ``run()`` called once under
    ``FlopCounterMode`` (aten matmuls and convolutions) with a kernel tally
    open, both multiplied by ``multiplicity`` (a pass run that many times a
    step). ``flops`` adds the tally's model FLOPs on CUDA only, where the
    kernels are opaque to FlopCounterMode; on the CPU the wrappers ran
    their plain versions, whose aten ops are counted already. XLA's count
    in JAX also holds elementwise work; FlopCounterMode counts matmuls and
    convolutions only."""
    from torch.utils.flop_counter import FlopCounterMode

    with tally_kernel_cost() as tally, FlopCounterMode(display=False) as counter:
        run()
    scale_tally(tally, multiplicity)
    aten = float(counter.get_total_flops()) * multiplicity
    by_cat = {k: dict(v) for k, v in tally["by_category"].items()}
    on_card = device.type == "cuda"
    return {"flops": aten + tally["flops"] if on_card else aten, "aten_flops": aten,
            "kernel_flops": tally["flops"], "kernel_hw_flops": tally["hw_flops"],
            "kernel_bytes_accessed": tally["bytes_accessed"],
            "kernel_transcendentals": tally["transcendentals"], "kernel_by_category": by_cat,
            "kernel_tally_added": on_card,
            # the JAX package's keys
            "pallas_flops": tally["flops"], "pallas_hw_flops": tally["hw_flops"],
            "pallas_by_category": by_cat}


#: the JAX package's names
record_pallas_cost = record_kernel_cost
tally_pallas_cost = tally_kernel_cost
