"""Port of ``distriflow_tpu/server/quarantine.py``: the gradient
quarantine gate, over the port's trees (numpy arrays or tensors).

No reference counterpart — the reference applies whatever arrives
(``asynchronousSGD_server.ts:95-108``), so one NaN upload poisons the
canonical model and every subsequent broadcast. The gate implements the
standard parameter-server defenses (Li et al., "Scaling Distributed
Machine Learning with the Parameter Server", OSDI 2014):

- **finiteness**: any NaN/inf entry rejects the whole gradient;
- **magnitude**: global norm beyond ``max_norm_multiplier`` x an EMA of
  accepted norms rejects (a diverged worker's exploding gradients are
  caught even when every entry is technically finite);
- **postmortem**: rejected payloads are dumped to
  ``save_dir/quarantine/<version>-<reason>/`` in the same packed flat
  format as checkpoints, with a ``meta.json`` naming the client, update
  id, and reason — so "why did training stall for worker 7" is a file
  read, not a log dig;
- **rollback guard**: if an update that passed the gate still drove the
  PARAMS non-finite (optimizer-state blowup, fp overflow in the update
  rule), the previous params are restored and the bad update is
  quarantined after the fact.

Both wire-serving training servers route through one :class:`GradientGate`
(see ``docs/ROBUSTNESS.md`` §8 for the failure-model contract).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from distriflow_tpu_torch.obs.telemetry import Telemetry
from distriflow_tpu_torch.utils.config import QuarantinePolicy
from distriflow_tpu_torch.utils.serialization import _f32, to_numpy, tree_leaves

QUARANTINE_DIR = "quarantine"


@dataclasses.dataclass
class GateVerdict:
    """Outcome of one gradient check."""

    ok: bool
    reason: str = ""
    norm: float = 0.0


def _global_norm_sq(tree: Any) -> Optional[float]:
    """Sum of squares over all leaves in float64, or None if any entry is
    non-finite. One pass answers both gate questions."""
    total = 0.0
    for leaf in tree_leaves(tree):
        a = to_numpy(leaf)
        if isinstance(a, torch.Tensor) or not np.issubdtype(a.dtype, np.floating):
            a = _f32(a)  # bfloat16 and integers: f32, as JAX's astype
        if not np.all(np.isfinite(a)):
            return None
        a64 = a.astype(np.float64, copy=False)
        total += float(np.sum(a64 * a64))
    return total


class GradientGate:
    """Shared quarantine machinery: check, EMA, dump, rollback accounting.

    Thread-safety: the EMA is lock-protected; servers may call
    :meth:`check`/:meth:`accept` from concurrent upload handlers.
    """

    def __init__(
        self,
        policy: QuarantinePolicy,
        save_dir: str,
        telemetry: Telemetry,
        log=None,
    ):
        self.policy = policy.validate()
        self.save_dir = save_dir
        self.quarantine_dir = os.path.join(save_dir, QUARANTINE_DIR)
        self._log = log or (lambda *a: None)
        self._c_quarantined = telemetry.counter(
            "server_quarantined_total",
            help="updates diverted to quarantine instead of applying")
        self._c_rollbacks = telemetry.counter(
            "server_rollbacks_total",
            help="model rollbacks to the last known-good checkpoint")
        # quarantined_updates / rollbacks are serialized by the OWNING
        # server's handler lock (every gate call sits inside the server's
        # ``with self._lock``), so they carry no guard of their own
        self.quarantined_updates = 0
        self.rollbacks = 0
        self._ema: Optional[float] = None  # guarded-by: _lock
        self._accepted = 0  # guarded-by: _lock
        self._lock = threading.Lock()

    @property
    def active(self) -> bool:
        return self.policy.enabled

    # -- pre-apply gate ----------------------------------------------------

    def check(self, grads: Any) -> GateVerdict:
        """Finiteness + norm-outlier gate over a deserialized gradient tree."""
        if not self.active:
            return GateVerdict(ok=True)
        norm_sq = _global_norm_sq(grads)
        if norm_sq is None:
            return GateVerdict(ok=False, reason="non-finite")
        norm = float(np.sqrt(norm_sq))
        with self._lock:
            warm = self._accepted >= self.policy.warmup_updates
            threshold = (
                self.policy.max_norm_multiplier * self._ema
                if (warm and self._ema is not None)
                else None
            )
        if threshold is not None and norm > threshold:
            return GateVerdict(
                ok=False,
                reason=f"norm-outlier ({norm:.3g} > {threshold:.3g})",
                norm=norm,
            )
        return GateVerdict(ok=True, norm=norm)

    def accept(self, norm: float) -> None:
        """Fold an ACCEPTED gradient's norm into the EMA threshold.

        Only accepted norms feed the EMA — a burst of outliers must not
        drag the threshold up toward themselves.
        """
        if not self.active:
            return
        with self._lock:
            d = self.policy.ema_decay
            self._ema = norm if self._ema is None else d * self._ema + (1.0 - d) * norm
            self._accepted += 1

    # -- post-apply rollback guard -----------------------------------------

    def params_finite(self, params: Any) -> bool:
        if not self.active:
            return True
        return _global_norm_sq(params) is not None

    def record_rollback(self) -> None:
        self.rollbacks += 1
        self._c_rollbacks.inc()

    # -- postmortem dump ---------------------------------------------------

    def quarantine(
        self,
        vars_: Optional[Dict[str, Any]],
        reason: str,
        **meta: Any,
    ) -> Optional[str]:
        """Count a rejection and dump the payload for postmortem.

        ``vars_`` is the upload's ``{path: SerializedArray}`` dict (or a
        plain pytree, which is serialized first); returns the dump dir, or
        None when dumping is disabled/failed (the dump is best-effort —
        postmortem files must never take the training plane down).
        """
        self.quarantined_updates += 1
        self._c_quarantined.inc()
        if not self.policy.dump or vars_ is None:
            return None
        try:
            from distriflow_tpu_torch.checkpoint.store import timestamp_version
            from distriflow_tpu_torch.utils.serialization import (
                SerializedArray,
                flat_serialize,
                host_tree,
                serialize_tree,
            )

            if not (
                isinstance(vars_, dict)
                and all(isinstance(v, SerializedArray) for v in vars_.values())
            ):
                vars_ = serialize_tree(host_tree(vars_))
            # slug the reason for the dir name; full text goes in meta.json
            slug = "".join(c if c.isalnum() else "-" for c in reason).strip("-")[:40]
            d = os.path.join(self.quarantine_dir, f"{timestamp_version()}-{slug}")
            os.makedirs(d, exist_ok=True)
            blob, flat_meta = flat_serialize(vars_)
            with open(os.path.join(d, "data.bin"), "wb") as f:
                f.write(blob)
            flat_meta["quarantine"] = {"reason": reason, **meta}
            with open(os.path.join(d, "meta.json"), "w") as f:
                json.dump(flat_meta, f)
            self._log(f"quarantined payload dumped to {d}")
            return d
        except Exception as e:  # noqa: BLE001 - dump is advisory only
            self._log(f"quarantine dump failed: {e!r}")
            return None
