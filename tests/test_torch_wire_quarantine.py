"""The port's ``GradientGate`` against the JAX package's: the same
verdicts, norms and EMA thresholds on the same gradient sequence."""

import json
import os

import numpy as np
import pytest
import torch

from distriflow_tpu.obs.telemetry import Telemetry as JaxTelemetry
from distriflow_tpu.server import quarantine as jax_q
from distriflow_tpu.utils.config import QuarantinePolicy as JaxPolicy

from distriflow_tpu_torch.obs.telemetry import Telemetry as PortTelemetry
from distriflow_tpu_torch.server import quarantine as port_q
from distriflow_tpu_torch.utils.config import QuarantinePolicy as PortPolicy
from distriflow_tpu_torch.utils import serialization as port_ser

pytestmark = pytest.mark.port


def _grads(i: int, scale: float = 1.0):
    rng = np.random.RandomState(i)
    return {"params": {"w": (rng.randn(7, 3) * scale).astype(np.float32),
                       "b": (rng.randn(3) * scale).astype(np.float32)},
            "count": np.int32(i)}


def test_gate_verdicts_match_jax(tmp_path):
    policy = dict(max_norm_multiplier=3.0, ema_decay=0.8, warmup_updates=3)
    ref = jax_q.GradientGate(JaxPolicy(**policy), str(tmp_path / "j"), JaxTelemetry())
    port = port_q.GradientGate(PortPolicy(**policy), str(tmp_path / "p"), PortTelemetry())
    seq = [_grads(i) for i in range(4)] + [_grads(9, 20.0), _grads(5)]
    bad = _grads(6)
    bad["params"]["w"][2, 1] = np.nan
    seq += [bad, _grads(7, 2.5), _grads(8, 50.0)]
    for i, g in enumerate(seq):
        a, b = ref.check(g), port.check(g)
        assert (a.ok, a.reason, a.norm) == (b.ok, b.reason, b.norm), i
        # a tensor tree (a gradient still on the model's device) gives the same verdict
        t = port.check(port_ser.tree_map_with_path(
            lambda _, v: torch.from_numpy(np.array(v)), g))
        assert (t.ok, t.reason, t.norm) == (b.ok, b.reason, b.norm), i
        if a.ok:
            ref.accept(a.norm)
            port.accept(b.norm)
    assert ref.params_finite(seq[0]) == port.params_finite(seq[0]) is True
    assert ref.params_finite(bad) == port.params_finite(bad) is False
    # the postmortem dump carries the same payload bytes and reason
    dirs = [gate.quarantine(bad, "non-finite", client_id="c", batch=1)
            for gate in (ref, port)]
    blobs = [open(os.path.join(d, "data.bin"), "rb").read() for d in dirs]
    assert blobs[0] == blobs[1]
    metas = [json.load(open(os.path.join(d, "meta.json"))) for d in dirs]
    assert metas[0] == metas[1]
    assert ref.quarantined_updates == port.quarantined_updates == 1
