"""The verdicts of two checks that one unlucky host timing used to fail,
each held both ways: what they must pass passes, and a planted fault
still fails.

- ``chip_smoke._epoch1_held``, the async wire leg's loss check: the lowest
  validation loss of the server's versions 9-16 (the first epoch's second
  half) must lie below the initial weights' by more than their spread.
  A run whose last version climbs but which fell within the window
  passes; at the leg's full size on the CPU (two worker threads, B 256,
  one epoch of 4096 synthetic images), a server whose model applies
  nothing keeps the initial weights at every version and fails.
- ``doctor._pipelined_fit_bound``, the critical-path drill's verdict on
  its pipelined run: fit above submit on the critical path in every
  round but at most one. The phases (ms) are those of the drill's
  pipelined run on the CPU, clean, with one round's submit stalled by
  150 ms (which flips the mean of the four rounds, the verdict this one
  replaced), and with the upload tail planted on the critical path (a
  0.1 s delay on every upload).
"""

import tempfile
from unittest import mock

import numpy as np
import pytest
import torch

import chip_smoke
from distriflow_tpu_torch import doctor
from distriflow_tpu_torch.server import DistributedServerInMemoryModel

pytestmark = pytest.mark.port
torch.set_num_threads(2)

INIT, SPREAD = 2.3362, 0.0411  # the leg's initial validation loss and spread


def test_epoch1_check_holds_the_window_not_its_last_version():
    # the last version climbs past the initial loss, as one H100 run's did
    climbed = {9: 2.1167, 10: 1.9698, 14: 1.7238, 16: 2.9086}
    assert chip_smoke._epoch1_held(INIT, SPREAD, climbed) == 1.7238
    with pytest.raises(AssertionError, match="did not lower the validation loss"):
        chip_smoke._epoch1_held(INIT, SPREAD, {v: INIT - SPREAD / 2 for v in range(9, 17)})


def test_epoch1_check_fails_when_the_server_applies_nothing():
    tree = chip_smoke._convnet_tree(np.random.default_rng(chip_smoke.SEED + 9))
    train, val = chip_smoke._synthetic_cifar10(chip_smoke.WIRE_TRAIN, chip_smoke.CN_VAL,
                                               chip_smoke.SEED + 11)
    (x, y), (vx, vy) = chip_smoke._to_xy(train), chip_smoke._to_xy(val)
    window = range(9, 17)
    with mock.patch.object(DistributedServerInMemoryModel, "update",
                           lambda self, *a, **k: None), \
            tempfile.TemporaryDirectory() as save_dir:
        report, _, _, _, snaps = chip_smoke._async_leg(
            tree, x, y, "cpu", chip_smoke.WIRE_WORKERS, 1, True, save_dir, snapshot_at=window)
    assert report["applied"] == 16 and sorted(snaps) == list(window)
    probe = chip_smoke._wire_model(tree, "cpu")
    init_val, spread = chip_smoke._val_spread(probe, vx, vy)
    vals = {}
    for version, params in snaps.items():
        probe.set_params(params)
        vals[version] = probe.evaluate(vx, vy)[0]
    assert all(v == init_val for v in vals.values()), (init_val, vals)
    with pytest.raises(AssertionError, match="did not lower the validation loss"):
        chip_smoke._epoch1_held(init_val, spread, vals)


# fit and submit (ms) of the drill's four pipelined rounds on the CPU
CLEAN = [(30.263, 5.048), (30.292, 2.085), (30.302, 1.716), (30.225, 1.520)]
LEAKED = [(30.264, 102.542), (32.155, 104.213), (30.324, 103.517), (30.268, 104.667)]


def _rounds(pairs):
    return [{"fit": f, "submit": s, "apply": 1.5} for f, s in pairs]


@pytest.mark.parametrize("pairs,fit_bound", [
    (CLEAN, True),
    # one round's submit stalled by 150 ms: the mean submit (39.6 ms)
    # outweighs the mean fit, but three rounds of four stay fit-bound
    ([(f, s + 150.0) if i == 0 else (f, s) for i, (f, s) in enumerate(CLEAN)], True),
    # two stalled rounds are more than one host stall
    ([(f, s + 150.0) if i < 2 else (f, s) for i, (f, s) in enumerate(CLEAN)], False),
    (LEAKED, False),
])
def test_pipelined_verdict_survives_one_stall_and_fails_a_leak(pairs, fit_bound):
    rounds = _rounds(pairs)
    assert doctor._pipelined_fit_bound(rounds) is fit_bound
    if fit_bound and pairs is not CLEAN:
        mean_fit = np.mean([f for f, _ in pairs])
        mean_submit = np.mean([s for _, s in pairs])
        assert mean_submit > mean_fit  # the old verdict failed this run
