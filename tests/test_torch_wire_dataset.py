"""The port's ``DistributedDataset`` against the JAX package's: the same
dispatch order, acks, requeues, epochs and ``state()`` under one seed."""

import numpy as np
import pytest

from distriflow_tpu.data import dataset as jax_ds

from distriflow_tpu_torch.data import dataset as port_ds
from distriflow_tpu_torch.utils import serialization as port_ser

pytestmark = pytest.mark.port


def _pair(config):
    rng = np.random.RandomState(3)
    x = rng.randn(70, 5).astype(np.float32)
    y = rng.randint(0, 4, 70).astype(np.int32)
    return jax_ds.DistributedDataset(x, y, config), port_ds.DistributedDataset(x, y, config)


@pytest.mark.parametrize("config", [
    {"batch_size": 16, "epochs": 3, "shuffle": True, "seed": 7},
    {"batch_size": 16, "epochs": 2, "small_last_batch": True},
    {"batch_size": 32, "epochs": 1, "shuffle": True, "seed": 1},
])
def test_dispatch_requeue_and_state_match_jax(config):
    ref, port = _pair(config)
    assert port.num_batches == ref.num_batches
    step = 0
    while True:
        a, b = ref.next(timeout=1.0), port.next(timeout=1.0)
        assert (a is None) == (b is None), step
        if a is None:
            break
        assert (a.batch, a.epoch) == (b.batch, b.epoch), step
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.y, b.y)
        if step % 3 == 1:  # a worker dies holding the batch: requeue
            ref.requeue(a.batch)
            port.requeue(b.batch)
        elif step % 5 == 2:  # hold it across the next dispatch, then ack
            c, d = ref.next(timeout=1.0), port.next(timeout=1.0)
            assert (c is None) == (d is None)
            if c is not None:
                assert (c.batch, c.epoch) == (d.batch, d.epoch)
                assert ref.state() == port.state()
                assert ref.complete_batch(c.batch) == port.complete_batch(d.batch)
            assert ref.complete_batch(a.batch) == port.complete_batch(b.batch)
        else:
            assert ref.complete_batch(a.batch) == port.complete_batch(b.batch)
            # a duplicate completion is not the first
            assert ref.complete_batch(a.batch) == port.complete_batch(b.batch) is False
        assert ref.state() == port.state(), step
        step += 1
    assert ref.exhausted and port.exhausted
    assert ref.state() == port.state()


def test_restore_state_and_preprocess_match_jax():
    ref, port = _pair({"batch_size": 8, "epochs": 2, "shuffle": True, "seed": 4})
    for ds in (ref, port):
        ds.add_preprocess(lambda bx, by: (bx * 2.0, by + 1))
    held = [(ref.next(), port.next()) for _ in range(3)]
    ref.complete_batch(held[0][0].batch)
    port.complete_batch(held[0][1].batch)
    snap = ref.state()
    assert port.state() == snap
    ref2, port2 = _pair({"batch_size": 8, "epochs": 2, "shuffle": True, "seed": 4})
    assert ref2.restore_state(snap) == port2.restore_state(snap) == 2
    while True:
        a, b = ref2.next(timeout=1.0), port2.next(timeout=1.0)
        assert (a is None) == (b is None)
        if a is None:
            break
        assert (a.batch, a.epoch) == (b.batch, b.epoch)
        ref2.complete_batch(a.batch)
        port2.complete_batch(b.batch)
    np.testing.assert_array_equal(held[1][0].x, held[1][1].x)
    # the wire form of a batch is the JAX package's
    msg = port_ds.batch_to_data_msg(held[1][1])
    assert port_ser.pack_bytes({"x": msg.x, "y": msg.y}) == \
        port_ser.pack_bytes({"x": port_ser.serialize_array(held[1][0].x),
                             "y": port_ser.serialize_array(held[1][0].y)})
    # next_sharded is ported: on a one-rank mesh the whole batch, with JAX's
    # all-ones weight (the multi-rank slices: tests/test_torch_parallel.py)
    import jax
    import torch.distributed as dist

    from distriflow_tpu.parallel.mesh import data_parallel_mesh as jax_mesh
    from distriflow_tpu_torch.parallel import data_parallel_mesh, ensure_process_group

    assert ensure_process_group("cpu")
    try:
        got = port.next_sharded(data_parallel_mesh("cpu"))
    finally:
        dist.destroy_process_group()
    want = ref.next_sharded(jax_mesh(jax.devices()[:1]))
    assert (got.batch, got.epoch) == (want.batch, want.epoch)
    for a, b in ((got.x, want.x), (got.y, want.y), (got.weight, want.weight)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sample_batch_matches_jax():
    rng = np.random.RandomState(5)
    x = rng.randint(0, 255, (40, 8, 8, 3)).astype(np.uint8)
    y = rng.randint(0, 10, 40).astype(np.int32)
    idx = rng.randint(0, 40, 16)
    for a, b in zip(port_ds.sample_batch(x, y, idx), jax_ds.sample_batch(x, y, idx)):
        assert a.tobytes() == b.tobytes()
