"""The port's ``StreamingTokenDataset`` and ``write_token_file``
(``distriflow_tpu_torch/data/streaming.py``) against JAX's on the CPU:
the same file bytes, the same batches for each (seed, epoch,
process_index/count), cursor states that move between the packages,
``seek``, the window-range holdout, the wide-token rejection, and a short
run of the port's ``SyncTrainer`` through ``run_chunked``. Every
comparison is exact (integer batches)."""

import json

import numpy as np
import pytest
import torch

from distriflow_tpu.data import streaming as js
from distriflow_tpu_torch.data import streaming as ts

pytestmark = pytest.mark.port


def _corpus(tmp_path, n=6000, vocab=300, seed=0):
    tokens = np.random.RandomState(seed).randint(0, vocab, n)
    return ts.write_token_file(str(tmp_path / "corpus"), tokens), tokens


def _pair(path, **kw):
    return js.StreamingTokenDataset(path, **kw), ts.StreamingTokenDataset(path, **kw)


def _same(a, b, n):
    for (jx, jy), (tx, ty) in zip(a.take(n), b.take(n)):
        assert jx.dtype == tx.dtype == np.int32
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)


@pytest.mark.parametrize("values", [np.arange(200), np.arange(50_000), np.arange(70_000),
                                    np.array([0, 2**31], np.int64),
                                    np.array([-1, 2**31], np.int64)])
def test_token_files_are_jaxs(tmp_path, values):
    jp = js.write_token_file(str(tmp_path / "jax"), values)
    tp = ts.write_token_file(str(tmp_path / "port"), values)
    assert open(tp + ".json").read() == open(jp + ".json").read()
    assert open(tp + ".bin", "rb").read() == open(jp + ".bin", "rb").read()


@pytest.mark.parametrize("seed,index,count", [(0, 0, 1), (7, 0, 2), (7, 1, 2), (3, 2, 4)])
def test_batches_are_jaxs_across_epochs(tmp_path, seed, index, count):
    path, _ = _corpus(tmp_path)
    a, b = _pair(path, seq_len=16, batch_size=4, seed=seed, process_index=index,
                 process_count=count)
    assert b.batches_per_epoch == a.batches_per_epoch
    _same(a, b, 2 * a.batches_per_epoch + 3)  # into the third epoch
    assert (b.epoch, b.batch_in_epoch) == (a.epoch, a.batch_in_epoch)


def test_shards_are_disjoint_and_cover(tmp_path):
    path, _ = _corpus(tmp_path)
    seen = []
    for p in range(2):
        ds = ts.StreamingTokenDataset(path, seq_len=16, batch_size=8, seed=5,
                                      process_index=p, process_count=2)
        rows = [tuple(r.tolist()) for x, _ in ds.take(ds.batches_per_epoch) for r in x]
        seen.append(set(ds._epoch_order(0).tolist()))
        assert len(set(rows)) == len(rows) == ds.batches_per_epoch * 8
    assert not seen[0] & seen[1]
    # each process drops at most its last partial batch of the epoch
    assert ds.n_windows - len(seen[0] | seen[1]) < 2 * 8 + 2


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_states_move_between_packages(tmp_path, direction):
    path, _ = _corpus(tmp_path)
    kw = dict(seq_len=16, batch_size=4, seed=11, process_index=1, process_count=3)
    src_jax = direction == "jax_to_port"
    src = (js if src_jax else ts).StreamingTokenDataset(path, **kw)
    for _ in src.take(src.batches_per_epoch + 2):
        pass
    state = json.loads(json.dumps(src.state()))
    dst = (ts if src_jax else js).StreamingTokenDataset(path, **kw)
    dst.restore(state)
    _same(src, dst, 5) if src_jax else _same(dst, src, 5)


def test_restore_refuses_another_layout_as_jax(tmp_path):
    path, _ = _corpus(tmp_path)
    a, b = _pair(path, seq_len=16, batch_size=4, seed=1, process_index=0, process_count=1)
    for key, value in (("seed", 2), ("process_count", 2), ("batch_size", 8),
                       ("window_range", [0, 3])):
        state = {**b.state(), key: value}
        with pytest.raises(ValueError) as want:
            a.restore(state)
        with pytest.raises(ValueError) as got:
            b.restore(state)
        assert str(got.value) == str(want.value)


def test_seek_is_jaxs(tmp_path):
    path, _ = _corpus(tmp_path)
    a, b = _pair(path, seq_len=16, batch_size=4, seed=3, process_index=0, process_count=1)
    for n in (0, 5, a.batches_per_epoch, 2 * a.batches_per_epoch + 1):
        a.seek(n)
        b.seek(n)
        _same(a, b, 3)
    with pytest.raises(ValueError):
        b.seek(-1)


def test_window_range_holdout_is_jaxs(tmp_path):
    path, _ = _corpus(tmp_path)
    total = 6000 // 17
    split = total - 40
    for rng in ((0, split), (split, total)):
        a, b = _pair(path, seq_len=16, batch_size=4, seed=0, process_index=0,
                     process_count=1, window_range=rng)
        _same(a, b, a.batches_per_epoch + 1)
    train = ts.StreamingTokenDataset(path, seq_len=16, batch_size=4, window_range=(0, split),
                                     process_index=0, process_count=1)
    held = ts.StreamingTokenDataset(path, seq_len=16, batch_size=4,
                                    window_range=(split, total), process_index=0,
                                    process_count=1)
    assert not set(train._epoch_order(0).tolist()) & set(held._epoch_order(0).tolist())
    for bad in ((5, 5), (0, total + 1), (-1, 3)):
        with pytest.raises(ValueError) as want:
            js.StreamingTokenDataset(path, seq_len=16, batch_size=4, window_range=bad,
                                     process_index=0, process_count=1)
        with pytest.raises(ValueError) as got:
            ts.StreamingTokenDataset(path, seq_len=16, batch_size=4, window_range=bad,
                                     process_index=0, process_count=1)
        assert str(got.value) == str(want.value)


def test_wide_tokens_fail_loudly_and_max_token_id(tmp_path):
    path = ts.write_token_file(str(tmp_path / "wide"),
                               np.array([2**31 + 5] * 40 + [1] * 40, np.int64))
    a, b = _pair(path, seq_len=3, batch_size=20, seed=0, process_index=0, process_count=1)
    with pytest.raises(ValueError) as want:
        next(a)
    with pytest.raises(ValueError) as got:
        next(b)
    assert str(got.value) == str(want.value)
    assert b.max_token_id() == a.max_token_id() == 2**31 + 5
    with pytest.raises(ValueError) as want:
        js.StreamingTokenDataset(path, seq_len=100, batch_size=4, process_index=0,
                                 process_count=1)
    with pytest.raises(ValueError) as got:
        ts.StreamingTokenDataset(path, seq_len=100, batch_size=4, process_index=0,
                                 process_count=1)
    assert str(got.value) == str(want.value)


def test_process_defaults_come_from_torch_distributed(tmp_path):
    """Outside a process group the port's dataset is process 0 of 1."""
    path, _ = _corpus(tmp_path)
    ds = ts.StreamingTokenDataset(path, seq_len=16, batch_size=4)
    assert (ds.process_index, ds.process_count) == (0, 1)


def test_trains_through_run_chunked(tmp_path):
    from distriflow_tpu_torch.models.transformer import TransformerConfig, transformer_lm
    from distriflow_tpu_torch.train.loop import run_chunked
    from distriflow_tpu_torch.train.sync import SyncTrainer

    path, _ = _corpus(tmp_path, n=8000, vocab=64)
    ds = ts.StreamingTokenDataset(path, seq_len=16, batch_size=4, process_index=0,
                                  process_count=1)
    cfg = TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=1, d_ff=64,
                            max_seq=16, dtype=torch.float32, use_flash_attention=False)
    tr = SyncTrainer(transformer_lm(cfg, device="cpu"), learning_rate=1e-2, optimizer="adam")
    tr.init(0)
    res = run_chunked(tr, ds, steps=6, steps_per_dispatch=2)
    assert res.steps_run == 6 and np.isfinite(res.last_loss)
    assert ds.state()["batch_in_epoch"] == 6
