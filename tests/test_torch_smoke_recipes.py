"""The data recipes that ``chip_smoke.py`` copies from the JAX repo's
experiments (the script runs on the card without them) give the same
arrays as the originals, bit for bit: the LM CLI's order-1 Markov corpus
and its random-offset windows over the training head, and the CIFAR-10
stand-in with its ``to_xy`` (f32 images, one-hot f32 targets)."""

import numpy as np
import pytest

import chip_smoke
from experiments.cifar10.cifar_data import synthetic_cifar10, to_xy
from experiments.lm.data import batches, generate_corpus

pytestmark = pytest.mark.port


def test_markov_corpus_and_windows_match_the_lm_cli():
    corpus = chip_smoke._markov_corpus(5000, seed=3)
    want = generate_corpus(5000, vocab=chip_smoke.CORPUS_VOCAB,
                           branching=chip_smoke.CORPUS_BRANCHING, order=1, seed=3)
    assert corpus.dtype == want.dtype and np.array_equal(corpus, want)
    assert corpus.max() < chip_smoke.CORPUS_VOCAB
    seq = 64
    # the CLI's split: the tail of max(4 (seq + 1), n / 10) tokens is held out
    split = max(len(want) - max(4 * (seq + 1), len(want) // 10), seq + 2)
    got = chip_smoke._corpus_windows(corpus, 2, seq, 3, seed=5)
    for (x, y), (wx, wy) in zip(got, batches(want[:split], 2, seq, 3, seed=5)):
        assert np.array_equal(x, wx) and np.array_equal(y, wy)


def test_synthetic_cifar10_matches_the_cifar_recipe():
    train, val = chip_smoke._synthetic_cifar10(64, 16, seed=2)
    want = synthetic_cifar10(64, 16, seed=2)
    for got, ref in ((train, want["train"]), (val, want["val"])):
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        (x, y), (wx, wy) = chip_smoke._to_xy(got), to_xy(ref)
        assert x.dtype == wx.dtype == np.float32 and np.array_equal(x, wx)
        assert y.dtype == wy.dtype == np.float32 and np.array_equal(y, wy)
