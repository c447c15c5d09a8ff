"""Exact kernel launch counts under threads: every ``ops/`` wrapper counts
through ``build.count_launch`` (one lock), so workers fitting in several
threads at once never lose an increment."""

import pathlib
import sys
import threading

import pytest

from distriflow_tpu_torch.ops import build, depthwise_gn, flash_attention, flash_decode, fused_ce

pytestmark = pytest.mark.port

WRAPPERS = [
    fused_ce.fused_ce_forward, fused_ce.fused_ce_backward,
    fused_ce.fused_ce_dense_forward, fused_ce.fused_ce_dense_backward,
    flash_attention.flash_attention, flash_attention.flash_attention_backward,
    flash_attention.flash_attention_dq, flash_attention.flash_attention_dkv,
    flash_decode.flash_decode, flash_decode.flash_decode_paged,
    flash_decode.flash_decode_int8, flash_decode.flash_decode_paged_int8,
    depthwise_gn.depthwise_gn_forward, depthwise_gn.depthwise_gn_backward,
]


def test_count_launch_is_exact_across_threads():
    interval = sys.getswitchinterval()
    fn = fused_ce.fused_ce_dense_forward
    saved = fn.launches
    sys.setswitchinterval(1e-6)  # switch threads as often as the interpreter allows
    try:
        fn.launches = 0
        n_threads, per_thread = 8, 20000
        barrier = threading.Barrier(n_threads)

        def worker():
            barrier.wait()
            for _ in range(per_thread):
                build.count_launch(fn)

        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert fn.launches == n_threads * per_thread
    finally:
        sys.setswitchinterval(interval)
        fn.launches = saved


def test_every_wrapper_counts_through_the_lock():
    root = pathlib.Path(build.__file__).parent
    for path in root.glob("*.py"):
        if path.name == "build.py":
            continue
        assert ".launches += 1" not in path.read_text(), path.name
    for fn in WRAPPERS:
        assert isinstance(fn.launches, int), fn.__name__
