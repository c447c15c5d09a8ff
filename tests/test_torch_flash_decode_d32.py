"""Port: the head-dim-32 bf16 decode kernel's host side (``ops/flash_decode.py``
and ``csrc/flash_decode.cu``, namespace ``d32``), on the CPU.

Kernels 2 and 3 at head dim 32 on a bf16 cache run one cluster launch
(``d32::decode_kernel``): a cluster of ``d32_cluster(n_splits)`` CTAs a
(row, head), rank r running splits r, r + C, ... one a warp, the combine
through distributed shared memory, no scratch in device memory. These
tests hold what the CPU can reach: the cluster choice covers every split
within the passes it promises, the source launches that kernel as a
cluster with two cluster barriers and no programmatic dependent launch
while the other instances keep the split kernel and its combine, and the
wrapper hands the D 32 bf16 call to its own C entry without allocating a
partial scratch. The kernel's results are held on the card
(``chip_smoke.py``'s rows ``flash_decode_paged_d32``, ``flash_decode_d32``).
"""

import re

import pytest
import torch

from distriflow_tpu_torch.ops import build
from distriflow_tpu_torch.ops import flash_decode as fd

pytestmark = pytest.mark.port


def _source():
    return (build.CSRC / "flash_decode.cu").read_text()


def _body(src, head):
    """The brace-balanced body that follows the first ``head`` in ``src``."""
    start = src.index("{", src.index(head))
    depth = 0
    for i in range(start, len(src)):
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        if depth == 0:
            return src[start:i + 1]
    raise AssertionError(f"unbalanced body after {head}")


@pytest.mark.parametrize("cluster_max", [1, 2, 4, 8, 16])
def test_cluster_choice_covers_every_split(monkeypatch, cluster_max):
    """For every n_splits from 1 to 128: C is a power of two, at most its
    maximum, at least n_splits where that is below the maximum, and the
    ranks' warps (rank r: splits r + C j, warp w: j = w, w + warps, ...)
    run every split once, in at most ceil(n_splits / (C * warps)) passes."""
    monkeypatch.setattr(fd, "D32_CLUSTER_MAX", cluster_max)
    w = fd.D32_WARPS
    for n in range(1, 129):
        c = fd.d32_cluster(n)
        assert c & (c - 1) == 0 and 1 <= c <= cluster_max, (n, c)
        assert c >= min(n, cluster_max), (n, c)
        seen, passes = [], 0
        for rank in range(c):
            for warp in range(w):
                mine = [rank + c * j for j in range(warp, n, w) if rank + c * j < n]
                seen += mine
                passes = max(passes, len(mine))
        assert sorted(seen) == list(range(n)), (n, c)
        assert passes <= -(-n // (c * w)), (n, c, passes)


def test_d32_entry_launches_the_cluster_kernel():
    """The D 32 bf16 entry launches ``d32::decode_kernel`` with a cluster
    dimension; the kernel holds two cluster barriers and no
    ``griddepcontrol``; the bf16 entry keeps D 64 and the f32 and int8
    entries the split kernel and ``combine_kernel``; the Python constants
    name the source's."""
    src = _source()
    d32 = _body(src, "namespace d32 {")
    entry = _body(src, 'extern "C" int dftt_flash_decode_d32(')
    assert "d32::launch(" in entry and "partial" not in entry.split("return")[-1]
    launch = _body(d32, "int launch(DecodeArgs a, int B, int cluster, cudaStream_t st)")
    assert "cudaLaunchKernelEx(&c.cfg, decode_kernel, a)" in launch
    assert "cudaLaunchAttributeClusterDimension" in _body(d32, "struct Config")
    kernel = _body(d32, "__global__ void __launch_bounds__(kThreads) decode_kernel(")
    assert kernel.count("cluster_sync()") == 2
    assert "griddepcontrol" not in d32 and "a.partial" not in d32
    assert "ld_cluster_f32x4" in _body(d32, "__device__ __forceinline__ void combine(")
    assert "ld_cluster_f32x4" in (build.CSRC / "hopper.cuh").read_text()
    bf16 = _body(src, 'extern "C" int dftt_flash_decode_bf16(')
    assert "launch<64, Cache::kBf16>" in bf16 and "launch<32" not in bf16
    for name, want in (("f32", ("launch<64, Cache::kF32>", "launch<32, Cache::kF32>")),
                       ("int8", ("launch<64, Cache::kInt8>",))):
        body = _body(src, f'extern "C" int dftt_flash_decode_{name}(')
        assert all(w in body for w in want), name
    # the split kernels' template launch still ends in the combine
    assert "cudaLaunchKernelEx(&cfg, combine_kernel<D, Out>, a)" in _body(
        src, "int launch(DecodeArgs a, int B, cudaStream_t st)")
    assert int(re.search(r"constexpr int kWarps = (\d+);", d32).group(1)) == fd.D32_WARPS
    assert int(re.search(r"constexpr int kMaxCluster = (\d+);", d32).group(1)) == fd.D32_CLUSTER_MAX


class _Lib:
    """A stand-in for the loaded library: records each entry's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def fake_launch(monkeypatch):
    """``_launch`` against :class:`_Lib` on CPU tensors, counting the
    tensors it allocates with ``torch.empty``."""
    lib = _Lib()
    empties = []
    real_empty = torch.empty

    def empty(*shape, **kw):
        empties.append(tuple(shape[0]) if len(shape) == 1 else shape)
        return real_empty(*shape, **kw)

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(fd.build, "load", lambda name, sig: lib)
    monkeypatch.setattr(fd.torch.cuda, "current_stream", lambda device=None: _Stream())
    monkeypatch.setattr(fd.torch, "empty", empty)
    return lib, empties


@pytest.mark.parametrize("layout", ["paged", "slab"])
def test_wrapper_allocates_no_partial_at_d32_bf16(fake_launch, layout):
    """A D 32 bf16 call goes to ``dftt_flash_decode_d32`` with the cluster of
    :func:`d32_cluster` and no scratch; a D 64 bf16 call keeps the f32
    partials ``[B, H, n_splits, D + 2]`` and ``dftt_flash_decode_bf16``."""
    lib, empties = fake_launch
    b, h, ps, pp = 3, 4, 128, 40
    for d in (32, 64):
        q = torch.zeros(b, h, d, dtype=torch.bfloat16)
        kv = torch.zeros(8 if layout == "paged" else b, ps if layout == "paged" else pp * ps, h * d,
                         dtype=torch.bfloat16)
        table = torch.zeros(b, pp, dtype=torch.int32) if layout == "paged" else None
        fd._launch(q, kv, kv, None, table, torch.tensor([5, 0, 700]), ps, pp, pp * ps,
                   8 if layout == "paged" else 0, "test")
    n_splits = -(-pp // fd.split_tiles(ps))
    (name32, args32), (name64, _) = lib.calls
    assert name32 == "dftt_flash_decode_d32" and name64 == "dftt_flash_decode_bf16"
    assert len(args32) == 18 and args32[14] == fd.d32_cluster(n_splits) == 16
    assert args32[12:14] == (fd.split_tiles(ps), n_splits)
    assert empties == [(b, h, n_splits, 64 + 2)]
