"""The port's kernel build and the sources of the Hopper attention kernels.

- ``ops/build.py`` names each library by a hash of its source and of the
  headers it includes, so an edit to ``csrc/hopper.cuh`` rebuilds the two
  attention sources, the decode source (its mbarrier helpers) and the
  depthwise source (its NHWC tensor maps and cluster helpers) and no
  other.
- The attention kernels are Hopper designs: their sources, with the
  headers they include, issue TMA loads (``cp.async.bulk.tensor``) and
  ``wgmma.mma_async`` products. Neither source keeps a WMMA path or an
  atomic add: the dQ kernel and the fused backward's dQ partial issue
  wgmma products, and the fused backward's partials are summed by a
  second pass, not with atomics.
- The depthwise kernels are cluster kernels: their source, with its
  headers, loads its boxes with TMA and meets the cluster at
  ``barrier.cluster``; it adds no atomics and keeps no dx kernel, and the
  wrapper passes no cotangent scratch.
"""

import re
import shutil

import pytest

from distriflow_tpu_torch.ops import build

pytestmark = pytest.mark.port


def test_hopper_header_rebuilds_exactly_the_attention_sources(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc, ignore=shutil.ignore_patterns("build"))
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", csrc / "build")
    before = {n: build._target(n).name for n in build.SOURCES}
    (csrc / "hopper.cuh").write_text((csrc / "hopper.cuh").read_text() + "\n// edited\n")
    after = {n: build._target(n).name for n in build.SOURCES}
    changed = {n for n in build.SOURCES if before[n] != after[n]}
    assert changed == {"flash_attention", "flash_attention_bwd", "flash_decode", "depthwise_gn"}
    (csrc / "common.cuh").write_text((csrc / "common.cuh").read_text() + "\n// edited\n")
    assert all(build._target(n).name != after[n] for n in build.SOURCES)


def _with_headers(name):
    return "".join((build.CSRC / f).read_text()
                   for f in (f"{name}.cu", *build.HEADERS.get(name, ("common.cuh",))))


@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_bwd"])
def test_attention_sources_use_tma_and_wgmma(name):
    text = _with_headers(name)
    assert "cp.async.bulk.tensor" in text and "wgmma.mma_async" in text
    assert '#include "hopper.cuh"' in (build.CSRC / f"{name}.cu").read_text()


def _namespace(text, name):
    """The body of C++ namespace ``name`` in ``text``, up to its matching brace."""
    start = re.search(rf"\bnamespace\s+{name}\s*{{", text).end()
    depth = 1
    for i in range(start, len(text)):
        depth += {"{": 1, "}": -1}.get(text[i], 0)
        if depth == 0:
            return text[start:i]
    raise AssertionError(f"namespace {name} is not closed")


def test_forward_and_dkv_kernels_keep_no_wmma_path():
    assert "wmma" not in (build.CSRC / "flash_attention.cu").read_text()
    bwd = (build.CSRC / "flash_attention_bwd.cu").read_text()
    assert "wmma" not in bwd and "mma.h" not in bwd and "atomicAdd" not in bwd
    # the dQ kernel and the fused kernel (with kernel 8) issue SS and RS wgmma
    for name in ("dq_split", "dkv"):
        body = _namespace(bwd, name)
        assert "wgmma_m64n64k16_ss" in body and "wgmma_m64n64k16_rs" in body
    # the fused backward's partials are summed by a second kernel
    assert re.search(r"__global__[^;{]*\bdq_sum_kernel\s*\(", _namespace(bwd, "dkv"))
    assert re.search(r"dq_sum_kernel\s*<<<", bwd)


def test_depthwise_source_is_a_cluster_kernel_without_scratch():
    import inspect

    from distriflow_tpu_torch.ops import depthwise_gn as dg

    src = (build.CSRC / "depthwise_gn.cu").read_text()
    text = _with_headers("depthwise_gn")
    assert '#include "hopper.cuh"' in src
    assert "cp.async.bulk.tensor" in text and "barrier.cluster" in text
    assert "mapa.shared::cluster" in text and "cudaLaunchAttributeClusterDimension" in src
    assert "atomicAdd" not in src and "atom." not in src and "red.global" not in src
    assert "dwgn_bwd_dx_kernel" not in src
    # the backward's C interface takes x, w, scale, bias, g and its four
    # outputs, and the wrapper allocates no cotangent scratch
    argtypes = dg._SIGNATURES["dftt_dwgn_bwd_bf16"]
    assert argtypes[:9] == [build.ctypes.c_void_p] * 9 and argtypes[9] is build.ctypes.c_int
    assert "dacc" not in inspect.getsource(dg.depthwise_gn_backward)
