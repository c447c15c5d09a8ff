"""The port's kernel build and the sources of the Hopper attention kernels.

- ``ops/build.py`` names each library by a hash of its source and of the
  headers it includes, so an edit to ``csrc/hopper.cuh`` rebuilds the two
  attention sources and no other.
- The flash forward and the dK/dV kernel are Hopper designs: their
  sources, with the headers they include, issue TMA loads
  (``cp.async.bulk.tensor``) and ``wgmma.mma_async`` products, and neither
  kernel keeps a WMMA path (the forward's source has none; the dK/dV
  kernel's body has none, while kernels 6 and 7 beside it are still WMMA).
"""

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
    assert changed == {"flash_attention", "flash_attention_bwd"}
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


def test_forward_and_dkv_kernels_keep_no_wmma_path():
    assert "wmma" not in (build.CSRC / "flash_attention.cu").read_text()
    bwd = (build.CSRC / "flash_attention_bwd.cu").read_text()
    body = bwd[bwd.index("namespace dkv {"):]
    assert "wmma" not in body and "wgmma_m64n64k16_rs" in body
    assert "dkv_body<D, false>" not in bwd and "kDq" not in bwd
