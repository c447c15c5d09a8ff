"""The port's C++ host kernels (``distriflow_tpu_torch.native``) against
the JAX package's, built and on their numpy paths, on the CPU."""

import numpy as np
import pytest

from distriflow_tpu import native as jax_native

from distriflow_tpu_torch import native as port_native

pytestmark = pytest.mark.port


def _paths(built: bool, monkeypatch):
    if built:
        assert port_native.ensure_built(), "g++ could not build the port's native library"
        assert jax_native.ensure_built()
        assert port_native.AVAILABLE
        assert str(port_native.BUILD_DIR).endswith("distriflow_tpu_torch/csrc/build")
    else:
        monkeypatch.setattr(jax_native, "ensure_built", lambda force=False: False)
        monkeypatch.setattr(port_native, "ensure_built", lambda force=False: False)


@pytest.mark.parametrize("built", [True, False])
@pytest.mark.parametrize("dtype,shape", [(np.float32, (50, 3, 4)), (np.uint8, (64, 32, 32, 3)),
                                         (np.int32, (10,))])
def test_gather_rows_matches_jax(built, dtype, shape, monkeypatch):
    _paths(built, monkeypatch)
    rng = np.random.RandomState(0)
    src = (rng.rand(*shape) * 100).astype(dtype)
    idx = rng.randint(0, shape[0], 37)
    got = port_native.gather_rows(src, idx)
    want = jax_native.gather_rows(src, idx)
    assert got.dtype == want.dtype and got.flags["C_CONTIGUOUS"]
    assert got.tobytes() == want.tobytes()
    np.testing.assert_array_equal(got, src[idx])
    # a strided source takes numpy's gather on both sides
    np.testing.assert_array_equal(port_native.gather_rows(src[::2], idx % (shape[0] // 2)),
                                  jax_native.gather_rows(src[::2], idx % (shape[0] // 2)))
    with pytest.raises(IndexError):
        port_native.gather_rows(src, np.array([shape[0]]))


@pytest.mark.parametrize("built", [True, False])
@pytest.mark.parametrize("n,size", [(1, 17), (3, 70000), (8, 1000)])
def test_mean_buffers_matches_jax(built, n, size, monkeypatch):
    _paths(built, monkeypatch)
    rng = np.random.RandomState(1)
    bufs = [rng.randn(size).astype(np.float32) * (i + 1) for i in range(n)]
    bufs[-1] = bufs[-1].astype(np.float16)  # widened to f32 on both sides
    got = port_native.mean_buffers(bufs)
    want = jax_native.mean_buffers(bufs)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    with pytest.raises(ValueError):
        port_native.mean_buffers([bufs[0], bufs[0][:-1]])
