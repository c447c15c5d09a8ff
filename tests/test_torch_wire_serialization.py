"""The port's wire payloads against the JAX package's, on the CPU.

Quantized, top-k sparse, sanitized, cast and stacked payloads and
dftp-flat v2 must give ``pack_bytes`` byte-identical to JAX's for the
same numpy arrays; ``mean_serialized`` (plain, weighted, sparse, int8,
mixed dtypes) must equal JAX's bit for bit; the ``DownloadMsg`` and
``UploadMsg`` dict forms must be equal for the same content.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distriflow_tpu.utils import messages as jax_msg
from distriflow_tpu.utils import serialization as jax_ser

from distriflow_tpu_torch.utils import messages as port_msg
from distriflow_tpu_torch.utils import serialization as port_ser

pytestmark = pytest.mark.port

#: the wire's keystr paths of the ``{"w": ..., "n": ...}`` template
W, N = "['w']", "['n']"


def _arr(seed: int, shape=(6, 5), scale: float = 1.0) -> np.ndarray:
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _port_bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).to(torch.bfloat16)


def _jax_bf16(a: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def _same_packed(jax_tree, port_tree) -> bytes:
    ref = jax_ser.pack_bytes(jax_tree)
    assert port_ser.pack_bytes(port_tree) == ref
    return ref


@pytest.mark.parametrize("shape", [(6, 5), (1,), (0,), (3, 4, 2)])
def test_quantize_array_bytes(shape):
    a = _arr(0, shape, 3.0) if np.prod(shape) else np.zeros(shape, np.float32)
    if a.size > 2:
        a.reshape(-1)[1] = np.inf  # sanitized to 0 on both sides
        a.reshape(-1)[2] = np.nan
    ref = _same_packed({"q": jax_ser.quantize_array(a)}, {"q": port_ser.quantize_array(a)})
    np.testing.assert_array_equal(
        port_ser.deserialize_array(port_ser.unpack_bytes(ref)["q"]),
        jax_ser.deserialize_array(jax_ser.unpack_bytes(ref)["q"]))
    # a tensor (the worker's gradient) quantizes to the same bytes
    _same_packed({"q": jax_ser.quantize_array(a)},
                 {"q": port_ser.quantize_array(torch.from_numpy(a))})


@pytest.mark.parametrize("fraction,quantize", [(0.1, False), (0.1, True), (1.0, False),
                                               (0.001, True)])
def test_topk_array_bytes(fraction, quantize):
    a = _arr(1, (40, 7))
    ref = _same_packed({"s": jax_ser.topk_array(a, fraction, quantize),
                        "d": jax_ser.serialize_array(a)},
                       {"s": port_ser.topk_array(a, fraction, quantize),
                        "d": port_ser.serialize_array(a)})
    assert b'"version":2' in ref  # dftp-flat v2: a sparse leaf
    for key in ("s", "d"):
        np.testing.assert_array_equal(
            port_ser.deserialize_array(port_ser.unpack_bytes(ref)[key]),
            jax_ser.deserialize_array(jax_ser.unpack_bytes(ref)[key]))


def test_sanitize_finite_and_cast_tree():
    a = _arr(2)
    a[0, 0], a[1, 1] = np.inf, np.nan
    np.testing.assert_array_equal(port_ser.sanitize_finite(a), jax_ser.sanitize_finite(a))
    tree = {"w": _arr(3), "b": np.arange(5, dtype=np.int32), "h": _arr(4).astype(np.float16)}
    for name in ("float16", "bfloat16", "float32"):
        _same_packed(jax_ser.serialize_tree(jax_ser.cast_tree(tree, name)),
                     port_ser.serialize_tree(port_ser.cast_tree(tree, name)))
    # bfloat16 leaves are not float leaves (ml_dtypes' kind is "V"): passed through
    bf = {"w": _arr(5)}
    _same_packed(jax_ser.serialize_tree(jax_ser.cast_tree({"w": _jax_bf16(bf["w"])}, "float16")),
                 port_ser.serialize_tree(port_ser.cast_tree({"w": _port_bf16(bf["w"])},
                                                            "float16")))


def test_stack_serialized_bytes():
    a, b = _arr(6), _arr(7)
    dense = [{"w": jax_ser.serialize_array(a)}, {"w": jax_ser.serialize_array(b)}]
    _same_packed(jax_ser.stack_serialized(dense),
                 port_ser.stack_serialized([{"w": port_ser.serialize_array(a)},
                                            {"w": port_ser.serialize_array(b)}]))
    mixed_j = [{"w": jax_ser.quantize_array(a)}, {"w": jax_ser.topk_array(b, 0.2, True)},
               {"w": jax_ser.serialize_array(b)}]
    mixed_p = [{"w": port_ser.quantize_array(a)}, {"w": port_ser.topk_array(b, 0.2, True)},
               {"w": port_ser.serialize_array(b)}]
    _same_packed(jax_ser.stack_serialized(mixed_j), port_ser.stack_serialized(mixed_p))


def test_tree_bytes_round_trip():
    tree = {"params": {"Dense_0": {"kernel": _arr(8), "bias": np.zeros(5, np.float32)}},
            "step": np.int64(3), "flags": [np.array([True, False])]}
    ref = jax_ser.tree_to_bytes(tree)
    assert port_ser.tree_to_bytes(tree) == ref
    back = port_ser.tree_from_bytes(ref, tree)
    np.testing.assert_array_equal(back["params"]["Dense_0"]["kernel"],
                                  tree["params"]["Dense_0"]["kernel"])
    assert int(back["step"]) == 3


def _mean_pair(updates_fn, like, weights=None):
    """``mean_serialized`` of the same updates through both packages."""
    want = jax_ser.mean_serialized(updates_fn(jax_ser), like, weights)
    got = port_ser.mean_serialized(updates_fn(port_ser), like, weights)
    for k in like:
        w, g = np.asarray(want[k]), port_ser.to_numpy(got[k])
        if isinstance(g, torch.Tensor):  # bfloat16 template
            assert str(w.dtype) == "bfloat16"
            w, g = w.astype(np.float32), g.float().numpy()
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        assert g.tobytes() == w.tobytes(), k


@pytest.mark.parametrize("native_built", [True, False])
@pytest.mark.parametrize("case", ["plain", "weighted", "sparse", "int8", "mixed", "wide", "bf16"])
def test_mean_serialized_bits(case, native_built, monkeypatch):
    from distriflow_tpu import native as jax_native

    from distriflow_tpu_torch import native as port_native

    if native_built:
        assert jax_native.ensure_built() and port_native.ensure_built()
    else:
        monkeypatch.setattr(jax_native, "ensure_built", lambda force=False: False)
        monkeypatch.setattr(port_native, "ensure_built", lambda force=False: False)
    gs = [_arr(10 + i, (33, 7), 1 + i) for i in range(3)]
    like = {"w": np.zeros((33, 7), np.float32), "n": np.zeros(4, np.int32)}
    ints = [np.arange(4, dtype=np.int32) * (i + 1) for i in range(3)]

    def plain(ser, gs=gs):
        return [{W: ser.serialize_array(g), N: ser.serialize_array(n)}
                for g, n in zip(gs, ints)]

    if case == "plain":
        _mean_pair(plain, like)
    elif case == "weighted":
        _mean_pair(plain, like, weights=[1.0, 0.5, 0.25])
    elif case == "sparse":
        _mean_pair(lambda ser: [{W: ser.topk_array(g, 0.3, q), N: ser.serialize_array(n)}
                                for g, n, q in zip(gs, ints, (False, True, False))],
                   like, weights=[1.0, 0.9, 0.81])
    elif case == "int8":
        _mean_pair(lambda ser: [{W: ser.quantize_array(g), N: ser.serialize_array(n)}
                                for g, n in zip(gs, ints)], like)
    elif case == "mixed":
        def mixed(ser):
            f16 = gs[1].astype(np.float16)
            return [{W: ser.serialize_array(gs[0]), N: ser.serialize_array(ints[0])},
                    {W: ser.serialize_array(f16), N: ser.serialize_array(ints[1])},
                    {W: ser.quantize_array(gs[2]), N: ser.serialize_array(ints[2])}]
        _mean_pair(mixed, like)
    elif case == "wide":
        _mean_pair(lambda ser: [{W: ser.serialize_array(g.astype(np.float64)),
                                 N: ser.serialize_array(n)} for g, n in zip(gs, ints)], like)
    else:  # bf16 uploads (the f64 path in JAX: ml_dtypes' bfloat16 is not kind "f")
        def bf16(ser):
            conv = _jax_bf16 if ser is jax_ser else _port_bf16
            return [{W: ser.serialize_array(conv(g)), N: ser.serialize_array(n)}
                    for g, n in zip(gs, ints)]
        _mean_pair(bf16, like)
        _mean_pair(bf16, {"w": np.zeros((33, 7), np.float16), "n": like["n"]})


def test_messages_dict_form():
    a, x, y = _arr(20), _arr(21, (4, 3)), np.eye(3, dtype=np.float32)[[0, 1, 2, 0]]
    vars_ = {"['params']['w']": "dense", "['params']['q']": "int8", "['params']['s']": "topk"}

    def payload(ser):
        make = {"dense": ser.serialize_array, "int8": ser.quantize_array,
                "topk": lambda v: ser.topk_array(v, 0.2)}
        return {k: make[kind](a) for k, kind in vars_.items()}

    def download(m, ser):
        return m.DownloadMsg(
            model=m.ModelMsg(version="v2", vars=payload(ser), delta_base="v1"),
            hyperparams={"batch_size": 8, "gradient_compression": "int8"},
            data=m.DataMsg(batch=3, epoch=1, x=ser.serialize_array(x), y=ser.serialize_array(y)),
            trace_id="t", span_id="s").to_wire()

    def upload(m, ser):
        return m.UploadMsg(
            client_id="c", gradients=m.GradientMsg(version="v2", vars=payload(ser)), batch=3,
            metrics=[0.5], update_id="u", trace_id="t", span_id="s",
            report={"v": 1, "seq": 2}).to_wire()

    for make in (download, upload):
        ref = make(jax_msg, jax_ser)
        assert make(port_msg, port_ser) == ref
    back = port_msg.DownloadMsg.from_wire(download(jax_msg, jax_ser))
    assert back.model.delta_base == "v1" and back.data.batch == 3
    up = port_msg.UploadMsg.from_wire(upload(jax_msg, jax_ser))
    np.testing.assert_array_equal(port_ser.deserialize_array(up.gradients.vars["['params']['s']"]),
                                  jax_ser.deserialize_array(jax_ser.topk_array(a, 0.2)))
    assert port_msg.Events.Upload.value == jax_msg.Events.Upload.value == "uploadVars"
