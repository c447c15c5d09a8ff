"""The port's Keras sequence layers against JAX's importer on the CPU:
Embedding (integer inputs stay integer), Conv1D (valid, same, causal),
SimpleRNN, LSTM (gate order i|f|c|o), GRU (z|r|h, both ``reset_after``),
Bidirectional (concat/sum/ave/mul), TimeDistributed, and the ``.h5``
weight names (TF2's nested cell scopes, Bidirectional's forward_/backward_
scopes, a layer whose own name starts with ``forward``). Forward outputs
and gradients within f32 1e-5 or bf16 2e-2 (``tests/torch_keras_cases.py``)."""

import json

import numpy as np
import pytest
import torch

from distriflow_tpu_torch.models import keras_import as tk
from torch_keras_cases import both, layer, random_weights, sequential, write_model

pytestmark = pytest.mark.port

S, C, U = 6, 3, 4


def _x(*shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _tokens(b=3, s=S, vocab=13, seed=2):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _rnn(cls, name="rnn", **cfg):
    cfg.setdefault("recurrent_activation", "sigmoid")
    if cls == "GRU":
        cfg.setdefault("reset_after", True)
    return layer(cls, name, units=U, **cfg)


def _check(tmp_path, layers, x, dtype="float32", **kw):
    topo = sequential(layers)
    path = write_model(tmp_path, topo, random_weights(topo))
    out_shape = tk.spec_from_keras_json(path, device="cpu").output_shape
    return both(path, x, _x(x.shape[0], *out_shape, seed=9), loss="mean_squared_error",
                dtype=dtype, **kw)


def test_embedding_keeps_integer_input(tmp_path):
    layers = [layer("InputLayer", "in", batch_input=[None, S]),
              layer("Embedding", "emb", input_dim=13, output_dim=5),
              layer("GlobalAveragePooling1D", "gap"), layer("Dense", "d", units=2)]
    _, spec = _check(tmp_path, layers, _tokens())
    model = spec.init(0)
    big = torch.full((1, S), 12, dtype=torch.int32)
    spec.apply(model, big)  # ids index the table as integers, not floats


@pytest.mark.parametrize("padding,strides,dilation", [
    ("causal", 1, 1), ("causal", 1, 2), ("causal", 2, 1), ("same", 2, 1), ("same", 1, 2),
    ("valid", 1, 1), ("valid", 2, 2)])
def test_conv1d(tmp_path, padding, strides, dilation):
    layers = [layer("Conv1D", "c", batch_input=[None, 9, C], filters=4, kernel_size=3,
                    padding=padding, strides=strides, dilation_rate=dilation,
                    activation="relu"),
              layer("SpatialDropout1D", "sd", rate=0.1)]
    _check(tmp_path, layers, _x(2, 9, C))


@pytest.mark.parametrize("cls,ret_seq,extra", [
    ("SimpleRNN", False, {}), ("SimpleRNN", True, {"activation": "relu"}),
    ("LSTM", False, {}), ("LSTM", True, {"recurrent_activation": "hard_sigmoid"}),
    ("LSTM", False, {"use_bias": False}),
    ("GRU", False, {"reset_after": True}), ("GRU", True, {"reset_after": False}),
    ("GRU", False, {"reset_after": False, "recurrent_activation": "hard_sigmoid"})])
def test_recurrent_layers(tmp_path, cls, ret_seq, extra):
    layers = [layer("InputLayer", "in", batch_input=[None, S, C]),
              _rnn(cls, return_sequences=ret_seq, **extra)]
    _check(tmp_path, layers, _x(3, S, C))


@pytest.mark.parametrize("merge", ["concat", "sum", "ave", "mul"])
@pytest.mark.parametrize("ret_seq", [False, True])
def test_bidirectional(tmp_path, merge, ret_seq):
    layers = [layer("Bidirectional", "bidi", batch_input=[None, S, C], merge_mode=merge,
                    layer={"class_name": "LSTM",
                           "config": {"name": "lstm", "units": U, "return_sequences": ret_seq,
                                      "recurrent_activation": "sigmoid"}})]
    _, spec = _check(tmp_path, layers, _x(2, S, C))
    names = {tk.split_name(n)[0] for n, _ in spec.init(0).named_parameters()}
    assert names == {"bidi/forward_lstm", "bidi/backward_lstm"}


def test_text_model_with_time_distributed_head(tmp_path):
    """Embedding -> causal Conv1D -> GRU(return_sequences) -> TimeDistributed
    Dense softmax (stripped) -> token logits, and its bf16 import."""
    layers = [layer("Embedding", "emb", batch_input=[None, S], input_dim=13, output_dim=4),
              layer("Conv1D", "c", filters=4, kernel_size=2, padding="causal"),
              _rnn("GRU", return_sequences=True),
              layer("TimeDistributed", "td", layer={
                  "class_name": "Dense", "config": {"units": 13, "activation": "softmax"}})]
    _, spec = _check(tmp_path, layers, _tokens())
    assert spec.name.endswith(":logits") and spec.output_shape == (S, 13)
    _, bf16 = _check(tmp_path / "bf16", layers, _tokens(), dtype="bfloat16")
    assert bf16.apply(bf16.init(0), torch.as_tensor(_tokens())).dtype == torch.bfloat16


def test_unit_forget_bias_and_default_warnings(tmp_path):
    path = write_model(tmp_path, sequential([layer("LSTM", "l", batch_input=[None, 4, 3],
                                                   units=2)]))
    with pytest.warns(UserWarning, match="recurrent_activation"):
        spec = tk.spec_from_keras_json(path, device="cpu")
    np.testing.assert_array_equal(spec.init(0).tree()["l"]["bias"].detach().numpy(),
                                  [0, 0, 1, 1, 0, 0, 0, 0])


def _h5(path, model_config, groups):
    """``groups``: ``{layer: [(weight path, array)]}`` in Keras' layout."""
    import h5py

    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(model_config)
        mw = f.create_group("model_weights")
        mw.attrs["layer_names"] = [n.encode() for n in groups]
        for lname, ws in groups.items():
            g = mw.create_group(lname)
            g.attrs["weight_names"] = [n.encode() for n, _ in ws]
            for n, a in ws:
                g.create_dataset(n, data=a)
    return path


def _rnn_weights(seed, units=U, gates=4):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * 0.5).astype(np.float32)
            for shape in ((C, gates * units), (units, gates * units), (gates * units,))]


def test_h5_tf2_nested_rnn_names(tmp_path):
    pytest.importorskip("h5py")
    k, rk, b = _rnn_weights(5)
    mc = {"class_name": "Sequential", "config": [
        _rnn("LSTM", "lstm", batch_input=[None, S, C])]}
    path = _h5(str(tmp_path / "m.h5"), mc, {"lstm": [
        (f"lstm/lstm_cell/{n}:0", a) for n, a in zip(("kernel", "recurrent_kernel", "bias"),
                                                     (k, rk, b))]})
    _, spec = both(path, _x(2, S, C), loader="h5")
    np.testing.assert_array_equal(spec.init(0).tree()["lstm"]["kernel"].detach().numpy(), k)


def test_h5_bidirectional_scoped_names(tmp_path):
    pytest.importorskip("h5py")
    mc = {"class_name": "Sequential", "config": [{
        "class_name": "Bidirectional",
        "config": {"name": "bidi", "batch_input_shape": [None, S, C],
                   "layer": {"class_name": "GRU", "config": {
                       "name": "gru", "units": U, "reset_after": True,
                       "recurrent_activation": "sigmoid"}}}}]}
    ws = []
    for seed, d in enumerate(("forward_gru", "backward_gru")):
        k, rk, b = _rnn_weights(seed, gates=3)
        b = np.stack([b, b * 0.5])  # reset_after: [2, 3U]
        ws += [(f"{d}/gru_cell/{n}:0", a) for n, a in zip(("kernel", "recurrent_kernel",
                                                           "bias"), (k, rk, b))]
    path = _h5(str(tmp_path / "m.h5"), mc, {"bidi": ws})
    _, spec = both(path, _x(2, S, C), loader="h5")
    assert set(spec.init(0).tree()) == {"bidi/forward_gru", "bidi/backward_gru"}


def test_h5_layer_named_forward_is_not_a_scope(tmp_path):
    pytest.importorskip("h5py")
    kernel = np.ones((3, 2), np.float32)
    mc = {"class_name": "Sequential", "config": [
        layer("Dense", "forward_head", batch_input=[None, 3], units=2, use_bias=False)]}
    path = _h5(str(tmp_path / "m.h5"), mc,
               {"forward_head": [("forward_head/kernel:0", kernel)]})
    _, spec = both(path, _x(2, 3), loader="h5")
    assert set(spec.init(0).tree()) == {"forward_head"}


def test_dynamic_sequence_dim_raises_as_jax(tmp_path):
    from distriflow_tpu.models import keras_import as jk

    path = write_model(tmp_path, sequential([_rnn("LSTM", batch_input=[None, None, C])]))
    with pytest.raises(ValueError) as want:
        jk.spec_from_keras_json(path)
    with pytest.raises(ValueError) as got:
        tk.spec_from_keras_json(path, device="cpu")
    assert str(got.value) == str(want.value)
    topo = sequential([_rnn("LSTM", batch_input=[None, None, C])])
    path = write_model(tmp_path / "given", topo, random_weights(topo, input_shape=(S, C)))
    both(path, _x(2, S, C), input_shape=(S, C))
