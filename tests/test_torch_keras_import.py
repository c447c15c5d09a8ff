"""The port's Keras importer (``distriflow_tpu_torch/models/keras_import.py``)
against JAX's (``distriflow_tpu/models/keras_import.py``) on the CPU.

Every test writes its own ``model.json`` (and weight shards) into
``tmp_path``; both packages load the same file, and forward outputs and
gradients are held within f32 1e-5 (absolute plus relative) or bf16 2e-2
(``tests/torch_keras_cases.py``). Covered: the ConvNet, the graph merges,
multi-input/multi-output heads with their softmax strips, a shared layer,
the depthwise multiplier order, separable and transposed convolutions,
upsampling, BatchNormalization (moving statistics trained, as under
``jax.grad``) and LayerNormalization, the pools, the advanced activations
and the structural layers, every error JAX raises, cold-init statistics,
the export round trip and the wire tree (keystr paths and bytes)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distriflow_tpu.models import keras_import as jk
from distriflow_tpu_torch.models import keras_import as tk
from torch_keras_cases import (
    F32_TOL,
    assert_close,
    both,
    functional,
    graph_input,
    layer,
    node,
    random_weights,
    sequential,
    write_model,
)

pytestmark = pytest.mark.port


def _x(*shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _onehot(n, k, seed=2):
    return np.eye(k, dtype=np.float32)[np.random.default_rng(seed).integers(0, k, n)]


def _load(tmp_path, topo, input_shape=None):
    return write_model(tmp_path, topo, random_weights(topo, input_shape=input_shape))


def _convnet(padding="valid", strides=(1, 1), dilation=(1, 1)):
    return sequential([
        layer("Conv2D", "conv2d_1", batch_input=[None, 8, 8, 2], filters=4,
              kernel_size=[3, 3], strides=list(strides), dilation_rate=list(dilation),
              padding=padding, activation="linear", use_bias=True),
        layer("Activation", "activation_1", activation="relu"),
        layer("MaxPooling2D", "max_pooling2d_1", pool_size=[2, 2], strides=[2, 2],
              padding="valid"),
        layer("Dropout", "dropout_1", rate=0.25),
        layer("Flatten", "flatten_1"),
        layer("Dense", "dense_1", units=8, activation="relu"),
        layer("Dense", "dense_2", units=3, activation="softmax"),
    ])


@pytest.mark.parametrize("padding,strides,dilation", [
    ("valid", (1, 1), (1, 1)), ("same", (1, 1), (1, 1)), ("same", (2, 2), (1, 1)),
    ("same", (1, 1), (2, 2))])
def test_convnet_forward_and_grads(tmp_path, padding, strides, dilation):
    path = _load(tmp_path, _convnet(padding, strides, dilation))
    _, spec = both(path, _x(3, 8, 8, 2), _onehot(3, 3))
    assert spec.name == "keras:model:logits"


def test_convnet_bf16_forward_and_grads(tmp_path):
    path = _load(tmp_path, _convnet("same"))
    both(path, _x(3, 8, 8, 2), _onehot(3, 3), dtype="bfloat16")


def test_softmax_kept_when_asked(tmp_path):
    path = _load(tmp_path, _convnet())
    _, spec = both(path, _x(2, 8, 8, 2), logits_output=False)
    assert spec.name == "keras:model"
    out = spec.apply(spec.init(0), torch.as_tensor(_x(2, 8, 8, 2)))
    np.testing.assert_allclose(out.sum(-1).detach().numpy(), 1.0, rtol=1e-6)


def _merge_graph(merge):
    conv = node("Conv2D", "conv_1", ["input_1"], filters=2, kernel_size=[1, 1],
                padding="same", activation="linear", use_bias=False)
    return functional([
        graph_input("input_1", (4, 4, 2)), conv,
        node(merge, "merge_1", ["conv_1", "input_1"], axis=-1),
        node("GlobalAveragePooling2D", "gap_1", ["merge_1"]),
        node("Dense", "dense_out", ["gap_1"], units=3, activation="softmax", use_bias=True),
    ], ["input_1"], ["dense_out"])


@pytest.mark.parametrize("merge", ["Add", "Subtract", "Multiply", "Average", "Maximum",
                                   "Minimum", "Concatenate"])
def test_graph_merges(tmp_path, merge):
    path = _load(tmp_path, _merge_graph(merge))
    _, spec = both(path, _x(3, 4, 4, 2), _onehot(3, 3))
    assert spec.name.endswith(":logits")


def test_shared_layer_at_a_second_node_imports_one_weight_set(tmp_path):
    """As JAX's importer: a layer called at two nodes lowers twice over
    one weight set (the ``shared_output`` graph of JAX's tests)."""
    topo = _merge_graph("Add")
    layers = topo["modelTopology"]["model_config"]["config"]["layers"]
    layers.append(node("Dense", "head_2", ["gap_1"], units=2))
    layers[3]["inbound_nodes"].append([["merge_1", 0, 0, {}]])  # gap_1 at node 1
    path = _load(tmp_path, topo)
    _, spec = both(path, _x(2, 4, 4, 2), _onehot(2, 3))
    names = {tk.split_name(n)[0] for n, _ in spec.init(0).named_parameters()}
    assert names == {"conv_1", "dense_out", "head_2"}


def _two_in_two_out():
    """Tokens -> Embedding -> GAP, floats -> Dense, concatenated, two
    softmax heads (one a Dense activation, one a Softmax layer)."""
    return functional([
        graph_input("tokens", (5,)), graph_input("feats", (3,)),
        node("Embedding", "emb", ["tokens"], input_dim=11, output_dim=4),
        node("GlobalAveragePooling1D", "pool", ["emb"]),
        node("Dense", "proj", ["feats"], units=4, activation="tanh"),
        node("Concatenate", "cat", ["pool", "proj"], axis=-1),
        node("Dense", "head_a", ["cat"], units=3, activation="softmax"),
        node("Dense", "head_b_pre", ["cat"], units=2),
        node("Softmax", "head_b", ["head_b_pre"], axis=-1),
    ], ["tokens", "feats"], ["head_a", "head_b"])


def test_multi_input_multi_output_heads_strip(tmp_path):
    path = _load(tmp_path, _two_in_two_out())
    tokens = np.random.default_rng(3).integers(0, 11, (4, 5)).astype(np.int32)
    x = (tokens, _x(4, 3))
    _, spec = both(path, x, (_onehot(4, 3), _onehot(4, 2)))
    assert spec.name.endswith(":logits")
    assert spec.input_shape == ((5,), (3,)) and spec.output_shape == ((3,), (2,))


def test_depthwise_multiplier_channel_order(tmp_path):
    """``depth_multiplier=2``: TF's output channels are channel-major
    (c * mult + m), as in JAX's test of the same name."""
    topo = sequential([layer("DepthwiseConv2D", "dw_1", batch_input=[None, 2, 2, 2],
                             kernel_size=[1, 1], depth_multiplier=2, padding="valid",
                             use_bias=False)])
    kernel = np.zeros((1, 1, 2, 2), np.float32)
    for c in range(2):
        for m in range(2):
            kernel[0, 0, c, m] = 10 * c + m
    path = write_model(tmp_path, topo, [("dw_1/depthwise_kernel", kernel)])
    x = np.zeros((1, 2, 2, 2), np.float32)
    x[..., 1] = 1.0
    _, spec = both(path, x)
    out = spec.apply(spec.init(0), torch.as_tensor(x)).detach().numpy()
    np.testing.assert_allclose(out[0, 0, 0], [0.0, 0.0, 10.0, 11.0])


CONV_LAYERS = {
    "depthwise_dilated": [layer("DepthwiseConv2D", "dw", batch_input=[None, 7, 7, 3],
                                kernel_size=[3, 3], depth_multiplier=2, padding="same",
                                dilation_rate=[2, 2], use_bias=True)],
    "depthwise_strided": [layer("DepthwiseConv2D", "dw", batch_input=[None, 7, 7, 3],
                                kernel_size=[3, 3], strides=[2, 2], padding="same",
                                activation="relu6")],
    "separable": [layer("SeparableConv2D", "sep", batch_input=[None, 6, 6, 3], filters=4,
                        kernel_size=[3, 3], depth_multiplier=2, padding="same",
                        activation="relu")],
    **{f"transpose_{p}_k{k}_s{s}": [layer(
        "Conv2DTranspose", "ct", batch_input=[None, 3, 4, 2], filters=3, kernel_size=[k, k],
        strides=[s, s], padding=p)]
       for p in ("same", "valid") for k, s in ((3, 1), (3, 2), (2, 2), (1, 3), (4, 2))},
    "upsampling": [layer("UpSampling2D", "up", batch_input=[None, 2, 3, 2], size=[2, 3]),
                   layer("Conv2D", "c", filters=2, kernel_size=[3, 3], padding="same")],
}


@pytest.mark.parametrize("case", sorted(CONV_LAYERS))
def test_conv_layers(tmp_path, case):
    topo = sequential(CONV_LAYERS[case])
    path = _load(tmp_path, topo)
    shape = CONV_LAYERS[case][0]["config"]["batch_input_shape"][1:]
    out = int(np.prod(jk.spec_from_keras_json(path).output_shape))
    both(path, _x(2, *shape), _x(2, *jk.spec_from_keras_json(path).output_shape, seed=5)
         if out else None, loss="mean_squared_error")


NORM_POOL_LAYERS = {
    "batchnorm": [layer("BatchNormalization", "bn", batch_input=[None, 4, 4, 3],
                        epsilon=1e-3)],
    "batchnorm_no_affine": [layer("BatchNormalization", "bn", batch_input=[None, 5, 3],
                                  scale=False, center=False)],
    "layernorm": [layer("LayerNormalization", "ln", batch_input=[None, 4, 6], epsilon=1e-5)],
    **{f"{kind}pool2d_{p}": [layer(f"{kind.capitalize()}Pooling2D", "pool",
                                   batch_input=[None, 5, 7, 2], pool_size=[2, 3],
                                   strides=[2, 2], padding=p)]
       for kind in ("max", "average") for p in ("valid", "same")},
    **{f"{kind}pool1d_{p}": [layer(f"{kind.capitalize()}Pooling1D", "pool",
                                   batch_input=[None, 7, 3], pool_size=3, strides=2,
                                   padding=p)]
       for kind in ("max", "average") for p in ("valid", "same")},
    "global_pools": [layer("GlobalMaxPooling2D", "gmp", batch_input=[None, 3, 4, 2])],
    "global_avg2d": [layer("GlobalAveragePooling2D", "gap", batch_input=[None, 3, 4, 2])],
    "global_1d": [layer("GlobalMaxPooling1D", "gmp", batch_input=[None, 5, 2])],
}


@pytest.mark.parametrize("case", sorted(NORM_POOL_LAYERS))
def test_norm_and_pool_layers(tmp_path, case):
    layers = NORM_POOL_LAYERS[case]
    path = _load(tmp_path, sequential(layers))
    shape = layers[0]["config"]["batch_input_shape"][1:]
    out_shape = jk.spec_from_keras_json(path).output_shape
    both(path, _x(3, *shape), _x(3, *out_shape, seed=6), loss="mean_squared_error")


ACT_LAYERS = {
    "leaky_elu_softmax": [layer("Dense", "d", batch_input=[None, 3], units=4),
                          layer("LeakyReLU", "lr", alpha=0.2), layer("ELU", "el", alpha=0.5),
                          layer("Softmax", "sm", axis=1)],
    "prelu_shared": [layer("Conv2D", "c", batch_input=[None, 3, 3, 2], filters=2,
                           kernel_size=[1, 1]),
                     layer("PReLU", "pr", shared_axes=[1, 2])],
    "relu_options": [layer("Dense", "d", batch_input=[None, 3], units=5),
                     layer("ReLU", "r", max_value=0.8, negative_slope=0.1, threshold=0.2)],
    **{f"activation_{a}": [layer("Dense", "d", batch_input=[None, 3], units=4,
                                 activation=a)]
       for a in ("relu6", "sigmoid", "hard_sigmoid", "tanh", "elu", "selu", "softplus",
                 "gelu", "swish", "exponential")},
}


@pytest.mark.parametrize("case", sorted(ACT_LAYERS))
def test_activation_layers(tmp_path, case):
    layers = ACT_LAYERS[case]
    path = _load(tmp_path, sequential(layers))
    shape = layers[0]["config"]["batch_input_shape"][1:]
    out_shape = jk.spec_from_keras_json(path, logits_output=False).output_shape
    for logits in (True, False):
        both(path, _x(4, *shape), _x(4, *out_shape, seed=7), loss="mean_squared_error",
             logits_output=logits)


STRUCT_LAYERS = {
    "pad_crop_2d": [layer("ZeroPadding2D", "zp", batch_input=[None, 3, 4, 2],
                          padding=[[1, 2], [0, 1]]),
                    layer("Cropping2D", "cr", cropping=[[0, 1], [1, 1]]),
                    layer("Conv2D", "c", filters=2, kernel_size=[2, 2])],
    "pad_crop_1d": [layer("ZeroPadding1D", "zp", batch_input=[None, 5, 2], padding=[2, 1]),
                    layer("Cropping1D", "cr", cropping=[1, 3]),
                    layer("Dense", "d", units=3)],
    "reshape_permute": [layer("Dense", "d", batch_input=[None, 6], units=12),
                        layer("Reshape", "rs", target_shape=[3, -1]),
                        layer("Permute", "pm", dims=[2, 1]),
                        layer("Flatten", "fl"), layer("Dense", "d2", units=2)],
    "repeat_vector": [layer("Dense", "d", batch_input=[None, 3], units=4),
                      layer("RepeatVector", "rv", n=3),
                      layer("TimeDistributed", "td",
                            layer={"class_name": "Dense", "config": {"units": 2}})],
    "time_distributed_softmax": [
        layer("InputLayer", "in", batch_input=[None, 4, 3]),
        layer("TimeDistributed", "td",
              layer={"class_name": "Dense", "config": {"units": 5, "activation": "softmax"}})],
}


@pytest.mark.parametrize("case", sorted(STRUCT_LAYERS))
def test_structural_layers(tmp_path, case):
    layers = STRUCT_LAYERS[case]
    path = _load(tmp_path, sequential(layers))
    shape = layers[0]["config"]["batch_input_shape"][1:]
    out_shape = jk.spec_from_keras_json(path).output_shape
    both(path, _x(2, *shape), _x(2, *out_shape, seed=8), loss="mean_squared_error")


def _err(cls, name, batch_input=None, **cfg):
    return sequential([layer(cls, name, batch_input=batch_input, **cfg)])


ERRORS = {
    "unsupported_layer": _err("Lambda", "lam", [None, 3]),
    "unsupported_activation": _err("Dense", "d", [None, 3], units=2, activation="mish"),
    "unsupported_initializer": _err("Dense", "d", [None, 3], units=2,
                                    kernel_initializer={"class_name": "Identity"}),
    "no_shape": _err("Dense", "d", units=2),
    "dynamic_dim": _err("Dense", "d", [None, None, 3], units=2),
    "duplicate_name": sequential([layer("Dense", "d", batch_input=[None, 3], units=2),
                                  layer("Dense", "d", units=2)]),
    "upsampling_bilinear": _err("UpSampling2D", "u", [None, 2, 2, 1],
                                interpolation="bilinear"),
    "transpose_dilation": _err("Conv2DTranspose", "t", [None, 2, 2, 1], filters=1,
                               kernel_size=[2, 2], dilation_rate=[2, 2]),
    "transpose_output_padding": _err("Conv2DTranspose", "t", [None, 2, 2, 1], filters=1,
                                     kernel_size=[2, 2], output_padding=[1, 1]),
    "layernorm_axis": _err("LayerNormalization", "ln", [None, 3, 4], axis=1),
    "layernorm_multi_axis": _err("LayerNormalization", "ln", [None, 3, 4], axis=[1, 2]),
    "embedding_rank": _err("Embedding", "e", [None, 3, 4], input_dim=5, output_dim=2),
    "embedding_mask_zero": _err("Embedding", "e", [None, 3], input_dim=5, output_dim=2,
                                mask_zero=True),
    "conv1d_padding": _err("Conv1D", "c", [None, 4, 2], filters=1, kernel_size=2,
                           padding="full"),
    "rnn_stateful": _err("LSTM", "l", [None, 3, 2], units=2, stateful=True),
    "rnn_go_backwards": _err("GRU", "g", [None, 3, 2], units=2, go_backwards=True),
    "rnn_rank": _err("SimpleRNN", "s", [None, 3], units=2),
    "bidi_inner": _err("Bidirectional", "b", [None, 3, 2],
                       layer={"class_name": "Dense", "config": {"units": 2}}),
    "bidi_merge": _err("Bidirectional", "b", [None, 3, 2], merge_mode="max",
                       layer={"class_name": "LSTM", "config": {"units": 2}}),
    "bidi_empty": _err("Bidirectional", "b", [None, 3, 2]),
    "crop_1d": _err("Cropping1D", "c", [None, 3, 2], cropping=[2, 1]),
    "crop_2d": _err("Cropping2D", "c", [None, 2, 2, 1], cropping=1),
    "permute": _err("Permute", "p", [None, 2, 3], dims=[1, 3]),
    "time_distributed_conv": _err("TimeDistributed", "t", [None, 3, 2],
                                  layer={"class_name": "Conv1D", "config": {}}),
    "time_distributed_rank": _err("TimeDistributed", "t", [None, 3],
                                  layer={"class_name": "Dense", "config": {"units": 1}}),
    "time_distributed_empty": _err("TimeDistributed", "t", [None, 3, 2]),
    "reshape_two_wildcards": _err("Reshape", "r", [None, 6], target_shape=[-1, -1]),
    "reshape_indivisible": _err("Reshape", "r", [None, 6], target_shape=[4, -1]),
    "model_class": {"modelTopology": {"model_config": {"class_name": "Graph", "config": {}}}},
    "graph_no_io": functional([graph_input("i", (2,))], [], ["i"]),
    "graph_cycle": functional([graph_input("i", (2,)), node("Dense", "a", ["b"], units=2),
                               node("Dense", "b", ["a"], units=2)], ["i"], ["a"]),
    "graph_stray_root": functional([graph_input("i", (2,)),
                                    {"name": "x", "class_name": "Dense",
                                     "config": {"units": 2}, "inbound_nodes": []}],
                                   ["i"], ["i"]),
    "graph_tensor_index": functional([graph_input("i", (2,)),
                                      {**node("Dense", "a", ["i"], units=2),
                                       "inbound_nodes": [[["i", 0, 1, {}]]]}], ["i"], ["a"]),
    "graph_merge_shapes": functional([graph_input("i", (2,)), node("Dense", "a", ["i"], units=3),
                                      node("Add", "m", ["a", "i"])], ["i"], ["m"]),
    "graph_concat_batch": functional([graph_input("i", (2,)),
                                      node("Concatenate", "m", ["i", "i"], axis=0)],
                                     ["i"], ["m"]),
    "graph_subtract_arity": functional([graph_input("i", (2,)),
                                        node("Subtract", "m", ["i", "i", "i"])], ["i"], ["m"]),
    "graph_shared_mismatch": functional([
        graph_input("i", (2,)), graph_input("j", (3,)),
        {**node("Dense", "d", ["i"], units=2),
         "inbound_nodes": [[["i", 0, 0, {}]], [["j", 0, 0, {}]]]}], ["i", "j"], ["d"]),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_errors_match_jax(tmp_path, case):
    path = write_model(tmp_path, ERRORS[case])
    with pytest.raises(Exception) as want:
        jk.spec_from_keras_json(path)
    with pytest.raises(Exception) as got:
        tk.spec_from_keras_json(path, device="cpu")
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


def test_weight_errors_match_jax(tmp_path):
    topo = _convnet()
    w = random_weights(topo)
    cases = {
        "shape": [(n, a[:1] if n == "dense_2/bias" else a) for n, a in w],
        "missing": [(n, a) for n, a in w if n != "dense_2/bias"],
    }
    for case, weights in cases.items():
        path = write_model(tmp_path / case, topo, weights)
        with pytest.raises(ValueError) as want:
            jk.spec_from_keras_json(path)
        with pytest.raises(ValueError) as got:
            tk.spec_from_keras_json(path, device="cpu")
        assert str(got.value) == str(want.value)
    quant = write_model(tmp_path / "quant", topo, w)
    meta = json.load(open(quant))
    meta["weightsManifest"][0]["weights"][0]["quantization"] = {"dtype": "uint8"}
    json.dump(meta, open(quant, "w"))
    wide = write_model(tmp_path / "wide", topo, w)
    meta = json.load(open(wide))
    meta["weightsManifest"][0]["weights"][0]["dtype"] = "float16"
    json.dump(meta, open(wide, "w"))
    for path in (quant, wide):
        with pytest.raises(ValueError) as want:
            jk.spec_from_keras_json(path)
        with pytest.raises(ValueError) as got:
            tk.spec_from_keras_json(path, device="cpu")
        assert str(got.value) == str(want.value)


def test_missing_shards_warn_and_cold_init(tmp_path):
    topo = _convnet()
    path = write_model(tmp_path, topo, random_weights(topo))
    (tmp_path / "group1-shard1of1").unlink()
    with pytest.warns(UserWarning, match="shard file is missing"):
        spec = tk.spec_from_keras_json(path, device="cpu")
    model = spec.init(0)
    assert float(model.tree()["dense_2"]["bias"].abs().sum()) == 0.0  # Zeros init
    cold = tk.spec_from_keras_json(path, device="cpu", load_weights=False).init(0)
    for (n, a), (_, b) in zip(model.named_parameters(), cold.named_parameters()):
        assert torch.equal(a, b), n


def test_shards_concatenate_in_manifest_order(tmp_path):
    topo = _convnet()
    w = random_weights(topo)
    path = write_model(tmp_path, topo, w, shards=("group1-shard1of3", "sub/group1-shard2of3",
                                                  "group1-shard3of3"))
    tree = tk.load_keras_weights(path, json.load(open(path))["weightsManifest"])
    want = jk.load_keras_weights(path, json.load(open(path))["weightsManifest"])
    for layer_name, ws in want.items():
        for wname, arr in ws.items():
            np.testing.assert_array_equal(tree[layer_name][wname], np.asarray(arr))


def test_cold_init_statistics(tmp_path):
    """Keras' default initializers, drawn from ``init(seed)``'s generator:
    glorot-uniform kernels inside sqrt(6 / (fan_in + fan_out)), orthogonal
    recurrent kernels (QᵀQ = I), ``unit_forget_bias`` ones on the forget
    block, zero biases; the same seed gives the same bits."""
    topo = sequential([
        layer("Dense", "d", batch_input=[None, 40], units=60),
        layer("Reshape", "r", target_shape=[6, 10]),
        layer("LSTM", "l", units=8, recurrent_activation="sigmoid", return_sequences=False),
        layer("Dense", "h", units=30, kernel_initializer={
            "class_name": "VarianceScaling",
            "config": {"scale": 2.0, "mode": "fan_in", "distribution": "normal"}}),
    ])
    spec = tk.spec_from_keras_json(write_model(tmp_path, topo), device="cpu")
    tree = spec.init(0).tree()
    limit = np.sqrt(6.0 / (40 + 60))
    k = tree["d"]["kernel"].detach().numpy()
    assert np.abs(k).max() <= limit and np.abs(k).max() > 0.9 * limit
    assert abs(k.std() - limit / np.sqrt(3)) < 0.1 * limit
    rk = tree["l"]["recurrent_kernel"].detach().numpy().astype(np.float64)  # [8, 32]
    np.testing.assert_allclose(rk @ rk.T, np.eye(8), atol=1e-5)
    np.testing.assert_array_equal(tree["l"]["bias"].detach().numpy(),
                                  np.r_[np.zeros(8), np.ones(8), np.zeros(16)])
    h = tree["h"]["kernel"].detach().numpy()
    std = np.sqrt(2.0 / 8)  # truncated normal at +-2 std, rescaled to std
    assert np.abs(h).max() <= 2 * std / 0.87962566103423978 + 1e-6
    assert abs(h.std() - std) < 0.15 * std
    assert float(tree["d"]["bias"].abs().sum()) == 0.0
    again = spec.init(0)
    other = spec.init(1)
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(spec.init(0).named_parameters(), again.named_parameters()))
    assert not torch.equal(other.tree()["d"]["kernel"], tree["d"]["kernel"])


def test_batchnorm_statistics_train_as_under_jax_grad(tmp_path):
    """Every leaf is a trained parameter, BatchNormalization's moving
    statistics too: a SpecModel step moves them by JAX's update."""
    from distriflow_tpu.models.base import SpecModel as JaxSpecModel
    from distriflow_tpu_torch.models.base import SpecModel

    topo = sequential([layer("Conv2D", "c", batch_input=[None, 4, 4, 2], filters=3,
                             kernel_size=[3, 3], padding="same"),
                       layer("BatchNormalization", "bn"), layer("Flatten", "f"),
                       layer("Dense", "d", units=2, activation="softmax")])
    path = write_model(tmp_path, topo, random_weights(topo))
    x, y = _x(4, 4, 4, 2), _onehot(4, 2)
    jm = JaxSpecModel(jk.spec_from_keras_json(path), learning_rate=0.1)
    tm = SpecModel(tk.spec_from_keras_json(path, device="cpu"), learning_rate=0.1)
    jm.update(jm.fit(x, y))
    tm.update(tm.fit(x, y))
    got = tm.get_params()
    want = jm.get_params()
    assert float(got["bn.moving_mean"].abs().sum()) > 0
    for n, v in got.items():
        layer_name, wname = tk.split_name(n)
        assert_close(v.numpy(), np.asarray(want[layer_name][wname]), F32_TOL, n)


def test_export_round_trip(tmp_path):
    """``export_keras_weights`` of a port model reloads to the same bits in
    the port and in JAX's importer."""
    topo = _convnet("same")
    src = write_model(tmp_path / "src", topo, random_weights(topo))
    spec = tk.spec_from_keras_json(src, device="cpu")
    model = spec.init(0)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1.5)
    out = tk.export_keras_weights(src, dict(model.named_parameters()), str(tmp_path / "out"))
    again = tk.spec_from_keras_json(out, device="cpu").init(0)
    for (n, a), (_, b) in zip(model.named_parameters(), again.named_parameters()):
        assert torch.equal(a, b), n
    jp = jk.spec_from_keras_json(out).init(jax.random.PRNGKey(0))
    for n, a in model.named_parameters():
        layer_name, wname = tk.split_name(n)
        np.testing.assert_array_equal(np.asarray(jp[layer_name][wname]), a.detach().numpy())
    # JAX's {layer: {weight}} tree exports the same file
    out2 = tk.export_keras_weights(src, model.tree(), str(tmp_path / "o2"))
    assert open(out2).read() == open(out).read()
    assert (tmp_path / "o2" / "group1-shard1of1").read_bytes() == \
        (tmp_path / "out" / "group1-shard1of1").read_bytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wire_tree_is_jaxs(tmp_path, dtype):
    """``to_wire`` gives JAX's ``{layer: {weight}}`` tree in the spec's
    dtype: the same keystr paths and the same serialized bytes, the
    Bidirectional scoped keys included; ``from_wire`` maps it back."""
    from distriflow_tpu.utils import serialization as jser
    from distriflow_tpu_torch.utils import serialization as tser

    topo = sequential([
        layer("Embedding", "emb", batch_input=[None, 4], input_dim=9, output_dim=3),
        layer("Bidirectional", "bidi", merge_mode="sum", layer={
            "class_name": "LSTM", "config": {"name": "lstm", "units": 2,
                                             "recurrent_activation": "sigmoid"}}),
        layer("Dense", "d", units=2)])
    path = write_model(tmp_path, topo, random_weights(topo))
    jspec = jk.spec_from_keras_json(path, dtype=getattr(jnp, dtype))
    tspec = tk.spec_from_keras_json(path, dtype=getattr(torch, dtype), device="cpu")
    wire = tspec.to_wire(dict(tspec.init(0).named_parameters()))
    assert set(wire) == {"emb", "bidi/forward_lstm", "bidi/backward_lstm", "d"}
    jbytes, jmeta = jser.flat_serialize(jser.serialize_tree(jspec.init(jax.random.PRNGKey(0))))
    tbytes, tmeta = tser.flat_serialize(tser.serialize_tree(wire))
    assert tbytes == jbytes and tmeta == jmeta
    back = tspec.from_wire(wire)
    assert set(back) == {n for n, _ in tspec.init(0).named_parameters()}


def test_jax_cold_init_carries_across(tmp_path):
    """JAX's own cold init, carried over by ``keras_params_from_jax``: the
    port computes JAX's forward from it."""
    from distriflow_tpu_torch.models.convert import keras_params_from_jax

    path = write_model(tmp_path, _two_in_two_out())
    jspec = jk.spec_from_keras_json(path)
    tspec = tk.spec_from_keras_json(path, device="cpu")
    jp = jspec.init(jax.random.PRNGKey(3))
    model = tspec.init(0)
    model.load_state_dict(keras_params_from_jax(jp), strict=True)
    x = (np.random.default_rng(4).integers(0, 11, (3, 5)).astype(np.int32), _x(3, 3))
    want = jspec.apply(jp, tuple(jnp.asarray(v) for v in x))
    got = tspec.apply(model, tuple(torch.as_tensor(v) for v in x))
    for g, w in zip(got, want):
        assert_close(g.detach().numpy(), np.asarray(w), F32_TOL)


def test_layer_names_with_dots_round_trip(tmp_path):
    topo = sequential([layer("Dense", "block.1%a", batch_input=[None, 3], units=2)])
    path = write_model(tmp_path, topo, random_weights(topo))
    _, spec = both(path, _x(2, 3), _x(2, 2), loss="mean_squared_error")
    model = spec.init(0)
    assert set(model.tree()) == {"block.1%a"}


def test_h5_topology_and_weights(tmp_path):
    h5py = pytest.importorskip("h5py")
    topo = _convnet("same")
    weights = random_weights(topo)
    path = str(tmp_path / "m.h5")
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(topo["modelTopology"]["model_config"])
        mw = f.create_group("model_weights")
        layers = sorted({n.split("/")[0] for n, _ in weights})
        mw.attrs["layer_names"] = [n.encode() for n in layers]
        for lname in layers:
            g = mw.create_group(lname)
            names = [f"{lname}/{w.split('/')[1]}:0" for w, _ in weights
                     if w.startswith(lname + "/")]
            g.attrs["weight_names"] = [n.encode() for n in names]
            for (w, a) in weights:
                if w.startswith(lname + "/"):
                    g.create_dataset(f"{lname}/{w.split('/')[1]}:0", data=a)
    both(path, _x(2, 8, 8, 2), _onehot(2, 3), loader="h5")
    with h5py.File(str(tmp_path / "bare.h5"), "w") as f:
        f.create_group("model_weights")
    for load in (jk.spec_from_keras_h5, lambda p: tk.spec_from_keras_h5(p, device="cpu")):
        with pytest.raises(ValueError, match="no model_config"):
            load(str(tmp_path / "bare.h5"))


def test_fused_loss_on_an_f32_cuda_model_is_refused_when_built(tmp_path, monkeypatch):
    """The spec states its device and dtype, so ``check_loss`` refuses a
    fused CE loss on a CUDA model whose logits the kernels do not take
    (f16) when it is built, and builds an f32 or bf16 one (driven on the
    CPU: nothing is allocated before the refusal)."""
    path = _load(tmp_path, _convnet())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(NotImplementedError, match="bf16"):
        tk.spec_from_keras_json(path, loss="fused_softmax_cross_entropy", device="cuda",
                                dtype=torch.float16)
    spec = tk.spec_from_keras_json(path, loss="fused_softmax_cross_entropy", device="cuda")
    assert spec.dtype == torch.float32
    spec = tk.spec_from_keras_json(path, loss="fused_softmax_cross_entropy", device="cuda",
                                   dtype=torch.bfloat16)
    assert spec.device == torch.device("cuda") and spec.dtype == torch.bfloat16
