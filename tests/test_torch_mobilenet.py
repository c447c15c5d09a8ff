"""Port parity: MobileNetV2 and its training path
(``distriflow_tpu_torch/models/mobilenet.py``, ``models/module_model.py``,
``models/convert.py::mobilenet_params_from_jax``, ``with_uint8_inputs``,
``fetch_model``, ``data/prefetch.py``, ``train/loop.py``).

The port with weights carried over from the JAX spec, against that spec on
the same numpy batch, at ``image_size=32, classes=8, width=0.25``, B 2 (the
fused branch runs the JAX Pallas kernel in interpret mode):

- logits and every parameter's gradient for each ``depthwise_impl`` at
  f32: logits within 1e-4, gradients within a relative Frobenius error of
  1e-4 (the same arithmetic in another order; logits measured 2.8e-6);
- logits for the one-pass GroupNorm, the frozen BatchNorm, and the fused
  model in bf16. bf16 rounds the convolutions and the GroupNorm outputs of
  52 layers at slightly other points in the two frameworks: the port's
  bf16 logits must lie no farther from JAX's bf16 logits than 2x the
  distance of JAX's bf16 logits from its own f32 ones (measured 0.070
  against 0.124);
- three ``SyncTrainer`` steps (``with_uint8_inputs``, sparse CE,
  momentum 0.05, f32, B 8) from flax's own init, with the ``"conv"``
  depthwise and with the ``"fused"`` one at the model's default f32 (the
  JAX side runs its Pallas kernel in interpret mode, the port the
  kernels' plain versions): losses within 1e-5 relative, parameters after
  within 1e-4 (conv measured 3.4e-6 and 4.8e-5). Momentum 0.05 is too
  large a step for this small model (its loss rises), so each step
  amplifies the last one's rounding differences; from the perturbed test
  tree above they outgrow the limits by the third step;
- the fused model's gate: at width 1.4 and 224 px both packages send
  112x112x144 at stride 2 to the unfused branch in f32 (JAX's VMEM
  estimate at 4 bytes an element) and fuse it in bf16, and agree on every
  other depthwise shape; the fused model builds on CUDA in bf16 and f32
  and refuses any other dtype by name.

The loop (``run_chunked`` with K 1 and K 2, ``evaluate_dataset`` with a
padded tail), the data stream and the wire cast are held against their
own contracts and the JAX package's outputs.
"""

import dataclasses
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distriflow_tpu.data.prefetch import sampling_iterator as jax_sampling
from distriflow_tpu.data.prefetch import to_uint8_wire as jax_wire
from distriflow_tpu.models.base import with_uint8_inputs as jax_uint8
from distriflow_tpu.models.mobilenet import mobilenet_v2 as jax_mobilenet
from distriflow_tpu.parallel import data_parallel_mesh
from distriflow_tpu.train.sync import SyncTrainer as JaxTrainer
from distriflow_tpu_torch.data.prefetch import (
    prefetch_to_device,
    sampling_iterator,
    to_uint8_wire,
)
from distriflow_tpu_torch.models.base import SpecModel, fetch_model, with_uint8_inputs
from distriflow_tpu_torch.models.convert import mobilenet_params_from_jax
from distriflow_tpu_torch.models.mobilenet import mobilenet_v2
from distriflow_tpu_torch.models.module_model import DistributedModuleModel
from distriflow_tpu_torch.train.loop import evaluate_dataset, run_chunked
from distriflow_tpu_torch.train.sync import SyncTrainer

pytestmark = pytest.mark.port
torch.set_num_threads(2)

SIZE = dict(image_size=32, classes=8, width=0.25)
B = 2


def _x(seed=0, b=B):
    return np.random.RandomState(seed).rand(b, 32, 32, 3).astype(np.float32)


def _y(seed=0, b=B):
    return np.eye(8, dtype=np.float32)[np.random.RandomState(seed + 100).randint(0, 8, b)]


def _jax_params(spec, seed=0):
    """Random params of the spec's tree (scales near 1, biases near 0, so
    every affine and statistic matters), as numpy."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(spec.init, jax.random.PRNGKey(0))

    def draw(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        base = 1.0 if name in ("scale", "frozen_var") else 0.0
        spread = 0.1 if name != "kernel" else 1.0 / np.sqrt(np.prod(s.shape[:-1]))
        a = base + spread * rng.randn(*s.shape)
        return np.abs(a).astype(np.float32) if name == "frozen_var" else a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _port_model(tree, **kw):
    spec = mobilenet_v2(**SIZE, device="cpu", **kw)
    model = spec.init(0)
    model.load_state_dict(mobilenet_params_from_jax(tree), strict=True)
    return spec, model


def _torch_dtype(jdtype):
    return torch.bfloat16 if jdtype == jnp.bfloat16 else torch.float32


@functools.lru_cache(maxsize=None)
def _jax_logits_and_grads(impl):
    spec = jax_mobilenet(**SIZE, depthwise_impl=impl)
    tree = _jax_params(spec)
    x, y = jnp.asarray(_x()), jnp.asarray(_y())

    @jax.jit
    def run(p):
        return spec.apply(p, x), jax.grad(lambda q: spec.loss_fn(q, x, y))(p)

    logits, grads = run(tree)
    return tree, np.asarray(logits), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("impl", ["fused", "shift", "conv"])
def test_logits_and_grads_match_jax(impl):
    tree, want_logits, want_grads = _jax_logits_and_grads(impl)
    spec, model = _port_model(tree, depthwise_impl=impl)
    logits = spec.apply(model, torch.from_numpy(_x()))
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, atol=1e-4, rtol=0)
    _, grads = spec.grad_fn()(model, torch.from_numpy(_x()), torch.from_numpy(_y()))
    want = mobilenet_params_from_jax(want_grads)
    assert set(grads) == set(want)
    for name, g in grads.items():
        rel = float((g - want[name]).norm() / want[name].norm().clamp_min(1e-30))
        assert rel <= 1e-4, (name, rel)


@pytest.mark.parametrize("impl,gn_impl,norm,dtype", [
    ("fused", "onepass", "group", jnp.float32),
    ("shift", "onepass", "group", jnp.float32),
    ("conv", "flax", "batch", jnp.float32),
    ("fused", "flax", "group", jnp.bfloat16),
])
def test_logits_match_jax(impl, gn_impl, norm, dtype):
    spec = jax_mobilenet(**SIZE, depthwise_impl=impl, gn_impl=gn_impl, norm=norm, dtype=dtype)
    if dtype == jnp.bfloat16:
        tree, f32_logits, _ = _jax_logits_and_grads(impl)
    else:
        tree = _jax_params(spec)
    want = np.asarray(jax.jit(spec.apply)(tree, jnp.asarray(_x())).astype(jnp.float32))
    pspec, model = _port_model(tree, depthwise_impl=impl, gn_impl=gn_impl, norm=norm,
                               dtype=_torch_dtype(dtype))
    got = pspec.apply(model, torch.from_numpy(_x())).detach().float().numpy()
    if dtype == jnp.bfloat16:
        assert np.abs(got - want).max() <= 2 * np.abs(want - f32_logits).max()
    else:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("impl,norm", [("fused", "group"), ("shift", "group"),
                                       ("conv", "group"), ("conv", "batch")])
def test_converter_keys_and_bits(impl, norm):
    spec = jax_mobilenet(**SIZE, depthwise_impl=impl, norm=norm)
    tree = _jax_params(spec, seed=3)
    sd = mobilenet_params_from_jax(tree)
    model = mobilenet_v2(**SIZE, depthwise_impl=impl, norm=norm, device="cpu").init(0)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not missing and not unexpected
    flat = {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree["params"])[0]}
    assert set(flat) == set(sd)
    for name, a in flat.items():
        t = model.state_dict()[name]
        assert t.dtype == torch.float32, name
        if name.endswith("Conv_0.kernel"):
            a = a.transpose(3, 2, 0, 1)
        assert np.array_equal(t.numpy().reshape(a.shape).view(np.uint32), a.view(np.uint32)), name
    # the frozen BatchNorm statistics stay out of the optimizer (JAX's mask)
    if norm == "batch":
        trainer = SyncTrainer(mobilenet_v2(**SIZE, norm=norm, device="cpu"))
        trainer.init()
        frozen = [n for n in trainer.state.params if n.rsplit(".", 1)[-1].startswith("frozen_")]
        assert frozen and not any(n in trainer.state.opt_state.get("trace", {}) for n in frozen)


def _wire_data(n=16, seed=5):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 32, 32, 3) * 255).astype(np.uint8), rng.randint(0, 8, n).astype(np.int32)


def _three_steps_match_jax(devices, impl):
    # the CLI's u8 wire format: raw pixels normalised on the device, sparse CE
    jspec = dataclasses.replace(jax_uint8(jax_mobilenet(**SIZE, depthwise_impl=impl)),
                                loss="sparse_softmax_cross_entropy")
    jt = JaxTrainer(jspec, mesh=data_parallel_mesh(devices[:1]), optimizer="momentum",
                    learning_rate=0.05)
    jt.init(jax.random.PRNGKey(0))  # flax's init, carried over: what the CLI trains from
    tree = jax.tree.map(np.asarray, jt.get_params())
    pspec = dataclasses.replace(with_uint8_inputs(mobilenet_v2(**SIZE, depthwise_impl=impl,
                                                               device="cpu")),
                                loss="sparse_softmax_cross_entropy")
    pt = SyncTrainer(pspec, optimizer="momentum", learning_rate=0.05)
    pt.init()
    pt.set_params(mobilenet_params_from_jax(tree))
    x, y = _wire_data(8)
    for _ in range(3):
        lj, lp = jt.step((x, y)), pt.step((x, y))
        assert abs(lp - lj) <= 1e-5 * abs(lj), (lp, lj)
    want = mobilenet_params_from_jax(jax.tree.map(np.asarray, jt.get_params()))
    for name, p in pt.get_params().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-4, rtol=0,
                                   err_msg=name)


def test_sync_trainer_three_steps_match_jax(devices):
    _three_steps_match_jax(devices, "conv")


def test_sync_trainer_three_steps_fused_f32_match_jax(devices):
    # the fused depthwise at the model's default f32: JAX's Pallas kernel
    # (interpret mode) against the port's kernels' plain versions
    assert inspect.signature(mobilenet_v2).parameters["dtype"].default is torch.float32
    _three_steps_match_jax(devices, "fused")


def _gate_calls(monkeypatch, module, run):
    """``[(h, w, c, stride, itemsize, admitted)]`` of every gate call
    ``run`` makes through ``module.depthwise_gn_supported``."""
    calls, real = [], module.depthwise_gn_supported

    def gate(h, w, c, stride=1, group_size=8, itemsize=4):
        ok = real(h, w, c, stride, group_size, itemsize)
        calls.append((h, w, c, stride, itemsize, ok))
        return ok

    with monkeypatch.context() as m:
        m.setattr(module, "depthwise_gn_supported", gate)
        run()
    return calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_gate_at_width_1_4_and_224px_matches_jax(monkeypatch, dtype):
    import warnings

    from distriflow_tpu.ops import depthwise_gn as jax_dg
    from distriflow_tpu_torch.models import mobilenet as port_mn
    from distriflow_tpu_torch.ops.depthwise_gn import _geometry

    size = dict(image_size=224, classes=1000, width=1.4)
    jspec = jax_mobilenet(**size, depthwise_impl="fused", dtype=getattr(jnp, dtype))
    x = jax.ShapeDtypeStruct((1, 224, 224, 3), jnp.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        params = jax.eval_shape(jspec.init, jax.random.PRNGKey(0))
        # traced only: the JAX branch is chosen while tracing, nothing runs
        want = _gate_calls(monkeypatch, jax_dg, lambda: jax.eval_shape(jspec.apply, params, x))
        # the port's model on the meta device: shapes only; the fused
        # function is replaced by an empty output of its shape
        model = port_mn.MobileNetV2(classes=1000, width=1.4, dtype=getattr(torch, dtype),
                                    depthwise_impl="fused").to("meta")
        fused = []

        def record(xd, w, scale, bias, stride, *rest):
            fused.append((*xd.shape[1:], stride))
            oh, ow = _geometry(xd.shape[1], xd.shape[2], stride)[2:]
            return xd.new_empty(xd.shape[0], oh, ow, xd.shape[3])

        monkeypatch.setattr(port_mn, "depthwise3x3_groupnorm", record)
        got = _gate_calls(monkeypatch, port_mn,
                          lambda: model(torch.empty(1, 224, 224, 3, device="meta")))
    assert got == want and len(got) == 17
    assert fused == [(h, w, c, s) for h, w, c, s, _, ok in got if ok]
    gated = [(h, w, c, s) for h, w, c, s, _, ok in got if not ok]
    assert gated == ([(112, 112, 144, 2)] if dtype == "float32" else [])
    assert {item for *_, item, _ in got} == {4 if dtype == "float32" else 2}


@pytest.fixture
def fake_card(monkeypatch):
    """``torch.cuda.is_available()`` reports a card, so that entry points
    resolve ``cuda`` (nothing may allocate on it here)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)


def test_fused_model_on_cuda_takes_bf16_and_f32_and_refuses_others(fake_card):
    for dtype in (torch.float32, torch.bfloat16):
        spec = mobilenet_v2(**SIZE, dtype=dtype, depthwise_impl="fused", device="cuda")
        assert spec.device.type == "cuda"
    with pytest.raises(NotImplementedError, match="torch.float16"):
        mobilenet_v2(**SIZE, dtype=torch.float16, depthwise_impl="fused", device="cuda")
    mobilenet_v2(**SIZE, dtype=torch.float16, depthwise_impl="shift", device="cuda")


def _port_trainer(seed=0):
    spec = dataclasses.replace(with_uint8_inputs(mobilenet_v2(**SIZE, depthwise_impl="fused",
                                                              device="cpu")),
                               loss="sparse_softmax_cross_entropy")
    trainer = SyncTrainer(spec, optimizer="momentum", learning_rate=0.05)
    trainer.init(seed)
    return trainer


def test_run_chunked_k1_equals_k2_and_prefetch():
    x, y = _wire_data()
    one, two = _port_trainer(), _port_trainer()
    r1 = run_chunked(one, prefetch_to_device(sampling_iterator(x, y, 4, steps=4, seed=1),
                                             "cpu"), steps=4)
    r2 = run_chunked(two, sampling_iterator(x, y, 4, steps=4, seed=1), steps=4,
                     steps_per_dispatch=2)
    assert (r1.steps_run, r1.timed_steps, r2.steps_run, r2.timed_steps) == (4, 3, 4, 2)
    assert r1.last_loss == r2.last_loss and np.isfinite(r1.last_loss)
    for name, p in one.get_params().items():
        assert torch.equal(p, two.get_params()[name]), name
    short = run_chunked(_port_trainer(), sampling_iterator(x, y, 4, steps=3), steps=4)
    assert short.ran_dry and short.steps_run == 3 and "ended early" in short.tail_note(4)


def test_evaluate_dataset_padded_tail_equals_whole_array():
    trainer = _port_trainer()
    x, y = _wire_data(10)
    whole = trainer.evaluate(x, y)
    chunked = evaluate_dataset(trainer.evaluate, x, y, batch_size=4, divisor=4)
    np.testing.assert_allclose(chunked, whole, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(evaluate_dataset(trainer.evaluate, x, y, batch_size=3), whole,
                               rtol=1e-6, atol=1e-6)


def test_sampling_stream_and_wire_equal_jax():
    x, y = _wire_data(20)
    for (a, b), (c, d) in zip(sampling_iterator(x, y, 6, steps=3, seed=7),
                              jax_sampling(x, y, 6, steps=3, seed=7)):
        assert np.array_equal(a, np.asarray(c)) and np.array_equal(b, np.asarray(d))
    raw = np.random.RandomState(0).rand(3, 4, 4, 3) * 255
    for got, want in zip(to_uint8_wire(raw, [1, 2, 3]), jax_wire(raw, [1, 2, 3])):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    for bad in (raw / 255.0, raw - 10.0):
        with pytest.raises(ValueError):
            to_uint8_wire(bad, [1, 2, 3])
    batches = list(prefetch_to_device(iter([(x[:2], y[:2]), (x[2:4], y[2:4]), (x[4:6], y[4:6])]),
                                      "cpu", size=2))
    assert [int(b[1][0]) for b in batches] == [y[0], y[2], y[4]]
    assert all(isinstance(t, torch.Tensor) for b in batches for t in b)
    # a mesh is ported: on a one-rank mesh every batch arrives whole
    # (the multi-rank slices: tests/test_torch_parallel.py)
    import torch.distributed as dist

    from distriflow_tpu_torch.parallel import data_parallel_mesh, ensure_process_group

    assert ensure_process_group("cpu")
    try:
        on_mesh = list(prefetch_to_device(iter([(x[:2], y[:2])]), mesh=data_parallel_mesh("cpu")))
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(on_mesh[0][1].numpy(), y[:2])
    with pytest.raises(ValueError):
        prefetch_to_device(iter([]), "cpu", size=0)


def test_uint8_spec_rejects_float_and_fetch_model_sources(tmp_path):
    spec = with_uint8_inputs(mobilenet_v2(**SIZE, device="cpu"))
    model = spec.init(0)
    with pytest.raises(TypeError):
        spec.apply(model, torch.zeros(1, 32, 32, 3))
    assert spec.apply(model, torch.zeros(1, 32, 32, 3, dtype=torch.uint8)).shape == (1, 8)
    assert isinstance(fetch_model(spec), SpecModel)
    assert isinstance(fetch_model(lambda: spec), SpecModel)
    dm = DistributedModuleModel(lambda: torch.nn.Linear(4, 2), input_shape=(4,),
                                output_shape=(2,), device="cpu")
    assert fetch_model(dm) is dm and dm.predict(np.zeros((3, 4), np.float32)).shape == (3, 2)
    with pytest.raises(TypeError):
        fetch_model(lambda: 3)
    # string sources resolve as JAX's do: a missing model.json, and a
    # directory with no checkpoint, raise FileNotFoundError
    with pytest.raises(FileNotFoundError):
        fetch_model(str(tmp_path / "model.json"), device="cpu")
    with pytest.raises(FileNotFoundError):
        fetch_model(str(tmp_path / "checkpoints"), device="cpu")
    for bad in (dict(norm="layer"), dict(depthwise_impl="dw"), dict(gn_impl="x"),
                dict(depthwise_impl="fused", norm="batch")):
        with pytest.raises(ValueError):
            mobilenet_v2(device="cpu", **bad)
