"""Port parity: the model-level checkpoint calls ``save_model``/``load_model``
(``distriflow_tpu_torch/checkpoint/__init__.py``), the cases of the JAX
suite's ``tests/test_checkpoint.py`` (``test_model_save_load_resume``,
``test_model_load_wrong_arch_raises``) on the CPU: a model saved with its
spec name comes back from the port's zoo by that name and predicts the
same values bit for bit; a checkpoint loaded into another architecture
raises; a checkpoint without a resolvable name asks for ``spec=``.
"""

import pytest
import torch

from distriflow_tpu_torch.checkpoint import CheckpointStore, load_model, save_model
from distriflow_tpu_torch.models.base import SpecModel
from distriflow_tpu_torch.models.zoo import mnist_mlp

pytestmark = pytest.mark.port


def test_model_save_load_resume(tmp_path):
    model = SpecModel(mnist_mlp(device="cpu"), seed=3)  # zoo-default arch: name-based resume
    model.setup()
    x = torch.ones((2, 28, 28, 1))
    before = model.predict(x)
    assert save_model(CheckpointStore(str(tmp_path)), model, version="123") == "123"
    assert CheckpointStore(str(tmp_path)).meta("123") == {"spec_name": "mnist_mlp"}

    # resume without passing the spec: resolved from the zoo by recorded name
    restored = load_model(str(tmp_path), device="cpu")
    assert restored.spec.name == "mnist_mlp"
    assert torch.equal(restored.predict(x), before)
    for n, p in model.get_params().items():
        assert torch.equal(restored.get_params()[n], p)


def test_model_load_wrong_arch_raises(tmp_path):
    model = SpecModel(mnist_mlp(hidden=8, device="cpu"))
    model.setup()
    save_model(CheckpointStore(str(tmp_path)), model, version="1")
    with pytest.raises(ValueError, match="shape mismatch"):
        load_model(str(tmp_path), spec=mnist_mlp(hidden=16, device="cpu"))


def test_model_load_needs_a_name_or_a_spec(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        load_model(str(tmp_path))
    store = CheckpointStore(str(tmp_path))
    store.save({"w": torch.zeros(2)}, version="5")
    with pytest.raises(ValueError, match="pass spec="):
        load_model(str(tmp_path))
