"""Port of ``distriflow_tpu/models/base.py``: the model abstraction.

Two levels, as in the JAX package:

- :class:`ModelSpec`, the functional core the trainers consume: ``init``
  builds the model, ``apply`` runs it, ``loss`` names a registry loss.
- :class:`DistributedModel` / :class:`SpecModel`, the stateful surface
  (``fit`` computes gradients without applying them, ``update`` applies
  one optimizer step, ``predict``, ``evaluate``, ``get_params``,
  ``set_params``).

PyTorch idiom inside: the "params" are an ``nn.Module``'s named
parameters (f32 masters that require grad, for a trainable model), and
a params tree is a ``{name: tensor}`` dict. :class:`Optimizer` is a small
functional update over such dicts **with optax's semantics**, which
``torch.optim`` does not share in every case: rmsprop decays at 0.9 with
eps inside the square root, adagrad starts its accumulator at 0.1 with
eps inside the square root, adamw decays weights by 1e-4. The optimizer
updates its state in place (JAX returns a new state); the trainers then
add the updates to the parameters in place.

**Frozen-param convention** (JAX's ``optax.masked``): a parameter whose
last name component starts with ``frozen_`` gets no optimizer state, and
its update is its gradient passed through unchanged, as optax's mask does.
"""

from __future__ import annotations

import abc
import dataclasses
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from distriflow_tpu_torch.models import losses as losses_lib
from distriflow_tpu_torch.utils.config import CompileConfig

Params = Dict[str, torch.Tensor]
LearningRate = Union[float, Callable[[int], float]]


def trainable(name: str) -> bool:
    """False where the last component of a parameter's name starts with
    ``frozen_`` (an exact-prefix test: ``UnfrozenEncoder.w`` still trains)."""
    return not name.rsplit(".", 1)[-1].startswith("frozen_")


def _f32(x: float) -> float:
    """A Python float rounded to f32, as optax's f32 scalar math rounds it."""
    return float(np.float32(x))


class Optimizer:
    """One of the registry's optimizers over ``{name: tensor}`` dicts.

    ``update(grads, state, params)`` returns ``(updates, state)``; add the
    updates to the params (:func:`apply_updates`). The learning rate is a
    float or a schedule ``step -> lr`` read at the count of earlier
    updates (optax's ``scale_by_schedule``)."""

    NAMES = ("sgd", "momentum", "adam", "adamw", "rmsprop", "adagrad")

    def __init__(self, name: str, learning_rate: LearningRate):
        if name not in self.NAMES:
            raise KeyError(f"unknown optimizer {name!r}; registered: {sorted(self.NAMES)}")
        self.name = name
        self.learning_rate = learning_rate

    def _lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    def init(self, params: Params) -> Dict[str, Any]:
        live = {n: p for n, p in params.items() if trainable(n)}

        def full(value: float) -> Dict[str, torch.Tensor]:
            return {n: torch.full_like(p, value, memory_format=torch.contiguous_format)
                    for n, p in live.items()}

        state: Dict[str, Any] = {"count": 0}
        if self.name == "momentum":
            state["trace"] = full(0.0)
        elif self.name in ("adam", "adamw"):
            state["mu"], state["nu"] = full(0.0), full(0.0)
        elif self.name == "rmsprop":
            state["nu"] = full(0.0)
        elif self.name == "adagrad":
            state["sum_of_squares"] = full(0.1)
        return state

    @torch.no_grad()
    def update(self, grads: Params, state: Dict[str, Any], params: Params
               ) -> Tuple[Params, Dict[str, Any]]:
        count = state["count"]
        lr = self._lr(count)
        updates: Params = {}
        for n, p in params.items():
            g = grads.get(n)
            g = torch.zeros_like(p) if g is None else g.to(p.dtype)
            if not trainable(n):
                updates[n] = g  # optax.masked passes a masked leaf's update through
                continue
            updates[n] = -lr * self._direction(n, g, p, state, count + 1)
        state["count"] = count + 1
        return updates, state

    def _direction(self, n: str, g: torch.Tensor, p: torch.Tensor,
                   state: Dict[str, Any], step: int) -> torch.Tensor:
        """The update before the learning rate, advancing ``state[...][n]``
        in place (optax's transform chain for this optimizer)."""
        if self.name == "sgd":
            return g
        if self.name == "momentum":
            t = state["trace"][n]
            t.mul_(0.9).add_(g)
            return t.clone()
        if self.name in ("adam", "adamw"):
            b1, b2, eps = 0.9, 0.999, 1e-8
            mu, nu = state["mu"][n], state["nu"][n]
            mu.mul_(b1).add_(g, alpha=1 - b1)
            nu.mul_(b2).add_(g * g, alpha=1 - b2)
            mu_hat = mu / _f32(1 - np.float32(b1) ** np.float32(step))
            nu_hat = nu / _f32(1 - np.float32(b2) ** np.float32(step))
            u = mu_hat / (nu_hat.sqrt() + eps)
            return u + 1e-4 * p if self.name == "adamw" else u
        if self.name == "rmsprop":
            nu = state["nu"][n]
            nu.mul_(0.9).add_(g * g, alpha=1 - 0.9)
            return g * torch.rsqrt(nu + 1e-8)
        acc = state["sum_of_squares"][n]  # adagrad
        acc.add_(g * g)
        return g * torch.where(acc > 0, torch.rsqrt(acc + 1e-7), torch.zeros_like(acc))


@torch.no_grad()
def apply_updates(params: Params, updates: Params) -> None:
    """``p += u`` in place for every parameter (optax's ``apply_updates``)."""
    for n, p in params.items():
        p.add_(updates[n].to(p.dtype))


def _optimizer(name: Union[str, Optimizer], learning_rate: Optional[LearningRate],
               default_rate: float = 0.001) -> Optimizer:
    """The optimizer registry: sgd (the parity default), momentum (0.9),
    adam, adamw, rmsprop, adagrad, with optax's hyperparameters. ``name``
    may be a ready-made :class:`Optimizer`; ``learning_rate`` a float or a
    schedule ``step -> lr``; ``None`` means ``default_rate``."""
    if isinstance(name, Optimizer):
        if learning_rate is not None:
            warnings.warn(
                "learning_rate is ignored when passing a ready-made Optimizer — "
                "set the rate on the optimizer instead", stacklevel=2)
        return name
    return Optimizer(name, default_rate if learning_rate is None else learning_rate)


def named_params(model: nn.Module) -> Params:
    """The model's parameters by name (the tensors themselves, not copies)."""
    return dict(model.named_parameters())


def to_device(batch: Any, device: torch.device) -> Any:
    """Numpy arrays and tensors of a batch tuple onto ``device``."""
    if batch is None:
        return None
    if isinstance(batch, (tuple, list)):
        return type(batch)(to_device(b, device) for b in batch)
    return torch.as_tensor(batch).to(device, non_blocking=True)


def init_params(spec: "ModelSpec", seed: int = 0) -> nn.Module:
    """Build the spec's model from ``seed`` (JAX: jit of ``spec.init``;
    PyTorch runs eagerly, so this is ``spec.init`` itself)."""
    return spec.init(seed)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Functional model: the unit trainers share.

    ``init(seed)`` returns the model (an ``nn.Module`` whose trainable
    parameters require grad); ``apply(model, x)`` returns predictions or
    logits; ``loss`` is a registry name. ``apply_with_aux`` optionally
    returns ``(preds, aux_scalar)``, the aux term added to the training
    loss but not to eval metrics."""

    init: Callable[[int], nn.Module]
    apply: Callable[[nn.Module, torch.Tensor], torch.Tensor]
    loss: str = "softmax_cross_entropy"
    input_shape: Tuple[int, ...] = ()
    output_shape: Tuple[int, ...] = ()
    name: str = "model"
    apply_with_aux: Optional[Callable[[nn.Module, torch.Tensor],
                                      Tuple[torch.Tensor, torch.Tensor]]] = None

    def loss_fn(self, model: nn.Module, x: torch.Tensor, y: torch.Tensor,
                weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Weighted-mean loss; ``weight`` (per example, 0 for padding rows)
        makes padded partial batches exact."""
        loss = losses_lib.get_loss(self.loss)
        if self.apply_with_aux is not None:
            preds, aux = self.apply_with_aux(model, x)
            return loss(preds, y, weight) + aux
        preds = self.apply(model, x)
        if isinstance(preds, (tuple, list)):
            if not isinstance(y, (tuple, list)) or len(y) != len(preds):
                raise ValueError(
                    f"model has {len(preds)} outputs; targets must be a "
                    f"{len(preds)}-tuple, got {type(y).__name__}")
            total = loss(preds[0], y[0], weight)
            for p, t in zip(preds[1:], y[1:]):
                total = total + loss(p, t, weight)
            return total
        return loss(preds, y, weight)

    def grad_fn(self) -> Callable[..., Tuple[torch.Tensor, Params]]:
        """``(model, x, y[, weight]) -> (loss, grads)``: the detached loss
        and a gradient for every named parameter (zeros where a parameter
        does not require grad, as JAX's gradient of a stopped leaf)."""

        def value_and_grad(model: nn.Module, x, y, weight=None):
            params = named_params(model)
            live = [n for n, p in params.items() if p.requires_grad]
            loss = self.loss_fn(model, x, y, weight)
            gs = torch.autograd.grad(loss, [params[n] for n in live], allow_unused=True)
            grads = {n: torch.zeros_like(p) for n, p in params.items()}
            grads.update({n: g for n, g in zip(live, gs) if g is not None})
            return loss.detach(), grads

        return value_and_grad

    def metrics_fn(self, metric_names: Sequence[str]) -> Callable[..., List[torch.Tensor]]:
        loss = losses_lib.get_loss(self.loss)

        @torch.no_grad()
        def compute(model: nn.Module, x, y, weight=None) -> List[torch.Tensor]:
            preds = self.apply(model, x)
            return [loss(preds, y, weight) if m == "loss"
                    else losses_lib.get_metric(m)(preds, y, weight) for m in metric_names]

        return compute


class DistributedModel(abc.ABC):
    """Stateful parity surface (reference ``DistributedModel``)."""

    @abc.abstractmethod
    def fit(self, x, y) -> Params:
        """Compute gradients on a batch WITHOUT applying them."""

    @abc.abstractmethod
    def update(self, grads: Params) -> None:
        """Apply one optimizer step with the given gradients."""

    @abc.abstractmethod
    def predict(self, x) -> torch.Tensor:
        ...

    @abc.abstractmethod
    def evaluate(self, x, y) -> List[float]:
        ...

    @abc.abstractmethod
    def get_params(self) -> Params:
        ...

    @abc.abstractmethod
    def set_params(self, params: Params) -> None:
        ...

    @property
    @abc.abstractmethod
    def input_shape(self) -> Tuple[int, ...]:
        ...

    @property
    @abc.abstractmethod
    def output_shape(self) -> Tuple[int, ...]:
        ...

    def setup(self) -> None:
        """Async-init hook (reference ``fetchInitial``); default no-op."""


class SpecModel(DistributedModel):
    """DistributedModel over a ModelSpec and its resident model."""

    def __init__(
        self,
        spec: ModelSpec,
        compile_config: Optional[CompileConfig] = None,
        learning_rate: Optional[LearningRate] = None,  # None -> 0.001 (reference default)
        params: Optional[Params] = None,
        seed: int = 0,
    ):
        self.spec = spec
        self.compile_config = compile_config or CompileConfig()
        if self.compile_config.loss is not None and self.compile_config.loss != spec.loss:
            # honor an explicitly configured loss over the spec default
            self.spec = dataclasses.replace(spec, loss=self.compile_config.loss)
        self.learning_rate = 0.001 if learning_rate is None else learning_rate
        self._seed = seed
        self._initial = params
        self.model: Optional[nn.Module] = None
        self._optimizer = _optimizer(self.compile_config.optimizer, learning_rate)
        self._opt_state = None
        self._grad = self.spec.grad_fn()
        self._metrics = self.spec.metrics_fn(["loss", *self.compile_config.metrics])
        self.last_loss: Optional[float] = None

    # -- lifecycle ---------------------------------------------------------

    def setup(self) -> None:
        if self.model is None:
            self.model = self.spec.init(self._seed)
            if self._initial is not None:
                self._load(self._initial)
                self._initial = None
        if self._opt_state is None:
            self._opt_state = self._optimizer.init(named_params(self.model))

    def _device(self) -> torch.device:
        return next(self.model.parameters()).device

    @torch.no_grad()
    def _load(self, params: Params) -> None:
        own = named_params(self.model)
        missing = set(own) - set(params)
        if missing:
            raise KeyError(f"params missing {sorted(missing)}")
        for n, p in own.items():
            p.copy_(torch.as_tensor(params[n]))

    # -- DistributedModel surface -----------------------------------------

    def fit(self, x, y) -> Params:
        self.setup()
        x, y = to_device((x, y), self._device())
        loss, grads = self._grad(self.model, x, y)
        self.last_loss = float(loss)
        return grads

    def update(self, grads: Params) -> None:
        self.setup()
        params = named_params(self.model)
        updates, self._opt_state = self._optimizer.update(grads, self._opt_state, params)
        apply_updates(params, updates)

    def predict(self, x) -> torch.Tensor:
        self.setup()
        with torch.no_grad():
            return self.spec.apply(self.model, to_device(x, self._device()))

    def evaluate(self, x, y) -> List[float]:
        self.setup()
        x, y = to_device((x, y), self._device())
        return [float(v) for v in self._metrics(self.model, x, y)]

    def get_params(self) -> Params:
        """A detached copy of every parameter (a snapshot: later updates
        happen in place and do not reach it)."""
        self.setup()
        return {n: p.detach().clone() for n, p in named_params(self.model).items()}

    def set_params(self, params: Params) -> None:
        self.setup()
        self._load(params)

    @property
    def input_shape(self) -> Tuple[int, ...]:
        return tuple(self.spec.input_shape)

    @property
    def output_shape(self) -> Tuple[int, ...]:
        return tuple(self.spec.output_shape)
