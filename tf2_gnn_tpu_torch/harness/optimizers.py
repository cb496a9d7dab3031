"""Optimizer factory (port of ``tf2_gnn_tpu/harness/optimizers.py``).

Adam with the reference's Keras epsilon (1e-7): ``torch.optim.Adam`` puts
eps outside the square root of the bias-corrected second moment with no
eps inside it, which is ``optax.adam``'s update. RMSProp and SGD are
written out by hand with optax's semantics, which ``torch.optim`` does not
have (see ``OptaxRMSProp`` and ``OptaxSGD``). The learning rate follows
``utils/schedules.py`` (a float or a step schedule, set before each update
with the 0-based update count, as optax's schedules read it). Gradient
clipping by value / per-tensor norm / global norm follows optax's
formulas; the three modes are mutually exclusive.
"""
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch

from ..utils.schedules import make_learning_rate


def _clip_by_value(max_delta: float) -> Callable[[List[torch.Tensor]], None]:
    def clip(grads):
        for g in grads:
            g.clamp_(-max_delta, max_delta)
    return clip


def _clip_by_per_tensor_norm(max_norm: float
                             ) -> Callable[[List[torch.Tensor]], None]:
    """Clip each gradient tensor to a maximum L2 norm (tf.clip_by_norm)."""
    def clip(grads):
        for g in grads:
            norm = torch.sqrt(torch.sum(torch.square(g)))
            g.mul_(torch.clamp(max_norm / torch.clamp(norm, min=1e-12),
                               max=1.0))
    return clip


def _clip_by_global_norm(max_norm: float
                         ) -> Callable[[List[torch.Tensor]], None]:
    """optax.clip_by_global_norm: scale by max_norm / norm when the global
    norm exceeds max_norm."""
    def clip(grads):
        norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
        scale = torch.where(norm < max_norm, torch.ones_like(norm),
                            max_norm / norm)
        for g in grads:
            g.mul_(scale)
    return clip


class OptaxRMSProp(torch.optim.Optimizer):
    """``optax.rmsprop(lr, decay=rho, eps, momentum)`` with its defaults
    (``eps_in_sqrt=True``, ``initial_scale=0``, not centered): the chain
    ``scale_by_rms``, ``scale_by_learning_rate``, ``trace(momentum)``::

        nu = (1 - rho) * g**2 + rho * nu
        t  = -lr * g * rsqrt(nu + eps) + momentum * t
        p += t

    ``torch.optim.RMSprop`` adds eps outside the root and applies the
    learning rate after its momentum buffer, so it is not this update."""

    def __init__(self, params, lr: float, rho: float, momentum: float,
                 eps: float):
        super().__init__(params, dict(lr=lr, rho=rho, momentum=momentum,
                                      eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr, rho = group["lr"], group["rho"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                    state["trace"] = torch.zeros_like(p)
                nu, trace = state["nu"], state["trace"]
                nu.mul_(rho).add_((1.0 - rho) * torch.square(g))
                update = -lr * (g * torch.rsqrt(nu + group["eps"]))
                trace.mul_(group["momentum"]).add_(update)
                p.add_(trace)


class OptaxSGD(torch.optim.Optimizer):
    """``optax.sgd(lr, momentum)``: the chain ``trace(momentum)``, then
    ``scale_by_learning_rate``::

        t  = g + momentum * t
        p -= lr * t
    """

    def __init__(self, params, lr: float, momentum: float):
        super().__init__(params, dict(lr=lr, momentum=momentum))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["trace"] = torch.zeros_like(p)
                trace = state["trace"]
                trace.mul_(group["momentum"]).add_(p.grad)
                p.add_(-group["lr"] * trace)


class Optimizer:
    """A torch optimizer plus the learning-rate schedule and clipping that
    optax chains around it in the reference."""

    def __init__(self, torch_optimizer: torch.optim.Optimizer,
                 learning_rate, clip: Optional[Callable] = None):
        self.torch_optimizer = torch_optimizer
        self.learning_rate = learning_rate
        self.clip = clip

    def zero_grad(self) -> None:
        self.torch_optimizer.zero_grad(set_to_none=True)

    def step(self, step: int) -> None:
        """Apply one update; ``step`` is the number of updates done so far."""
        params = [p for group in self.torch_optimizer.param_groups
                  for p in group["params"] if p.grad is not None]
        if self.clip is not None:
            self.clip([p.grad for p in params])
        lr = (self.learning_rate(step) if callable(self.learning_rate)
              else self.learning_rate)
        for group in self.torch_optimizer.param_groups:
            group["lr"] = lr
        self.torch_optimizer.step()


def make_optimizer(params: Dict[str, Any],
                   model_parameters: Iterable[torch.nn.Parameter]
                   ) -> Optimizer:
    learning_rate = make_learning_rate(params)

    name = params.get("optimizer", "Adam").lower()
    initial = learning_rate(0) if callable(learning_rate) else learning_rate
    momentum = params.get("momentum", 0.85)
    if name == "sgd":
        core = OptaxSGD(list(model_parameters), lr=initial, momentum=momentum)
    elif name == "rmsprop":
        core = OptaxRMSProp(list(model_parameters), lr=initial,
                            rho=params.get("rmsprop_rho", 0.98),
                            momentum=momentum,
                            eps=1e-7)  # keras RMSprop epsilon
    elif name == "adam":
        core = torch.optim.Adam(list(model_parameters), lr=initial,
                                eps=1e-7)  # keras Adam epsilon
    else:
        raise ValueError(f'Unknown optimizer "{params.get("optimizer")}".')

    clip_value = params.get("gradient_clip_value")
    clip_norm = params.get("gradient_clip_norm")
    clip_global_norm = params.get("gradient_clip_global_norm")
    set_clips = [c for c in (clip_value, clip_norm, clip_global_norm)
                 if c is not None]
    if len(set_clips) > 1:
        raise ValueError("Only one gradient clipping mode can be set at a time.")

    clip = None
    if clip_value is not None:
        clip = _clip_by_value(clip_value)
    elif clip_norm is not None:
        clip = _clip_by_per_tensor_norm(clip_norm)
    elif clip_global_norm is not None:
        clip = _clip_by_global_norm(clip_global_norm)
    return Optimizer(core, learning_rate, clip)
