"""Optimizer factory (port of ``tf2_gnn_tpu/harness/optimizers.py``).

Adam with the reference's Keras epsilon (1e-7): ``torch.optim.Adam`` puts
eps outside the square root of the bias-corrected second moment with no
eps inside it, which is ``optax.adam``'s update. The learning rate follows
``utils/schedules.py`` (a float or a step schedule, set before each update
with the 0-based update count, as optax's schedules read it). Gradient
clipping by value / per-tensor norm / global norm follows optax's
formulas; the three modes are mutually exclusive. SGD and RMSProp are not
ported (RMSProp needs optax's eps-inside-the-sqrt form) and raise.
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
    if name == "adam":
        initial = learning_rate(0) if callable(learning_rate) else learning_rate
        core = torch.optim.Adam(list(model_parameters), lr=initial,
                                eps=1e-7)  # keras Adam epsilon
    elif name in ("sgd", "rmsprop"):
        raise NotImplementedError(
            f'optimizer "{params.get("optimizer")}" is not ported yet; only '
            "Adam is.")
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
