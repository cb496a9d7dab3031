"""Activation-function registry (port of ``tf2_gnn_tpu/ops/activations.py``).

The reference's name->fn lookup, with its tanh-approximated GELU and a
leaky_relu pinned to slope 0.2.
"""
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

Activation = Callable[[torch.Tensor], torch.Tensor]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximated GELU, matching the reference's custom implementation
    (reference: tf2_gnn/utils/activation.py:7-14)."""
    cdf = 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                  * (x + 0.044715 * torch.pow(x, 3))))
    return x * cdf


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.leaky_relu(x, 0.2)``: ``where(x >= 0, x, 0.2 * x)``, slope
    0.2 as tf.nn.leaky_relu's alpha (torch's default is 0.01). Its gradient
    at exactly 0 is 1, the reference's; ``F.leaky_relu``'s is 0.2. Message
    sums are exactly 0 wherever every in-neighbour's row is 0 (a node with
    no in-edges feeds LayerNorm a constant row, whose output is the zero
    bias at initialisation), so the choice shows in the gradients."""
    return torch.where(x >= 0, x, 0.2 * x)


_ACTIVATIONS = {
    "linear": _identity,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "leaky_relu": leaky_relu,
    "elu": F.elu,
    "selu": F.selu,
    "gelu": gelu,
    "sigmoid": torch.sigmoid,
}


def get_activation_function(name: Optional[str]) -> Activation:
    """Map an activation name to its function (case-insensitive); ``None``
    and ``"linear"`` both map to identity."""
    if name is None:
        return _identity
    fn = _ACTIVATIONS.get(name.lower())
    if fn is None:
        raise ValueError(f"Unknown activation function: {name}")
    return fn


def get_known_activation_names():
    return sorted(_ACTIVATIONS.keys())
