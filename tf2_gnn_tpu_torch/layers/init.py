"""Parameter initialisers matching the JAX package's flax defaults.

Weights are drawn from an explicit ``torch.Generator``; the values differ
from flax's for the same seed (the tests bridge weights instead).
"""
import math

import torch
from torch import nn


def glorot_uniform_(tensor: torch.Tensor, fan_in: int, fan_out: int,
                    generator: torch.Generator) -> torch.Tensor:
    """U(-l, l) with l = sqrt(6 / (fan_in + fan_out)) (flax
    ``glorot_uniform``; stacked per-type kernels use the per-type fans)."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        values = torch.rand(tensor.shape, generator=generator,
                            dtype=torch.float32)
        tensor.copy_(values * (2.0 * limit) - limit)
    return tensor


def init_dense_(layer: nn.Linear, generator: torch.Generator) -> None:
    """Glorot-uniform kernel and zero bias, as flax ``nn.Dense`` here."""
    glorot_uniform_(layer.weight, layer.in_features, layer.out_features,
                    generator)
    if layer.bias is not None:
        with torch.no_grad():
            layer.bias.zero_()
