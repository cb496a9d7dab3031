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


def glorot_uniform_batched_(tensor: torch.Tensor,
                            generator: torch.Generator) -> torch.Tensor:
    """Flax ``glorot_uniform(batch_axis=(0,))``: axis 0 is a batch of
    independent matrices, the last two axes are (fan in, fan out) and any
    axes between them the receptive field."""
    shape = tensor.shape
    receptive = math.prod(shape[1:-2])
    return glorot_uniform_(tensor, shape[-2] * receptive,
                           shape[-1] * receptive, generator)


def init_dense_(layer: nn.Linear, generator: torch.Generator) -> None:
    """Glorot-uniform kernel and zero bias, as flax ``nn.Dense`` here."""
    glorot_uniform_(layer.weight, layer.in_features, layer.out_features,
                    generator)
    if layer.bias is not None:
        with torch.no_grad():
            layer.bias.zero_()
