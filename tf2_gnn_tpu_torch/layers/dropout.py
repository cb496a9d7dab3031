"""Dropout with flax's semantics, from an explicit generator."""
import torch


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout with flax's semantics: keep with probability
    ``1 - rate`` and scale kept entries by ``1 / (1 - rate)``; the mask
    comes from an explicit generator on ``x``'s device."""
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))
