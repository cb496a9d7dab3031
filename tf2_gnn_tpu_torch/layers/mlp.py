"""MLP with dpu-utils ``tf2utils.MLP`` semantics (port of
``tf2_gnn_tpu/layers/mlp.py``).

* ``hidden_layers`` is an int N (N hidden layers of size ``out_size``) or a
  list of sizes.
* Hidden layers: Linear (+bias if ``use_biases``) -> activation -> dropout
  (training only, from an explicit generator).
* Output layer: Linear (+bias if ``use_biases``), no activation, no dropout.

The linears are ``hidden_{i}`` and ``out``, the flax names, so the bridge
maps ``<mlp>/hidden_0/kernel`` to ``<mlp>.hidden_0.weight``.
"""
from typing import Optional, Sequence, Union

import torch
from torch import nn

from ..ops.activations import get_activation_function
from .dropout import dropout
from ..utils.init import init_dense_


class MLP(nn.Module):
    def __init__(self, input_dim: int, out_size: int,
                 hidden_layers: Union[int, Sequence[int]] = 1,
                 use_biases: bool = False, activation: str = "relu",
                 dropout_rate: float = 0.0):
        super().__init__()
        if isinstance(hidden_layers, int):
            sizes = [out_size] * hidden_layers
        else:
            sizes = list(hidden_layers)
        self.num_hidden = len(sizes)
        self.dropout_rate = dropout_rate
        self.act = get_activation_function(activation)
        dims = [input_dim] + sizes
        for i, size in enumerate(sizes):
            self.add_module(f"hidden_{i}",
                            nn.Linear(dims[i], size, bias=use_biases))
        self.out = nn.Linear(dims[-1], out_size, bias=use_biases)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Glorot-uniform kernels, zero biases (the flax initialisers)."""
        for i in range(self.num_hidden):
            init_dense_(getattr(self, f"hidden_{i}"), generator)
        init_dense_(self.out, generator)

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(self.num_hidden):
            x = self.act(getattr(self, f"hidden_{i}")(x))
            if training and self.dropout_rate > 0.0:
                if generator is None:
                    raise ValueError("training with dropout needs an "
                                     "explicit torch.Generator")
                x = dropout(x, self.dropout_rate, generator)
        return self.out(x)
