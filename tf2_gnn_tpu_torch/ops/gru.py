"""GRU cell with ``tf.keras.layers.GRUCell`` math, ``reset_after=True``
(port of ``tf2_gnn_tpu/ops/gru.py``).

The reset gate multiplies the post-matmul recurrent contribution, and the
input and recurrent projections carry separate biases. The packed kernels
keep the flax layout, ``[in, 3H]`` with gates in the Keras order
``[z | r | h]``, so the weight bridge copies them as they are.
``torch.nn.GRUCell`` is not this cell: its gates run r, z, n and its
weights are ``[3H, in]``.
"""
import torch
from torch import nn

from ..utils.init import glorot_uniform_


class GRUCell(nn.Module):
    """``new_h = z * state + (1 - z) * candidate``; ``forward(inputs
    [N, D_in], state [N, H]) -> [N, H]``."""

    def __init__(self, input_dim: int, hidden_dim: int):
        super().__init__()
        self.input_dim = input_dim
        self.hidden_dim = hidden_dim
        self.kernel = nn.Parameter(torch.empty(input_dim, 3 * hidden_dim))
        self.recurrent_kernel = nn.Parameter(
            torch.empty(hidden_dim, 3 * hidden_dim))
        self.input_bias = nn.Parameter(torch.empty(3 * hidden_dim))
        self.recurrent_bias = nn.Parameter(torch.empty(3 * hidden_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Glorot-uniform kernel, orthogonal recurrent kernel, zero biases
        (the flax initialisers)."""
        glorot_uniform_(self.kernel, self.input_dim, 3 * self.hidden_dim,
                        generator)
        with torch.no_grad():
            nn.init.orthogonal_(self.recurrent_kernel, generator=generator)
            self.input_bias.zero_()
            self.recurrent_bias.zero_()

    def forward(self, inputs: torch.Tensor,
                state: torch.Tensor) -> torch.Tensor:
        x_z, x_r, x_h = torch.chunk(inputs @ self.kernel + self.input_bias,
                                    3, dim=-1)
        h_z, h_r, h_h = torch.chunk(
            state @ self.recurrent_kernel + self.recurrent_bias, 3, dim=-1)
        z = torch.sigmoid(x_z + h_z)
        r = torch.sigmoid(x_r + h_r)
        candidate = torch.tanh(x_h + r * h_h)
        return z * state + (1.0 - z) * candidate
