"""Per-edge-type linear maps with stacked weights (port of
``tf2_gnn_tpu/layers/message_passing/typed_linear.py``).

All types share one ``[L, D, H]`` parameter, so the node-space transform of
every type is one batched matmul. The JAX module's ``pad_out_to`` is not
ported: it padded the output to the TPU's 128-lane feature tile for the
Pallas kernels, and the CUDA kernels mask the ragged feature edge instead.
"""
from typing import Optional

import torch
from torch import nn

from ..init import glorot_uniform_


class TypedLinear(nn.Module):
    """Stacked per-type linear map (no bias, glorot init).

    * ``forward(x)`` with x [V, D] -> [L, V, out_size] (all types)
    * ``forward(x)`` with x [L, V, D] -> [L, V, out_size] (per-type batched)
    * ``forward(x, edge_type=l)`` with x [N, D] -> [N, out_size] (one type,
      the unfused path's per-edge layers)

    Products run in float32 (the JAX module's ``compute_dtype`` other than
    float32 is not ported and raises; ROADMAP.md, queue A item 7).
    """

    def __init__(self, num_types: int, in_size: int, out_size: int,
                 compute_dtype: str = "float32"):
        super().__init__()
        if compute_dtype != "float32":
            raise NotImplementedError(
                f"TypedLinear compute_dtype={compute_dtype!r} is not ported; "
                "only float32 products are (ROADMAP.md, queue A item 7).")
        self.num_types = num_types
        self.in_size = in_size
        self.out_size = out_size
        self.kernel = nn.Parameter(torch.empty(num_types, in_size, out_size))

    def reset_parameters(self, generator: torch.Generator) -> None:
        glorot_uniform_(self.kernel, self.in_size, self.out_size, generator)

    def forward(self, x: torch.Tensor,
                edge_type: Optional[int] = None) -> torch.Tensor:
        if edge_type is not None:
            return torch.matmul(x, self.kernel[edge_type])
        if x.dim() in (2, 3):
            return torch.matmul(x, self.kernel)
        raise ValueError(
            f"TypedLinear expects rank-2 or rank-3 input, got {x.dim()}.")
