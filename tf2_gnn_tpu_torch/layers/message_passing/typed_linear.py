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

from ...utils.init import glorot_uniform_

_OPERAND_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def _rounded(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and held in float32 again."""
    return x if dtype is None else x.to(dtype).to(torch.float32)


class TypedLinear(nn.Module):
    """Stacked per-type linear map (no bias, glorot init).

    * ``forward(x)`` with x [V, D] -> [L, V, out_size] (all types)
    * ``forward(x)`` with x [L, V, D] -> [L, V, out_size] (per-type batched)
    * ``forward(x, edge_type=l)`` with x [N, D] -> [N, out_size] (one type,
      the unfused path's per-edge layers)

    ``compute_dtype="bfloat16"`` rounds both operands to bf16 and takes
    their product in float32, as the JAX module's ``preferred_element_type
    =float32`` einsum does: the product of two bf16 values is exact in
    f32, the sums accumulate in f32 and the output is f32, not rounded to
    bf16 (``torch.matmul`` of two bf16 tensors would round it). The
    gradients pass the casts, so they are rounded to bf16 on the way to
    the f32 parameters and inputs, as the reference's are.
    """

    def __init__(self, num_types: int, in_size: int, out_size: int,
                 compute_dtype: str = "float32"):
        super().__init__()
        if compute_dtype not in _OPERAND_DTYPES:
            raise ValueError(f"TypedLinear compute_dtype={compute_dtype!r}; "
                             f"expected one of {sorted(_OPERAND_DTYPES)}")
        self.operand_dtype = _OPERAND_DTYPES[compute_dtype]
        self.num_types = num_types
        self.in_size = in_size
        self.out_size = out_size
        self.kernel = nn.Parameter(torch.empty(num_types, in_size, out_size))

    def reset_parameters(self, generator: torch.Generator) -> None:
        glorot_uniform_(self.kernel, self.in_size, self.out_size, generator)

    def forward(self, x: torch.Tensor,
                edge_type: Optional[int] = None) -> torch.Tensor:
        kernel = _rounded(self.kernel, self.operand_dtype)
        x = _rounded(x, self.operand_dtype)
        if edge_type is not None:
            return torch.matmul(x, kernel[edge_type])
        if x.dim() in (2, 3):
            return torch.matmul(x, kernel)
        raise ValueError(
            f"TypedLinear expects rank-2 or rank-3 input, got {x.dim()}.")
