"""Per-edge-type linear maps with stacked weights (port of
``tf2_gnn_tpu/layers/message_passing/typed_linear.py``).

All types share one ``[L, D, H]`` parameter. The all-types form (one
``[V, D]`` input against every type) writes the type-major ``[L, V, H]``
tables in place: ``torch.matmul`` of a rank-2 input and a rank-3 kernel
folds the pair into one product ``kernel.mT [L*H, D] @ x.mT [D, V]``,
whose ``[L*H, V]`` result it then copies, transposed, into ``[L, V, H]``,
and in the backward it copies the ``[L, V, H]`` gradient back into the
folded layout: two strided copies of every table a layer. ``_AllTypes``
instead takes one batched product with the input at batch stride 0
forward, the input's gradient as one product a type accumulated into one
``[V, D]`` (split-K over the types), and the kernel's gradient as one
product a type into its slice of ``[L, D, H]`` (on an H100 cuBLAS takes
the batched form with ``x.mT`` at batch stride 0 1.8 to 8 times slower:
it picks small tiles for the long reduction over V). The per-type batched
form (``[L, V, D]`` input) and the one-type form keep ``torch.matmul``,
which maps them to a batched or a single product without a fold. The
rows form (``forward_rows``, ``_TypeRows``) takes only the rows of the
all-types tables that a joint plan reads: each type's rows of the input,
gathered once, against that type's kernel, one product a type each way,
the input's gradient summed back by node by the row owner K1.

The JAX module's ``pad_out_to`` is not ported: it padded the output to
the TPU's 128-lane feature tile for the Pallas kernels, and the CUDA
kernels mask the ragged feature edge instead.
"""
from typing import Optional

import torch
from torch import nn

from ...ops import pair_spmm
from ...utils import tracing
from ...utils.init import glorot_uniform_

_OPERAND_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def _rounded(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and held in float32 again."""
    return x if dtype is None else x.to(dtype).to(torch.float32)


class _AllTypes(torch.autograd.Function):
    """``x`` [V, D] against every type of ``kernel`` [L, D, H] -> the
    contiguous [L, V, H], with no transposed copy either way."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, kernel)
        num_types = kernel.shape[0]
        out = x.new_empty(num_types, x.shape[0], kernel.shape[2])
        return torch.bmm(x.expand(num_types, -1, -1), kernel, out=out)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        x, kernel = ctx.saved_tensors
        d_x = d_kernel = None
        if ctx.needs_input_grad[0]:
            d_x = torch.mm(grad[0], kernel[0].mT)
            for l in range(1, kernel.shape[0]):
                d_x.addmm_(grad[l], kernel[l].mT)
        if ctx.needs_input_grad[1]:
            d_kernel = torch.empty_like(kernel)
            for l in range(kernel.shape[0]):
                torch.mm(x.mT, grad[l], out=d_kernel[l])
        return d_x, d_kernel


class _TypeRows(torch.autograd.Function):
    """Each type's rows against its kernel -> [n, H], row ``i`` of type
    ``l`` where ``read.type_offsets[l] <= i < read.type_offsets[l + 1]``:
    the rows of ``x`` itself ([n, D]) or, with ``gather``, the rows
    ``x[read.node]`` ([V, D] input). One product a type each way; through
    the gather the input's gradient rows are summed into [V, D] by node
    (``pair_spmm_node_rows``: K1 over ``read.node_rows``, each node's rows
    in type order, so the bits repeat)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, kernel: torch.Tensor,
                read: pair_spmm.ReadRows, gather: bool) -> torch.Tensor:
        rows = x.index_select(0, read.node) if gather else x
        out = rows.new_empty(rows.shape[0], kernel.shape[2])
        offsets = read.type_offsets
        for l, (a, b) in enumerate(zip(offsets, offsets[1:])):
            torch.mm(rows[a:b], kernel[l], out=out[a:b])
        ctx.save_for_backward(rows, kernel)
        ctx.read, ctx.gather = read, gather
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        rows, kernel = ctx.saved_tensors
        offsets = ctx.read.type_offsets
        spans = list(enumerate(zip(offsets, offsets[1:])))
        grad = grad.contiguous()
        d_x = d_kernel = None
        if ctx.needs_input_grad[0]:
            d_x = torch.empty_like(rows)
            for l, (a, b) in spans:
                torch.mm(grad[a:b], kernel[l].mT, out=d_x[a:b])
            if ctx.gather:
                d_x = pair_spmm.pair_spmm_node_rows(d_x, ctx.read)
        if ctx.needs_input_grad[1]:
            d_kernel = torch.empty_like(kernel)
            for l, (a, b) in spans:
                torch.mm(rows[a:b].mT, grad[a:b], out=d_kernel[l])
        return d_x, d_kernel, None, None


class TypedLinear(nn.Module):
    """Stacked per-type linear map (no bias, glorot init).

    * ``forward(x)`` with x [V, D] -> [L, V, out_size] (all types; counted
      as ``typed_linear.shared_input`` in ``utils/tracing.py``'s registry)
    * ``forward(x)`` with x [L, V, D] -> [L, V, out_size] (per-type batched)
    * ``forward(x, edge_type=l)`` with x [N, D] -> [N, out_size] (one type,
      the unfused path's per-edge layers)
    * ``forward_rows(x, read, gather)`` -> [n, out_size] (the rows of the
      all-types form that a joint plan reads, ``GNN_Edge_MLP``'s compact
      tables)

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
        if x.dim() == 2:
            tracing.count("typed_linear.shared_input")
            return _AllTypes.apply(x, kernel)
        if x.dim() == 3:
            return torch.matmul(x, kernel)
        raise ValueError(
            f"TypedLinear expects rank-2 or rank-3 input, got {x.dim()}.")

    def forward_rows(self, x: torch.Tensor,
                     read: pair_spmm.ReadRows,
                     gather: bool) -> torch.Tensor:
        """Only the rows of the all-types form's [L, V, H] that a joint
        plan reads (``read``), as one [n, out_size] in their order: row
        ``i`` of type ``l`` is ``x[read.node[i]] @ kernel[l]`` with
        ``gather`` (x [V, D]), else ``x[i] @ kernel[l]`` (x [n, D] in the
        same row order), with the operands rounded as in ``forward``."""
        kernel = _rounded(self.kernel, self.operand_dtype)
        x = _rounded(x, self.operand_dtype)
        return _TypeRows.apply(x, kernel, read, gather)
