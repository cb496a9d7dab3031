"""Plain PyTorch reference of RGAT training: tf2-gnn's relational graph
attention with the node multiclass head and Adam (PPI_RGAT).

Everything but the layer comes from ``reference/rgcn.py``, by import: the
hyperparameters as run, the initial projection, the dense layers and the
head with its loss, Adam, inverted dropout with the program's masks, the
precisions and their controls, the edge stream's rounding and
``Graphs``. ``Model`` subclasses ``rgcn.Model`` and replaces only the
encoder, so that a model class built on ``rgcn.Model`` (a planted fault
that alters the loss) runs RGAT when ``train_readings`` is handed it.

The layer, per edge type l and head k, hidden H in K heads of D = H / K:
the f32 product ``x_l = h W_l``; the source and target scores
``s_l[v, k] = x_l[v, k, :] . a_lk[:D]`` and ``t_l[v, k] = x_l[v, k, :] .
a_lk[D:]``; the logit of an edge u -> v of type l, ``LeakyReLU_0.2(s_l[u,
k] + t_l[v, k])``; one softmax per (target, head) over the target's
incoming edges of all types jointly, shifted by the exact max of the
logits (detached) and with no epsilon, a target without in-edges reading
0; the message, head k's slice of ``x_l[u]``, weighted by the softmax and
summed per target, heads concatenated; the message activation (tanh)
after the sum.

The edge stream. The messages and both score tables stream in the
configuration's edge dtype (bf16): each is rounded to it before the
attention, sums and exps run in float32, and their gradients come back
rounded to it. In the backward pass the cotangent of the weighted sums is
rounded to the stream dtype before it meets the messages and the scores;
the denominators' cotangent stays float32.

Departures from tf2-gnn's layer (``tf2_gnn/layers/message_passing/
rgat.py``), each the program's:

* the bf16 edge stream (``gnn_edge_dtype``), above; tf2-gnn computes in
  float32 throughout;
* dropout masks drawn from one generator in the program's order, over the
  padded node rows (``rgcn.dropout``), where tf2-gnn draws TensorFlow's;
* the per-type attention parameters stacked as one [L, K, 2D] weight and
  the per-type kernels as one [L, in, H] weight, under the program's
  names; the values are tf2-gnn's [K, 2D] and [in, H] per type.

``gnn_use_target_state_as_input`` (true in the shipped file) and
``gnn_normalize_by_num_incoming`` are not read: tf2-gnn's RGAT takes
neither (the target's state enters through its score alone, and the
softmax normalises), nor does the program's. The program's softmax
stabiliser (``gnn_attention_stabiliser``) is a numerical device whose
shift the softmax does not see; the reference takes the exact max.
"""
from typing import Any, Dict, Sequence

import numpy as np
import torch

from . import rgcn
from .rgcn import (
    ACTIVATIONS,
    Graphs,
    Precision,
    dropout,
    hyper,
    leaky_relu,
    padded_nodes,
    stream_round,
)


class Stream(torch.autograd.Function):
    """``x`` through the stream dtype and back to float32, its gradient
    too: the program's casts to the stream dtype outside its attention
    op, whose gradients come back in that dtype."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return stream_round(x, dtype)

    @staticmethod
    def backward(ctx, g):
        return stream_round(g, ctx.dtype), None


class StreamCotangent(torch.autograd.Function):
    """The identity, its gradient through the stream dtype: the cotangent
    of the weighted sums as the program's backward streams it."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return stream_round(g, ctx.dtype), None


class Model(rgcn.Model):
    """RGAT's forward pass over weights held by name (the program's
    parameter names and layouts); the head and its loss are
    ``rgcn.Model``'s."""

    def __init__(self, config: Dict[str, Any], num_types: int,
                 precision: Precision):
        self.config, self.num_types, self.p = config, num_types, precision
        h = lambda key: hyper(config, "gnn_" + key)  # noqa: E731
        if h("message_calculation_class") != "rgat":
            raise ValueError("this reference implements RGAT only")
        if (h("num_edge_MLP_hidden_layers")
                or h("aggregation_function") != "sum"
                or h("message_activation_before_aggregation")
                or h("dense_dtype") != "float32"
                or h("use_inter_layer_layernorm")
                or h("global_exchange_every_num_layers") < h("num_layers")):
            raise ValueError("this reference implements RGAT's sum of f32 "
                             "products, activation after it, without "
                             "LayerNorm or a global exchange")
        self.hidden = h("hidden_dim")
        self.heads = h("num_heads")
        if self.hidden % self.heads:
            raise ValueError("the hidden size must split into the heads")
        self.layers = h("num_layers")
        self.residual_every = h("residual_every_num_layers")
        self.dense_every = h("dense_every_num_layers")
        self.initial_act = ACTIVATIONS[
            h("initial_node_representation_activation")]
        self.dense_act = ACTIVATIONS[h("dense_intermediate_layer_activation")]
        self.message_act = ACTIVATIONS[h("message_activation_function")]
        self.input_dropout = h("layer_input_dropout_rate")
        edge_dtype = h("edge_dtype")
        self.stream_dtype = precision.stream(
            None if edge_dtype == "float32" else getattr(torch, edge_dtype))
        self.rows_drawn = padded_nodes(config)

    def stream(self, x: torch.Tensor) -> torch.Tensor:
        if self.stream_dtype is None:
            return x
        return Stream.apply(x, self.stream_dtype)

    def stream_cotangent(self, x: torch.Tensor) -> torch.Tensor:
        if self.stream_dtype is None:
            return x
        return StreamCotangent.apply(x, self.stream_dtype)

    def attend(self, w, i: int, x: torch.Tensor,
               graphs: Graphs) -> torch.Tensor:
        """Layer ``i``'s softmax-weighted message sums, [N, H]."""
        n, types, heads = graphs.num_nodes, self.num_types, self.heads
        d = self.hidden // heads
        pre = f"gnn.mp_layer_{i}."
        kernel = w[pre + "edge_weights.kernel"]
        attention = w[pre + "edge_attention_parameters"]
        tables = torch.stack([self.p.mm(x, kernel[l]) for l in range(types)])
        tables = tables.reshape(types, n, heads, d)
        src = torch.einsum("lvkd,lkd->lvk", tables, attention[:, :, :d])
        tgt = torch.einsum("lvkd,lkd->lvk", tables, attention[:, :, d:])
        tables = self.stream(tables.reshape(types * n, heads, d))
        src = self.stream(src.reshape(types * n, heads))
        tgt = self.stream(tgt.reshape(types * n, heads))
        rows, targets = graphs.rows, graphs.targets
        logits = leaky_relu(src[rows] + tgt[(rows // n) * n + targets])
        maxes = torch.full((n, heads), float("-inf"), device=x.device)
        maxes = maxes.scatter_reduce(
            0, targets[:, None].expand_as(logits), logits.detach(),
            reduce="amax")
        expd = torch.exp(logits - maxes[targets])
        denom = expd.new_zeros((n, heads)).index_add_(0, targets, expd)
        weighted = expd.new_zeros((n, heads, d)).index_add_(
            0, targets, expd[:, :, None] * tables[rows])
        weighted = self.stream_cotangent(weighted)
        has_edges = (denom > 0.0)[:, :, None]
        out = torch.where(
            has_edges,
            weighted / torch.where(has_edges, denom[:, :, None],
                                   torch.ones_like(denom[:, :, None])),
            torch.zeros_like(weighted))
        return out.reshape(n, self.hidden)

    def encode(self, w, graphs: Graphs, generator) -> torch.Tensor:
        cur = self.initial_act(self.linear(
            w, "gnn.initial_node_projection", graphs.features))
        last = cur
        for i in range(self.layers):
            if self.input_dropout > 0.0:
                cur = dropout(cur, self.input_dropout, generator,
                              self.rows_drawn)
            if i % self.residual_every == 0:
                tmp = cur
                if i > 0:
                    cur = (cur + last) / 2.0
                last = tmp
            cur = self.message_act(self.attend(w, i, cur, graphs))
            if i % self.dense_every == 0:
                cur = self.dense_act(self.linear(w, f"gnn.dense_{i}", cur))
        return cur


def train_readings(config: Dict[str, Any], draws: Sequence[Any],
                   weights: Dict[str, torch.Tensor], dropout_seed: int,
                   device, precision: str = "f32", steps: int = 3,
                   model_class=None, optimizer_class=None) -> Dict[str, Any]:
    """``rgcn.train_readings`` with RGAT's encoder. A ``model_class`` that
    is not a ``Model`` (one built on ``rgcn.Model``, as a planted fault
    that alters the loss) is combined with it: its own methods, this
    module's encoder."""
    if model_class is None:
        model_class = Model
    elif not issubclass(model_class, Model):
        model_class = type(f"RGAT{model_class.__name__}",
                           (Model, model_class), {})
    return rgcn.train_readings(config, draws, weights, dropout_seed, device,
                               precision, steps, model_class,
                               optimizer_class)


def model_flops(config: Dict[str, Any], draw) -> float:
    """Model FLOPs of one training step on ``draw``: 2 * M * K * N for each
    dense product forward (the per-type products and the two score
    tables of each layer among them), three times that for forward and
    backward, plus 2 * edges * hidden for the weighted sums of each layer
    in each direction. Elementwise work (the logits, exps and the
    softmax) is not counted."""
    m, d = draw.num_nodes, int(draw.node_features.shape[1])
    num_types = len(draw.edges)
    edges = sum(int(a.shape[0]) for a in draw.edges)
    h = hyper(config, "gnn_hidden_dim")
    layers = hyper(config, "gnn_num_layers")
    dense_every = hyper(config, "gnn_dense_every_num_layers")
    products = [(m, d, h)]
    for i in range(layers):
        products += [(m, h, h)] * num_types + [(m, h, 1)] * (2 * num_types)
        if i % dense_every == 0:
            products.append((m, h, h))
    products.append((m, h, int(draw.node_labels.shape[1])))
    dense = sum(2.0 * a * b * c for a, b, c in products)
    return 3.0 * dense + layers * 2 * (2.0 * edges * h)


def _ids(config: Dict[str, Any], draw):
    """(entries, padded nodes, table rows, distinct source rows u,
    distinct target-score rows, distinct targets) of the merged plan's
    compact form, which holds every edge: u = l * V + source and the
    target-score row l * V + target, V the padded nodes."""
    v = padded_nodes(config)
    src = np.concatenate([a[:, 0].astype(np.int64) + l * v
                          for l, a in enumerate(draw.edges)])
    ts = np.concatenate([a[:, 1].astype(np.int64) + l * v
                         for l, a in enumerate(draw.edges)])
    targets = np.concatenate([a[:, 1] for a in draw.edges])
    return (int(src.size), v, len(draw.edges) * v, len(np.unique(src)),
            len(np.unique(ts)), len(np.unique(targets)))


def aggregation_flops(config: Dict[str, Any], draw) -> float:
    """Operations of one training step's attention kernels, every layer,
    counted as the port's kernel bounds count them
    (``chip_smoke.py::expd_rows_bound_ms``, ``kernel_bound_ms``,
    ``b9_bound_ms``): B8 6 an entry and head; B3, once a head, a
    multiply and an add an entry and column of its head's D + 1 columns;
    B9 4 an entry and column."""
    n = _ids(config, draw)[0]
    h = hyper(config, "gnn_hidden_dim")
    k = hyper(config, "gnn_num_heads")
    per_layer = 6.0 * n * k + 2.0 * n * (h + k) + 4.0 * n * h
    return hyper(config, "gnn_num_layers") * per_layer


def aggregation_bytes(config: Dict[str, Any], draw) -> float:
    """Bytes one training step's attention kernels must move, every layer,
    counted as the port's kernel bounds count them (each input read
    once, each output written once; ``chip_smoke.py``):

    * B8, the expd: the distinct source- and target-score halves in the
      stream dtype, the f32 stabiliser rows of targets with an entry, 4 B
      an entry, 4 B an output row pointer and K f32 values an entry;
    * B3, once a head: the distinct [D + 1]-column table rows read in the
      stream dtype, 8 B an entry, 4 B an output row pointer and the f32
      [V, D + 1] output;
    * B9, the backward: the distinct table rows with their source-score
      halves, the distinct dw rows with their f32 stabiliser and d_denom
      rows, the distinct target-score halves, 4 B an entry, 4 B a row
      pointer of each of its two CSRs, and d_ss, d_ts and d_table in f32.
    """
    n, v, rows, u_rows, ts_rows, t_rows = _ids(config, draw)
    h = hyper(config, "gnn_hidden_dim")
    k = hyper(config, "gnn_num_heads")
    item = 2 if hyper(config, "gnn_edge_dtype") in ("bfloat16",
                                                    "float16") else 4
    d1 = h // k + 1
    expd = ((u_rows + ts_rows) * k * item + t_rows * k * 4 + n * 4
            + (v + 1) * 4 + n * k * 4)
    sums = k * (u_rows * d1 * item + n * 8 + (v + 1) * 4 + v * d1 * 4)
    backward = (u_rows * (h + k) * item + t_rows * (h * item + 8 * k)
                + ts_rows * k * item + n * 4 + 2 * (rows + 1) * 4
                + rows * (h + 2 * k) * 4)
    return hyper(config, "gnn_num_layers") * float(expd + sums + backward)
