"""Plain PyTorch reference of RGCN training (tf2-gnn's RGCN with its node
multiclass and QM9 regression heads, Adam and optax-style RMSProp).

It reads the configuration file and the generator's raw draws and works
everything out itself: edge lists, per-type in-degrees and their 1/deg
scales, the graph segments, the padded node count that the dropout masks
are drawn over. It imports neither the program nor JAX. Dense products run
in float32 with TF32 off (``precision="f32"``), or with TF32 on
(``"tf32"``, a control: on a card the tensor cores' TF32, on the CPU
operands rounded to TF32's 10-bit mantissa). Messages stream in the
configuration's edge dtype: each table row is rounded to it before its
1/deg scale, and all sums accumulate in float32. ``"fp8_stream"`` (a
control) streams a bfloat16 or float16 stream in fp8 (e4m3) in its place,
one step lower, each rounded tensor scaled by its largest magnitude over
fp8's largest, as fp8 training scales it. In the backward pass a
batch with plans (the streamed aggregation) rounds each cotangent row to
the edge dtype before the same scale; a batch without plans (per-edge
gathers of the rounded table, whose gradients autograd keeps in the
table's dtype) rounds each edge's scaled cotangent, and each table row's
sum of them once more.

Dropout is inverted dropout with masks ``rand(shape) < 1 - rate`` drawn
from one generator seeded as the program's training state's, in the order
the program draws them: each layer's input dropout ([V_pad, hidden]); in a
GRU global exchange the scoring MLP's hidden layer, the transformation
MLP's hidden layer and the broadcast summary (each [V_pad, hidden]). Only
the real nodes' rows are used.

The global exchange is tf2-gnn's: a weighted-sum readout (a scoring MLP of
one hidden layer of ``hidden`` units and the transformation MLP of one
hidden layer of 128 units, relu, no biases, dropout 0.2 on their hidden
layers, a relu on the transformed values, a per-graph softmax over
``heads`` scores) broadcast to the nodes, dropped out, and fed as the
input of a Keras GRU cell (``reset_after``, gates z, r, h) whose state is
the node's.
"""
import contextlib
from typing import Any, Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

SMALL_NUMBER = 1e-7
BLOCK_NODES = 128
TRANSFORM_HIDDEN = 128
READOUT_DROPOUT = 0.2
LAYERNORM_EPS = 1e-3
FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


def hyper(config: Dict[str, Any], key: str):
    """A model hyperparameter as run: ``model_params``, else ``assumed``."""
    if key in config["model_params"]:
        return config["model_params"][key]
    return config["assumed"]["model"][key]


def padded_nodes(config: Dict[str, Any]) -> int:
    """The batch's padded node rows: the node budget, in whole 128-row
    blocks where the data layer builds plans."""
    budget = int(config["task_params"]["max_nodes_per_batch"])
    params = config["task_params"]
    if params.get("use_pair_spmm") or params.get("use_pallas_spmm"):
        budget = -(-budget // BLOCK_NODES) * BLOCK_NODES
    return budget


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 explicit mantissa bits, to nearest even)."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """A 2-D product of TF32-rounded operands, its backward products too,
    accumulated in float32: the tensor cores' TF32 on the CPU."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return g @ b.t(), a.t() @ g


def stream_round(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` through the stream dtype and back to float32; fp8 scaled per
    tensor."""
    if dtype is FP8:
        scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
        return (x / scale).to(dtype).float() * scale
    return x.to(dtype).float()


class Precision:
    def __init__(self, name: str):
        if name not in ("f32", "tf32", "fp8_stream"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def stream(self, dtype):
        """The edge stream's dtype as this precision runs it."""
        if self.name == "fp8_stream" and dtype in (torch.bfloat16,
                                                   torch.float16):
            return FP8
        return dtype

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "tf32" and a.device.type == "cpu":
            return _TF32MatMul.apply(a, b)
        return torch.matmul(a, b)

    @contextlib.contextmanager
    def flags(self):
        """TF32 on the card's matrix products as this precision asks."""
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        on = self.name == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old


class StreamSum(torch.autograd.Function):
    """``out[t] = sum over edges e=(r -> t) of scale_e * stream(table[r])``
    and its transpose for the table's gradient, ``stream`` the round trip
    through the edge dtype (or none)."""

    @staticmethod
    def forward(ctx, table, rows, targets, scale, num_out: int,
                stream_dtype, per_edge: bool):
        ctx.save_for_backward(rows, targets, scale)
        ctx.num_rows, ctx.stream_dtype = table.shape[0], stream_dtype
        ctx.per_edge = per_edge
        streamed = (stream_round(table, stream_dtype) if stream_dtype
                    else table)
        out = table.new_zeros((num_out, table.shape[1]))
        return out.index_add_(0, targets, streamed[rows] * scale[:, None])

    @staticmethod
    def backward(ctx, g):
        rows, targets, scale = ctx.saved_tensors
        dtype = ctx.stream_dtype
        grad = g.new_zeros((ctx.num_rows, g.shape[1]))
        if dtype is None:
            return (grad.index_add_(0, rows, g[targets] * scale[:, None]),
                    None, None, None, None, None, None)
        if ctx.per_edge:
            per_edge = stream_round(g[targets] * scale[:, None], dtype)
            grad = stream_round(grad.index_add_(0, rows, per_edge), dtype)
        else:
            streamed = stream_round(g, dtype)
            grad.index_add_(0, rows, streamed[targets] * scale[:, None])
        return grad, None, None, None, None, None, None


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator,
            rows_drawn: int) -> torch.Tensor:
    """Inverted dropout; a rate of 0 draws nothing, as in the program."""
    if rate <= 0.0:
        return x
    keep_prob = 1.0 - rate
    mask = torch.rand((rows_drawn,) + tuple(x.shape[1:]),
                      generator=generator, device=x.device) < keep_prob
    return torch.where(mask[:x.shape[0]], x / keep_prob,
                       torch.zeros_like(x))


def segment_sum(x: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    return x.new_zeros((n,) + tuple(x.shape[1:])).index_add_(0, ids, x)


def segment_softmax(scores, ids, n):
    maxes = torch.full((n,) + tuple(scores.shape[1:]), float("-inf"),
                       device=scores.device)
    index = ids[:, None].expand_as(scores)
    maxes = maxes.scatter_reduce(0, index, scores.detach(), reduce="amax")
    maxes = torch.where(torch.isfinite(maxes), maxes, torch.zeros_like(maxes))
    exp = torch.exp(scores - maxes[ids])
    return exp / (segment_sum(exp, ids, n) + SMALL_NUMBER)[ids]


def leaky_relu(x):
    return torch.where(x >= 0, x, 0.2 * x)


ACTIVATIONS = {"tanh": torch.tanh, "relu": torch.relu,
               "leaky_relu": leaky_relu, "linear": lambda x: x}


class Graphs:
    """One draw as device tensors: features, the edges of every type in the
    stacked [L * N] table rows, their 1/deg scales, the node-to-graph map
    and the labels."""

    def __init__(self, draw, device):
        n = draw.num_nodes
        self.num_nodes, self.num_graphs = n, draw.num_graphs
        self.features = torch.as_tensor(draw.node_features, device=device)
        rows, targets, inv = [], [], []
        for l, adj in enumerate(draw.edges):
            src = adj[:, 0].astype(np.int64)
            tgt = adj[:, 1].astype(np.int64)
            deg = torch.as_tensor(np.bincount(tgt, minlength=n)
                                  .astype(np.float32))
            scale = 1.0 / (deg + SMALL_NUMBER)
            rows.append(torch.as_tensor(src + l * n))
            targets.append(torch.as_tensor(tgt))
            inv.append(scale[torch.as_tensor(tgt)])
        self.rows = torch.cat(rows).to(device)
        self.targets = torch.cat(targets).to(device)
        self.inv_scale = torch.cat(inv).to(device)
        self.node_to_graph = torch.as_tensor(
            draw.node_to_graph.astype(np.int64), device=device)
        self.node_labels = (None if draw.node_labels is None else
                            torch.as_tensor(draw.node_labels, device=device))
        self.graph_targets = (None if draw.graph_targets is None else
                              torch.as_tensor(draw.graph_targets,
                                              device=device))


class Model:
    """The forward pass and loss of the configuration, over weights held
    by name (the program's parameter names and layouts: ``[out, in]``
    linears, ``[L, in, out]`` typed kernels, ``[in, 3H]`` GRU kernels)."""

    def __init__(self, config: Dict[str, Any], num_types: int,
                 precision: Precision):
        self.config, self.num_types, self.p = config, num_types, precision
        h = lambda key: hyper(config, "gnn_" + key)  # noqa: E731
        if h("message_calculation_class") != "rgcn":
            raise ValueError("this reference implements RGCN only")
        if (h("use_target_state_as_input")
                or h("num_edge_MLP_hidden_layers")
                or h("aggregation_function") != "sum"
                or h("message_activation_before_aggregation")
                or h("dense_dtype") != "float32"):
            raise ValueError("this reference implements RGCN's source-only "
                             "sum of f32 products, activation after it")
        self.hidden = h("hidden_dim")
        self.layers = h("num_layers")
        self.residual_every = h("residual_every_num_layers")
        self.dense_every = h("dense_every_num_layers")
        self.layernorm = h("use_inter_layer_layernorm")
        self.initial_act = ACTIVATIONS[
            h("initial_node_representation_activation")]
        self.dense_act = ACTIVATIONS[h("dense_intermediate_layer_activation")]
        self.message_act = ACTIVATIONS[h("message_activation_function")]
        self.input_dropout = h("layer_input_dropout_rate")
        self.normalize = h("normalize_by_num_incoming")
        edge_dtype = h("edge_dtype")
        self.stream_dtype = precision.stream(
            None if edge_dtype == "float32" else getattr(torch, edge_dtype))
        every = h("global_exchange_every_num_layers")
        self.exchange_layers = [i for i in range(self.layers)
                                if i and i % every == 0]
        if self.exchange_layers:
            if (h("global_exchange_mode") != "gru"
                    or h("global_exchange_weighting_fun") != "softmax"):
                raise ValueError("this reference implements the GRU exchange "
                                 "with a softmax readout only")
            self.heads = h("global_exchange_num_heads")
            self.exchange_dropout = h("global_exchange_dropout_rate")
        self.rows_drawn = padded_nodes(config)
        task = config["task_params"]
        self.per_edge = not (task.get("use_pair_spmm")
                             or task.get("use_pallas_spmm"))

    def linear(self, w, name, x, bias: bool = False):
        y = self.p.mm(x, w[name + ".weight"].t())
        return y + w[name + ".bias"] if bias else y

    def exchange(self, w, i, x, graphs, generator):
        pre = f"gnn.global_exchange_{i}."
        readout = pre + "node_to_graph_representation."
        ids, n_graphs = graphs.node_to_graph, graphs.num_graphs
        hidden = torch.relu(self.linear(w, readout + "scoring_mlp.hidden_0",
                                        x))
        hidden = dropout(hidden, READOUT_DROPOUT, generator, self.rows_drawn)
        scores = self.linear(w, readout + "scoring_mlp.out", hidden)
        weights = segment_softmax(scores, ids, n_graphs)
        hidden = torch.relu(self.linear(
            w, readout + "transformation_mlp.hidden_0", x))
        hidden = dropout(hidden, READOUT_DROPOUT, generator, self.rows_drawn)
        values = torch.relu(self.linear(
            w, readout + "transformation_mlp.out", hidden))
        weighted = weights[:, :, None] * values.reshape(
            -1, self.heads, self.hidden // self.heads)
        summary = segment_sum(weighted.reshape(-1, self.hidden), ids,
                              n_graphs)
        inputs = dropout(summary[ids], self.exchange_dropout, generator,
                         self.rows_drawn)
        gates_x = self.p.mm(inputs, w[pre + "gru_cell.kernel"]) + w[
            pre + "gru_cell.input_bias"]
        gates_h = self.p.mm(x, w[pre + "gru_cell.recurrent_kernel"]) + w[
            pre + "gru_cell.recurrent_bias"]
        x_z, x_r, x_h = torch.chunk(gates_x, 3, dim=-1)
        h_z, h_r, h_h = torch.chunk(gates_h, 3, dim=-1)
        z = torch.sigmoid(x_z + h_z)
        r = torch.sigmoid(x_r + h_r)
        candidate = torch.tanh(x_h + r * h_h)
        return z * x + (1.0 - z) * candidate

    def encode(self, w, graphs: Graphs, generator) -> torch.Tensor:
        n = graphs.num_nodes
        cur = self.initial_act(self.linear(
            w, "gnn.initial_node_projection", graphs.features))
        last = cur
        scale = (graphs.inv_scale if self.normalize
                 else torch.ones_like(graphs.inv_scale))
        for i in range(self.layers):
            if self.input_dropout > 0.0:
                cur = dropout(cur, self.input_dropout, generator,
                              self.rows_drawn)
            if i % self.residual_every == 0:
                tmp = cur
                if i > 0:
                    cur = (cur + last) / 2.0
                last = tmp
            kernel = w[f"gnn.mp_layer_{i}.edge_mlp_layer_0.kernel"]
            tables = torch.cat([self.p.mm(cur, kernel[l])
                                for l in range(self.num_types)])
            cur = self.message_act(StreamSum.apply(
                tables, graphs.rows, graphs.targets, scale, n,
                self.stream_dtype, self.per_edge))
            if i in self.exchange_layers:
                cur = self.exchange(w, i, cur, graphs, generator)
            if self.layernorm:
                cur = F.layer_norm(cur, (self.hidden,),
                                   w[f"gnn.layernorm_{i}.weight"],
                                   w[f"gnn.layernorm_{i}.bias"],
                                   LAYERNORM_EPS)
            if i % self.dense_every == 0:
                cur = self.dense_act(self.linear(w, f"gnn.dense_{i}", cur))
        return cur

    def loss(self, w, graphs: Graphs, generator) -> torch.Tensor:
        final = self.encode(w, graphs, generator)
        task = self.config["task"]
        if task == "NodeMulticlassTask":
            x = self.linear(w, "node_to_labels", final, bias=True)
            z = graphs.node_labels
            per_entry = (torch.clamp(x, min=0.0) - x * z
                         + torch.log1p(torch.exp(-torch.abs(x))))
            return per_entry.sum() / graphs.num_nodes
        if task == "QM9RegressionTask":
            values = self.linear(w, "regression_transform.out", final,
                                 bias=True)
            gates = self.linear(w, "regression_gate.out",
                                torch.cat([graphs.features, final], dim=-1),
                                bias=True)
            per_node = (torch.sigmoid(gates) * values).squeeze(-1)
            predicted = segment_sum(per_node, graphs.node_to_graph,
                                    graphs.num_graphs)
            err = predicted - graphs.graph_targets
            return torch.sum(err * err) / graphs.num_graphs
        raise ValueError(f"this reference has no head for {task}")


class Optimizer:
    """Adam (torch's, Keras epsilon 1e-7) or optax's RMSProp (epsilon 1e-7
    inside the root, then momentum), after clipping by value where the
    configuration asks."""

    def __init__(self, config: Dict[str, Any], weights: Dict[str, Any]):
        self.name = hyper(config, "optimizer").lower()
        self.lr = hyper(config, "learning_rate")
        self.clip = hyper(config, "gradient_clip_value")
        if (hyper(config, "gradient_clip_norm") is not None
                or hyper(config, "gradient_clip_global_norm") is not None
                or hyper(config, "learning_rate_warmup_steps") is not None
                or hyper(config, "learning_rate_decay_steps") is not None):
            raise ValueError("this reference clips by value only, at a "
                             "constant learning rate")
        self.rho = hyper(config, "rmsprop_rho")
        self.momentum = hyper(config, "momentum")
        self.state = {k: (torch.zeros_like(v), torch.zeros_like(v))
                      for k, v in weights.items()}
        self.t = 0

    def clipped(self, grads):
        if self.clip is None:
            return grads
        return {k: torch.clamp(g, -self.clip, self.clip)
                for k, g in grads.items()}

    @torch.no_grad()
    def step(self, weights, grads) -> None:
        self.t += 1
        for name, g in grads.items():
            a, b = self.state[name]
            p = weights[name]
            if self.name == "adam":
                beta1, beta2 = 0.9, 0.999
                a.mul_(beta1).add_((1.0 - beta1) * g)
                b.mul_(beta2).add_((1.0 - beta2) * g * g)
                m_hat = a / (1.0 - beta1 ** self.t)
                v_hat = b / (1.0 - beta2 ** self.t)
                p.sub_(self.lr * m_hat / (torch.sqrt(v_hat) + 1e-7))
            elif self.name == "rmsprop":
                a.mul_(self.rho).add_((1.0 - self.rho) * g * g)
                b.mul_(self.momentum).add_(-self.lr * g
                                           * torch.rsqrt(a + 1e-7))
                p.add_(b)
            else:
                raise ValueError(f"this reference has no {self.name}")


def train_readings(config: Dict[str, Any], draws: Sequence[Any],
                   weights: Dict[str, torch.Tensor], dropout_seed: int,
                   device, precision: str = "f32", steps: int = 3,
                   model_class=None, optimizer_class=None) -> Dict[str, Any]:
    """``steps`` training steps from ``weights`` over the draws in order:
    each step's loss, each leaf's first gradient (after clipping) and each
    leaf's change after the last step."""
    p = Precision(precision)
    w = {k: v.detach().clone().float().requires_grad_(True)
         for k, v in weights.items()}
    initial = {k: v.detach().clone() for k, v in w.items()}
    model = (model_class or Model)(config, len(draws[0].edges), p)
    optimizer = (optimizer_class or Optimizer)(config, w)
    generator = torch.Generator(device=device).manual_seed(dropout_seed)
    losses: List[float] = []
    first: Dict[str, torch.Tensor] = {}
    with p.flags():
        for step in range(steps):
            graphs = Graphs(draws[step], device)
            loss = model.loss(w, graphs, generator)
            grads = dict(zip(w, torch.autograd.grad(loss, list(w.values()))))
            grads = optimizer.clipped(grads)
            if step == 0:
                first = {k: g.detach().clone() for k, g in grads.items()}
            optimizer.step(w, grads)
            losses.append(float(loss.detach()))
            del graphs, loss, grads
    change = {k: w[k].detach() - initial[k] for k in w}
    return {"losses": losses, "grads": first, "changes": change}


def model_flops(config: Dict[str, Any], draw) -> float:
    """Model FLOPs of one training step on ``draw``: 2 * M * K * N for each
    dense product forward, three times that for forward and backward, plus
    2 * edges * hidden for the aggregation of each layer in each direction.
    Elementwise work and recomputation are not counted."""
    m, d = draw.num_nodes, int(draw.node_features.shape[1])
    num_types = len(draw.edges)
    edges = sum(int(a.shape[0]) for a in draw.edges)
    h = hyper(config, "gnn_hidden_dim")
    layers = hyper(config, "gnn_num_layers")
    dense_every = hyper(config, "gnn_dense_every_num_layers")
    every = hyper(config, "gnn_global_exchange_every_num_layers")
    products = [(m, d, h)]
    for i in range(layers):
        products += [(m, h, h)] * num_types
        if i and i % every == 0:
            heads = hyper(config, "gnn_global_exchange_num_heads")
            products += [(m, h, h), (m, h, heads), (m, h, TRANSFORM_HIDDEN),
                         (m, TRANSFORM_HIDDEN, h), (m, h, 3 * h),
                         (m, h, 3 * h)]
        if i % dense_every == 0:
            products.append((m, h, h))
    if config["task"] == "NodeMulticlassTask":
        products.append((m, h, int(draw.node_labels.shape[1])))
    else:
        products += [(m, h, 1), (m, d + h, 1)]
    dense = sum(2.0 * a * b * c for a, b, c in products)
    return 3.0 * dense + layers * 2 * (2.0 * edges * h)


def aggregation_flops(config: Dict[str, Any], draw) -> float:
    """Operations of one training step's aggregations: a multiply and an
    add per edge and column, forward and backward, every layer."""
    edges = sum(int(a.shape[0]) for a in draw.edges)
    return (hyper(config, "gnn_num_layers") * 2
            * 2.0 * edges * hyper(config, "gnn_hidden_dim"))


def aggregation_bytes(config: Dict[str, Any], draw) -> float:
    """Bytes one training step's aggregations must move, forward and
    backward over every layer, counted as the port's kernel bound counts
    them (``chip_smoke.py::kernel_bound_ms``): the distinct rows read in
    the stream dtype, 8 B an edge (its index and scale), 4 B an output row
    pointer and the float32 output written once. Forward: the [L * N]
    message tables into N rows; backward: the [N] cotangent into L * N
    rows."""
    n, num_types = draw.num_nodes, len(draw.edges)
    h = hyper(config, "gnn_hidden_dim")
    edge_dtype = hyper(config, "gnn_edge_dtype")
    item = 2 if edge_dtype in ("bfloat16", "float16") else 4
    edges = sum(int(a.shape[0]) for a in draw.edges)
    table_rows = len(np.unique(np.concatenate(
        [a[:, 0].astype(np.int64) + l * n for l, a in enumerate(draw.edges)])))
    cotangent_rows = len(np.unique(np.concatenate(
        [a[:, 1] for a in draw.edges])))

    def spmm(rows_read, out_rows):
        return (rows_read * h * item + edges * 8 + (out_rows + 1) * 4
                + out_rows * h * 4)

    per_layer = spmm(table_rows, n) + spmm(cotangent_rows, num_types * n)
    return hyper(config, "gnn_num_layers") * float(per_layer)
