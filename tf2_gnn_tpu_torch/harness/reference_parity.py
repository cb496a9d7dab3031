"""Hold the port to the TF reference's own recorded runs.

``tests/fixtures/reference_dumps/<name>/dump.npz`` are runs of the original
tf2-gnn on CPU TensorFlow: the first VALIDATION batch (``feat::*``,
``label::*``), every variable by its Keras name (``var::*``), each GNN
layer's representation (``rep::i``), ``final_reps``, ``task_output``,
``loss`` and every loss gradient (``grad::*``); ``meta.json`` holds the
model and dataset parameters. The JAX package's
``tests/test_reference_parity.py`` holds the JAX package to them; this
module does the same for the port, on any device:

1. ``build``: the dump's data through the port's loaders (``write_data``
   regenerates the PPI and QM9 files the dumps were recorded on with
   ``workloads.write_ppi_dataset`` / ``write_qm9_dataset``; the
   GraphRegression dumps read ``tests/fixtures/ref_molecules``), with the
   dump's ``dataset_params`` and the edge stream pinned to float32 (the
   dumps are f32 runs), and a plan kind (``PLAN_PARAMS``: ``"none"``, no
   plans and the unfused route; ``"per_type"`` pair plans; the
   ``"merged"`` pair plan);
2. ``check_batch``: the first VALIDATION batch equals the dump's in its
   real rows (features, node-to-graph map, adjacency, PPI labels);
3. ``import_weights``: the ``var::`` weights through
   ``import_reference.import_reference_weights``; any unmapped variable
   raises;
4. ``run`` and ``compare``: each layer's representation, the final
   representations, the task output and the loss of an eval forward, and
   the gradients of one backward pass (mapped by
   ``map_reference_variables``), each against the dump at the parity
   test's tolerances. ``compare`` returns each quantity's largest error
   as a share of its limit (at most 1 passes) and raises naming the
   worst where one exceeds it.
"""
import json
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from .. import workloads
from ..data.graph_dataset import DataFold
from .import_jax import flatten_params, state_dict_to_flax_params
from .import_reference import import_reference_weights, map_reference_variables
from .run import get_model_and_dataset_from_args, get_train_cli_arg_parser
from .training import to_device

FIXTURES = Path(__file__).resolve().parents[2] / "tests" / "fixtures"
DUMPS_DIR = FIXTURES / "reference_dumps"
MOLECULES_DIR = FIXTURES / "ref_molecules"

# (dump directory, task, model), as the JAX package's parity test has them.
CASES = (
    ("rgcn", "GraphRegression", "RGCN"),
    ("RGAT", "GraphRegression", "RGAT"),
    ("GGNN", "GraphRegression", "GGNN"),
    ("RGIN", "GraphRegression", "RGIN"),
    ("GNN_FiLM", "GraphRegression", "GNN_FiLM"),
    ("GNN_Edge_MLP", "GraphRegression", "GNN_Edge_MLP"),
    ("ppi_rgcn", "PPI", "RGCN"),
    ("qm9_rgcn", "QM9", "RGCN"),
)

# The parity test's tolerances: representations and outputs allclose at
# RTOL / ATOL, the loss at LOSS_RTOL, each gradient within GRAD_RTOL of its
# tensor's largest entry.
RTOL = 2e-4
ATOL = 1e-4
LOSS_RTOL = 5e-4
GRAD_RTOL = 5e-3

# The dataset parameters of each plan kind. The merged plan is RGAT's, at
# a node budget of 1024 (the dump's batch is 200 nodes): at the dumps'
# 10000 the reference's static gate of pair attention (its VMEM budgets,
# ``ops/pair_attention.py::pair_attention_applicable``) sends RGAT down its
# unfused path.
PLAN_PARAMS = {
    "none": {"use_pair_spmm": False, "use_pallas_spmm": False},
    "per_type": {"use_pair_spmm": True, "pair_per_type": True},
    "merged": {"use_pair_spmm": True, "max_nodes_per_batch": 1024},
}
# The plan kind whose fused route each flavour takes: per-type pair plans
# (K2 and K1 for RGCN, GGNN and RGIN; K1 both ways for GNN-FiLM and the
# 0-hidden target-state GNN_Edge_MLP), the merged pair plan for RGAT.
FUSED_PLANS = {"RGCN": "per_type", "GGNN": "per_type", "RGIN": "per_type",
               "GNN_FiLM": "per_type", "GNN_Edge_MLP": "per_type",
               "RGAT": "merged"}


class Dump(NamedTuple):
    name: str
    task: str
    model: str
    arrays: Dict[str, np.ndarray]
    meta: Dict[str, Any]

    @property
    def variables(self) -> Dict[str, np.ndarray]:
        return {k[5:]: v for k, v in self.arrays.items()
                if k.startswith("var::")}

    @property
    def gradients(self) -> Dict[str, np.ndarray]:
        return {k[6:]: v for k, v in self.arrays.items()
                if k.startswith("grad::")}

    @property
    def use_target_state_as_input(self) -> bool:
        return bool(self.meta["model_params"].get(
            "gnn_use_target_state_as_input", False))


class Outputs(NamedTuple):
    reps: Tuple[np.ndarray, ...]     # real rows of each captured layer
    final: np.ndarray                # real rows of the final states
    task_output: np.ndarray          # real rows (nodes or graphs)
    loss: float
    grads: Dict[Tuple[str, ...], np.ndarray]  # flax path -> gradient


def load_dump(name: str, dumps_dir: Path = DUMPS_DIR) -> Dump:
    task, model = {c[0]: c[1:] for c in CASES}[name]
    with np.load(Path(dumps_dir) / name / "dump.npz") as npz:
        arrays = {k: npz[k] for k in npz.files}
    with open(Path(dumps_dir) / name / "meta.json") as f:
        meta = json.load(f)
    return Dump(name, task, model, arrays, meta)


def write_data(task: str, root: Path) -> Path:
    """The data directory a dump of ``task`` was recorded on: the PPI and
    QM9 files regenerated under ``root`` from the recording's arguments,
    the fixture molecules for GraphRegression."""
    if task == "GraphRegression":
        return MOLECULES_DIR
    if task == "PPI":
        return workloads.write_ppi_dataset(
            Path(root) / "ppi", graphs_per_fold=3, nodes_per_graph=40,
            feature_dim=50, num_labels=121, seed=7)
    if task == "QM9":
        return workloads.write_qm9_dataset(Path(root) / "qm9", num_graphs=12,
                                           feature_dim=15, seed=7)
    raise ValueError(f"no recorded dataset for task {task}")


def build(dump: Dump, data_path: Path, plans: str = "none", device="cuda"):
    """(model on ``device`` with fresh weights, dataset with TRAIN and
    VALIDATION loaded) through the command line's own resolution, with the
    dump's parameters, the edge stream in float32 and ``plans``."""
    model_params = dict(dump.meta["model_params"], gnn_edge_dtype="float32")
    data_params = dict(dump.meta["dataset_params"], **PLAN_PARAMS[plans])
    args = get_train_cli_arg_parser().parse_args([
        dump.model, dump.task, str(data_path),
        "--model-params-override", json.dumps(model_params),
        "--data-params-override", json.dumps(data_params),
        "--device", str(device)])
    model, _, dataset = get_model_and_dataset_from_args(args)
    return model, dataset


def first_batch(dataset):
    """The first VALIDATION (batch, labels), on the host."""
    return next(iter(dataset.batch_iterator(DataFold.VALIDATION)))


def check_batch(batch, labels, dump: Dump) -> None:
    """The padded host batch holds exactly the dump's batch in its real
    rows; raises AssertionError otherwise."""
    v, g = int(batch.num_nodes), int(batch.num_graphs)
    ref_feat = dump.arrays["feat::node_features"]
    if (v, g) != (ref_feat.shape[0],
                  int(dump.arrays["feat::num_graphs_in_batch"])):
        raise AssertionError(f"{dump.name}: batch of {v} nodes and {g} "
                             f"graphs vs the dump's {ref_feat.shape[0]}")
    np.testing.assert_allclose(np.asarray(batch.node_features)[:v], ref_feat,
                               rtol=1e-6, atol=0)
    np.testing.assert_array_equal(np.asarray(batch.node_to_graph)[:v],
                                  dump.arrays["feat::node_to_graph_map"])
    for t in range(len(batch.edge_sources)):
        adj = dump.arrays[f"feat::adjacency_list_{t}"]
        count = int(np.asarray(batch.num_edges)[t])
        if count != adj.shape[0]:
            raise AssertionError(f"{dump.name}: type {t} has {count} edges "
                                 f"vs the dump's {adj.shape[0]}")
        np.testing.assert_array_equal(
            np.asarray(batch.edge_sources[t])[:count], adj[:, 0])
        np.testing.assert_array_equal(
            np.asarray(batch.edge_targets[t])[:count], adj[:, 1])
    if dump.task == "PPI":
        np.testing.assert_allclose(np.asarray(labels["node_labels"])[:v],
                                   dump.arrays["label::node_labels"],
                                   rtol=1e-6, atol=0)


def import_weights(model, dump: Dump) -> List[str]:
    """Import the dump's variables into ``model``; returns the importer's
    log. Raises where a reference variable or a model parameter is left
    unmatched."""
    lines: List[str] = []
    import_reference_weights(
        model, dump.variables,
        use_target_state_as_input=dump.use_target_state_as_input,
        log=lines.append)
    unmatched = [line for line in lines if line.startswith("W:")]
    if unmatched:
        raise AssertionError(f"{dump.name}: the import left variables "
                             f"unmatched: {unmatched}")
    return lines


def _real_rows(x: torch.Tensor, batch) -> np.ndarray:
    x = x.detach().float().cpu().numpy()
    if x.ndim and x.shape[0] == batch.num_nodes_padded:
        return x[:int(batch.num_nodes)]
    if x.ndim and x.shape[0] == batch.num_graphs_padded:
        return x[:int(batch.num_graphs)]
    return x


def run(model, batch, labels) -> Outputs:
    """The eval forward's representations, task output and loss, and the
    loss gradients of one backward pass, on the model's device (``batch``
    and ``labels`` on the host)."""
    device = next(model.parameters()).device
    batch, labels = to_device(batch, labels, device)
    model.eval()
    model.zero_grad(set_to_none=True)
    with torch.no_grad():
        final, reps = model.gnn(batch, False)
    out = model(batch, False)
    loss = model.compute_task_metrics(batch, out, labels)["loss"]
    loss.backward()
    grads = {name: (p.grad if p.grad is not None else torch.zeros_like(p))
             for name, p in model.named_parameters()}
    task_output = out[0] if isinstance(out, (tuple, list)) else out
    return Outputs(
        reps=tuple(_real_rows(r, batch) for r in reps),
        final=_real_rows(final, batch),
        task_output=_real_rows(task_output, batch),
        loss=float(loss.detach().cpu()),
        grads=flatten_params(state_dict_to_flax_params(grads)))


def _allclose_share(got: np.ndarray, want: np.ndarray) -> float:
    """The largest |got - want| / (ATOL + RTOL |want|): at most 1 is
    ``np.allclose(got, want, RTOL, ATOL)``."""
    got = np.asarray(got, np.float64).reshape(want.shape)
    return float(np.max(np.abs(got - want) / (ATOL + RTOL * np.abs(want)),
                        initial=0.0))


def compare(outputs: Outputs, dump: Dump) -> Dict[str, Tuple[float, float]]:
    """Each quantity's (largest error as a share of its limit, largest
    absolute error) against the dump: ``rep::i``, ``final_reps``,
    ``task_output`` and ``loss``, and ``grads`` (the worst gradient's
    share; its absolute error is that of the worst tensor). Raises
    AssertionError naming every quantity whose share exceeds 1."""
    arrays = dump.arrays
    ref_reps = sorted((int(k.split("::")[1]), v) for k, v in arrays.items()
                      if k.startswith("rep::"))
    if len(ref_reps) != len(outputs.reps):
        raise AssertionError(f"{dump.name}: {len(outputs.reps)} captured "
                             f"representations vs {len(ref_reps)}")
    report = {}
    for (idx, want), got in zip(ref_reps, outputs.reps):
        report[f"rep::{idx}"] = (_allclose_share(got, want),
                                 float(np.abs(got - want).max()))
    wanted = {"final_reps": (outputs.final, arrays["final_reps"]),
              "task_output": (outputs.task_output, arrays.get(
                  "task_output", arrays.get("task_output::0")))}
    for what, (got, want) in wanted.items():
        got = np.asarray(got).reshape(want.shape)
        report[what] = (_allclose_share(got, want),
                        float(np.abs(got - want).max()))
    ref_loss = float(arrays["loss"])
    loss_err = abs(outputs.loss - ref_loss)
    report["loss"] = (loss_err / (LOSS_RTOL * abs(ref_loss)), loss_err)
    mapped, _ = map_reference_variables(
        dump.gradients,
        use_target_state_as_input=dump.use_target_state_as_input,
        log=lambda *_: None)
    if not mapped:
        raise AssertionError(f"{dump.name}: the dump has no gradients")
    worst = (0.0, 0.0, "")
    for path, want in sorted(mapped.items()):
        got = outputs.grads.get(path)
        if got is None:
            raise AssertionError(f"{dump.name}: no gradient computed for "
                                 f"{'/'.join(path)}")
        scale = max(float(np.abs(want).max()), 1e-8)
        err = float(np.abs(got - want).max())
        share = err / scale / GRAD_RTOL
        if share >= worst[0]:
            worst = (share, err, "/".join(path))
    report["grads"] = worst[:2]
    failed = {k: v[0] for k, v in report.items() if not v[0] <= 1.0}
    if failed:
        raise AssertionError(f"{dump.name}: diverges from the reference "
                             f"(error / limit): {failed}; worst gradient "
                             f"{worst[2]}")
    return report
