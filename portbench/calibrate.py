"""The readings that a cell's limits are set from, at the cell's own size:

    python3 portbench/calibrate.py --workload <name> --seeds 1 2 3 ...

For each seed, in one process: the program's first three steps against
the plain reference (the lower reading); three controls, the reference in
the program's place with its dense products in TF32 (the precision below
the configuration's float32 products) or with its bfloat16 edge stream in
fp8 (the precision below that), and the program with its own
bf16-operand products switched on (``gnn_dense_dtype: bfloat16``); and
two planted faults, the reference in the program's place with the loss
over the first half of the batch's nodes or graphs, the mean taken over
them, and with each update applied with the wrong sign. A state left
unchanged reads 1 on the change numbers by construction (a norm of 0
against the reference's) and is not run. One JSON line a seed on
standard output: each side's numbers and losses, and each leaf's norms
([reference, side, difference]) of the first gradient and of the change,
from which any number of ``check.py`` can be worked out again; the limits
go in ``portbench/limits/<workload>.json`` with the readings they were set
from.
"""
import argparse
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.check import leaf_norms, numbers_from_norms  # noqa: E402
from portbench.reference import rgcn  # noqa: E402


class HalfBatch(rgcn.Model):
    """The reference with half of each batch left out of the loss, the
    mean taken over the rest."""

    def loss(self, w, graphs, generator):
        final = self.encode(w, graphs, generator)
        if self.config["task"] == "NodeMulticlassTask":
            x = self.linear(w, "node_to_labels", final, bias=True)
            z = graphs.node_labels
            per_entry = (torch.clamp(x, min=0.0) - x * z
                         + torch.log1p(torch.exp(-torch.abs(x))))
            half = graphs.num_nodes // 2
            return per_entry[:half].sum() / half
        values = self.linear(w, "regression_transform.out", final, bias=True)
        gates = self.linear(w, "regression_gate.out",
                            torch.cat([graphs.features, final], dim=-1),
                            bias=True)
        per_node = (torch.sigmoid(gates) * values).squeeze(-1)
        predicted = rgcn.segment_sum(per_node, graphs.node_to_graph,
                                     graphs.num_graphs)
        half = graphs.num_graphs // 2
        err = (predicted - graphs.graph_targets)[:half]
        return torch.sum(err * err) / half


class Ascent(rgcn.Optimizer):
    """The reference's optimizer with each update applied with the wrong
    sign (its state as it should be)."""

    @torch.no_grad()
    def step(self, weights, grads) -> None:
        before = {k: v.detach().clone() for k, v in weights.items()}
        super().step(weights, grads)
        for k, v in weights.items():
            v.copy_(2.0 * before[k] - v)


def _side(readings, reference) -> dict:
    grads = leaf_norms(readings["grads"], reference["grads"])
    changes = leaf_norms(readings["changes"], reference["changes"])
    return {"numbers": numbers_from_norms(readings["losses"],
                                          reference["losses"], grads,
                                          changes),
            "losses": readings["losses"], "grads": grads,
            "changes": changes}


def readings_for_seed(cell, seed: int, device, log) -> dict:
    start = time.perf_counter()
    session = harness.Session(cell, seed, device)
    program = session.readings
    session.free()
    set_up = time.perf_counter() - start
    draws = session.draws[:harness.CHECKED_STEPS]
    args = (cell.config, draws, session.weights, session.dropout_seed,
            device)
    start = time.perf_counter()
    reference = cell.reference.train_readings(*args)
    harness._sync(device)
    reference_s = time.perf_counter() - start
    bf16_cell = copy.deepcopy(cell)
    bf16_cell.config["model_params"]["gnn_dense_dtype"] = "bfloat16"
    bf16 = harness.Session(bf16_cell, seed, device)
    bf16.free()
    sides = {
        "program": program,
        "control_tf32": cell.reference.train_readings(*args,
                                                      precision="tf32"),
        "control_bf16_dense": bf16.readings,
        "control_fp8_stream": cell.reference.train_readings(
            *args, precision="fp8_stream"),
        "fault_half_batch": cell.reference.train_readings(
            *args, model_class=HalfBatch),
        "fault_wrong_sign": cell.reference.train_readings(
            *args, optimizer_class=Ascent),
    }
    line = {"workload": cell.name, "seed": seed,
            "reference_losses": reference["losses"],
            "set_up_s": set_up, "reference_s": reference_s}
    line.update({name: _side(readings, reference)
                 for name, readings in sides.items()})
    log(f"{cell.name} seed {seed}: " + json.dumps(
        {name: line[name]["numbers"] for name in sides}))
    return line


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.load_cell(args.workload)
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        line = readings_for_seed(cell, seed, device,
                                 lambda s: print(s, file=sys.stderr))
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
