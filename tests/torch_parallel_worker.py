"""The rank side of the port's scale-out tests: ``run_cases`` runs, in one
rank's process of a gloo cluster (``tf2_gnn_tpu_torch.parallel.launch.
run_ranks``), every case a test file hands it, and returns what each case
read on that rank. It imports the port only (never JAX), so each rank
starts as a user's process would.

A case is a dict:

* ``kind``: ``"spmd"`` (one graph partitioned over the ranks: the stacked
  forward, then with ``train`` one train step and with ``eval`` the eval
  metrics), ``"dp"`` (one stacked batch a rank, ``"batches"``) or
  ``"hybrid"`` (``"replicas"`` graphs, each partitioned over half the
  ranks);
* ``task`` (``"node"`` or ``"regression"``), ``params`` (the flat
  hyperparameters), ``input_dim``, ``num_edge_types``, ``num_labels`` and
  ``state`` (the weights bridged from the JAX model, numpy);
* for ``"spmd"``: ``graph`` (node features, adjacency, node-to-graph,
  graph count), ``node_labels`` and ``partition`` (``partition_graph``'s
  keywords).

A case may carry a ``fault`` (``FAULTS``), planted on every rank for its
run, so that a test can show that its check refuses it.

Each rank returns, per case: the restored per-node forward output
(``"forward"``, rank 0 only), the forward's collective counts, the train
step's metrics and every parameter after it (``"params"``), the eval
metrics, and the layers' routes.
"""
import contextlib
from typing import Any, Dict, List
from unittest import mock

import numpy as np
import torch


def _model(case, device):
    from tf2_gnn_tpu_torch.models import GraphRegressionTask, NodeMulticlassTask

    if case["task"] == "node":
        model = NodeMulticlassTask(case["params"], case["input_dim"],
                                   case["num_edge_types"],
                                   num_labels=case["num_labels"])
    else:
        model = GraphRegressionTask(case["params"], case["input_dim"],
                                    case["num_edge_types"])
    model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                           for k, v in case["state"].items()})
    return model.to(device)


def _floats(metrics: Dict[str, Any]) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()}


def _params(model) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}


def _train(case, model, mesh, make_step, batch, labels):
    from tf2_gnn_tpu_torch.harness.optimizers import make_optimizer
    from tf2_gnn_tpu_torch.harness.training import create_train_state

    optimizer = make_optimizer(case["params"], model.parameters())
    state = create_train_state(model, optimizer, seed=0)
    step = make_step(model, optimizer, mesh)
    _, metrics = step(state, batch, labels)
    return _floats(metrics)


def _route(model, batch) -> str:
    """The fused route the first layer takes on ``batch``."""
    layer = model.gnn.mp_layer_0
    return layer._route(batch) if hasattr(layer, "_route") else "unfused"


def spmd_case(rank: int, world: int, case) -> Dict[str, Any]:
    from tf2_gnn_tpu_torch.parallel import (
        distribute_batch,
        make_mesh,
        make_spmd_eval_step,
        make_spmd_forward,
        make_spmd_train_step,
        partition_graph,
        replicate_to_mesh,
        restore_node_order,
    )
    from tf2_gnn_tpu_torch.parallel import collectives

    device = collectives.process_device()
    mesh = make_mesh(axis_name="nodes")
    nf, adj, n2g, num_graphs = case["graph"]
    host, host_labels = partition_graph(
        nf, adj, n2g, num_graphs, world,
        node_labels={"node_labels": case["node_labels"]},
        **case["partition"])
    model = _model(case, device)
    replicate_to_mesh(mesh, model)
    batch, labels = distribute_batch(mesh, (host, host_labels), "nodes")
    out: Dict[str, Any] = {"rank": rank, "route": _route(model, batch)}
    collectives.reset_counts()
    stacked = make_spmd_forward(model, mesh)(batch)
    out["forward_counts"] = collectives.counts_snapshot()
    logits = stacked[0] if isinstance(stacked, tuple) else stacked
    if rank == 0:
        out["stacked"] = logits.cpu().numpy()
        out["forward"] = (restore_node_order(logits, host)
                          if case["task"] == "node" else None)
    if case.get("eval"):
        out["eval"] = _floats(make_spmd_eval_step(model, mesh)(batch,
                                                               labels))
    if case.get("train"):
        out["metrics"] = _train(case, model, mesh, make_spmd_train_step,
                                batch, labels)
        out["params"] = _params(model)
    return out


def dp_case(rank: int, world: int, case) -> Dict[str, Any]:
    from tf2_gnn_tpu_torch.parallel import (
        distribute_batch,
        make_dp_eval_step,
        make_dp_train_step,
        make_mesh,
        stack_batches,
    )
    from tf2_gnn_tpu_torch.parallel import collectives

    device = collectives.process_device()
    mesh = make_mesh()
    pairs = case["batches"]
    stacked = stack_batches([b for b, _ in pairs], [l for _, l in pairs])
    batch, labels = distribute_batch(mesh, stacked)
    model = _model(case, device)
    out = {"rank": rank,
           "eval": _floats(make_dp_eval_step(model, mesh)(batch, labels))}
    out["metrics"] = _train(case, model, mesh, make_dp_train_step, batch,
                            labels)
    out["params"] = _params(model)
    return out


def hybrid_case(rank: int, world: int, case) -> Dict[str, Any]:
    from tf2_gnn_tpu_torch.parallel import (
        distribute_batch,
        make_hybrid_mesh,
        make_hybrid_train_step,
        partition_graph,
        stack_partitioned_batches,
    )
    from tf2_gnn_tpu_torch.parallel import collectives

    device = collectives.process_device()
    replicas = len(case["replicas"])
    mesh = make_hybrid_mesh(replicas, world // replicas)
    parts = [partition_graph(nf, adj, n2g, g, world // replicas,
                             node_labels={"node_labels": lab},
                             **case["partition"])
             for nf, adj, n2g, g, lab in case["replicas"]]
    stacked = stack_partitioned_batches([b for b, _ in parts],
                                        [l for _, l in parts])
    batch, labels = distribute_batch(mesh, stacked, ("data", "nodes"))
    model = _model(case, device)
    out = {"rank": rank}
    out["metrics"] = _train(case, model, mesh, make_hybrid_train_step,
                            batch, labels)
    out["params"] = _params(model)
    return out


RUNNERS = {"spmd": spmd_case, "dp": dp_case, "hybrid": hybrid_case}


def _patches(fault: str):
    """The patches of a planted fault:

    * ``halo_backward``: the halo's gradients never reach their owners
      (the backward of the ring's ppermute and of the dense all_to_all
      gives zeros);
    * ``ring_inverse``: the ring's backward sends by the forward's
      permutation (``i -> i + k``) instead of its inverse;
    * ``gradient_factor``: the gradients are psum-ed over the shards but
      not divided (a missing pmean)."""
    from tf2_gnn_tpu_torch.parallel import collectives, spmd

    if fault == "halo_backward":
        return [mock.patch.object(
                    collectives._PPermute, "backward", staticmethod(
                        lambda ctx, g: (torch.zeros_like(g), None, None))),
                mock.patch.object(
                    collectives._AllToAll, "backward", staticmethod(
                        lambda ctx, g: (torch.zeros_like(g), None)))]
    if fault == "ring_inverse":
        return [mock.patch.object(
            collectives._PPermute, "backward", staticmethod(
                lambda ctx, g: (collectives._shift("ppermute", g, ctx.axis,
                                                   ctx.k), None, None)))]
    assert fault == "gradient_factor", fault
    mean = spmd.mean_gradients

    def summed(model, axis):
        mean(model, axis)
        for p in model.parameters():
            if p.grad is not None:
                p.grad.mul_(collectives.axis_size(axis))

    return [mock.patch.object(spmd, "mean_gradients", summed)]


def run_cases(rank: int, world: int, cases) -> List[Dict[str, Any]]:
    """Every case in order on this rank (all ranks run them alike)."""
    results = []
    for case in cases:
        with contextlib.ExitStack() as stack:
            if case.get("fault"):
                for patch in _patches(case["fault"]):
                    stack.enter_context(patch)
            results.append(RUNNERS[case["kind"]](rank, world, case))
    return results
