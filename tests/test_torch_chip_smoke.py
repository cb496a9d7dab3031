"""``chip_smoke.py``'s eval checks on the CPU, where the kernel wrappers
take their plain versions.

* Phase 7 (``check_eval_forward`` at ``QM9_ATOL`` / ``QM9_LOGIT_RTOL`` /
  ``QM9_LOSS_RTOL``) holds a joint kernel (K2) stand-in against the plain
  version on the shipped QM9_RGCN at 120 molecules. A stand-in that sums
  the same slots in another order (as the card's atomics do) passes it:
  the outputs move by 2.8e-3 of the largest |output| (4.0e-2 of 14.5) and
  the loss by 1.5e-4 of itself, through 8 bf16 layers with LayerNorm. A
  stand-in with one edge type's scales doubled fails it (0.74 of the
  largest |output|).
* Phase 9 holds K1 and K2 stand-ins on each of its four shipped models
  (PPI_GGNN, PPI_RGIN, PPI_GNN_Edge_MLP, PPI_GNN_FiLM, at full width) on
  the PPI batch cut to 3 graphs of 150 nodes and 1500 forward edges (V =
  512), at the model's tolerance (``FLAVOUR_MODELS``): sums in another
  order pass (up to 1.6e-3 of the largest |logit| for GGNN, 2.2e-3 for
  RGIN, 8e-6 for the f32-stream models), one edge type's scales doubled
  fail (0.79-1.1 of it).
* Phase 10 holds B3, B12 and K1 stand-ins on each of its seven routes
  (``ROUTE_MODELS``, at full width) on the same cut batches (and the QM9
  batch at 120 molecules) at the route's tolerance: sums in another order
  pass, one edge type's scales doubled (B3, K1) or one chunk's slots
  doubled (B12) fail; and each route's eval forward and train step launch
  the wrappers exactly as often as ``ROUTE_MODELS`` states, counted
  through the wrappers' plain versions.
"""
import pytest
import torch

import chip_smoke
from tf2_gnn_tpu_torch import workloads
from tf2_gnn_tpu_torch.models.node_multiclass_task import NodeMulticlassTask
from tf2_gnn_tpu_torch.models.qm9_regression_task import QM9RegressionTask
from tf2_gnn_tpu_torch.ops import pair_spmm as tps
from tf2_gnn_tpu_torch.ops import sorted_spmm as tss


@pytest.fixture(scope="module")
def qm9_case():
    batch, labels, _ = workloads.build_qm9_batch(0, device="cpu",
                                                 molecules=120,
                                                 node_budget=2304)
    model = QM9RegressionTask.from_params(
        workloads.qm9_shipped_params(), input_dim=workloads.QM9_FEATURE_DIM,
        num_edge_types=workloads.QM9_EDGE_TYPES, device="cpu", seed=0)
    return model, batch, labels


def _reordered_k2(tables, scale, rel_src, rel_tgt, src_blk, grp_tgt,
                  grp_type, v, out_rows, compact=None):
    """K2's sum over the same slots, added in a random order."""
    srcabs, tgtabs, valid = tps._stream_slot_abs_ids(
        rel_src, rel_tgt, src_blk, grp_tgt, grp_type, v)
    perm = torch.randperm(srcabs.shape[0],
                          generator=torch.Generator().manual_seed(1))
    return tps._scatter_slots(tables, scale.reshape(-1)[perm], srcabs[perm],
                              tgtabs[perm], valid[perm], out_rows)


def _type1_doubled_k2(tables, scale, rel_src, rel_tgt, src_blk, grp_tgt,
                      grp_type, v, out_rows, compact=None):
    """K2 with edge type 1's scales doubled."""
    group = tps.plan_group(src_blk, grp_tgt)
    slot_type = grp_type.long().repeat_interleave(group * tps.E_C)
    scale = torch.where(slot_type == 1, 2.0 * scale.reshape(-1),
                        scale.reshape(-1))
    return tps.pair_spmm_stream_plain(tables, scale, rel_src, rel_tgt,
                                      src_blk, grp_tgt, grp_type, v, out_rows)


def _check(model, batch, labels):
    chip_smoke.check_eval_forward(
        model, batch, labels,
        [(tps, "pair_spmm_stream_joint",
          chip_smoke.plain_version(tps.pair_spmm_stream_plain))],
        chip_smoke.QM9_LOGIT_RTOL, chip_smoke.QM9_ATOL,
        chip_smoke.QM9_LOSS_RTOL, shape=(batch.num_graphs_padded,))


def test_qm9_eval_check_passes_a_reordered_sum(qm9_case, monkeypatch):
    monkeypatch.setattr(tps, "pair_spmm_stream_joint", _reordered_k2)
    _check(*qm9_case)


def test_qm9_eval_check_catches_a_wrong_scale(qm9_case, monkeypatch):
    monkeypatch.setattr(tps, "pair_spmm_stream_joint", _type1_doubled_k2)
    with pytest.raises(AssertionError, match="eval forward"):
        _check(*qm9_case)


@pytest.fixture(scope="module")
def ppi_case():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(workloads, "NODES_PER_GRAPH", 150)
        mp.setattr(workloads, "FWD_EDGES_PER_GRAPH", 1500)
        mp.setattr(workloads, "NODE_BUDGET", 512)
        batch, labels, _ = workloads.build_ppi_batch(0, device="cpu")
    return batch, labels


def _check_flavour(model_name, batch, labels):
    name, hypers, style, _, tols = next(
        m for m in chip_smoke.FLAVOUR_MODELS if m[0] == model_name)
    model = NodeMulticlassTask.from_params(
        workloads.shipped_params(hypers, style),
        input_dim=workloads.FEATURE_DIM, num_edge_types=3, device="cpu",
        seed=0, num_labels=workloads.NUM_LABELS)
    atol, logit_rtol, loss_rtol = tols
    plain = chip_smoke.plain_version(tps.pair_spmm_stream_plain)
    chip_smoke.check_eval_forward(
        model, batch, labels,
        [(tps, "pair_spmm_stream_joint", plain),
         (tps, "pair_spmm_stream", plain)], logit_rtol, atol, loss_rtol)


FLAVOURS = [m[0] for m in chip_smoke.FLAVOUR_MODELS]


@pytest.mark.parametrize("model_name", FLAVOURS)
def test_flavour_eval_check_passes_a_reordered_sum(model_name, ppi_case,
                                                   monkeypatch):
    monkeypatch.setattr(tps, "pair_spmm_stream_joint", _reordered_k2)
    monkeypatch.setattr(tps, "pair_spmm_stream", _reordered_k2)
    _check_flavour(model_name, *ppi_case)


@pytest.mark.parametrize("model_name", FLAVOURS)
def test_flavour_eval_check_catches_a_wrong_scale(model_name, ppi_case,
                                                  monkeypatch):
    monkeypatch.setattr(tps, "pair_spmm_stream_joint", _type1_doubled_k2)
    monkeypatch.setattr(tps, "pair_spmm_stream", _type1_doubled_k2)
    with pytest.raises(AssertionError, match="eval forward"):
        _check_flavour(model_name, *ppi_case)


@pytest.fixture(scope="module")
def route_batches():
    """Phase 10's batches, cut as ``ppi_case``'s (and the QM9 batch at
    120 molecules), by kind."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(workloads, "NODES_PER_GRAPH", 150)
        mp.setattr(workloads, "FWD_EDGES_PER_GRAPH", 1500)
        mp.setattr(workloads, "NODE_BUDGET", 512)
        real = workloads.build_qm9_batch
        mp.setattr(workloads, "build_qm9_batch",
                   lambda seed, device="cuda": real(seed, device,
                                                    molecules=120,
                                                    node_budget=2304))
        return {kind: chip_smoke.route_batch(kind, "cpu")[:2]
                for kind in ("pairs", "merged_targets", "scatter", "qm9")}


def _route_case(name, route_batches):
    route = next(r for r in chip_smoke.ROUTE_MODELS if r[0] == name)
    _, source, kind, per_layer, eval_per_layer, tols, _ = route
    params = chip_smoke.route_params(source)
    batch, labels = route_batches[kind]
    if kind == "qm9":
        from tf2_gnn_tpu_torch.models.graph_regression_task import (
            GraphRegressionTask,
        )

        model = GraphRegressionTask.from_params(
            params, input_dim=workloads.QM9_FEATURE_DIM, num_edge_types=5,
            device="cpu", seed=0)
    else:
        model = NodeMulticlassTask.from_params(
            params, input_dim=workloads.FEATURE_DIM, num_edge_types=3,
            device="cpu", seed=0, num_labels=workloads.NUM_LABELS)
    return (model, params, batch, labels, kind, per_layer, eval_per_layer,
            tols)


def _reordered_b3(table, scale, rel_src, rel_tgt, src_blk, grp_tgt,
                  out_rows, compact=None, by_entry=False):
    """B3's sum over the same slots, added in a random order."""
    srcabs, tgtabs, valid = tps.slot_abs_ids(rel_src, rel_tgt, src_blk,
                                             grp_tgt)
    perm = torch.randperm(srcabs.shape[0],
                          generator=torch.Generator().manual_seed(1))
    return tps._scatter_slots(table, scale.reshape(-1)[perm], srcabs[perm],
                              tgtabs[perm], valid[perm], out_rows)


def _wrong_b3(table, scale, rel_src, rel_tgt, src_blk, grp_tgt, out_rows,
              compact=None, by_entry=False):
    """B3 with the slots of the sources of edge type 1 (rows of the second
    [V] slab of the stacked tables, or, backward, the targets of the
    second slab) doubled."""
    srcabs, tgtabs, _ = tps.slot_abs_ids(rel_src, rel_tgt, src_blk, grp_tgt)
    stacked = srcabs if table.shape[0] >= out_rows else tgtabs
    typed = stacked // (max(table.shape[0], out_rows) // 3) == 1
    scale = torch.where(typed, 2.0 * scale.reshape(-1), scale.reshape(-1))
    return tps.pair_spmm_plain(table, scale, rel_src, rel_tgt, src_blk,
                               grp_tgt, out_rows)


def _reordered_b12(msgs, rel, block_ids, num_nodes, block_rows=None,
                   compact=None):
    """B12's sum over the same slots, added in a random order."""
    r = tss._block_rows(num_nodes, block_rows)
    seg = tss._segment_ids(rel, block_ids, num_nodes, r)
    perm = torch.randperm(seg.shape[0],
                          generator=torch.Generator().manual_seed(1))
    out = torch.zeros((num_nodes + 1, msgs.shape[1]))
    out.index_add_(0, seg[perm], msgs.float()[perm])
    return out[:num_nodes]


def _wrong_b12(msgs, rel, block_ids, num_nodes, block_rows=None,
               compact=None):
    """B12 with the slots of its first chunk doubled."""
    msgs = msgs.float().clone()
    msgs[:tss.CHUNK_EDGES] *= 2.0
    return tss.sorted_segment_sum_plain(msgs, rel, block_ids, num_nodes,
                                        block_rows)


def _gathered(b12):
    """``sorted_segment_sum_gathered`` through the stand-in ``b12``."""
    def call(g, stream_row, sentinel, rel, block_ids, num_nodes,
             compact=None):
        return b12(tss._gathered_stream(g, stream_row, sentinel), rel,
                   block_ids, num_nodes)
    return call


def _check_route(case):
    model, _, batch, labels, kind, _, _, tols = case
    atol, logit_rtol, loss_rtol = tols
    plain = chip_smoke.plain_version
    chip_smoke.check_eval_forward(
        model, batch, labels,
        [(tps, "pair_spmm", plain(tps.pair_spmm_plain)),
         (tps, "pair_spmm_stream", plain(tps.pair_spmm_stream_plain)),
         (tss, "sorted_segment_sum", plain(tss.sorted_segment_sum_plain)),
         (tss, "sorted_segment_sum_gathered",
          plain(tss.sorted_segment_sum_gathered_plain))],
        logit_rtol, atol, loss_rtol,
        shape=(batch.num_graphs_padded,) if kind == "qm9" else None)


ROUTES = [r[0] for r in chip_smoke.ROUTE_MODELS]


def _stand_ins(monkeypatch, b3, b12, k1):
    monkeypatch.setattr(tps, "pair_spmm", b3)
    monkeypatch.setattr(tps, "pair_spmm_stream", k1)
    monkeypatch.setattr(tss, "sorted_segment_sum", b12)
    monkeypatch.setattr(tss, "sorted_segment_sum_gathered", _gathered(b12))


@pytest.mark.parametrize("name", ROUTES)
def test_route_eval_check_passes_a_reordered_sum(name, route_batches,
                                                 monkeypatch):
    case = _route_case(name, route_batches)
    _stand_ins(monkeypatch, _reordered_b3, _reordered_b12, _reordered_k2)
    _check_route(case)


@pytest.mark.parametrize("name", ROUTES)
def test_route_eval_check_catches_a_wrong_scale(name, route_batches,
                                                monkeypatch):
    case = _route_case(name, route_batches)
    _stand_ins(monkeypatch, _wrong_b3, _wrong_b12, _type1_doubled_k2)
    with pytest.raises(AssertionError, match="eval forward"):
        _check_route(case)


def _counting(module, name, key):
    real = getattr(module, name)

    def call(*args, **kwargs):
        module.LAUNCHES[key] += 1
        return real(*args, **kwargs)
    return call


@pytest.mark.parametrize("name", ROUTES)
def test_route_launch_counts(name, route_batches, monkeypatch):
    """Each wrapper counted where the route calls it: the eval forward and
    one train step launch exactly what ``ROUTE_MODELS`` states, and
    nothing else."""
    model, params, batch, labels, _, per_layer, eval_per_layer, _ = \
        _route_case(name, route_batches)
    for module, wrapper, key in (
            (tps, "pair_spmm", "pair_spmm"),
            (tps, "pair_spmm_stream", "pair_stream"),
            (tps, "pair_spmm_stream_joint", "pair_stream_joint"),
            (tss, "sorted_segment_sum", "sorted_segment_sum"),
            (tss, "sorted_segment_sum_scaled", "sorted_segment_sum_scaled")):
        monkeypatch.setattr(module, wrapper, _counting(module, wrapper, key))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    counters = chip_smoke.launch_counters()
    layers = params["gnn_num_layers"]
    for reset, _ in counters:
        reset()
    with torch.no_grad():
        model(batch, False)
    got = {n: c for _, counts in counters for n, c in counts.items()}
    assert got == dict(chip_smoke.zero_counts(counters), **{
        n: c * layers for n, c in eval_per_layer.items()})
    chip_smoke.train_and_count(
        model, params, batch, labels, counters,
        dict(chip_smoke.zero_counts(counters),
             **{n: c * layers for n, c in per_layer.items()}), steps=1)
