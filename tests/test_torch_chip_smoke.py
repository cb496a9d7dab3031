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
"""
import pytest
import torch

import chip_smoke
from tf2_gnn_tpu_torch import workloads
from tf2_gnn_tpu_torch.models.node_multiclass_task import NodeMulticlassTask
from tf2_gnn_tpu_torch.models.qm9_regression_task import QM9RegressionTask
from tf2_gnn_tpu_torch.ops import pair_spmm as tps


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
