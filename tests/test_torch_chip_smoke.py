"""``chip_smoke.py``'s eval checks on the CPU, where the kernel wrappers
take their plain versions.

* Phase 7 (``check_eval_forward`` at ``QM9_ATOL`` / ``QM9_LOGIT_RTOL`` /
  ``QM9_LOSS_RTOL``) holds a joint kernel (K2) stand-in against the plain
  version on the shipped QM9_RGCN at 120 molecules (whose tables hold only
  the rows the plan reads, so K2 runs over their form: the stand-ins
  replace both K2 wrappers). A stand-in that sums
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
* Phase 11 (``UNFUSED_MODELS``, at full width on the same cut batches):
  every model takes the unfused path on the batch without plans, and its
  eval forward and a train step reach no kernel wrapper (each counted
  where the layers look it up); its eval check, as the phase runs it,
  passes (against the same weights on the per-type-plan batch through
  the plain versions, or, for the options without a fused route, against
  a CPU forward whose segment sums run in another order, as the card's
  atomics would) and fails with one edge type's messages doubled on the
  unfused side.
* Phase 13e (``hook_check``) on the PPI batch cut to 3 graphs of 150
  nodes (V = 512), at PPI_RGCN's full width: K1 and K2 once a layer and
  step, the joint plan built once for the batch, the hook's eval logits
  bit-equal to the base model's on the transformed batch; with a
  ``GraphBatch.replace`` that drops the plan forms the check fails.
* Phase 14's check (``scaleout_check``) on synthetic ranks' results:
  results equal to the single process's pass; a gradient twice the
  single process's (a missing pmean), a rank without a kernel launch,
  ranks whose parameters differ, or a loss off by 1% fail; a case with a
  planted fault (case (e) with its ring slabs zeroed) fails the phase
  when its numbers pass, and passes it when they do not. The planted
  fault itself runs at the case's own size on the card, in the phase.
* Phase 1's ptxas lines (``_ptxas_report``) on canned ``nvcc -Xptxas -v``
  output: each entry whose name holds the match, with its registers and
  the spills printed since its own ``Compiling entry function`` line;
  other entries skipped; the names through ``c++filt`` where it runs,
  as printed where it is missing or fails (``_demangle``).
"""
import subprocess

import pytest
import torch

import chip_smoke
from tf2_gnn_tpu_torch import workloads
from tf2_gnn_tpu_torch.harness import reference_parity as rp
from tf2_gnn_tpu_torch.layers.message_passing import base as tbase
from tf2_gnn_tpu_torch.layers.message_passing import rgat as trgat
from tf2_gnn_tpu_torch.models.node_multiclass_task import NodeMulticlassTask
from tf2_gnn_tpu_torch.models.qm9_regression_task import QM9RegressionTask
from tf2_gnn_tpu_torch.ops import pair_attention as tpa
from tf2_gnn_tpu_torch.ops import pair_edge_mlp as tpem
from tf2_gnn_tpu_torch.ops import pair_spmm as tps
from tf2_gnn_tpu_torch.ops import probes as tprobes
from tf2_gnn_tpu_torch.ops import segment as tseg
from tf2_gnn_tpu_torch.ops import sorted_spmm as tss
from tf2_gnn_tpu_torch.utils import tracing


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


def _reordered_rows(tables, scale, compact, out_rows):
    """K1's or K2's sum over a form alone (the read rows' forms), its
    entries added in a random order."""
    counts = torch.diff(compact.row_ptr).long()
    tgt = torch.repeat_interleave(torch.arange(out_rows), counts)
    msgs = tables[compact.src_row.long()].float()
    if scale is not None:
        msgs = msgs * scale[compact.slot.long()][:, None]
    perm = torch.randperm(tgt.shape[0],
                          generator=torch.Generator().manual_seed(1))
    out = torch.zeros((out_rows, tables.shape[1]))
    return out.index_add_(0, tgt[perm], msgs[perm])


def _type1_doubled_rows(batch):
    """K2 over the forward form of ``batch``'s read rows with edge type 1's
    scales doubled: the entries whose table row is one of type 1's."""
    offsets = batch.pair_stream_joint.read_rows.type_offsets

    def k2(tables, scale, compact, out_rows):
        src = compact.src_row.long()
        doubled = scale.clone()
        doubled[compact.slot.long()[(src >= offsets[1])
                                    & (src < offsets[2])]] *= 2.0
        return tps.slot_rows_plain(tables, doubled, compact)
    return k2


def _check(model, batch, labels):
    chip_smoke.check_eval_forward(
        model, batch, labels, chip_smoke.joint_patches(),
        chip_smoke.QM9_LOGIT_RTOL, chip_smoke.QM9_ATOL,
        chip_smoke.QM9_LOSS_RTOL, shape=(batch.num_graphs_padded,))


def test_qm9_eval_check_passes_a_reordered_sum(qm9_case, monkeypatch):
    monkeypatch.setattr(tps, "pair_spmm_stream_joint", _reordered_k2)
    monkeypatch.setattr(tps, "pair_spmm_stream_joint_rows", _reordered_rows)
    _check(*qm9_case)


def test_qm9_eval_check_catches_a_wrong_scale(qm9_case, monkeypatch):
    monkeypatch.setattr(tps, "pair_spmm_stream_joint", _type1_doubled_k2)
    monkeypatch.setattr(tps, "pair_spmm_stream_joint_rows",
                        _type1_doubled_rows(qm9_case[1]))
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
    chip_smoke.check_eval_forward(
        model, batch, labels, chip_smoke.joint_patches(), logit_rtol, atol,
        loss_rtol)


FLAVOURS = [m[0] for m in chip_smoke.FLAVOUR_MODELS]


@pytest.mark.parametrize("model_name", FLAVOURS)
def test_flavour_eval_check_passes_a_reordered_sum(model_name, ppi_case,
                                                   monkeypatch):
    monkeypatch.setattr(tps, "pair_spmm_stream_joint", _reordered_k2)
    monkeypatch.setattr(tps, "pair_spmm_stream", _reordered_k2)
    monkeypatch.setattr(tps, "pair_spmm_stream_joint_rows", _reordered_rows)
    monkeypatch.setattr(tps, "pair_spmm_stream_rows", _reordered_rows)
    _check_flavour(model_name, *ppi_case)


@pytest.mark.parametrize("model_name", FLAVOURS)
def test_flavour_eval_check_catches_a_wrong_scale(model_name, ppi_case,
                                                  monkeypatch):
    monkeypatch.setattr(tps, "pair_spmm_stream_joint", _type1_doubled_k2)
    monkeypatch.setattr(tps, "pair_spmm_stream", _type1_doubled_k2)
    monkeypatch.setattr(tps, "pair_spmm_stream_joint_rows",
                        _type1_doubled_rows(ppi_case[0]))
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
    zero = dict.fromkeys(tracing.counters("launch"), 0)
    layers = params["gnn_num_layers"]
    tracing.reset()
    with torch.no_grad():
        model(batch, False)
    assert tracing.counters("launch") == dict(zero, **{
        n: c * layers for n, c in eval_per_layer.items()})
    chip_smoke.train_and_count(
        model, params, batch, labels,
        dict(zero, **{n: c * layers for n, c in per_layer.items()}), steps=1)


@pytest.fixture(scope="module")
def unfused_batches():
    """Phase 11's batches, cut as ``route_batches``, by (kind, plans)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(workloads, "NODES_PER_GRAPH", 150)
        mp.setattr(workloads, "FWD_EDGES_PER_GRAPH", 1500)
        mp.setattr(workloads, "NODE_BUDGET", 512)
        real = workloads.build_qm9_batch
        mp.setattr(workloads, "build_qm9_batch",
                   lambda seed, device="cuda", **kw: real(
                       seed, device, molecules=120, node_budget=2304, **kw))
        return chip_smoke.unfused_batches("cpu")


UNFUSED = [m[0] for m in chip_smoke.UNFUSED_MODELS]


def _unfused_case(name, unfused_batches):
    _, source, kind, _, against, tols = next(
        m for m in chip_smoke.UNFUSED_MODELS if m[0] == name)
    params = chip_smoke.unfused_params(source)
    bare, labels, _ = unfused_batches[kind, False]
    model = chip_smoke.route_model(params, bare, "cpu", name)
    return model, params, kind, against, tols, unfused_batches


# Every kernel wrapper by the name its callers look it up under, and the
# launch count it runs under; the modules that import one by name.
WRAPPERS = {
    "pair_spmm_stream": "pair_stream",
    "pair_spmm_stream_joint": "pair_stream_joint",
    "pair_spmm_stream_rows": "pair_stream",
    "pair_spmm_stream_joint_rows": "pair_stream_joint",
    "pair_spmm_node_rows": "node_rows",
    "pair_spmm": "pair_spmm",
    **{name: name for name in (*tpa.LAUNCHES, *tpem.LAUNCHES, *tss.LAUNCHES,
                               *tprobes.LAUNCHES)},
    "sorted_segment_sum_gathered": "sorted_segment_sum",
}
CALLERS = (tps, tpa, tpem, tss, tprobes, trgat)


def _count_every_wrapper(monkeypatch):
    """Each wrapper counted under its launch count wherever a caller looks
    it up; returns the counts."""
    counts = {key: 0 for key in WRAPPERS.values()}
    for module in CALLERS:
        for name, key in WRAPPERS.items():
            real = getattr(module, name, None)
            if real is None:
                continue

            def call(*args, _real=real, _key=key, **kwargs):
                counts[_key] += 1
                return _real(*args, **kwargs)
            monkeypatch.setattr(module, name, call)
    return counts


@pytest.mark.parametrize("name", UNFUSED)
def test_unfused_models_launch_no_kernel(name, unfused_batches, monkeypatch):
    """On the batch without plans every layer names the unfused route, and
    the eval forward and a train step reach no kernel wrapper, while the
    same model's eval forward on a planned batch reaches one (the counts
    see the layers' calls)."""
    model, params, kind, against, _, batches = _unfused_case(
        name, unfused_batches)
    bare, labels, _ = batches[kind, False]
    counts = _count_every_wrapper(monkeypatch)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    layers = params["gnn_num_layers"]
    assert {getattr(model.gnn, f"mp_layer_{i}")._route(bare)
            for i in range(layers)} == {"unfused"}
    with torch.no_grad():
        model(bare, False)
    chip_smoke.train_and_count(model, params, bare, labels,
                               dict.fromkeys(tracing.counters("launch"), 0),
                               steps=1)
    assert not any(counts.values()), counts
    if against == "fused":
        with torch.no_grad():
            model(batches[kind, True][0], False)
        assert any(counts.values())


def _unfused_check(model, kind, against, tols, batches):
    """Phase 11's eval check of ``model`` on the batch without plans."""
    bare, labels, _ = batches[kind, False]
    ref = batches[kind, True] if against == "fused" else batches[kind, False]
    what, out_ref, ref_batch, ref_labels = chip_smoke.unfused_reference(
        model, ref[0], ref[1], against)
    with torch.no_grad():
        out = model(bare, False)
    atol, logit_rtol, loss_rtol = tols
    graphs = kind == "qm9"
    chip_smoke.check_outputs_agree(
        what, model, bare, labels, out, out_ref, logit_rtol, atol, loss_rtol,
        shape=(bare.num_graphs_padded,) if graphs else None,
        ref_batch=ref_batch, ref_labels=ref_labels,
        rows=bare.num_graphs if graphs else bare.num_nodes)


_SEGMENT_SUM = tseg.segment_sum


def _reordered_segment_sum(data, segment_ids, num_segments, spmd_axis=None,
                           order=None):
    """``segment_sum`` over the same rows, added in a random order (the
    batch's ``order`` describes the rows as given, so it is not passed
    on)."""
    perm = torch.randperm(data.shape[0],
                          generator=torch.Generator().manual_seed(1))
    return _SEGMENT_SUM(data[perm], segment_ids[perm], num_segments,
                        spmd_axis)


def _type1_messages_doubled(monkeypatch, model):
    """The model's unfused messages with edge type 1's doubled (RGAT's
    per-edge messages, not its logits)."""
    cls = type(model.gnn.mp_layer_0)
    real = cls._compute_messages_per_type

    def doubled(self, *args, **kwargs):
        messages = list(real(self, *args, **kwargs))
        first = messages[1]
        messages[1] = ((2.0 * first[0],) + tuple(first[1:])
                       if isinstance(first, tuple) else 2.0 * first)
        return messages
    monkeypatch.setattr(cls, "_compute_messages_per_type", doubled)


@pytest.mark.parametrize("name", UNFUSED)
def test_unfused_eval_check_passes(name, unfused_batches, monkeypatch):
    model, _, kind, against, tols, batches = _unfused_case(
        name, unfused_batches)
    if against == "cpu":
        # The reference is the same model on the same device here: the
        # card's side sums in another order.
        real = chip_smoke.unfused_reference

        def reference(*args):
            with monkeypatch.context() as mp:
                mp.setattr(tseg, "segment_sum", _reordered_segment_sum)
                mp.setattr(tbase, "get_aggregation_function",
                           lambda n: {"sum": _reordered_segment_sum}.get(
                               n, tseg.get_aggregation_function(n)))
                return real(*args)
        monkeypatch.setattr(chip_smoke, "unfused_reference", reference)
    _unfused_check(model, kind, against, tols, batches)


@pytest.mark.parametrize("name", UNFUSED)
def test_unfused_eval_check_catches_doubled_messages(name, unfused_batches,
                                                     monkeypatch):
    model, _, kind, against, tols, batches = _unfused_case(
        name, unfused_batches)
    if against == "cpu":
        real = chip_smoke.unfused_reference
        # The reference runs before the patch below takes effect.
        reference = real(model, *batches[kind, False][:2], against)
        monkeypatch.setattr(chip_smoke, "unfused_reference",
                            lambda *args: reference)
    _type1_messages_doubled(monkeypatch, model)
    with pytest.raises(AssertionError, match="eval forward"):
        _unfused_check(model, kind, against, tols, batches)


# ---- phase 13: the reference's recorded runs -------------------------------------
REFERENCE = [c[0] for c in rp.CASES]
# The module whose ``LAUNCHES`` counts each key.
LAUNCH_OWNERS = {key: module for module in (tps, tpa, tpem, tss, tprobes)
                 for key in module.LAUNCHES}


def _count_into_launches(monkeypatch):
    """Each wrapper, wherever a caller looks it up, adds one to its
    kernel's launch count, as the wrappers do where they launch on the
    card; ``torch.cuda.synchronize`` is a no-op."""
    for module in CALLERS:
        for name, key in WRAPPERS.items():
            real = getattr(module, name, None)
            if real is None:
                continue

            def call(*args, _real=real, _key=key, **kwargs):
                LAUNCH_OWNERS[_key].LAUNCHES[_key] += 1
                return _real(*args, **kwargs)
            monkeypatch.setattr(module, name, call)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


@pytest.fixture
def one_torch_thread():
    """One torch thread for phase 13's tests: under parallel test workers
    torch's CPU thread pool oversubscribes the cores, and these small ops
    then run many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def reference_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("phase13")
    return {task: rp.write_data(task, root)
            for task in ("GraphRegression", "PPI", "QM9")}


@pytest.mark.parametrize("name", REFERENCE)
@pytest.mark.usefixtures("one_torch_thread")
def test_reference_runs_reach_the_named_wrappers(name, reference_data,
                                                 monkeypatch):
    """Phase 13's runs on the CPU, each wrapper counted where it is looked
    up: the fused run reaches exactly the wrappers ``REFERENCE_LAUNCHES``
    names, that often, the run without plans none; both within the
    reference's tolerances."""
    _count_into_launches(monkeypatch)
    dump = rp.load_dump(name)
    for kind in ("none", rp.FUSED_PLANS[dump.model]):
        route, launches, report = chip_smoke.reference_run(
            dump, reference_data[dump.task], kind, "cpu")
        assert (route == "unfused") == (kind == "none")
        assert bool(launches) == (kind != "none")
        assert all(share <= 1.0 for share, _ in report.values())


@pytest.mark.usefixtures("one_torch_thread")
def test_reference_check_passes_a_reordered_sum(reference_data, monkeypatch):
    """K2 and K1 stand-ins that add the same slots in a random order (as
    the card's kernels may) pass the check on a fused run."""
    monkeypatch.setattr(tps, "pair_spmm_stream_joint", _reordered_k2)
    monkeypatch.setattr(tps, "pair_spmm_stream", _reordered_k2)
    monkeypatch.setattr(tps, "pair_spmm_stream_joint_rows", _reordered_rows)
    monkeypatch.setattr(tps, "pair_spmm_stream_rows", _reordered_rows)
    _count_into_launches(monkeypatch)
    for name in ("rgcn", "GNN_Edge_MLP"):
        dump = rp.load_dump(name)
        chip_smoke.reference_run(dump, reference_data[dump.task], "per_type",
                                 "cpu")


@pytest.mark.parametrize("kind", ["none", "per_type"])
@pytest.mark.usefixtures("one_torch_thread")
def test_reference_check_catches_swapped_edge_types(kind, reference_data,
                                                    monkeypatch):
    """One layer's edge types 0 and 1 swapped at import: the check
    fails."""
    _count_into_launches(monkeypatch)
    dump = rp.load_dump("rgcn")
    arrays = dict(dump.arrays)
    first = [k for k in arrays
             if k.startswith("var::") and "/Layer_1/" in k
             and "/edge_type_0/" in k]
    assert first
    for key in first:
        other = key.replace("/edge_type_0/", "/edge_type_1/")
        arrays[key], arrays[other] = arrays[other], arrays[key]
    with pytest.raises(AssertionError, match="diverges from the reference"):
        chip_smoke.reference_run(dump._replace(arrays=arrays),
                                 reference_data[dump.task], kind, "cpu")


@pytest.mark.usefixtures("one_torch_thread")
def test_gnn_input_check_on_cut_files(tmp_path, monkeypatch):
    """Phase 13d on PPI files cut to 3 graphs of 150 nodes: the GNNInput
    batch launches nothing, the dataset batch K2 and K1 once a layer, and
    their real rows agree. The cut dataset batch's plan reads fewer of
    its tables' rows than ``COMPACT_TABLES_BELOW`` (the full files' reads
    0.977), so its tables hold only those rows and the node sum launches
    once a layer too (``PPI_NODE_SUMS`` 1)."""
    monkeypatch.setattr(workloads, "NODES_PER_GRAPH", 150)
    monkeypatch.setattr(workloads, "FWD_EDGES_PER_GRAPH", 1500)
    monkeypatch.setattr(chip_smoke, "PPI_NODE_SUMS", 1)
    _count_into_launches(monkeypatch)
    lines = []
    monkeypatch.setattr(chip_smoke, "log", lines.append)
    chip_smoke.gnn_input_check("cpu", tmp_path / "ppi")
    assert "routes ('unfused', 'pair_joint')" in lines[-1]


@pytest.mark.parametrize("forms_kept", [True, False])
@pytest.mark.usefixtures("one_torch_thread")
def test_hook_check_on_a_cut_batch(forms_kept, monkeypatch):
    """Phase 13e on the PPI batch cut to 3 graphs of 150 nodes (V = 512):
    K1 and K2 once a layer and step, the joint plan built once and the
    eval logits bit-equal to the base model's. A ``replace`` that drops
    the plan forms, so that every step builds the joint plan again, fails
    it."""
    import dataclasses

    from tf2_gnn_tpu_torch.data import graph_batch as tgb

    monkeypatch.setattr(workloads, "NODES_PER_GRAPH", 150)
    monkeypatch.setattr(workloads, "FWD_EDGES_PER_GRAPH", 1500)
    monkeypatch.setattr(workloads, "NODE_BUDGET", 512)
    _count_into_launches(monkeypatch)
    lines = []
    monkeypatch.setattr(chip_smoke, "log", lines.append)
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "no card")
    monkeypatch.setattr(chip_smoke, "time_path",
                        lambda *args, **kwargs: (1.0, 1.0))
    if forms_kept:
        chip_smoke.hook_check("cpu", [])
        assert "the joint plan built 1 time(s)" in lines[-2]
        assert "K1 20 and K2 20 launches (node sums 0)" in lines[-2]
        return
    monkeypatch.setattr(tgb.GraphBatch, "replace",
                        lambda self, **changes: dataclasses.replace(
                            self, **changes))
    with pytest.raises(AssertionError, match="built the joint plan 6 times"):
        chip_smoke.hook_check("cpu", [])


@pytest.mark.parametrize("pinned", [False, True])
def test_relu_inputs_records_and_pins_the_activation(pinned):
    """Phase 13d's hook records each relu input's first v rows and, given
    masks, keeps exactly the masked entries there (its own sign past v);
    the layer's own relu otherwise."""
    from tf2_gnn_tpu_torch.layers.message_passing import base
    from tf2_gnn_tpu_torch.layers.message_passing.rgcn import RGCN

    layer = RGCN(2, 3, hidden_dim=3)
    x = torch.tensor([[1e-8, -0.5, 2.0], [-1e-8, 0.25, -1.0],
                      [3.0, -2.0, 0.0]], requires_grad=True)
    mask = torch.tensor([[False, True, True], [True, False, True]])
    with chip_smoke.relu_inputs(2, [mask] if pinned else None) as inputs:
        out = base.MessagePassing._post_aggregate(layer, x, None, None,
                                                  False)
    out.sum().backward()
    keep = torch.cat([mask, x.detach()[2:] > 0]) if pinned else x > 0
    assert torch.equal(out, x.detach() * keep)
    assert torch.equal(x.grad, keep.float())
    assert len(inputs) == 1 and torch.equal(inputs[0], x.detach()[:2])
    assert torch.equal(base.MessagePassing._post_aggregate(
        layer, x.detach(), None, None, False), torch.relu(x.detach()))


def test_relu_inputs_refuses_another_activation():
    from tf2_gnn_tpu_torch.layers.message_passing import base
    from tf2_gnn_tpu_torch.layers.message_passing.rgcn import RGCN

    layer = RGCN(2, 3, hidden_dim=3, message_activation_function="tanh")
    with chip_smoke.relu_inputs(1):
        with pytest.raises(AssertionError, match="no relu after"):
            base.MessagePassing._post_aggregate(layer, torch.ones(2, 3),
                                                None, None, False)


@pytest.mark.parametrize("size,fails", [(2.0 ** -22, False), (0.5, True)])
def test_relu_flip_check_bounds_the_flipped_inputs(size, fails):
    """A relu input the two runs put on opposite sides of 0 passes within
    the states' tolerance of 0 (the card's atomic sums put such an input
    about 1e-7 from it) and fails beyond it."""
    want = [torch.tensor([[1.0, -2.0], [size, 0.5]]), torch.ones(2, 2)]
    got = [w.clone() for w in want]
    got[0][1, 0] = -size
    if fails:
        with pytest.raises(AssertionError, match="opposite sides of 0"):
            chip_smoke.check_relu_flips(got, want)
    else:
        assert chip_smoke.check_relu_flips(got, want) == (1, size)
    assert chip_smoke.check_relu_flips(want, want) == (0, 0.0)


def _decoded(path):
    import gzip
    import json

    with gzip.open(path, "rt") as f:
        return [json.loads(line) for line in f]


def test_dump_writers_match_the_test_writers(tmp_path):
    """``workloads``' copies of the two writers the PPI and QM9 dumps were
    recorded on give the same files (decoded) for the dumps' arguments."""
    import json

    import numpy as np

    from .synthetic_data import write_ppi_dataset, write_qm9_dataset

    ppi = dict(graphs_per_fold=3, nodes_per_graph=40, feature_dim=50,
               num_labels=121, seed=7)
    qm9 = dict(num_graphs=12, feature_dim=15, seed=7)
    for writer, twin, kwargs in (
            (workloads.write_ppi_dataset, write_ppi_dataset, ppi),
            (workloads.write_qm9_dataset, write_qm9_dataset, qm9)):
        got, want = tmp_path / "port" / writer.__name__, tmp_path / "tests" / \
            writer.__name__
        writer(got, **kwargs)
        twin(want, **kwargs)
        names = sorted(p.name for p in want.iterdir())
        assert sorted(p.name for p in got.iterdir()) == names
        for name in names:
            if name.endswith(".jsonl.gz"):
                assert _decoded(got / name) == _decoded(want / name), name
            elif name.endswith(".json"):
                assert (json.loads((got / name).read_text())
                        == json.loads((want / name).read_text())), name
            else:
                a, b = np.load(got / name), np.load(want / name)
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b, err_msg=name)


# -- phase 14's check ----------------------------------------------------------

def _scaleout_results(grads, params, launches):
    """Two ranks' results of an SPMD case as ``scaleout_rank`` returns
    them (rank 0 carries the gradients)."""
    return [{"rank": r, "losses": [2.0, 1.5], "launches": dict(launches),
             "final_params": params[r], "grads": grads}
            for r in range(2)]


@pytest.mark.parametrize("fault", [None, "gradient_factor", "one_kernel",
                                   "rank_params", "loss"])
def test_scaleout_check_catches_faults(fault):
    """Phase 14's check (``scaleout_check``) on synthetic results at case
    (b)'s limits: equal ones pass; a gradient twice the single process's
    (a missing pmean), a rank that launched no kernel, ranks whose
    parameters differ, or a loss off by 1% fail."""
    import numpy as np

    case = next(c for c in chip_smoke.scaleout_cases()
                if c["name"] == "b_dense")
    grads = [np.linspace(-1.0, 1.0, 12, dtype=np.float32).reshape(3, 4)]
    ref = {"losses": [2.0, 1.5], "grads": [g.copy() for g in grads]}
    params = [np.arange(5, dtype=np.float32)] * 2
    launches = {"pair_spmm": 8}
    if fault == "gradient_factor":
        grads = [2.0 * g for g in grads]
    results = _scaleout_results(grads, params, launches)
    if fault == "one_kernel":
        results[1]["launches"] = {}
    elif fault == "rank_params":
        results[1]["final_params"] = params[0] + 1e-7
    elif fault == "loss":
        results[0]["losses"] = [2.02, 1.5]
    if fault is None:
        assert "step-1 gradients (share) 0 of" in chip_smoke.scaleout_check(
            case, results, ref)
    else:
        with pytest.raises(AssertionError, match="phase 14"):
            chip_smoke.scaleout_check(case, results, ref)


@pytest.mark.parametrize("lost", [False, True])
def test_scaleout_check_needs_a_planted_fault_to_fail(lost):
    """Phase 14's planted fault (case (e) with every ring slab zeroed):
    the check refuses the phase if the faulted run's numbers pass (a
    check that cannot see a lost halo), and reports the refusal if they
    fail, as they must."""
    import numpy as np

    cases = {c["name"]: c for c in chip_smoke.scaleout_cases()}
    case = cases["e_fault"]
    assert case["fault"] == "ring_slab"
    assert {k: v for k, v in case.items() if k not in ("name", "fault")} \
        == {k: v for k, v in cases["e"].items() if k != "name"}
    grads = [np.linspace(-1.0, 1.0, 12, dtype=np.float32).reshape(3, 4)]
    ref = {"losses": [2.0, 1.5], "grads": [g.copy() for g in grads]}
    got = [g * 1.1 for g in grads] if lost else grads
    results = _scaleout_results(got, [np.zeros(5, np.float32)] * 2,
                                {"pair_stream": 4, "pair_stream_joint": 4})
    if lost:
        assert chip_smoke.scaleout_check(case, results, ref).startswith(
            "refused as it must be")
    else:
        with pytest.raises(AssertionError, match="passed a planted"):
            chip_smoke.scaleout_check(case, results, ref)


# ``nvcc -Xptxas -v`` output for three entries of two sources: the first
# spills, the second prints no spill line, the third matches neither.
PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z21relu_pair_rows_kernelILi1EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z21relu_pair_rows_kernelILi1EEvv
    16 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 168 registers, 392 bytes cmem[0]
ptxas info    : Compiling entry function '_Z21relu_pair_rows_kernelILi2EEvv' for 'sm_90a'
ptxas info    : Used 96 registers, 392 bytes cmem[0]
ptxas info    : Compiling entry function '_Z16expd_rows_kernelv' for 'sm_90a'
ptxas info    : Function properties for _Z16expd_rows_kernelv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 384 bytes cmem[0]
"""


@pytest.fixture
def mangled(monkeypatch):
    """Names as ptxas prints them."""
    monkeypatch.setattr(chip_smoke, "_demangle", list)


def test_ptxas_report_reads_a_matching_entrys_registers(mangled):
    assert chip_smoke._ptxas_report(PTXAS_LOG, "expd_rows") == [
        ("_Z16expd_rows_kernelv", 40, 0, 0)]


def test_ptxas_report_credits_spills_to_their_entry(mangled):
    assert chip_smoke._ptxas_report(PTXAS_LOG, "relu_pair_rows") == [
        ("_Z21relu_pair_rows_kernelILi1EEvv", 168, 8, 12),
        ("_Z21relu_pair_rows_kernelILi2EEvv", 96, 0, 0)]


def test_ptxas_report_skips_other_entries(mangled):
    assert chip_smoke._ptxas_report(PTXAS_LOG, "relu_pair_da") == []
    assert [r[0] for r in chip_smoke._ptxas_report(PTXAS_LOG, "kernel")] == [
        "_Z21relu_pair_rows_kernelILi1EEvv",
        "_Z21relu_pair_rows_kernelILi2EEvv", "_Z16expd_rows_kernelv"]


def test_ptxas_report_names_entries_through_cxxfilt(monkeypatch):
    def run(cmd, input, **kwargs):
        assert cmd == ["c++filt"]
        names = [f"demangled {n}" for n in input.splitlines()]
        return subprocess.CompletedProcess(cmd, 0, "\n".join(names), "")

    monkeypatch.setattr(chip_smoke.subprocess, "run", run)
    assert chip_smoke._ptxas_report(PTXAS_LOG, "relu_pair_rows") == [
        ("demangled _Z21relu_pair_rows_kernelILi1EEvv", 168, 8, 12),
        ("demangled _Z21relu_pair_rows_kernelILi2EEvv", 96, 0, 0)]


@pytest.mark.parametrize("error", [
    OSError(2, "No such file or directory: 'c++filt'"),
    subprocess.CalledProcessError(1, ["c++filt"]),
], ids=["missing", "failed"])
def test_demangle_keeps_the_mangled_names_without_cxxfilt(error,
                                                         monkeypatch):
    def run(*args, **kwargs):
        raise error

    monkeypatch.setattr(chip_smoke.subprocess, "run", run)
    names = ["_Z16expd_rows_kernelv", "_Z21relu_pair_rows_kernelILi1EEvv"]
    assert chip_smoke._demangle(names) == names
