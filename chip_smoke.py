#!/usr/bin/env python3
"""Drive the PyTorch port (``tf2_gnn_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py            # the check, on card 0
    python3 chip_smoke.py --profile  # also a torch.profiler breakdown of
                                     # each path's train step

Phases, each of which fails the run by raising:

1. Build the hand-written CUDA kernels from ``tf2_gnn_tpu_torch/csrc``
   (one nvcc per source, started together) and print the card.
2. PPI_RGCN on the per-type-plan PPI batch:
   a. kernel checks at the real plan shapes: the joint kernel (K2, forward
      layout) and the stream kernel (K1, backward layout with all-zero
      types) against their plain PyTorch versions on the card, bf16
      tables, f32 outputs;
   b. the shipped PPI_RGCN model at full width (4 layers, hidden 320, bf16
      edge stream, input dropout 0.1, Adam at lr 1e-3), random weights
      from a seed: one eval forward held against the same model run
      through the plain versions; then its main path, a few train steps
      with the launch counts set to 0 just before and read just after
      (K1 and K2 must each launch once per layer per step);
   c. timings (CUDA events): each kernel, its plain version and one
      PyTorch library call computing the same function
      (``torch.sparse.mm``, CSR built from the plan outside the timed
      window), the train step and the eval forward.
3. PPI_RGAT on the merged-plan PPI batch, the same three steps:
   a. the expd kernel (B8), one head's merged-plan SpMM (B3) and the fused
      attention backward (B9) against their plain versions at the real
      plan shapes;
   b. the shipped PPI_RGAT model at full width (3 layers, hidden 320, 4
      heads, tanh, bf16 edge stream, input dropout 0.1, Adam at lr 1e-3):
      the eval forward against the plain versions, then its main path
      (per step B8 and B9 launch once per layer, B3 once per head and
      layer);
   c. timings as in 2c (B3's library call is ``torch.sparse.mm`` of the
      expd-scaled CSR; B8 and B9 have no single PyTorch call).
4. The reference-default GNN_Edge_MLP (target-state input, one hidden
   edge-MLP layer, GRU global exchange after layer 2) on the merged-target
   PPI batch, the same three steps:
   a. the relu-pair kernels B4 (training forward, R and the mask sum M),
      B5 (dA over the backward plan), B6 (eval forward) and B7 (dB over
      the forward plan, on no call path) against their plain versions at
      the real plan shapes: bf16 A and B, f32 cotangent, unit scales;
   b. ``workloads.edge_mlp_default_params()`` at full width (4 layers,
      hidden 320, bf16 edge stream, Adam at lr 1e-3): the eval forward
      against the plain versions (B6 once per layer, B4 and B5 never),
      then its main path (per step B4 and B5 once per layer, B6 and B7
      never);
   c. timings as in 2c (none of the four has a single PyTorch call).

The line before the last two is the JSON ``kernels`` line; then the card's
name and power limit (nvidia-smi); the last line is the JSON result. Exits
non-zero, printing no result, without a card or without the repository
beside this script.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent

TRAIN_STEPS = 5          # main-path train steps (launch counts read after)
TIMED_STEPS = 20         # train steps in the step-time window
KERNEL_REPS = 20         # launches per kernel timing
SEED = 0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 peak
F32_FLOPS_PER_S = 67e12     # H100 SXM float32 peak outside the tensor cores
# Kernel vs plain version: both sum f32 products, in different orders
# (the kernel's atomics reorder run to run); B8/B9 take expf of the same
# f32 arguments as torch.exp.
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-4
# Whole model, kernels vs plain versions: besides the f32 reorder, a sum
# that lands on the other side of a bf16 rounding boundary re-rounds one
# stream entry by a bf16 ulp in the next layer.
MODEL_ATOL = 2e-2
# The GNN_Edge_MLP model at random weights sums unit-scaled relu messages,
# so its logits reach about a hundred; a re-rounded bf16 entry (2**-8
# relative) then moves a logit by a share of its size, not by a fixed
# amount: the bound grows by 2e-2 (5 bf16 ulps) of the largest |logit|
# (observed up to 1.3 ulps on an H100).
EDGE_MLP_LOGIT_RTOL = 2e-2
LOSS_RTOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def require_card():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card.", file=sys.stderr)
        raise SystemExit(2)
    return torch.device("cuda", 0)


def time_ms(fn, reps: int = KERNEL_REPS, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def stream_args(plan, direction: str):
    """The plan arrays one kernel reads, per direction of the joint op."""
    if direction == "fwd":
        return (plan.scale_fwd, plan.rel_src_f, plan.rel_tgt_f,
                plan.src_blk_f, plan.grp_tgt_fl, plan.grp_type_f)
    return (plan.scale_bwd, plan.rel_src_b, plan.rel_tgt_b, plan.src_blk_b,
            plan.grp_tgt_b, plan.type_b_zeros)


def slot_matrix(srcabs, tgtabs, valid, scale, out_rows: int, in_rows: int):
    """CSR [out_rows, in_rows] of a plan's valid slots (duplicates summed)
    in f32 and in bf16, the operands of the library yardstick; also the
    distinct input rows and the valid slot count."""
    import torch

    idx = torch.stack([tgtabs[valid], srcabs[valid]])
    coo = torch.sparse_coo_tensor(idx, scale.reshape(-1)[valid],
                                  (out_rows, in_rows)).coalesce()
    csr = coo.to_sparse_csr()
    csr_bf16 = torch.sparse_coo_tensor(
        coo.indices(), coo.values().to(torch.bfloat16),
        (out_rows, in_rows)).coalesce().to_sparse_csr()
    return (csr, csr_bf16, int(torch.unique(srcabs[valid]).numel()),
            int(valid.sum()))


def bound_ms(nbytes: float, flops: float):
    """(bound ms, what bounds it): the larger of the bytes over HBM
    bandwidth and the f32 operations over the f32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_bound_ms(rows_read: int, h: int, itemsize: int, slots: int,
                    chunks: int, groups: int, out_rows: int,
                    valid_slots: int):
    """The stream SpMM kernels' bound (K1, K2, B3): bytes = distinct table
    rows read + the plan (12 B a slot, 4 B a chunk, 8 B a group) + the f32
    output written once; operations = a multiply and an add per valid slot
    and column."""
    nbytes = (rows_read * h * itemsize + slots * 12 + chunks * 4
              + groups * 8 + out_rows * h * 4)
    return bound_ms(nbytes, 2.0 * valid_slots * h)


def check_close(name: str, got, want, rtol: float, atol: float) -> float:
    import torch

    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max abs err {err}, rtol {rtol}, atol {atol})")
    return err


def build_model(hypers_file: str, style: str, device, num_types: int):
    from tf2_gnn_tpu_torch.models.node_multiclass_task import (
        NodeMulticlassTask,
    )
    from tf2_gnn_tpu_torch.workloads import FEATURE_DIM, NUM_LABELS

    hypers = json.loads((ROOT / "tf2_gnn_tpu_torch" / "harness"
                         / "default_hypers" / hypers_file).read_text())
    params = NodeMulticlassTask.get_default_hyperparameters(style)
    params.update(hypers["model_params"])
    params["learning_rate"] = 0.001
    model = NodeMulticlassTask.from_params(
        params, input_dim=FEATURE_DIM, num_edge_types=num_types,
        device=device, seed=SEED, num_labels=NUM_LABELS)
    log(f"model {hypers_file}: "
        f"{sum(p.numel() for p in model.parameters())} parameters, "
        f"{params['gnn_num_layers']} layers, hidden {params['gnn_hidden_dim']}, "
        f"edge stream {params['gnn_edge_dtype']}")
    return model, params


def check_eval_forward(model, batch, labels, patches,
                       logit_rtol: float = 0.0) -> None:
    """One eval forward with the kernels against the same model with every
    wrapper in ``patches`` ((module, name, plain version)) replaced by its
    plain version: logits within ``MODEL_ATOL`` plus ``logit_rtol`` of the
    largest plain |logit|, losses within ``LOSS_RTOL``."""
    import torch

    from tf2_gnn_tpu_torch.workloads import NUM_LABELS

    v = batch.num_nodes_padded
    with torch.no_grad():
        (logits,) = model(batch, False)
        with _patched(patches):
            (logits_plain,) = model(batch, False)
        loss = model.compute_task_metrics(batch, (logits,), labels)["loss"]
        loss_plain = model.compute_task_metrics(
            batch, (logits_plain,), labels)["loss"]
    if tuple(logits.shape) != (v, NUM_LABELS):
        raise AssertionError(f"eval forward: logits of shape "
                             f"{tuple(logits.shape)}, expected {(v, NUM_LABELS)}")
    model_err = float((logits - logits_plain).abs().max())
    largest = float(logits_plain.abs().max())
    limit = MODEL_ATOL + logit_rtol * largest
    if not (torch.isfinite(logits).all() and model_err <= limit
            and abs(float(loss) - float(loss_plain))
            <= LOSS_RTOL * abs(float(loss_plain))):
        raise AssertionError(
            f"eval forward: kernels vs plain versions max abs logit err "
            f"{model_err} (limit {limit}: atol {MODEL_ATOL} + {logit_rtol} "
            f"of the largest |logit| {largest}), loss {float(loss)} vs "
            f"{float(loss_plain)}")
    log(f"eval forward vs plain versions: max abs logit err {model_err:.3e} "
        f"(limit {limit:.3e}, largest |logit| {largest:.3e}), loss "
        f"{float(loss):.6f} vs {float(loss_plain):.6f}")


def _patched(patches):
    from contextlib import ExitStack

    stack = ExitStack()
    for module, name, plain in patches:
        stack.enter_context(mock.patch.object(module, name, plain))
    return stack


def train_and_count(model, params, batch, labels, counters, expected):
    """The path's main run: TRAIN_STEPS train steps with every launch
    count set to 0 just before and read just after; each kernel in
    ``expected`` must have launched exactly that many times. Returns
    (state, train_step, eval_step, launches)."""
    import torch

    from tf2_gnn_tpu_torch.harness.optimizers import make_optimizer
    from tf2_gnn_tpu_torch.harness.training import (
        create_train_state,
        make_eval_step,
        make_train_step,
    )

    optimizer = make_optimizer(params, model.parameters())
    state = create_train_state(model, optimizer, seed=SEED)
    train_step = make_train_step(model, optimizer)
    eval_step = make_eval_step(model)

    for reset, _ in counters:
        reset()
    losses = []
    for _ in range(TRAIN_STEPS):
        state, metrics = train_step(state, batch, labels)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    launches = {}
    for _, counts in counters:
        launches.update(counts)
    losses = [float(x) for x in losses]
    log(f"train: {TRAIN_STEPS} steps, losses {losses}, launches {launches}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"training did not lower the loss: {losses}")
    for name, count in expected.items():
        if launches[name] != count:
            raise AssertionError(
                f"{name} launched {launches[name]} times in {TRAIN_STEPS} "
                f"steps; expected {count}")
    final = eval_step(batch, labels)
    if not math.isfinite(float(final["loss"])):
        raise AssertionError("non-finite eval loss after training")
    log(f"eval after training: loss {float(final['loss']):.6f}, "
        f"f1 {float(final['f1_score']):.4f}")
    return state, train_step, eval_step, launches


def time_path(state, train_step, eval_step, batch, labels, real_edges,
              device, argv, name: str) -> None:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        state, metrics = train_step(state, batch, labels)
    float(metrics["loss"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / TIMED_STEPS * 1e3
    eval_ms = time_ms(lambda: eval_step(batch, labels), reps=10)
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30
    log(f"{name} train step: {step_ms:.3f} ms ({real_edges / step_ms * 1e3:.4g} "
        f"edges/s), eval forward: {eval_ms:.3f} ms, peak memory "
        f"{peak_gib:.2f} GiB")
    if "--profile" in argv:
        profile_step(train_step, state, batch, labels, step_ms)


def rgcn_path(device, argv):
    """Phase 2: PPI_RGCN through K1 and K2. Returns their kernel entries."""
    import torch

    from tf2_gnn_tpu_torch.ops import pair_spmm as ps
    from tf2_gnn_tpu_torch.workloads import build_ppi_batch

    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    batch, labels, real_edges = build_ppi_batch(SEED, device=device)
    log(f"workload: {real_edges} edges, V={batch.num_nodes_padded}, "
        f"built in {time.perf_counter() - t0:.1f} s")
    plan = batch.pair_stream_joint
    v, num_types, h = plan.v_out, plan.num_types, 320
    gen = torch.Generator(device=device).manual_seed(SEED)
    tables = torch.randn((num_types * v, h), generator=gen,
                         device=device).to(torch.bfloat16)
    cot = torch.randn((v, h), generator=gen, device=device).to(torch.bfloat16)
    fwd_args, bwd_args = stream_args(plan, "fwd"), stream_args(plan, "bwd")

    def k2():
        return ps.pair_spmm_stream_joint(tables, *fwd_args, v, v)

    def k2_plain():
        return ps.pair_spmm_stream_plain(tables, *fwd_args, v, v)

    def k1():
        return ps.pair_spmm_stream(cot, *bwd_args, v, num_types * v)

    def k1_plain():
        return ps.pair_spmm_stream_plain(cot, *bwd_args, v, num_types * v)

    out2, want2 = k2(), k2_plain()
    out1, want1 = k1(), k1_plain()
    torch.cuda.synchronize()
    err2 = check_close("pair_stream_joint", out2, want2, KERNEL_RTOL,
                       KERNEL_ATOL)
    err1 = check_close("pair_stream", out1, want1, KERNEL_RTOL, KERNEL_ATOL)
    log(f"kernel check: pair_stream_joint max_abs_err {err2:.3e}, "
        f"pair_stream max_abs_err {err1:.3e} "
        f"(rtol {KERNEL_RTOL}, atol {KERNEL_ATOL})")
    del out1, out2, want1, want2

    model, params = build_model("PPI_RGCN.json", "rgcn", device, num_types)
    check_eval_forward(model, batch, labels, [
        (ps, "pair_spmm_stream_joint", ps.pair_spmm_stream_plain),
        (ps, "pair_spmm_stream", ps.pair_spmm_stream_plain)])
    per_step = params["gnn_num_layers"] * TRAIN_STEPS
    state, train_step, eval_step, launches = train_and_count(
        model, params, batch, labels, [(ps.reset_launch_counts, ps.LAUNCHES)],
        {"pair_stream": per_step, "pair_stream_joint": per_step})
    time_path(state, train_step, eval_step, batch, labels, real_edges,
              device, argv, "PPI_RGCN")

    # The library yardstick: torch.sparse.mm of the plan's CSR matrix with
    # the same bf16 table (bf16 output, f32-rounded scales rounded to bf16),
    # and, for reference, with f32 copies of both (the kernel's f32 output).
    a_fwd, a_fwd16, rows_fwd, valid_fwd = slot_matrix(
        *ps._stream_slot_abs_ids(*fwd_args[1:], v), fwd_args[0], v,
        num_types * v)
    a_bwd, a_bwd16, rows_bwd, valid_bwd = slot_matrix(
        *ps._stream_slot_abs_ids(*bwd_args[1:], v), bwd_args[0],
        num_types * v, v)
    tables_f32, cot_f32 = tables.float(), cot.float()
    kernels = []
    for name, source_fn, plain_fn, lib_fn, lib32_fn, args, tab, out_rows, \
            rows, valid, replaces, err in (
            ("pair_stream_joint", k2, k2_plain,
             lambda: torch.sparse.mm(a_fwd16, tables),
             lambda: torch.sparse.mm(a_fwd, tables_f32), fwd_args, tables,
             v, rows_fwd, valid_fwd,
             "tf2_gnn_tpu/ops/pair_spmm.py:1057", err2),
            ("pair_stream", k1, k1_plain,
             lambda: torch.sparse.mm(a_bwd16, cot),
             lambda: torch.sparse.mm(a_bwd, cot_f32), bwd_args, cot,
             num_types * v, rows_bwd, valid_bwd,
             "tf2_gnn_tpu/ops/pair_spmm.py:895", err1)):
        bound, bound_by = kernel_bound_ms(
            rows, h, tab.element_size(), args[1].numel(),
            args[3].numel(), args[4].numel(), out_rows, valid)
        kernels.append(time_kernel(
            name, "tf2_gnn_tpu_torch/csrc/pair_stream.cu", replaces,
            launches[name], err, source_fn, plain_fn, lib_fn, lib32_fn,
            bound, bound_by,
            f"{valid} valid of {args[1].numel()} slots, {rows} distinct "
            "rows read"))
    return kernels


def time_kernel(name, source, replaces, launches, err, source_fn, plain_fn,
                lib_fn, lib32_fn, bound, bound_by, detail):
    """One entry of the kernels line: the kernel, its plain version and
    (where there is one) the library call, timed with CUDA events."""
    ms = time_ms(source_fn)
    plain_ms = time_ms(plain_fn)
    library_ms = None if lib_fn is None else time_ms(lib_fn)
    line = (f"{name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bound:.4f} ms ({bound_by}), {detail}")
    if lib_fn is not None:
        library32_ms = time_ms(lib32_fn)
        lib_err = float((lib32_fn() - source_fn()).abs().max())
        line += (f"; torch.sparse.mm bf16 {library_ms:.4f} ms, f32 "
                 f"{library32_ms:.4f} ms (max abs diff to the kernel "
                 f"{lib_err:.2e})")
    log(line)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": library_ms}


def rgat_path(device, argv):
    """Phase 3: PPI_RGAT through B8, B3 and B9. Returns their entries."""
    import torch

    from tf2_gnn_tpu_torch.ops import pair_attention as pa
    from tf2_gnn_tpu_torch.ops import pair_spmm as ps
    from tf2_gnn_tpu_torch.workloads import build_ppi_batch

    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    batch, labels, real_edges = build_ppi_batch(SEED, device=device,
                                                merged=True)
    plan = batch.pair_merged
    v, num_types = batch.num_nodes_padded, batch.num_edge_types
    log(f"workload (merged plans): {real_edges} edges, V={v}, "
        f"{plan.rel_src_f.shape[0]} forward / {plan.rel_src_b.shape[0]} "
        f"backward chunks, {plan.ovf_src.shape[0]} overflow slots, built "
        f"in {time.perf_counter() - t0:.1f} s")
    model, params = build_model("PPI_RGAT.json", "rgat", device, num_types)
    # The kernels' widths on the main path: [L*V, H] hk-major tables with
    # the heads padded to a divisor of 128 (none at 4 heads).
    k = model.gnn.mp_layer_0._padded_heads()
    head_dim = params["gnn_hidden_dim"] // params["gnn_num_heads"]
    h, rows = head_dim * k, num_types * v

    # Kernel inputs at the main path's shapes and dtypes.
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    table = torch.randn((rows, h), generator=gen,
                        device=device).to(torch.bfloat16)
    scores = (0.5 * torch.randn((rows, 2 * k), generator=gen,
                                device=device)).to(torch.bfloat16)
    m = pa._stabilise(pa._bound_stabiliser(scores, v, k), torch.bfloat16)
    dw = torch.randn((v, h), generator=gen, device=device).to(torch.bfloat16)
    d_denom = torch.randn((v, k), generator=gen, device=device)
    expd_want = pa.pair_attention_expd_plain(scores, m, *plan.fwd, v, k)
    head0 = torch.cat([table.reshape(rows, head_dim, k)[:, :, 0],
                       table.new_ones((rows, 1))], dim=1).contiguous()
    scale0 = expd_want[0]

    def b8():
        return pa.pair_attention_expd(scores, m, *plan.fwd, v, k)

    def b8_plain():
        return pa.pair_attention_expd_plain(scores, m, *plan.fwd, v, k)

    def b3():
        return ps.pair_spmm(head0, scale0, *plan.fwd, v)

    def b3_plain():
        return ps.pair_spmm_plain(head0, scale0, *plan.fwd, v)

    bwd_args = (table, dw, d_denom, scores, m, *plan.bwd, v, k)

    def b9():
        return pa.pair_attention_bwd_fused(*bwd_args)

    def b9_plain():
        return pa.pair_attention_bwd_fused_plain(*bwd_args)

    err8 = check_close("pair_attention_expd", b8(), expd_want, KERNEL_RTOL,
                       KERNEL_ATOL)
    err3 = check_close("pair_spmm", b3(), b3_plain(), KERNEL_RTOL,
                       KERNEL_ATOL)
    err9 = max(check_close(f"pair_attention_bwd_fused {part}", got, want,
                           KERNEL_RTOL, KERNEL_ATOL)
               for part, got, want in zip(("d_ss", "d_ts", "d_table"),
                                          b9(), b9_plain()))
    torch.cuda.synchronize()
    log(f"kernel check: pair_attention_expd max_abs_err {err8:.3e}, "
        f"pair_spmm max_abs_err {err3:.3e}, pair_attention_bwd_fused "
        f"max_abs_err {err9:.3e} (rtol {KERNEL_RTOL}, atol {KERNEL_ATOL})")

    check_eval_forward(model, batch, labels, [
        (ps, "pair_spmm", ps.pair_spmm_plain),
        (pa, "pair_spmm", ps.pair_spmm_plain),
        (pa, "pair_attention_expd", pa.pair_attention_expd_plain),
        (pa, "pair_attention_bwd_fused", pa.pair_attention_bwd_fused_plain)])
    per_step = params["gnn_num_layers"] * TRAIN_STEPS
    counters = [(ps.reset_launch_counts, ps.LAUNCHES),
                (pa.reset_launch_counts, pa.LAUNCHES)]
    state, train_step, eval_step, launches = train_and_count(
        model, params, batch, labels, counters,
        {"pair_attention_expd": per_step, "pair_spmm": k * per_step,
         "pair_attention_bwd_fused": per_step, "pair_stream": 0,
         "pair_stream_joint": 0})
    time_path(state, train_step, eval_step, batch, labels, real_edges,
              device, argv, "PPI_RGAT")

    # Bounds from this run's plan: the bytes each kernel must move (each
    # input read once, each output written once) and its f32 operations.
    srcabs, tgtabs, valid = ps.slot_abs_ids(*plan.fwd)
    fwd_slots, fwd_chunks = plan.rel_src_f.numel(), plan.src_blk_f.numel()
    fwd_groups = plan.grp_tgt_f.numel()
    fwd_valid = int(valid.sum())
    plan_bytes = fwd_slots * 8 + fwd_chunks * 4 + fwd_groups * 4
    b8_bound = bound_ms(
        plan_bytes + scores.numel() * 2 + m.numel() * 4 + k * fwd_slots * 4,
        6.0 * fwd_valid * k)   # add, leaky, subtract, exp per slot and head
    a_s, a_s16, rows_read, _ = slot_matrix(srcabs, tgtabs, valid, scale0, v,
                                           rows)
    b3_bound = kernel_bound_ms(rows_read, head0.shape[1], 2, fwd_slots,
                               fwd_chunks, fwd_groups, v, fwd_valid)
    b_src, b_tgt, b_valid = ps.slot_abs_ids(*plan.bwd)
    bwd_valid = int(b_valid.sum())
    bwd_bytes = (plan.rel_src_b.numel() * 8 + plan.src_blk_b.numel() * 4
                 + plan.grp_tgt_b.numel() * 4
                 + int(torch.unique(b_tgt[b_valid]).numel()) * h * 2
                 + int(torch.unique(b_src[b_valid]).numel()) * h * 2
                 + scores.numel() * 2 + (m.numel() + d_denom.numel()) * 4
                 + rows * (h + 2 * k) * 4)
    # Per valid slot and column: the head sum's multiply-add and the
    # d_table multiply-add.
    b9_bound = bound_ms(bwd_bytes, 4.0 * bwd_valid * h)
    head0_f32 = head0.float()
    return [
        time_kernel("pair_spmm", "tf2_gnn_tpu_torch/csrc/pair_stream.cu",
                    "tf2_gnn_tpu/ops/pair_spmm.py:678", launches["pair_spmm"],
                    err3, b3, b3_plain,
                    lambda: torch.sparse.mm(a_s16, head0),
                    lambda: torch.sparse.mm(a_s, head0_f32), *b3_bound,
                    f"one head's launch, [{rows}, {head0.shape[1]}] bf16 "
                    f"table, {fwd_valid} valid of {fwd_slots} slots"),
        time_kernel("pair_attention_expd",
                    "tf2_gnn_tpu_torch/csrc/pair_attention.cu",
                    "tf2_gnn_tpu/ops/pair_attention.py:427",
                    launches["pair_attention_expd"], err8, b8, b8_plain,
                    None, None, *b8_bound,
                    f"[{k}, {fwd_slots}] f32 out"),
        time_kernel("pair_attention_bwd_fused",
                    "tf2_gnn_tpu_torch/csrc/pair_attention.cu",
                    "tf2_gnn_tpu/ops/pair_attention.py:860",
                    launches["pair_attention_bwd_fused"], err9, b9, b9_plain,
                    None, None, *b9_bound,
                    f"{bwd_valid} valid of {plan.rel_src_b.numel()} slots"),
    ]


def relu_pair_bound_ms(plan_args, table_rows_read, cot_rows_read, h: int,
                       outputs: int, out_rows: int, ops_per_slot: float):
    """A relu-pair kernel's bound: bytes = the distinct bf16 rows of A and
    B it reads, the distinct f32 cotangent rows (B5, B7), the plan (12 B a
    slot, 4 B a chunk and a group) and its f32 outputs written once;
    operations = ``ops_per_slot`` per valid slot and column."""
    from tf2_gnn_tpu_torch.ops import pair_spmm as ps

    rel_src, _, src_blk, grp_tgt = plan_args
    valid = int(ps.slot_abs_ids(*plan_args)[2].sum())
    nbytes = (table_rows_read * h * 2 + cot_rows_read * h * 4
              + rel_src.numel() * 12 + src_blk.numel() * 4
              + grp_tgt.numel() * 4 + outputs * out_rows * h * 4)
    return bound_ms(nbytes, ops_per_slot * valid * h), valid


def edge_mlp_path(device, argv):
    """Phase 4: the reference-default GNN_Edge_MLP through B4, B5 and B6
    (B7 checked and timed beside them). Returns the four entries."""
    import torch

    from tf2_gnn_tpu_torch.models.node_multiclass_task import (
        NodeMulticlassTask,
    )
    from tf2_gnn_tpu_torch.ops import pair_attention as pa
    from tf2_gnn_tpu_torch.ops import pair_edge_mlp as pem
    from tf2_gnn_tpu_torch.ops import pair_spmm as ps
    from tf2_gnn_tpu_torch.workloads import (
        FEATURE_DIM,
        NUM_LABELS,
        build_ppi_batch,
        edge_mlp_default_params,
    )

    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    batch, labels, real_edges = build_ppi_batch(SEED, device=device,
                                                merged=True,
                                                merge_targets=True)
    plan = batch.pair_merged
    rows = plan.out_rows
    log(f"workload (merged-target plans): {real_edges} edges, "
        f"V={batch.num_nodes_padded}, {rows} output rows, "
        f"{plan.rel_src_f.shape[0]} forward / {plan.rel_src_b.shape[0]} "
        f"backward chunks, {plan.ovf_src.shape[0]} overflow slots, built "
        f"in {time.perf_counter() - t0:.1f} s")
    params = edge_mlp_default_params()
    model = NodeMulticlassTask.from_params(
        params, input_dim=FEATURE_DIM, num_edge_types=batch.num_edge_types,
        device=device, seed=SEED, num_labels=NUM_LABELS)
    h = params["gnn_hidden_dim"]
    log(f"model edge_mlp_default_params(): "
        f"{sum(p.numel() for p in model.parameters())} parameters, "
        f"{params['gnn_num_layers']} layers, hidden {h}, edge stream "
        f"{params['gnn_edge_dtype']}, global exchange "
        f"{params['gnn_global_exchange_mode']} after layers "
        f"{list(model.gnn.exchange_layers)}")

    # Kernel inputs at the main path's shapes and dtypes: A and B are the
    # [L*V, H] bf16 halves (A's rows are L*V here too), g the f32
    # cotangent of R, and the unit scales of the unnormalised model.
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    a = torch.randn((rows, h), generator=gen, device=device).to(torch.bfloat16)
    b = torch.randn((rows, h), generator=gen, device=device).to(torch.bfloat16)
    g = torch.randn((rows, h), generator=gen, device=device)
    sf, sb, _ = ps.pair_unit_scales(plan, rows)
    fwd_args = (a, b, sf, *plan.fwd, rows)
    da_args = (a, b, g, sb, *plan.bwd, rows)
    db_args = (a, b, g, sf, *plan.fwd, rows)
    fns = {
        "relu_pair_fwd_m": (lambda: pem.relu_pair_fwd_m(*fwd_args),
                            lambda: pem.relu_pair_fwd_m_plain(*fwd_args)),
        "relu_pair_da": (lambda: pem.relu_pair_da(*da_args),
                         lambda: pem.relu_pair_da_plain(*da_args)),
        "relu_pair_fwd": (lambda: pem.relu_pair_fwd(*fwd_args),
                          lambda: pem.relu_pair_fwd_plain(*fwd_args)),
        "relu_pair_db": (lambda: pem.relu_pair_db(*db_args),
                         lambda: pem.relu_pair_db_plain(*db_args)),
    }
    errs = {}
    for name, (kernel_fn, plain_fn) in fns.items():
        got, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        errs[name] = max(check_close(f"{name} output {i}", x, y, KERNEL_RTOL,
                                     KERNEL_ATOL)
                         for i, (x, y) in enumerate(zip(got, want)))
        del got, want
    log("kernel check: " + ", ".join(f"{name} max_abs_err {err:.3e}"
                                     for name, err in errs.items())
        + f" (rtol {KERNEL_RTOL}, atol {KERNEL_ATOL})")

    counters = [(ps.reset_launch_counts, ps.LAUNCHES),
                (pa.reset_launch_counts, pa.LAUNCHES),
                (pem.reset_launch_counts, pem.LAUNCHES)]
    layers = params["gnn_num_layers"]
    for reset, _ in counters:
        reset()
    check_eval_forward(model, batch, labels, [
        (pem, name, getattr(pem, f"{name}_plain")) for name in fns],
        logit_rtol=EDGE_MLP_LOGIT_RTOL)
    torch.cuda.synchronize()
    eval_launches = dict(pem.LAUNCHES)
    log(f"eval forward launches {eval_launches}")
    if eval_launches != {"relu_pair_fwd_m": 0, "relu_pair_da": 0,
                         "relu_pair_fwd": layers, "relu_pair_db": 0}:
        raise AssertionError(f"eval forward launched {eval_launches}; "
                             f"expected relu_pair_fwd {layers} times only")
    per_step = layers * TRAIN_STEPS
    state, train_step, eval_step, launches = train_and_count(
        model, params, batch, labels, counters,
        {"relu_pair_fwd_m": per_step, "relu_pair_da": per_step,
         "relu_pair_fwd": 0, "relu_pair_db": 0, "pair_stream": 0,
         "pair_stream_joint": 0, "pair_spmm": 0, "pair_attention_expd": 0,
         "pair_attention_bwd_fused": 0})
    launches["relu_pair_fwd"] = eval_launches["relu_pair_fwd"]
    time_path(state, train_step, eval_step, batch, labels, real_edges,
              device, argv, "GNN_Edge_MLP")

    # Bounds from this run's plan: distinct rows of A, B and g read once,
    # the plan, the f32 outputs written once.
    f_src, f_tgt, f_valid = ps.slot_abs_ids(*plan.fwd)
    a_rows = int(torch.unique(f_src[f_valid]).numel())
    t_rows = int(torch.unique(f_tgt[f_valid]).numel())
    b_tgt, b_src, b_valid = ps.slot_abs_ids(*plan.bwd)
    da_a_rows = int(torch.unique(b_src[b_valid]).numel())
    da_t_rows = int(torch.unique(b_tgt[b_valid]).numel())
    # Per valid slot and column: z = a + b, then relu, scale and add (B6);
    # also compare, select and add for M (B4); compare, select, scale and
    # add (B5); compare, select and add, and g's multiply per output (B7).
    bounds = {
        "relu_pair_fwd": relu_pair_bound_ms(plan.fwd, a_rows + t_rows, 0, h,
                                            1, rows, 4.0),
        "relu_pair_fwd_m": relu_pair_bound_ms(plan.fwd, a_rows + t_rows, 0,
                                              h, 2, rows, 7.0),
        "relu_pair_da": relu_pair_bound_ms(plan.bwd, da_a_rows + da_t_rows,
                                           da_t_rows, h, 1, rows, 5.0),
        "relu_pair_db": relu_pair_bound_ms(plan.fwd, a_rows + t_rows,
                                           t_rows, h, 1, rows, 4.0),
    }
    replaces = {"relu_pair_fwd_m": "tf2_gnn_tpu/ops/pair_edge_mlp.py:289",
                "relu_pair_da": "tf2_gnn_tpu/ops/pair_edge_mlp.py:523",
                "relu_pair_fwd": "tf2_gnn_tpu/ops/pair_edge_mlp.py:171",
                "relu_pair_db": "tf2_gnn_tpu/ops/pair_edge_mlp.py:402"}
    kernels = []
    for name, (kernel_fn, plain_fn) in fns.items():
        (bound, bound_by), valid = bounds[name]
        kernels.append(time_kernel(
            name, "tf2_gnn_tpu_torch/csrc/pair_edge_mlp.cu", replaces[name],
            launches[name], errs[name], kernel_fn, plain_fn, None, None,
            bound, bound_by,
            f"[{rows}, {h}] bf16 A and B, {valid} valid slots"))
    return kernels


def main(argv) -> int:
    import torch

    device = require_card()
    sys.path.insert(0, str(ROOT))
    from tf2_gnn_tpu_torch.ops import cuda_build

    # A reference states its float32 product precision: full f32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for "
        f"{sorted(logs) or 'cached libraries'}")
    for source, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {source}: {line.strip()}")
    log(f"device: {torch.cuda.get_device_name(device)} "
        f"(torch {torch.__version__}, CUDA {torch.version.cuda})")

    # -- 2. PPI_RGCN, 3. PPI_RGAT, 4. GNN_Edge_MLP ---------------------------
    kernels = rgcn_path(device, argv)
    torch.cuda.empty_cache()
    kernels += rgat_path(device, argv)
    torch.cuda.empty_cache()
    kernels += edge_mlp_path(device, argv)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(json.dumps({"kernels": kernels}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def profile_step(train_step, state, batch, labels, step_ms: float,
                 steps: int = 5) -> None:
    """Device time by kernel over a few train steps (torch.profiler), and
    the device's busy share of the unprofiled step time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, metrics = train_step(state, batch, labels)
        torch.cuda.synchronize()

    def self_us(e):  # the attribute's name changed across torch versions
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and self_us(e) > 0]
    kernels.sort(key=self_us, reverse=True)
    busy_ms = sum(self_us(e) for e in kernels) / steps / 1e3
    log(f"profile: {steps} steps, kernel time {busy_ms:.3f} ms/step of a "
        f"{step_ms:.3f} ms unprofiled step (device busy share "
        f"{busy_ms / step_ms:.3f})")
    for e in kernels[:15]:
        log(f"  {self_us(e) / steps / 1e3:8.4f} ms/step  "
            f"{e.count // steps:4d}x  {e.key[:100]}")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
