"""Time the unfused path's sums over edges on one CUDA card, at the
benchmark's PPI batch (``ppi_rgcn.unfused``: 20 graphs of 2,400 nodes
with 34,000 uniform forward edges each, reversed, plus self loops, so
1,408,000 edges of 3 types over a 49,152-node budget, each type padded by
the data layer's slack of 1.25 with pad-node edges; f32 rows of 320).
From the root of a checkout:

    python -m tf2_gnn_tpu_torch.tools.segment_sum_variants

Both directions the unfused path sums: the messages of every type,
concatenated, into their targets (the forward of ``_aggregate_messages``),
and each type's f32 cotangent into its sources (the backward of
``gather_source_rows``). Each in three forms, CUDA events over
``chip_smoke.KERNEL_REPS`` calls and the profiler's device time:
``index_add_`` (``segment_sum`` without an order); ``torch.sparse.mm`` of
the order's CSR of ones (``SegmentOrder.sum_rows``, as shipped); and
``torch.segment_reduce`` over the rows gathered in the order, one run a
segment. Each form's two calls are compared bit for bit, and its largest
difference from an f64 sum is given as a share of the segment's sum of
magnitudes. Then the device time and the bytes of building the orders a
batch (``SegmentOrder.build``), the bound of one direction's read (rows
once, over 3.35 TB/s), and a forward and backward of the aggregation
through ``segment_sum`` with and without the order, kernels by name.
"""
import subprocess
import sys
import warnings

import numpy as np

GRAPHS, NODES, FWD_EDGES, NODE_BUDGET, H = 20, 2400, 34000, 49152, 320
SLACK = 1.25


def cell_edges(seed: int):
    """The batch's padded (sources, targets) per type (self loops,
    forward, reversed), each type padded to its count times ``SLACK``,
    rounded up to 512, with pad-node edges, as numpy int32."""
    rng = np.random.RandomState(seed)
    base = np.repeat(np.arange(GRAPHS) * NODES, FWD_EDGES)
    src = rng.randint(0, NODES, GRAPHS * FWD_EDGES) + base
    tgt = rng.randint(0, NODES, GRAPHS * FWD_EDGES) + base
    loops = np.arange(GRAPHS * NODES)
    pad = NODE_BUDGET - 1
    out = []
    for s, t in ((loops, loops), (src, tgt), (tgt, src)):
        budget = -(-int(s.shape[0] * SLACK) // 512) * 512
        ps = np.full(budget, pad, np.int32)
        pt = np.full(budget, pad, np.int32)
        ps[:s.shape[0]], pt[:t.shape[0]] = s, t
        out.append((ps, pt))
    return out


def _forms(order, rows):
    """{label: call} of one direction's sums of the [M, H] ``rows``."""
    import torch

    n = order.num_segments
    offsets = order.matrix.crow_indices().long()
    perm = order.matrix.col_indices()
    ids = order.ids.long()

    def scatter():
        out = rows.new_zeros((n + 1, rows.shape[1]))
        return out.index_add_(0, ids, rows)[:n]

    def gathered():
        return torch.segment_reduce(rows.index_select(0, perm), "sum",
                                    offsets=offsets, unsafe=True)[:n]

    return {"index_add_": scatter,
            "sparse.mm of the CSR (sum_rows, shipped)":
                lambda: order.sum_rows(rows),
            "gathered in order, segment_reduce": gathered}


def _report(label, ids, n, rows, reps):
    import torch

    import chip_smoke
    from tf2_gnn_tpu_torch.ops.segment import SegmentOrder

    order = SegmentOrder.build(ids, n)
    exact = rows.double().new_zeros((n + 1, rows.shape[1])).index_add_(
        0, order.ids.long(), rows.double())[:n]
    scale = rows.double().abs().new_zeros((n + 1, rows.shape[1])).index_add_(
        0, order.ids.long(), rows.double().abs())[:n].clamp_min(1e-30)
    longest = int(order.counts().max())
    gb = rows.numel() * rows.element_size() / 1e9
    print(f"{label}: [{rows.shape[0]}, {rows.shape[1]}] into {n} rows "
          f"(the longest segment {longest} entries), {gb:.3f} GB read, "
          f"bound {gb / 3.35:.4f} ms", flush=True)
    for name, fn in _forms(order, rows).items():
        first, second = fn(), fn()
        torch.cuda.synchronize()
        same = torch.equal(first, second)
        err = float(((first.double() - exact).abs() / scale).max())
        ms = chip_smoke.time_ms(fn, reps)
        dev = chip_smoke.device_ms(fn, reps)
        print(f"  {name}: {ms:.4f} ms, device {dev} ms; two calls "
              f"bit-equal {same}; largest error {err:.2e} of the "
              "segment's sum of magnitudes", flush=True)


def main() -> int:
    import torch

    import chip_smoke
    from tf2_gnn_tpu_torch.ops.segment import SegmentOrder, segment_sum
    from tf2_gnn_tpu_torch.tools.typed_linear_variants import _kernels

    warnings.filterwarnings("ignore", message=".*[Ss]parse.*")
    device = chip_smoke.require_card()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    reps = chip_smoke.KERNEL_REPS
    edges = [(torch.as_tensor(s, device=device),
              torch.as_tensor(t, device=device))
             for s, t in cell_edges(chip_smoke.SEED)]
    targets = torch.cat([t for _, t in edges])
    gen = torch.Generator(device=device).manual_seed(chip_smoke.SEED)
    messages = torch.randn((targets.shape[0], H), generator=gen,
                           device=device)

    def build():
        return [SegmentOrder.build(ids, NODE_BUDGET)
                for ids in [targets] + [s for s, _ in edges]]

    before = torch.cuda.memory_allocated(device)
    orders = build()
    held = torch.cuda.memory_allocated(device) - before
    del orders
    print(f"orders of a batch (the targets' and 3 types' sources): "
          f"{chip_smoke.time_ms(build, reps):.4f} ms, device "
          f"{chip_smoke.device_ms(build, reps)} ms; they hold {held} bytes "
          f"on the card ({targets.shape[0]} targets, "
          f"{sum(s.shape[0] for s, _ in edges)} sources)", flush=True)
    _report("forward, every type's messages into their targets", targets,
            NODE_BUDGET, messages, reps)
    for l, (s, _) in enumerate(edges):
        cot = torch.randn((s.shape[0], H), generator=gen, device=device)
        _report(f"backward, type {l}'s cotangent into its sources", s,
                NODE_BUDGET, cot, reps)
    order = SegmentOrder.build(targets, NODE_BUDGET)

    leaf = messages.clone().requires_grad_(True)
    g = torch.randn((NODE_BUDGET, H), generator=gen, device=device)

    def whole(ordered):
        leaf.grad = None
        out = segment_sum(leaf, targets, NODE_BUDGET,
                          order=order if ordered else None)
        out.backward(g)
        return out

    for ordered in (False, True):
        label = "over the order" if ordered else "index_add_"
        ms = chip_smoke.time_ms(lambda: whole(ordered), reps)
        kernels = _kernels(lambda: whole(ordered), reps)
        total = sum(k[1] for k in kernels)
        print(f"segment_sum forward and backward, {label}: {ms:.4f} ms, "
              f"device {total:.4f} ms", flush=True)
        for key, kms in kernels:
            print(f"    {kms:.4f} ms  {key[:100]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
