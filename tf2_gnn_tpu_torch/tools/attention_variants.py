"""Time RGAT's attention row owners in variants of their sources on one
CUDA card: the backward B9 (``csrc/pair_attention.cu``'s
``bwd_rows_kernel`` and ``bwd_rows_tiled_kernel``, with its second pass)
and the sums B10 and B14 (``csrc/pair_stream.cu``'s ``head_rows_kernel``),
at ``chip_smoke.py``'s shapes. From the repository root:

    python -m tf2_gnn_tpu_torch.tools.attention_variants

Each variant changes one line of one source in a copy of ``csrc/`` under
``build/``, built with ``ops/cuda_build.py``'s flags: B9's register form
with two entries' dw rows in flight where a lane holds at most 4 words of
the row (at H = 64, K = 8 in bf16; the shipped source keeps one), and
``head_rows_kernel`` with 4 entries in flight (2 shipped). Every call
first runs in turn for a few seconds, so that the card's clocks settle;
then each variant runs twice, after the shipped sources each time. For each it prints the ptxas registers and spills
of the changed kernels, then each call's wrapper time (CUDA events) and
device time (torch.profiler, ``chip_smoke.device_ms``): B9 on the merged
PPI plan at K = 4, H = 320 (PPI_RGAT), 576 and 1024 (the tiled form) and
K = 8, H = 64 (GAT's head layout), bf16; B10 on the largest type's plan
at K = 8, H = 64 and K = 4, H = 512, bf16; B14 on the scatter-plan batch,
K = 4, H = 320, f32. Every
output should equal the shipped sources' bit for bit (a variant changes
how many entries are in flight or the registers, not the order of any
sum): each line says whether it does, and the tool exits 1 if one does
not.
"""
import subprocess
import sys
import time

from .relu_pair_variants import _ptxas_report, _variant_csrc

B9_SOURCE, HEAD_SOURCE = "pair_attention.cu", "pair_stream.cu"
_B9_TWO = (B9_SOURCE, [(
    "bwd_rows_kernel(BwdRowsArgs a) {", "constexpr int IN_FLIGHT = 1;",
    "constexpr int IN_FLIGHT = W * U::kWords <= 4 ? 2 : 1;")])
_HEAD_FOUR = (HEAD_SOURCE, [("constexpr int HEAD_IN_FLIGHT", "= 2;",
                             "= 4;")])
# (name, source, edits: (anchor, the shipped text after it, the
# variant's)), in the order run; a repeated source text is not rebuilt.
VARIANTS = [
    ("shipped", None, []),
    ("B9 register form, 2 in flight at H = 64", *_B9_TWO),
    ("head_rows_kernel, 4 in flight", *_HEAD_FOUR),
    ("shipped, again", None, []),
    ("B9 register form, 2 in flight at H = 64, again", *_B9_TWO),
    ("head_rows_kernel, 4 in flight, again", *_HEAD_FOUR),
]
# Seconds of every call in turn before the first variant, so that the
# card's clocks have settled.
WARM_UP_S = 5.0
B9_SHAPES = ((4, 320), (8, 64), (4, 576), (4, 1024))
B10_SHAPES = ((8, 64), (4, 512))


def _calls(device):
    """{label: call} of B9, B10 and B14 at the shapes above."""
    import torch

    import chip_smoke
    from tf2_gnn_tpu_torch.ops import pair_attention as pa
    from tf2_gnn_tpu_torch.ops import pair_spmm as ps
    from tf2_gnn_tpu_torch.ops import sorted_spmm as ss
    from tf2_gnn_tpu_torch.workloads import build_ppi_batch

    gen = torch.Generator(device=device).manual_seed(chip_smoke.SEED + 5)
    bf16 = torch.bfloat16

    def randn(*shape, dtype=bf16, scale=1.0):
        return (scale * torch.randn(shape, generator=gen,
                                    device=device)).to(dtype)

    calls = {}
    batch = build_ppi_batch(chip_smoke.SEED, device=device, merged=True)[0]
    plan, v = batch.pair_merged, batch.num_nodes_padded
    rows = batch.num_edge_types * v
    compact, ts_rows = plan.bwd_rows(rows, v), plan.bwd_ts_rows(rows, v, v)
    for k, h in B9_SHAPES:
        scores = randn(rows, 2 * k, scale=0.5)
        m = pa._stabilise(pa._bound_stabiliser(scores, v, k), bf16)
        args = (randn(rows, h), randn(v, h), randn(v, k, dtype=torch.float32),
                scores, m, *plan.bwd, v, k)
        calls[f"B9 K = {k}, H = {h}, merged plan"] = (
            lambda args=args: pa.pair_attention_bwd_fused(
                *args, compact=compact, ts_rows=ts_rows))

    typed = build_ppi_batch(chip_smoke.SEED, device=device)[0].pair_typed
    valid = [int(ps.slot_abs_ids(*p.fwd)[2].sum()) for p in typed]
    big = typed[valid.index(max(valid))]
    fwd_rows = big.fwd_rows(v, v)
    for k, h in B10_SHAPES:
        scores = randn(v, 2 * k, scale=0.5)
        m = pa._stabilise(pa._bound_stabiliser(scores, v, k), bf16)
        expd = pa.pair_attention_expd_plain(scores, m, *big.fwd, v, k)
        table = randn(v, h)
        calls[f"B10 K = {k}, H = {h}, one type's plan"] = (
            lambda table=table, expd=expd, k=k: pa.pair_attention_agg(
                table, expd, *big.fwd, v, k, compact=fwd_rows))

    splan = build_ppi_batch(chip_smoke.SEED, device=device,
                            scatter=True)[0].scatter_merged
    slots = splan.rel_tgt.numel()
    msgs = randn(slots, 324, dtype=torch.float32)[:, :320]
    expd = torch.rand((slots, 4), generator=gen, device=device)
    expd.masked_fill_(splan.fwd_sentinel[:, None], 0.0)
    sum_rows = splan.sum_rows("fwd", v)
    calls["B14 K = 4, H = 320, f32 view"] = (
        lambda: ss.attention_scatter_sums(expd, msgs, splan.rel_tgt,
                                          splan.tgt_blocks, v,
                                          compact=sum_rows))
    return calls


def main() -> int:
    import torch

    import chip_smoke
    from tf2_gnn_tpu_torch.ops import cuda_build

    device = chip_smoke.require_card()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    calls = _calls(device)
    cuda_build.build_all([B9_SOURCE, HEAD_SOURCE])
    start = time.perf_counter()
    while time.perf_counter() - start < WARM_UP_S:
        for fn in calls.values():
            fn()
        torch.cuda.synchronize()
    shipped_csrc = cuda_build.CSRC_DIR
    shipped, failed = {}, False
    for variant, source, edits in VARIANTS:
        cuda_build.CSRC_DIR = _variant_csrc(cuda_build, shipped_csrc,
                                            variant, edits, source)
        for src in (B9_SOURCE, HEAD_SOURCE):
            cuda_build._LOADED.pop(src, None)
        logs = cuda_build.build_all([B9_SOURCE, HEAD_SOURCE])
        print(f"== {variant}", flush=True)
        if source is not None:
            match = "bwd_rows" if source == B9_SOURCE else "head_rows"
            for name, regs, stores, loads in _ptxas_report(
                    logs.get(source, ""), match):
                print(f"  ptxas {name}: {regs} registers, spill stores "
                      f"{stores} B, loads {loads} B")
        for label, fn in calls.items():
            out = fn()
            torch.cuda.synchronize()
            want = shipped.setdefault(label, out)
            same = all(torch.equal(x, y) for x, y in zip(out, want))
            ms = chip_smoke.time_ms(fn)
            dev = chip_smoke.device_ms(fn)
            print(f"  {label}: wrapper {ms:.4f} ms, device {dev} ms, "
                  f"bit-equal to the shipped output: {same}", flush=True)
            failed = failed or not same
    cuda_build.CSRC_DIR = shipped_csrc
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
