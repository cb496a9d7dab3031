"""Time RGAT's two stabilisers, B11 and B15 (``csrc/pair_stream.cu``'s
``max_rows_kernel``), and B8, the expd (its ``expd_rows_kernel``), at
each lane count a row, at ``chip_smoke.py``'s shapes, on one CUDA card.
From the repository root:

    python -m tf2_gnn_tpu_torch.tools.max_rows_lanes

The calls: B11 over the largest type's forward compact form of the
per-type PPI batch (bf16 [8064, 8] scores), the same from an init (the
per-type forward's second and third launches), and over the merged
plan's (bf16 [24192, 8]); B15 over the scatter-plan batch's forward
compact form (f32 [245760, 4] logits); B8 over the same two pair forms
as B11, with the bound stabiliser. Each variant sets both kernels' lanes
a row (``MAX_LANES`` and ``EXPD_LANES``: 4, 8, 16 or 32; 8 and 32 ship)
in a copy of ``csrc/`` under ``build/``, built with
``ops/cuda_build.py``'s flags.
After a few seconds of every call in turn, so that the card's clocks
settle, each variant runs twice, in turns: its ptxas registers and
spills, then for each call its wrapper time (CUDA events) and device time
(torch.profiler, ``chip_smoke.device_ms``). A max does not depend on the
order of its operands, and B8 computes each entry alone, so every variant
must give the shipped source's bits: each line says whether it does, and
the tool exits 1 if one does not.
"""
import subprocess
import sys
import time

from .relu_pair_variants import _ptxas_report, _variant_csrc

SOURCE = "pair_stream.cu"
LANES = (4, 8, 16, 32)
# The shipped lanes a row of each kernel, by the constant that sets them.
SHIPPED_LANES = {"MAX_LANES": 8, "EXPD_LANES": 32}
ROUNDS = 2
WARM_UP_S = 5.0


def _calls(device):
    """{label: call} of B11, B15 and B8 at chip_smoke.py's shapes."""
    import torch

    import chip_smoke
    from tf2_gnn_tpu_torch.ops import pair_attention as pa
    from tf2_gnn_tpu_torch.ops import pair_spmm as ps
    from tf2_gnn_tpu_torch.ops import sorted_spmm as ss
    from tf2_gnn_tpu_torch.workloads import build_ppi_batch

    gen = torch.Generator(device=device).manual_seed(chip_smoke.SEED + 6)
    k = 4

    def scores(rows):
        return (0.5 * torch.randn((rows, 2 * k), generator=gen,
                                  device=device)).to(torch.bfloat16)

    typed = build_ppi_batch(chip_smoke.SEED, device=device)[0]
    v = typed.num_nodes_padded
    valid = [int(ps.slot_abs_ids(*p.fwd)[2].sum()) for p in typed.pair_typed]
    big = typed.pair_typed[valid.index(max(valid))]
    merged = build_ppi_batch(chip_smoke.SEED, device=device,
                             merged=True)[0].pair_merged
    s_t, s_m = scores(v), scores(3 * v)
    init = pa.pair_attention_max_plain(scores(v), *big.fwd, v, k)
    rows_t, rows_m = big.fwd_rows(v, v), merged.fwd_rows(v, 3 * v)
    splan = build_ppi_batch(chip_smoke.SEED, device=device,
                            scatter=True)[0].scatter_merged
    logits = torch.randn((splan.rel_tgt.numel(), k), generator=gen,
                         device=device)
    rows_s = splan.sum_rows("fwd", v)
    m_t = pa._stabilise(pa._bound_stabiliser(s_t, v, k), torch.bfloat16)
    m_m = pa._stabilise(pa._bound_stabiliser(s_m, v, k), torch.bfloat16)
    return {
        "B11 one type's plan": lambda: pa.pair_attention_max(
            s_t, *big.fwd, v, k, compact=rows_t),
        "B11 one type's plan, from an init": lambda: pa.pair_attention_max(
            s_t, *big.fwd, v, k, compact=rows_t, init=init),
        "B11 merged plan": lambda: pa.pair_attention_max(
            s_m, *merged.fwd, v, k, compact=rows_m),
        "B15 scatter plan": lambda: ss.sorted_segment_max(
            logits, splan.rel_tgt, splan.tgt_blocks, v, compact=rows_s),
        "B8 one type's plan": lambda: pa.pair_attention_expd(
            s_t, m_t, *big.fwd, v, k, compact=rows_t),
        "B8 merged plan": lambda: pa.pair_attention_expd(
            s_m, m_m, *merged.fwd, v, k, compact=rows_m),
    }


def main() -> int:
    import torch

    import chip_smoke
    from tf2_gnn_tpu_torch.ops import cuda_build

    device = chip_smoke.require_card()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    cuda_build.build_all([SOURCE])
    calls = _calls(device)
    start = time.perf_counter()
    while time.perf_counter() - start < WARM_UP_S:
        for fn in calls.values():
            fn()
        torch.cuda.synchronize()
    shipped_csrc = cuda_build.CSRC_DIR
    shipped, failed = {}, False
    for _ in range(ROUNDS):
        for lanes in LANES:
            edits = [(f"constexpr int {name}", f"= {shipped_g};",
                      f"= {lanes};")
                     for name, shipped_g in SHIPPED_LANES.items()
                     if lanes != shipped_g]
            cuda_build.CSRC_DIR = _variant_csrc(
                cuda_build, shipped_csrc, f"max rows {lanes} lanes", edits,
                SOURCE)
            cuda_build._LOADED.pop(SOURCE, None)
            logs = cuda_build.build_all([SOURCE])
            print(f"== {lanes} lanes a row", flush=True)
            for match in ("max_rows", "expd_rows"):
                for name, regs, stores, loads in _ptxas_report(
                        logs.get(SOURCE, ""), match):
                    print(f"  ptxas {name}: {regs} registers, spill "
                          f"stores {stores} B, loads {loads} B")
            for label, fn in calls.items():
                out = fn()
                torch.cuda.synchronize()
                want = shipped.setdefault(label, out)
                same = torch.equal(out.view(torch.int32),
                                   want.view(torch.int32))
                ms = chip_smoke.time_ms(fn)
                dev = chip_smoke.device_ms(fn)
                print(f"  {label}: wrapper {ms:.4f} ms, device {dev} ms, "
                      f"bit-equal to the first variant's output: {same}",
                      flush=True)
                failed = failed or not same
    cuda_build.CSRC_DIR = shipped_csrc
    cuda_build._LOADED.pop(SOURCE, None)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
