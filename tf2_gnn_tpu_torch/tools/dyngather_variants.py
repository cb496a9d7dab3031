"""Time P3, the per-lane gather probe (``csrc/dyngather.cu``), in its
forms at ``chip_smoke.py``'s probe shape (``DYNGATHER_SHAPE``: an [8192,
128] table, 64 shifts), f32 and bf16, on one CUDA card. From the
repository root:

    python -m tf2_gnn_tpu_torch.tools.dyngather_variants

The variants: the shared form's strip width (``ops/probes.py``'s
``STRIP_COLS``: f32 1, 2 and 4 columns, bf16 2, 4 and 8) at each thread
count a block (``SHARED_THREADS``: 256, 512 and 1024, in a copy of
``csrc/`` under ``build/``, built with ``ops/cuda_build.py``'s flags), and
the global form (``MAX_STRIP_BYTES`` set to 0, so no strip fits). After a
few seconds of the shipped forms, so that the card's clocks settle, each
thread count runs twice, in turns: its ptxas registers and spills, then
for each dtype and form its wrapper time (CUDA events) and device time
(torch.profiler, ``chip_smoke.device_ms``). Every form adds the same
values in shift order, so every variant must give the shipped source's
bits: each line says whether it does, and the tool exits 1 if one does
not.
"""
import subprocess
import sys
import time

from .relu_pair_variants import _ptxas_report, _variant_csrc

SOURCE = "dyngather.cu"
THREADS = (256, 512, 1024)
SHIPPED_THREADS = 1024
WIDTHS = {"float32": (1, 2, 4), "bfloat16": (2, 4, 8)}
ROUNDS = 2
WARM_UP_S = 5.0


def thread_edits(threads: int):
    """The source edits (``_variant_csrc``'s) that set the shared form's
    threads a block."""
    if threads == SHIPPED_THREADS:
        return []
    return [("constexpr int SHARED_THREADS", f"= {SHIPPED_THREADS};",
             f"= {threads};")]


def main() -> int:
    import torch

    import chip_smoke
    from tf2_gnn_tpu_torch.ops import cuda_build, probes

    device = chip_smoke.require_card()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    built = cuda_build.build_all([SOURCE])
    rows, cols, reps = chip_smoke.DYNGATHER_SHAPE
    gen = torch.Generator(device=device).manual_seed(chip_smoke.SEED + 5)
    table = torch.randn((rows, cols), generator=gen, device=device)
    idx = torch.randint(0, rows, (rows, cols), generator=gen, device=device,
                        dtype=torch.int32)
    tables = {torch.float32: table, torch.bfloat16: table.to(torch.bfloat16)}
    widths = {getattr(torch, name): w for name, w in WIDTHS.items()}
    shipped_cols, shipped_bytes = dict(probes.STRIP_COLS), \
        probes.MAX_STRIP_BYTES
    shipped = {t.dtype: probes.dyngather(t, idx, reps)
               for t in tables.values()}
    start = time.perf_counter()
    while time.perf_counter() - start < WARM_UP_S:
        for t in tables.values():
            probes.dyngather(t, idx, reps)
        torch.cuda.synchronize()

    def run(label, t):
        out = probes.dyngather(t, idx, reps)
        torch.cuda.synchronize()
        same = torch.equal(out, shipped[t.dtype])
        ms = chip_smoke.time_ms(lambda: probes.dyngather(t, idx, reps))
        dev = chip_smoke.device_ms(lambda: probes.dyngather(t, idx, reps))
        print(f"  {t.dtype} {label}: wrapper {ms:.4f} ms, device {dev} ms, "
              f"bit-equal to the shipped output: {same}", flush=True)
        return same

    shipped_csrc = cuda_build.CSRC_DIR
    failed = False
    try:
        for _ in range(ROUNDS):
            for threads in THREADS:
                edits = thread_edits(threads)
                cuda_build.CSRC_DIR = _variant_csrc(
                    cuda_build, shipped_csrc, f"dyngather {threads} threads",
                    edits, SOURCE)
                cuda_build._LOADED.pop(SOURCE, None)
                logs = cuda_build.build_all([SOURCE])
                print(f"== {threads} threads a block", flush=True)
                report = logs.get(SOURCE) or (
                    built.get(SOURCE, "") if not edits else "")
                for name, regs, stores, loads in _ptxas_report(report,
                                                               "dyngather"):
                    print(f"  ptxas {name}: {regs} registers, spill "
                          f"stores {stores} B, loads {loads} B")
                for dtype, t in tables.items():
                    for width in widths[dtype]:
                        probes.STRIP_COLS[dtype] = width
                        failed |= not run(f"shared, {width} columns a strip",
                                          t)
                    probes.STRIP_COLS[dtype] = shipped_cols[dtype]
                    if threads == SHIPPED_THREADS:
                        probes.MAX_STRIP_BYTES = 0
                        failed |= not run("global", t)
                        probes.MAX_STRIP_BYTES = shipped_bytes
    finally:
        probes.STRIP_COLS.update(shipped_cols)
        probes.MAX_STRIP_BYTES = shipped_bytes
        cuda_build.CSRC_DIR = shipped_csrc
        cuda_build._LOADED.pop(SOURCE, None)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
