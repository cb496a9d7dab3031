"""Time the relu-pair row owners of ``csrc/pair_edge_mlp.cu`` (B4, B5, B6)
in variants of their source on one CUDA card, at the GNN_Edge_MLP path's
shapes (``chip_smoke.py`` phase 4's inputs). From the repository root:

    python -m tf2_gnn_tpu_torch.tools.relu_pair_variants

Each variant changes the gathers a kernel keeps in flight (one
``constexpr`` line) in a copy of ``csrc/`` under ``build/``, built with
``ops/cuda_build.py``'s flags. For each it prints the ptxas registers and
spills of every relu-pair kernel, then each kernel's wrapper time (CUDA
events) and device time (torch.profiler, ``chip_smoke.device_ms``) at the
path's width (H = 320) and a narrow one (H = 64), in 8-byte lane units and
in element units (reached through tables that start 2 bytes past an
8-byte boundary); the shipped source runs first and last, for the drift
between the two. Every output should equal the shipped
source's 8-byte output bit for bit (a variant changes how many entries are
in flight and the lane unit how the row is split, not the order of any
sum): each line says whether it does, and the tool exits 1 if one does
not.
"""
import re
import shutil
import subprocess
import sys
from pathlib import Path

SOURCE = "pair_edge_mlp.cu"
_ONE, _TWO = "constexpr int IN_FLIGHT = 1;", "constexpr int IN_FLIGHT = 2;"
# name -> edits (the kernel's signature, the shipped line in its body, the
# variant's line)
VARIANTS = {
    "shipped (1 in flight)": [],
    "B5 2 in flight": [("relu_pair_da_rows_kernel(DaRowsArgs a) {", _ONE,
                        _TWO)],
    "B4/B6 2 in flight": [("relu_pair_rows_kernel(RowsArgs a) {", _ONE,
                           _TWO)],
    "shipped, again": [],
}
WIDTHS = (320, 64)


def _variant_csrc(cuda_build, shipped: Path, name: str, edits,
                  source: str = SOURCE) -> Path:
    """The ``shipped`` ``csrc/`` with ``edits`` applied to ``source``: the
    directory itself where there are none, else a copy under the build
    directory."""
    if not edits:
        return shipped
    slug = re.sub(r"\W+", "_", name).strip("_")
    root = cuda_build.BUILD_DIR.parent / "variants" / slug / "csrc"
    shutil.copytree(shipped, root, dirs_exist_ok=True)
    text = (root / source).read_text()
    for anchor, old, new in edits:
        at = text.index(old, text.index(anchor))
        text = text[:at] + new + text[at + len(old):]
    (root / source).write_text(text)
    return root


def _demangle(names):
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, check=True)
        return out.stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        return list(names)


def _ptxas_report(log: str, match: str = "relu_pair"):
    """(kernel, registers, spill stores, spill loads) of every entry
    function whose name holds ``match`` in ``nvcc -Xptxas -v``'s output."""
    rows, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spills = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name and match in name:
            rows.append((name, int(m.group(1))) + spills)
    names = _demangle([r[0] for r in rows])
    return [(n,) + r[1:] for n, r in zip(names, rows)]


def _misaligned(x):
    """A copy of ``x`` whose start lies one element past a 16-byte
    boundary."""
    import torch

    flat = torch.empty((x.numel() + 8,), dtype=x.dtype, device=x.device)
    view = flat[1:1 + x.numel()].view(x.shape)
    view.copy_(x)
    return view


def main() -> int:
    import torch

    import chip_smoke
    from tf2_gnn_tpu_torch.ops import cuda_build
    from tf2_gnn_tpu_torch.ops import pair_edge_mlp as pem
    from tf2_gnn_tpu_torch.ops import pair_spmm as ps
    from tf2_gnn_tpu_torch.workloads import build_ppi_batch

    device = chip_smoke.require_card()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    batch, _, _ = build_ppi_batch(chip_smoke.SEED, device=device,
                                  merged=True, merge_targets=True)
    plan = batch.pair_merged
    rows = plan.out_rows
    gen = torch.Generator(device=device).manual_seed(chip_smoke.SEED + 2)
    a = torch.randn((rows, 320), generator=gen,
                    device=device).to(torch.bfloat16)
    b = torch.randn((rows, 320), generator=gen,
                    device=device).to(torch.bfloat16)
    g = torch.randn((rows, 320), generator=gen, device=device)
    sf, sb, _ = ps.pair_unit_scales(plan, rows)
    fwd_rows, bwd_rows = plan.fwd_rows(rows, rows), plan.bwd_rows(rows, rows)
    # (width, lane unit) -> A, B and g: the path's width and a narrow one,
    # each aligned (8-byte units) and misaligned (element units).
    tables = {}
    for h in WIDTHS:
        cut = tuple(x[:, :h].contiguous() for x in (a, b, g))
        tables[h, "8-byte"] = cut
        tables[h, "element"] = tuple(_misaligned(x) for x in cut)

    def calls(a, b, g):
        return {
            "B4 relu_pair_fwd_m": lambda: pem.relu_pair_fwd_m(
                a, b, sf, *plan.fwd, rows, compact=fwd_rows),
            "B6 relu_pair_fwd": lambda: pem.relu_pair_fwd(
                a, b, sf, *plan.fwd, rows, compact=fwd_rows),
            "B5 relu_pair_da": lambda: pem.relu_pair_da(
                a, b, g, sb, *plan.bwd, rows, compact=bwd_rows),
        }

    print(f"[{rows}, H] bf16 A and B, f32 g, H in {WIDTHS}; "
          f"{fwd_rows.src_row.numel()} forward and "
          f"{bwd_rows.src_row.numel()} backward entries", flush=True)
    shipped_csrc = cuda_build.CSRC_DIR
    shipped, failed = {}, False
    for variant, edits in VARIANTS.items():
        cuda_build.CSRC_DIR = _variant_csrc(cuda_build, shipped_csrc,
                                            variant, edits)
        cuda_build._LOADED.pop(SOURCE, None)
        log = cuda_build.build_all([SOURCE]).get(SOURCE, "")
        print(f"== {variant}", flush=True)
        for name, regs, stores, loads in _ptxas_report(log):
            print(f"  ptxas {name}: {regs} registers, spill stores "
                  f"{stores} B, loads {loads} B")
        for (h, unit), (ta, tb, tg) in tables.items():
            for kernel, fn in calls(ta, tb, tg).items():
                out = fn()
                torch.cuda.synchronize()
                want = shipped.setdefault((h, kernel), out)
                got = out if isinstance(out, tuple) else (out,)
                ref = want if isinstance(want, tuple) else (want,)
                same = all(torch.equal(x, y) for x, y in zip(got, ref))
                ms = chip_smoke.time_ms(fn)
                dev = chip_smoke.device_ms(fn)
                print(f"  H = {h}, {unit} units: {kernel}: wrapper "
                      f"{ms:.4f} ms, device {dev} ms, bit-equal to the "
                      f"shipped 8-byte output: {same}", flush=True)
                failed = failed or not same
    cuda_build.CSRC_DIR = shipped_csrc
    return 1 if failed else 0

if __name__ == "__main__":
    sys.exit(main())
