"""Time the expd (B8, ``pair_attention_expd``) and dB (B7,
``relu_pair_db``) kernels at ``chip_smoke.py``'s shapes on one CUDA card:
B8 on the merged PPI plan and on the largest type's plan (K = 4, bf16
scores), B7 on the merged-target plan (bf16 [24192, 320] A and B, f32 g,
unit scales). From the root of a checkout:

    python -m tf2_gnn_tpu_torch.tools.expd_db_times

For each call it prints the wrapper time (CUDA events,
``chip_smoke.time_ms``) and the device time (torch.profiler,
``chip_smoke.device_ms``), and the largest difference from the plain
version (B8's at the plan slots its output covers). The wrappers take the
plan's forward compact form; where a checkout's wrapper takes none (a
kernel over the plan arrays), the call passes none, so the tool times
both designs: copy it into another checkout's ``tools/`` and run it
there, in turns with this one, to compare the two on one card.
"""
import inspect
import subprocess
import sys


def _calls(device):
    """{label: (kernel call, plain call)} at chip_smoke.py's shapes."""
    import torch

    import chip_smoke
    from tf2_gnn_tpu_torch.ops import pair_attention as pa
    from tf2_gnn_tpu_torch.ops import pair_edge_mlp as pem
    from tf2_gnn_tpu_torch.ops import pair_spmm as ps
    from tf2_gnn_tpu_torch.workloads import build_ppi_batch

    gen = torch.Generator(device=device).manual_seed(chip_smoke.SEED + 7)
    k, bf16 = 4, torch.bfloat16
    merged = build_ppi_batch(chip_smoke.SEED, device=device,
                             merged=True)[0]
    v = merged.num_nodes_padded
    typed = build_ppi_batch(chip_smoke.SEED, device=device)[0].pair_typed
    valid = [int(ps.slot_abs_ids(*p.fwd)[2].sum()) for p in typed]
    big = typed[valid.index(max(valid))]
    takes_form = {fn: "compact" in inspect.signature(fn).parameters
                  for fn in (pa.pair_attention_expd, pem.relu_pair_db)}
    calls = {}
    for label, plan, rows in (("B8 merged plan", merged.pair_merged, 3 * v),
                              ("B8 one type's plan", big, v)):
        scores = (0.5 * torch.randn((rows, 2 * k), generator=gen,
                                    device=device)).to(bf16)
        m = pa._stabilise(pa._bound_stabiliser(scores, v, k), bf16)
        form = plan.fwd_rows(v, rows)
        extra = ({"compact": form} if takes_form[pa.pair_attention_expd]
                 else {})
        at = (form.slot.long() if extra
              else torch.arange(plan.rel_src_f.numel(), device=device))
        calls[label] = (
            lambda s=scores, m=m, p=plan, e=extra: pa.pair_attention_expd(
                s, m, *p.fwd, v, k, **e),
            lambda s=scores, m=m, p=plan, at=at:
                pa.pair_attention_expd_plain(s, m, *p.fwd, v, k)[:, at])
    target = build_ppi_batch(chip_smoke.SEED, device=device, merged=True,
                             merge_targets=True)[0].pair_merged
    rows, h = target.out_rows, 320
    a, b = (torch.randn((rows, h), generator=gen, device=device).to(bf16)
            for _ in range(2))
    g = torch.randn((rows, h), generator=gen, device=device)
    sf = ps.pair_unit_scales(target, rows)[0]
    extra = ({"compact": target.fwd_rows(rows, rows)}
             if takes_form[pem.relu_pair_db] else {})
    calls["B7 merged-target plan"] = (
        lambda: pem.relu_pair_db(a, b, g, sf, *target.fwd, rows, **extra),
        lambda: pem.relu_pair_db_plain(a, b, g, sf, *target.fwd, rows))
    return calls


def main() -> int:
    import torch

    import chip_smoke

    device = chip_smoke.require_card()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    for label, (kernel, plain) in _calls(device).items():
        got = kernel()
        torch.cuda.synchronize()
        err = float((got - plain()).abs().max())
        ms = chip_smoke.time_ms(kernel)
        dev = chip_smoke.device_ms(kernel)
        print(f"{label}: wrapper {ms:.4f} ms, device {dev} ms, max abs "
              f"diff to the plain version {err:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
