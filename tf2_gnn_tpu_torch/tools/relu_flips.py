"""Measure how far ``chip_smoke.py`` phase 13's comparisons on one CUDA
card depend on relu inputs that lie within rounding of 0. From the root of
a checkout:

    python -m tf2_gnn_tpu_torch.tools.relu_flips [REPEATS]

Phase 13d (``chip_smoke.gnn_input_case``): the dataset batch's fused run
twice, then the GNNInput batch's unfused run REPEATS times (default 6)
with its relu free and as often with the relu keeping the first fused
run's signs (``chip_smoke.relu_inputs``). Each run prints its relu inputs
on the other side of 0 from the first fused run's (count and largest
|x|) and its worst gradients as a share of their largest entries.

Then each TF dump of phase 13 (``reference_parity.CASES``) REPEATS times
unfused and twice on its fused plans (``chip_smoke.reference_run``): the
runs that fail, each quantity's worst share of its limit over the runs,
and the smallest nonzero |x| that relu and leaky_relu meet.
"""
import sys


def _flips(got, want):
    """(count, largest |x|) of the entries on opposite sides of 0."""
    flipped = (got > 0) != (want > 0)
    sizes = got.abs().maximum(want.abs())[flipped]
    return int(flipped.sum()), float(sizes.max()) if sizes.numel() else 0.0


def gnn_input_runs(device, repeats: int) -> None:
    import chip_smoke

    run, bare, planned, _, _ = chip_smoke.gnn_input_case(
        device, chip_smoke.ROOT / "build" / "phase12" / "ppi")
    want = run(planned, None)
    pinned = [x > 0 for x in want[3]]
    runs = [("fused", planned, None)] + [("unfused", bare, None)] * repeats
    runs += [("unfused, relu pinned", bare, pinned)] * repeats
    for label, batch, pins in runs:
        got = run(batch, pins)
        flips = [_flips(g, w) for g, w in zip(got[3], want[3])]
        shares = chip_smoke.gradient_shares(got[1], want[1])
        worst = sorted(shares.items(), key=lambda kv: -kv[1])[:3]
        print(f"13d {label}: relu inputs on the other side of 0 by layer "
              f"(count, largest |x|) {flips}; worst gradients "
              f"{[(n, f'{s:.3g}') for n, s in worst]}", flush=True)


def dump_runs(device, repeats: int) -> None:
    import chip_smoke
    from tf2_gnn_tpu_torch.harness import reference_parity as rp
    from tf2_gnn_tpu_torch.ops import activations

    smallest = {}
    for key in ("relu", "leaky_relu"):
        def recorded(x, _fn=activations._ACTIVATIONS[key], _key=key):
            a = x.detach().abs()
            a = a[a > 0]
            if a.numel():
                smallest[_key] = min(smallest.get(_key, float("inf")),
                                     float(a.min()))
            return _fn(x)
        activations._ACTIVATIONS[key] = recorded
    root = chip_smoke.ROOT / "build" / "phase13"
    for name, task, _ in rp.CASES:
        dump = rp.load_dump(name)
        data = rp.write_data(task, root)
        for kind in ("none", rp.FUSED_PLANS[dump.model]):
            smallest.clear()
            worst, fails = {}, 0
            for _ in range(repeats if kind == "none" else 2):
                try:
                    report = chip_smoke.reference_run(dump, data, kind,
                                                      device)[2]
                except AssertionError as e:
                    fails += 1
                    print(f"{name} on {kind} plans failed: {e}", flush=True)
                    continue
                for k, (share, _) in report.items():
                    k = "reps" if k.startswith("rep::") else k
                    worst[k] = max(worst.get(k, 0.0), share)
            print(f"{name} on {kind} plans: {fails} runs failed; worst "
                  f"share of each limit "
                  f"{ {k: float(f'{v:.3g}') for k, v in worst.items()} }; "
                  f"smallest nonzero |x| {smallest}", flush=True)


def main(argv) -> int:
    import torch

    import chip_smoke
    from tf2_gnn_tpu_torch import native
    from tf2_gnn_tpu_torch.ops import cuda_build

    repeats = int(argv[0]) if argv else 6
    device = chip_smoke.require_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.build_all()
    native.build()
    gnn_input_runs(device, repeats)
    dump_runs(device, repeats)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
