"""Time the forms of ``TypedLinear``'s all-types product (x [V, D] against
the stacked kernel [L, D, H] -> [L, V, H]) on one CUDA card, at the
benchmark's table shapes: PPI_RGCN's (L = 3, V = 49152, D = H = 320) and
QM9_RGCN's (L = 5, V = 131072, D = H = 128), all f32 with TF32 off. From
the root of a checkout:

    python -m tf2_gnn_tpu_torch.tools.typed_linear_variants

Each direction's forms, CUDA events over ``chip_smoke.KERNEL_REPS`` calls
and the profiler's device time: ``torch.matmul``'s fold (its product
alone, and with the transposed copy it makes: forward of the [L*H, V]
result into [L, V, H], backward of the gradient into [L, H, V]); the
forward as one batched product with x at batch stride 0 and as one
product a type into slices of [L, V, H]; the input's gradient as one
product a type accumulated into [V, D] (split-K over the types) and as
one batched product summed over the types; the kernel's gradient as one
batched product with x.mT at batch stride 0, as one product a type, and
in the transposed orientation ([L, H, D], batched or a product a type,
then transposed). Then forward and
backward whole, ``torch.matmul`` against ``TypedLinear``'s path, with the
device time of each kernel by name, and the largest difference between
the two relative to the largest entry.
"""
import subprocess
import sys

SHAPES = {"PPI_RGCN": (3, 49152, 320, 320), "QM9_RGCN": (5, 131072, 128, 128)}


def _forms(x, w, g):
    """{label: call} of every direction's forms. The fold's operands are
    its layouts: ``w_fold`` [L*H, D] and ``g_fold`` [L*H, V], copied once
    here, so its products are timed alone as well as with the copy it
    makes of the [L*H, V] table."""
    import torch

    num_types, rows, h = g.shape
    d = x.shape[1]
    out = torch.empty_like(g)
    d_kernel = torch.empty_like(w)
    d_kernel_t = torch.empty((num_types, h, d), device=x.device)
    w_fold = w.transpose(1, 2).reshape(-1, d)
    g_fold = g.transpose(1, 2).reshape(-1, rows)

    def fwd_per_type():
        for l in range(num_types):
            torch.mm(x, w[l], out=out[l])

    def dx_split_k():
        d_x = torch.mm(g[0], w[0].mT)
        for l in range(1, num_types):
            d_x.addmm_(g[l], w[l].mT)
        return d_x

    def dw_per_type():
        for l in range(num_types):
            torch.mm(x.mT, g[l], out=d_kernel[l])

    def dw_per_type_t():
        for l in range(num_types):
            torch.mm(g[l].mT, x, out=d_kernel_t[l])
        return d_kernel_t.transpose(1, 2).contiguous()

    return {
        "forward, fold's product alone": lambda: torch.mm(w_fold, x.mT),
        "forward, fold with its copy": lambda: torch.mm(w_fold, x.mT).view(
            num_types, h, rows).transpose(1, 2).contiguous(),
        "forward, batched at stride 0": lambda: torch.bmm(
            x.expand(num_types, -1, -1), w, out=out),
        "forward, a product a type": fwd_per_type,
        "d_x, fold's product alone": lambda: torch.mm(g_fold.mT, w_fold),
        "d_x, fold with its copy": lambda: torch.mm(
            g.transpose(1, 2).reshape(-1, rows).mT, w_fold),
        "d_x, split-K over types": dx_split_k,
        "d_x, batched, then summed": lambda: torch.bmm(g, w.mT).sum(0),
        "d_kernel, fold's product alone": lambda: torch.mm(g_fold, x),
        "d_kernel, batched at stride 0": lambda: torch.bmm(
            x.mT.expand(num_types, -1, -1), g),
        "d_kernel, a product a type": dw_per_type,
        "d_kernel, a product a type into [L, H, D], transposed":
            dw_per_type_t,
        "d_kernel, batched [L, H, D] at stride 0, transposed": lambda:
            torch.bmm(g.mT, x.expand(num_types, -1, -1)).transpose(
                1, 2).contiguous(),
    }


def _kernels(fn, reps):
    """[(kernel name, device ms a call)] of ``fn``, largest first."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, chip_smoke._self_device_us(e) / reps / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    return sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])


def main() -> int:
    import torch

    import chip_smoke
    from tf2_gnn_tpu_torch.layers.message_passing.typed_linear import (
        TypedLinear,
    )

    device = chip_smoke.require_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    gen = torch.Generator(device=device).manual_seed(chip_smoke.SEED)
    reps = chip_smoke.KERNEL_REPS
    for name, (num_types, rows, d, h) in SHAPES.items():
        x = torch.randn((rows, d), generator=gen, device=device)
        g = torch.randn((num_types, rows, h), generator=gen, device=device)
        layer = TypedLinear(num_types, d, h).to(device)
        with torch.no_grad():
            layer.kernel.normal_(generator=gen).mul_(d ** -0.5)
        w = layer.kernel.detach()
        gflop = 2 * num_types * rows * d * h / 1e9
        print(f"{name}: L={num_types} V={rows} D={d} H={h}, "
              f"{gflop:.1f} GFLOP a product", flush=True)
        for label, fn in _forms(x, w, g).items():
            ms = chip_smoke.time_ms(fn)
            dev = chip_smoke.device_ms(fn)
            print(f"  {label}: {ms:.4f} ms, device {dev} ms", flush=True)

        xg = x.clone().requires_grad_(True)

        def whole(new):
            xg.grad = layer.kernel.grad = None
            y = layer(xg) if new else torch.matmul(xg, layer.kernel)
            y.backward(g)
            return y

        ref = whole(False)
        ref_grads = (xg.grad.clone(), layer.kernel.grad.clone())
        got = whole(True)
        for label, a, b in (("output", got, ref),
                            ("d_x", xg.grad, ref_grads[0]),
                            ("d_kernel", layer.kernel.grad, ref_grads[1])):
            a, b = a.detach(), b.detach()
            err = float((a - b).abs().max() / b.abs().max())
            print(f"  {label}: largest difference {err:.3e} of the largest "
                  f"entry", flush=True)
        for new in (False, True):
            label = "TypedLinear" if new else "torch.matmul"
            ms = chip_smoke.time_ms(lambda: whole(new))
            kernels = _kernels(lambda: whole(new), reps)
            total = sum(k[1] for k in kernels)
            print(f"  forward and backward, {label}: {ms:.4f} ms, device "
                  f"{total:.4f} ms", flush=True)
            for key, kms in kernels:
                print(f"    {kms:.4f} ms  {key[:100]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
