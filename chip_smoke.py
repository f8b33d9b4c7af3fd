#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and turns TF32 off for matmuls and cuDNN.
2. Builds the four CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, in parallel) and prints the build time.
3. Kernel phase: every kernel against its plain PyTorch version on the card,
   at the shapes one main-path step gives it and at stress shapes, with its
   gate: bitwise for the ring mixes, <= 5e-5 absolute for fused_retract,
   <= 1e-5 relative for stiefel_project.  Times from CUDA events (median
   after warm-up) beside the least time the card could take, and for the
   ring mixes beside one ``torch.matmul`` by W^k (the library call that
   computes the same function, up to rounding).  An fp64 operand must
   raise, not fall back.
4. Main path: DRGDA (full batch, polar_fused) and DRSGDA (minibatch) through
   ``repro_torch.launch.fair.run_method`` on the paper's 20-node ring with
   k = 1 and 28x28 images, 30 steps each, then DRGDA at the Theorem-1
   k = 67 for 5 steps; losses finite, Stiefel residual <= 1e-4, every
   kernel launched.  Then a profile of the DRGDA k = 1 step (wall time,
   device time and busy share, the kernels that take the most), and a
   small DRGDA run on the card against the same run on the CPU (plain
   versions).
5. Prints the kernel table as one JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises, and the script exits non-zero without the last
line.  It needs a CUDA device and the repository's ``src/`` beside it.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published peaks of one H100 SXM (NVIDIA data sheet): fp32 on CUDA cores
# and HBM3 bandwidth.  bound_ms = max(flops / PEAK_FLOPS, bytes / PEAK_BYTES).
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12

KERNEL_META = {
    "stiefel_project": ("src/repro_torch/kernels/csrc/stiefel_project.cu",
                        "src/repro/kernels/stiefel_project.py:59"),
    "fused_retract": ("src/repro_torch/kernels/csrc/retract.cu",
                      "src/repro/kernels/retract.py:119"),
    "ring_mix": ("src/repro_torch/kernels/csrc/ring_mix.cu",
                 "src/repro/kernels/ring_mix.py:36"),
    "multi_hop_mix": ("src/repro_torch/kernels/csrc/multi_hop_mix.cu",
                      "src/repro/kernels/multi_hop_mix.py:117"),
}

# Main-path geometry: 20 nodes, 28x28x1 images, init_cnn's widths.
N_NODES = 20
K_THEOREM1 = 67
# node-stacked leaves of x (port layout: conv kernels OIHW) and of y
X_LEAVES = [(N_NODES, 8, 1, 3, 3), (N_NODES, 16, 8, 3, 3),
            (N_NODES, 784, 64), (N_NODES, 64, 3)]
Y_LEAF = (N_NODES, 3)
STIEFEL_LEAVES = [(N_NODES, 784, 64), (N_NODES, 64, 3)]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, reps: int = 15, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` from CUDA events, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------


def _stiefel_inputs(shape, gen, device):
    import torch
    x = torch.linalg.qr(torch.randn(shape, generator=gen, device=device))[0]
    # an update direction of the optimizer's size: alpha*[Wx]_i - beta*u
    g = 0.5 * x + 0.1 * torch.randn(shape, generator=gen, device=device)
    return x, g


def _project_cost(shape):
    b = math.prod(shape[:-2])
    d, r = shape[-2:]
    return b * (4 * d * r * r + d * r), 3 * b * d * r * 4


def _retract_cost(shape, ns_iters=20):
    b = math.prod(shape[:-2])
    d, r = shape[-2:]
    return (b * (8 * d * r * r + (6 + 6 * ns_iters) * r ** 3),
            3 * b * d * r * 4)


def _mix_cost(shape, hops):
    n = math.prod(shape)
    return 4 * n * hops, 2 * n * 4


def kernel_phase(device="cuda") -> dict:
    """Each kernel against its plain version; returns the table rows."""
    import numpy as np
    import torch
    from repro_torch.core.gossip import ring_matrix
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=device).manual_seed(0)
    wc = 1.0 / 3.0
    ws = (1.0 - wc) / 2.0
    rows = {}

    def run_case(name, calls, plain_calls, gate, costs, label,
                 library_calls=None):
        """calls/plain_calls/library_calls: lists of thunks over the same
        inputs; library_calls, where given, are one PyTorch call each that
        computes the same function up to rounding."""
        outs = [c() for c in calls]
        torch.cuda.synchronize()
        want = [p() for p in plain_calls]
        err = max(float((a - b).abs().max()) for a, b in zip(outs, want))
        scale = max(float(b.abs().max()) for b in want)
        ok, gate_txt = gate(outs, want, err, scale)
        ms = time_ms(lambda: [c() for c in calls])
        plain_ms = time_ms(lambda: [p() for p in plain_calls])
        library_ms, lib_txt = None, ""
        if library_calls is not None:
            lib_err = max(float((lc() - b).abs().max())
                          for lc, b in zip(library_calls, want))
            # the library call rounds in another order (one product by
            # W^k against k rounded hops): it only has to compute the same
            # function, which 1e-4 relative shows
            if lib_err > 1e-4 * scale:
                raise AssertionError(f"{name} {label}: the library call "
                                     f"differs by {lib_err:.3e}")
            library_ms = time_ms(lambda: [lc() for lc in library_calls])
            lib_txt = f" library={library_ms:.4f} ms (err {lib_err:.1e})"
        flops = sum(c[0] for c in costs)
        nbytes = sum(c[1] for c in costs)
        b_ms, b_by = bound(flops, nbytes)
        log(f"  {name:16s} {label:34s} max_abs_err={err:.3e} "
            f"({gate_txt}) kernel={ms:.4f} ms plain={plain_ms:.4f} ms"
            f"{lib_txt} bound={b_ms:.5f} ms ({b_by})")
        if not ok:
            raise AssertionError(f"{name} {label}: outside its gate "
                                 f"({gate_txt}), max_abs_err={err:.3e}")
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}

    def bitwise(outs, want, err, scale):
        return all(torch.equal(a, b) for a, b in zip(outs, want)), "bitwise"

    def absolute(tol):
        return lambda outs, want, err, scale: (err <= tol, f"<= {tol:g} abs")

    def relative(tol):
        return lambda outs, want, err, scale: (err <= tol * scale,
                                               f"<= {tol:g} rel")

    # -- stiefel_project and fused_retract ---------------------------------
    for name, op, plain, gate, cost in (
            ("stiefel_project", ops.stiefel_project, ref.stiefel_project_ref,
             relative(1e-5), _project_cost),
            ("fused_retract", ops.fused_retract, ref.fused_retract_ref,
             absolute(5e-5), _retract_cost)):
        pairs = [_stiefel_inputs(s, gen, device) for s in STIEFEL_LEAVES]
        rows[name] = run_case(
            name, [lambda a=a, b=b: op(a, b) for a, b in pairs],
            [lambda a=a, b=b: plain(a, b) for a, b in pairs], gate,
            [cost(s) for s in STIEFEL_LEAVES],
            "main step (20,784,64)+(20,64,3)")
        for shape in ((N_NODES, 4096, 256), (N_NODES, 1000, 37)):
            a, b = _stiefel_inputs(shape, gen, device)
            run_case(name, [lambda: op(a, b)], [lambda: plain(a, b)], gate,
                     [cost(shape)], f"stress {shape}")

    # -- the library call of the ring mixes: W^k x as one fp32 GEMM, with
    # W^k taken in float64 and cast, as the dense mix path does it
    w_ring = ring_matrix(N_NODES, wc)

    def library(xs, k):
        wk = torch.as_tensor(np.linalg.matrix_power(w_ring, k),
                             dtype=torch.float32, device=device)
        return [lambda x=x: torch.matmul(wk, x.view(N_NODES, -1)
                                         ).view(x.shape) for x in xs]

    # -- ring_mix: one step mixes x, u (4 leaves each), y and v ------------
    leaves = X_LEAVES * 2 + [Y_LEAF] * 2
    xs = [torch.randn(s, generator=gen, device=device) for s in leaves]
    rows["ring_mix"] = run_case(
        "ring_mix", [lambda x=x: ops.ring_mix(x, w_self=wc, w_side=ws)
                     for x in xs],
        [lambda x=x: ref.ring_mix_ref(x, x.roll(1, 0), x.roll(-1, 0), wc, ws)
         for x in xs], bitwise, [_mix_cost(s, 1) for s in leaves],
        "main step 10 leaves", library(xs, 1))
    big = torch.randn((N_NODES, 1 << 20), generator=gen, device=device)
    run_case("ring_mix", [lambda: ops.ring_mix(big, w_self=wc, w_side=ws)],
             [lambda: ref.ring_mix_ref(big, big.roll(1, 0), big.roll(-1, 0),
                                       wc, ws)],
             bitwise, [_mix_cost(big.shape, 1)], "stress (20, 1M)",
             library([big], 1))

    # -- multi_hop_mix: the k = 67 step mixes x, y and u with W^k ----------
    def hops_plain(x, k):
        z = x
        for _ in range(k):
            z = ref.ring_mix_ref(z, z.roll(1, 0), z.roll(-1, 0), wc, ws)
        return z

    leaves = X_LEAVES * 2 + [Y_LEAF]
    xs = [torch.randn(s, generator=gen, device=device) for s in leaves]
    rows["multi_hop_mix"] = run_case(
        "multi_hop_mix",
        [lambda x=x: ops.multi_hop_mix(x, hops=K_THEOREM1, w_self=wc,
                                       w_side=ws) for x in xs],
        [lambda x=x: hops_plain(x, K_THEOREM1) for x in xs], bitwise,
        [_mix_cost(s, K_THEOREM1) for s in leaves],
        f"main step k={K_THEOREM1}, 9 leaves", library(xs, K_THEOREM1))
    for k in (1, 3, K_THEOREM1):
        run_case("multi_hop_mix",
                 [lambda k=k: ops.multi_hop_mix(big, hops=k, w_self=wc,
                                                w_side=ws)],
                 [lambda k=k: hops_plain(big, k)], bitwise,
                 [_mix_cost(big.shape, k)], f"stress (20, 1M) k={k}",
                 library([big], k))
    # the halo-panel oracle of the JAX package's interface, on the wrapped
    # panel: the same numbers as k repeated hops
    small = big[:, :4096]
    panel = ref.multi_hop_mix_ref(ref.ring_panel(small, K_THEOREM1),
                                  hops=K_THEOREM1, out_rows=N_NODES,
                                  halo=K_THEOREM1, w_self=wc, w_side=ws)
    if not torch.equal(panel, ops.multi_hop_mix(small, hops=K_THEOREM1,
                                                w_self=wc, w_side=ws)):
        raise AssertionError("multi_hop_mix differs from the panel oracle")
    log("  multi_hop_mix    bitwise equal to the halo-panel oracle (k=67)")

    # -- a CUDA operand the kernel does not take raises --------------------
    for call in (lambda: ops.ring_mix(big.double(), w_self=wc, w_side=ws),
                 lambda: ops.fused_retract(*(t.double() for t in pairs[0]))):
        try:
            call()
        except TypeError as exc:
            log(f"  fp64 operand raises: {exc}")
        else:
            raise AssertionError("an fp64 CUDA operand did not raise")
    torch.cuda.synchronize()
    return rows


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------


def main_path_phase() -> dict:
    """The port's main path through its entry point; returns the launch
    counts of all its runs."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.fair import run_method

    runs = (("drgda", 30, True, 1), ("drsgda", 30, False, 1),
            ("drgda", 5, True, K_THEOREM1))
    ops.reset_launch_counts()
    for name, steps, det, k in runs:
        before = ops.launch_counts()
        res = run_method(name, steps, det, image_hw=28, n_nodes=N_NODES,
                         k_steps=k, retraction="polar_fused",
                         eval_every=10, device="cuda")
        torch.cuda.synchronize()
        after = ops.launch_counts()
        last = res["curve"][-1]
        log(f"  {name:7s} k={k:<3d} steps={steps:<3d} "
            f"final loss={last['loss']:.6f} M_t={last['M_t']:.6f} "
            f"stiefel_residual={last['stiefel_residual']:.3e} "
            f"us_per_step={res['us_per_step']:.1f} "
            f"launches={ {n: after[n] - before[n] for n in after} }")
        for point in res["curve"]:
            if not all(math.isfinite(point[key]) for key in
                       ("loss", "M_t", "consensus_x", "stiefel_residual")):
                raise AssertionError(f"{name} k={k}: non-finite {point}")
            if point["stiefel_residual"] > 1e-4:
                raise AssertionError(f"{name} k={k}: Stiefel residual "
                                     f"{point['stiefel_residual']:.3e}")
    counts = ops.launch_counts()
    missing = [n for n, c in counts.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    return counts


OWN_KERNELS = ("gram_partial_kernel", "sym_reduce_kernel", "apply_kernel",
               "finalize_kernel", "ring_mix_kernel", "ring_hops_kernel")


def profile_phase(steps: int = 5) -> None:
    """Where a DRGDA k=1 main-path step spends its time: the step's wall
    time without the profiler, the device time of its kernels under
    ``torch.profiler``, and the kernels that take the most."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.fair import prepare

    run = prepare("drgda", True, image_hw=28, n_nodes=N_NODES, k_steps=1,
                  device="cuda")
    state = run.state
    for _ in range(3):
        state, _ = run.opt.step(state, run.full)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = run.opt.step(state, run.full)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) / steps * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, _ = run.opt.step(state, run.full)
        torch.cuda.synchronize()
    # device-side events only: a CPU op's self device time repeats the
    # time of the kernels it launched
    kernels = [(e.self_device_time_total / steps, e.count / steps, e.key)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    kernels.sort(reverse=True)
    device_us = sum(k[0] for k in kernels)
    launches = sum(k[1] for k in kernels)
    own_us = sum(k[0] for k in kernels
                 if any(name in k[2] for name in OWN_KERNELS))
    log(f"  drgda k=1 step: {wall_us:.1f} us wall without the profiler; "
        f"{device_us:.1f} us of device time in {launches:.0f} kernels "
        f"(device busy {100 * device_us / wall_us:.1f}% of the wall); "
        f"the port's CUDA kernels {own_us:.1f} us")
    for us, count, key in kernels[:12]:
        log(f"    {us:9.1f} us/step  x{count:4.0f}  {key[:100]}")


def agreement_phase() -> None:
    """A small DRGDA run on the card (kernels) against the same run on the
    CPU (plain versions): per-step loss and final M_t."""
    from repro_torch.launch.fair import run_method

    kw = dict(image_hw=8, n_nodes=6, k_steps=3, eval_every=5)
    gpu = run_method("drgda", 10, True, device="cuda", **kw)
    cpu = run_method("drgda", 10, True, device="cpu", **kw)
    for a, b in zip(gpu["curve"], cpu["curve"]):
        for key in ("loss", "M_t"):
            if abs(a[key] - b[key]) > 1e-4 * max(1.0, abs(b[key])):
                raise AssertionError(f"card vs CPU at step {a['step']}: "
                                     f"{key} {a[key]} vs {b[key]}")
    log(f"  card vs CPU (n=6, 8x8, k=3, 10 steps): final M_t "
        f"{gpu['final_M_t']:.6f} vs {cpu['final_M_t']:.6f}, "
        f"loss {gpu['final_loss']:.6f} vs {cpu['final_loss']:.6f}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32: torch.backends.cuda.matmul.allow_tf32=False, "
        "torch.backends.cudnn.allow_tf32=False")

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    per = build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s wall "
        f"({', '.join(f'{n} {s:.1f} s' for n, s in per.items())})")

    log("kernel phase:")
    rows = kernel_phase()
    log("main path:")
    counts = main_path_phase()
    log("profile:")
    profile_phase()
    log("agreement:")
    agreement_phase()

    table = []
    for name, (source, replaces) in KERNEL_META.items():
        row = rows[name]
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": counts[name],
                      "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                      "plain_ms": row["plain_ms"],
                      "bound_ms": row["bound_ms"],
                      "bound_by": row["bound_by"],
                      "library_ms": row["library_ms"]})
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
