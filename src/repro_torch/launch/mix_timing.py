"""Time one DRGDA step's ring mixes through the stacked backend, the mix
of a (20, 1M) leaf with 1, 3 and 67 hops, the EF-int8 k = 67 step's
all-hop int8 tail (66 hops of x, u and y), the step's tangent projection
of its two Stiefel leaves and the projection at stress shapes, the EF-int8
step's first hop of its four trees with the hats' exact hop, the fused
retraction at the step's two Stiefel leaves and at stress shapes, and the
k = 1, EF-int8 k = 1, Theorem-1 k = 67 and EF-int8 ``quant_hops="all"``
k = 67 steps themselves, on one card; prints the card and one JSON line.

    python -m repro_torch.launch.mix_timing

The paper's 20-node ring at 28x28 images: a k = 1 step mixes x, y, u and v
with one hop, a k = 67 step mixes x, y and u with 67 hops and v with one.
Each mix case has two times: ``*_ms``, the CUDA-event median of its
``StackedBackend.mix`` calls (the host's launch work included, as the
step sees it), and ``*_device_us``, the device time of its kernels under
``torch.profiler`` (``self_device_time_total`` of the CUDA events, per
call).  The steps: host-clock medians of synchronized steps, the two
configurations taken in turns, and the profiler's device time and kernel
count per step.  Every host-clock and CUDA-event time is taken before the
first profiler session.  The script calls only what every version of the
port has (``StackedBackend.mix`` and ``quant_ring_hops``, or
``quant_ring_hops_leaves`` where the port has it; ``ops.stiefel_project``,
or ``ops.stiefel_project_leaves`` where the port has it; ``mix_hop`` plus
``quant_ring_hop`` per leaf plus the add, or ``quant_ring_hop_leaves``
where the port has it; ``ops.fused_retract``, ``launch.fair.prepare``),
so the same file also times an older checkout of the port:

    PYTHONPATH=<checkout>/src python src/repro_torch/launch/mix_timing.py

Compare two versions only within one call on one card, in turns (old, new,
new, old).
"""
from __future__ import annotations

import json
import statistics
import subprocess
import time

import torch

N_NODES, K_THEOREM1 = 20, 67
# node-stacked leaves of x (and u): conv1, conv2, fc1, head
X_LEAVES = [(N_NODES, 8, 1, 3, 3), (N_NODES, 16, 8, 3, 3),
            (N_NODES, 784, 64), (N_NODES, 64, 3)]
Y_LEAF = (N_NODES, 3)


def event_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median milliseconds of ``fn`` from CUDA events, after warm-up."""
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


def step_walls(runs: dict, rounds: int = 4, per_round: int = 5) -> dict:
    """Median microseconds of a synchronized step of each run, the runs
    taken in turns."""
    states = {k: run.state for k, run in runs.items()}
    for k, run in runs.items():
        for _ in range(3):
            states[k], _ = run.opt.step(states[k], run.full)
    walls = {k: [] for k in runs}
    for _ in range(rounds):
        for k, run in runs.items():
            for _ in range(per_round):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                states[k], _ = run.opt.step(states[k], run.full)
                torch.cuda.synchronize()
                walls[k].append((time.perf_counter() - t0) * 1e6)
    return {k: statistics.median(w) for k, w in walls.items()}


def device_us(fn, calls: int = 20) -> tuple[float, float, dict]:
    """(device microseconds, kernels, microseconds by kernel name) per call
    of ``fn`` under the profiler: the CUDA events' self time, summed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in events) / calls,
            sum(e.count for e in events) / calls,
            {e.key[:100]: e.self_device_time_total / calls for e in events})


def main() -> int:
    import dataclasses

    import repro_torch
    from repro_torch.comms.backend import StackedBackend
    from repro_torch.core.gossip import GossipSpec
    from repro_torch.kernels import ops
    from repro_torch.launch.fair import COMM_PRESETS, prepare

    if not torch.cuda.is_available():
        raise SystemExit("mix_timing: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)

    def tree():
        return {f"l{j}": torch.randn(s, generator=gen, device=dev)
                for j, s in enumerate(X_LEAVES)}

    x, u = tree(), tree()
    y, v = (torch.randn(Y_LEAF, generator=gen, device=dev) for _ in range(2))
    big = torch.randn((N_NODES, 1 << 20), generator=gen, device=dev)
    spec, backend = GossipSpec(n_nodes=N_NODES), StackedBackend()

    def quant_tail(t):
        """The all-hop int8 tail of one tree, as the comms engine calls it."""
        leaves = list(t.values()) if isinstance(t, dict) else [t]
        if hasattr(backend, "quant_ring_hops_leaves"):
            return backend.quant_ring_hops_leaves(spec, leaves, K_THEOREM1 - 1)
        return [backend.quant_ring_hops(spec, leaf, K_THEOREM1 - 1)
                for leaf in leaves]

    def stiefel(shape):
        xs = torch.linalg.qr(torch.randn(shape, generator=gen,
                                         device=dev))[0].contiguous()
        return xs, 0.5 * xs + 0.1 * torch.randn(shape, generator=gen,
                                                device=dev)

    fc1, head = stiefel(X_LEAVES[2]), stiefel(X_LEAVES[3])
    stress = {r: stiefel((N_NODES, 4096 if r > 37 else 1000, r))
              for r in (37, 99, 256)}

    def project_step():
        """The step's projection of fc1 and head, as the optimizer calls
        it."""
        if hasattr(ops, "stiefel_project_leaves"):
            return ops.stiefel_project_leaves([fc1[0], head[0]],
                                              [fc1[1], head[1]])
        return [ops.stiefel_project(*fc1), ops.stiefel_project(*head)]

    from repro_torch.comms.compress import quantize_det
    wc = spec.self_weight
    ws = (1.0 - wc) / 2.0

    def wire(t):
        leaves = list(t.values()) if isinstance(t, dict) else [t]
        out = []
        for leaf in leaves:
            q, sc = quantize_det(leaf)
            out.append((q.reshape(N_NODES, -1), sc.reshape(N_NODES, 1)))
        return out

    hat_trees = [tree(), tree(), torch.randn(Y_LEAF, generator=gen, device=dev),
                 torch.randn(Y_LEAF, generator=gen, device=dev)]
    wires = [wire(t) for t in (x, u, y, v)]

    def first_hop():
        """The EF-int8 step's first hop of its four trees with the old
        hats' exact hop, as the comms engine makes it."""
        out = []
        for hat, w in zip(hat_trees, wires):
            hs = list(hat.values()) if isinstance(hat, dict) else [hat]
            base = [h.reshape(N_NODES, -1) for h in hs]
            if hasattr(backend, "quant_ring_hop_leaves"):
                out.append(backend.quant_ring_hop_leaves(
                    spec, [q for q, _ in w], [sc for _, sc in w], base))
            else:
                mixed = backend.mix_hop(spec, base)
                out.append([m + backend.quant_ring_hop(spec, q, sc)
                            for m, (q, sc) in zip(mixed, w)])
        return out

    cases = {
        "project_step": project_step,
        **{f"project_r{r}": (lambda r=r: ops.stiefel_project(*stress[r]))
           for r in stress},
        "first_hop_ef": first_hop,
        "quant_tail_k67": lambda: [quant_tail(t) for t in (x, u, y)],
        "retract_step": lambda: [ops.fused_retract(*fc1),
                                 ops.fused_retract(*head)],
        **{f"retract_r{r}": (lambda r=r: ops.fused_retract(*stress[r]))
           for r in stress},
        "mix_k1": lambda: [backend.mix(spec, t, 1) for t in (x, y, u, v)],
        "mix_k67": lambda: ([backend.mix(spec, t, K_THEOREM1)
                             for t in (x, y, u)]
                            + [backend.mix(spec, v, 1)]),
        "big_k1": lambda: backend.mix(spec, big, 1),
        "big_k3": lambda: backend.mix(spec, big, 3),
        "big_k67": lambda: backend.mix(spec, big, K_THEOREM1),
    }
    out = {"port": str(repro_torch.__file__)}
    for name, fn in cases.items():
        out[f"{name}_ms"] = event_ms(fn)
    int8_all = dataclasses.replace(COMM_PRESETS["int8_ef"], quant_hops="all")
    runs = {f"k{k}": prepare("drgda", True, image_hw=28, n_nodes=N_NODES,
                             k_steps=k, device=dev) for k in (1, K_THEOREM1)}
    runs["int8_k1"] = prepare("drgda", True, image_hw=28, n_nodes=N_NODES,
                              k_steps=1, device=dev,
                              comm=COMM_PRESETS["int8_ef"])
    runs[f"int8_all_k{K_THEOREM1}"] = prepare(
        "drgda", True, image_hw=28, n_nodes=N_NODES, k_steps=K_THEOREM1,
        device=dev, comm=int8_all)
    walls = step_walls(runs)
    for name, fn in cases.items():
        total, _, by_kernel = device_us(fn)
        out[f"{name}_device_us"] = total
        if name.startswith(("retract", "quant", "project", "first")):
            out[f"{name}_by_kernel_us"] = by_kernel
    for k, run in runs.items():
        state = run.state

        def step():
            nonlocal state
            state, _ = run.opt.step(state, run.full)

        out[f"step_{k}_us"] = walls[k]
        out[f"step_{k}_device_us"], out[f"step_{k}_kernels"], _ = \
            device_us(step, calls=5)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
