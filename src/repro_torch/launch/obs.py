"""Telemetry on the main path: overhead, bit-identity, counters, estimates.

The port's counterpart of ``benchmarks/obs.py``.  The 20-node DRGDA fair
step at full width (28x28 images, ``"polar_fused"``, k = 1, as
``launch/fair.py`` ``prepare`` builds it; ``--comm int8_ef`` for EF-int8
gossip) runs three ways:

* **off** -- ``telemetry=None``;
* **on** -- counters threaded through the state, flushed to the event log
  at every ``flush_every``-th step;
* **phases** -- the step's compute (per-node loss and Riemannian
  gradients), retract, mix (slot x's mix through the run's gossip: the
  exact ``W^k``, or the engine's compressed round) and metric (M_t)
  parts, each timed alone.

Off and on run in interleaved blocks of ``flush_every`` steps from the
same initial state, so every on block pays one flush; a block's time is
the host clock around its steps, ended by a synchronize, over its steps,
and the minimum over blocks is kept (the median beside it).  The step is
host-bound and the blocks spread by more than telemetry's cost, so the
counters' own host work is also timed alone: the step's four
``account_mix`` calls over 200 steps, ended by a synchronize, and a
flush, amortized over ``flush_every`` steps.  The final states are
compared after one more block of each under
``torch.backends.cudnn.deterministic``: under
cuDNN's default algorithms the weight-gradient convolutions sum in
another order on every run, and two runs of the same program differ
(``launch/figure_cudnn.py``).  A phase's time is CUDA events
around 20 back-to-back calls, over 20 (the host clock with ``--device
cpu``).  Reported: the overhead of on against off; whether the two final
states are bitwise equal; the counters' bytes per hop against the
backend's ``est_hop_bytes`` (raw bytes; and the wire bytes against
``CommEngine.wire_round_bytes`` under compression); whether a step that
does not flush runs under ``torch.cuda.set_sync_debug_mode("error")``
without raising, with telemetry off and on; the events validated; and
the analytical estimates of one step, per kernel, placed on the H100
roofline.

    python -m repro_torch.launch.obs                  # on the card
    python -m repro_torch.launch.obs --comm int8_ef
    python -m repro_torch.launch.obs --device cpu --image-hw 8 --n-nodes 4 \
        --repeats 2 --flush-every 5                   # a rehearsal

prints one JSON object.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import tempfile
import time

import torch

from repro_torch.comms.layer import make_mixer
from repro_torch.core.gda import _vmapped_loss_and_rgrads
from repro_torch.core.metric import convergence_metric
from repro_torch.launch import fair, roofline, synchronize
from repro_torch.obs import Telemetry, unpack
from repro_torch.obs import estimates as obs_est
from repro_torch.obs import events as obs_events
from repro_torch.obs import wire as obs_wire
from repro_torch.tree import tree_flatten_with_path, tree_map

FLUSH_EVERY = 50      # the Telemetry default; one flush per timed block
REPEATS = 14
PHASE_CALLS = 20
ACCOUNT_STEPS = 200
FLUSHES = 10
#: the roofline each kernel's operations run on: fp32 products as 3xTF32
#: on the tensor cores, elementwise work on the fp32 CUDA cores
KERNEL_HW = {"stiefel_project": "h100_tf32x3", "fused_retract": "h100_tf32x3",
             "flash_attention": "h100_tf32x3"}


def _prepare(device, image_hw, n_nodes, comm, telemetry=None) -> fair.Run:
    return fair.prepare("drgda", True, image_hw=image_hw, n_nodes=n_nodes,
                        k_steps=1, retraction="polar_fused", device=device,
                        comm=comm, telemetry=telemetry)


def _block(step, state0, batch, steps, dev) -> tuple[object, float]:
    """``steps`` calls from ``state0``; (final state, seconds a step)."""
    state = state0
    synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = step(state, batch)
    synchronize(dev)
    return state, (time.perf_counter() - t0) / steps


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms inside the block: the setting under
    which a run on the card repeats bit for bit."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def state_tensors(state) -> list:
    """Every tensor of an optimizer state but its counters, in flatten
    order."""
    return [leaf for leaf in tree_flatten_with_path(
        dataclasses.replace(state, obs=None))[1] if torch.is_tensor(leaf)]


def bitwise_equal(a, b) -> bool:
    ta, tb = state_tensors(a), state_tensors(b)
    return len(ta) == len(tb) and all(torch.equal(x, y)
                                      for x, y in zip(ta, tb))


def no_sync(run: fair.Run, state) -> bool:
    """True when one step of ``run`` from ``state`` (one that does not
    flush) runs without a host sync (``torch.cuda.set_sync_debug_mode(
    "error")`` raises on any)."""
    tel = run.opt.telemetry
    if tel is not None and (state.step + 1) % tel.flush_every == 0:
        raise ValueError(f"no_sync: step {state.step + 1} flushes")
    if run.device.type != "cuda":
        return True
    synchronize(run.device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        run.opt.step(state, run.full)
        ok = True
    except RuntimeError:
        ok = False
    finally:
        torch.cuda.set_sync_debug_mode("default")
    synchronize(run.device)
    return ok


def hop_bytes(run: fair.Run, counters) -> dict:
    """The counters' bytes per hop against the oracles: the hop-weighted
    mean of ``est_hop_bytes`` over DRGDA's slots (x, y, u with k hops, v
    with 1) for the raw bytes, and under compression the wire bytes
    against ``wire_round_bytes``."""
    opt, st = run.opt, run.state
    obs = unpack(counters)
    slots = ((st.x, opt.k), (st.y, opt.k), (st.u, opt.k), (st.v, 1))
    hops = sum(h for _, h in slots)
    rounds = obs.rounds / len(slots)
    expect = sum(opt.backend.est_hop_bytes(opt.gossip, t) * h
                 for t, h in slots) / hops
    out = {"counters": obs.as_dict(),
           "raw_bytes_per_hop": obs.raw_bytes / obs.hops,
           "est_hop_bytes": expect,
           "raw_rel_err": abs(obs.raw_bytes / obs.hops - expect) / expect}
    wire = (sum(opt.engine.wire_round_bytes(t, h)[0] for t, h in slots)
            if opt.engine is not None else expect * hops)
    out["wire_bytes_per_hop"] = obs.wire_bytes / obs.hops
    out["wire_bytes_per_hop_expected"] = wire / hops
    out["wire_rel_err"] = abs(obs.wire_bytes - rounds * wire) / (rounds
                                                                   * wire)
    return out


def counter_cost(run: fair.Run, steps: int = ACCOUNT_STEPS,
                 flushes: int = FLUSHES) -> dict:
    """Host microseconds of a step's counter work alone, on a run with
    telemetry: the step's four ``account_mix`` calls (x, y, u with k hops,
    v with 1; their device draws too under a drawing engine) over
    ``steps`` steps, ended by a synchronize; a flush (a counter event
    written to a log of its own), over ``flushes``; and the sum per step at
    the run's cadence."""
    opt, st = run.opt, run.state
    tel = opt.telemetry
    slots = (("x", st.x, opt.k), ("y", st.y, opt.k), ("u", st.u, opt.k),
             ("v", st.v, 1))
    c = st.obs
    synchronize(run.device)
    t0 = time.perf_counter()
    for _ in range(steps):
        for slot, tree, hops in slots:
            c = obs_wire.account_mix(c, opt.gossip, opt.engine, opt.backend,
                                     st.comm, slot, tree, hops, st.step)
    synchronize(run.device)
    account_us = (time.perf_counter() - t0) * 1e6 / steps
    sink = Telemetry(run=f"{tel.run}-cost", out_dir=tel.out_dir,
                     flush_every=tel.flush_every)
    t0 = time.perf_counter()
    for _ in range(flushes):
        sink.flush_counters(c, tel.flush_every)
    flush_us = (time.perf_counter() - t0) * 1e6 / flushes
    return {"account_us_per_step": account_us, "flush_us": flush_us,
            "us_per_step": account_us + flush_us / tel.flush_every}


def step_estimates(run: fair.Run) -> dict:
    """Per-kernel estimates of one step (from the run's initial state),
    each placed on its roofline."""
    with obs_est.collect() as c:
        run.opt.step(run.state, run.full)
    synchronize(run.device)
    out = {}
    for name, rec in c.snapshot().items():
        est = obs_est.Estimates(rec["ops"], rec["lds"], rec["mem"])
        hw = roofline.get_hardware(KERNEL_HW.get(name, "h100"))
        out[name] = {**rec, "roofline": roofline.place(est, hw)}
    return out


def _timed(fn, dev, calls: int = PHASE_CALLS) -> float:
    """Microseconds a call of ``fn`` over ``calls`` back-to-back calls:
    CUDA events on the card, the host clock on the CPU."""
    fn()
    synchronize(dev)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3 / calls
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) * 1e6 / calls


@torch.no_grad()
def phase_breakdown(run: fair.Run) -> dict:
    """compute / retract / mix / metric, each alone (the split of
    ``benchmarks/obs.py``); mix is slot x's, through the run's gossip."""
    opt, st, prob = run.opt, run.state, run.problem
    h = opt.hyper

    def retract():
        return tree_map(lambda m, x, u: m.retract(
            x, -h.beta * u, m.resolve_retraction(h.retraction)),
            prob.manifold_map, st.x, st.u)

    phases = {
        "compute": lambda: _vmapped_loss_and_rgrads(prob, st.x, st.y,
                                                    run.full),
        "retract": retract,
        "mix": lambda: make_mixer(opt.gossip, opt.engine, st.comm,
                                  st.step)[0]("x", st.x, opt.k),
        "metric": lambda: convergence_metric(prob, st.x, st.y,
                                             run.full)["M_t"],
    }
    us = {name: _timed(fn, run.device) for name, fn in phases.items()}
    total = sum(us.values())
    return {"us_per_call": us,
            "fraction": {k: v / total for k, v in us.items()}}


def run(device="cuda", image_hw: int = 28, n_nodes: int = 20, comm=None,
        flush_every: int = FLUSH_EVERY, repeats: int = REPEATS,
        out_dir: str | None = None) -> dict:
    out_dir = out_dir or tempfile.mkdtemp(prefix="obs_")
    tel = Telemetry(run="obs", out_dir=out_dir, flush_every=flush_every)
    r_off = _prepare(device, image_hw, n_nodes, comm)
    r_on = _prepare(device, image_hw, n_nodes, comm, telemetry=tel)
    dev, batch = r_off.device, r_off.full
    # both arms start from one state (the init's gradients come from
    # cuDNN's default algorithms, which differ from run to run)
    s0_off = r_off.state
    s0_on = dataclasses.replace(s0_off, obs=r_on.state.obs)
    step_off, step_on = r_off.opt.step, r_on.opt.step
    # warm-up: builds the kernels
    s_off, _ = _block(step_off, s0_off, batch, 2, dev)
    s_on, _ = _block(step_on, s0_on, batch, 2, dev)
    sync_free = {"off": no_sync(r_off, s_off), "on": no_sync(r_on, s_on)}
    # a block of flush_every steps from step 0 flushes once, at its end
    t_off, t_on = [], []
    for _ in range(repeats):
        _, dt = _block(step_off, s0_off, batch, flush_every, dev)
        t_off.append(dt)
        state_on, dt = _block(step_on, s0_on, batch, flush_every, dev)
        t_on.append(dt)
    dt_off, dt_on = min(t_off), min(t_on)
    med_off, med_on = statistics.median(t_off), statistics.median(t_on)
    with deterministic_cudnn():
        same_off, _ = _block(step_off, s0_off, batch, flush_every, dev)
        same_on, _ = _block(step_on, s0_on, batch, flush_every, dev)
    cost = counter_cost(r_on)
    paths = tel.export()
    return {
        "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "n_nodes": n_nodes, "image_hw": image_hw, "k": r_off.opt.k,
        "comm": dataclasses.asdict(comm) if comm is not None else None,
        "flush_every": flush_every, "repeats": repeats,
        "us_per_step_off": dt_off * 1e6, "us_per_step_on": dt_on * 1e6,
        "us_per_step_off_all": [t * 1e6 for t in t_off],
        "us_per_step_on_all": [t * 1e6 for t in t_on],
        "overhead_pct": (dt_on - dt_off) / dt_off * 100.0,
        "overhead_median_pct": (med_on - med_off) / med_off * 100.0,
        "counter_cost": cost,
        "counter_cost_pct": cost["us_per_step"] / (dt_off * 1e6) * 100.0,
        "bit_identical": bitwise_equal(same_on, same_off),
        "sync_free_step": sync_free,
        **hop_bytes(r_on, state_on.obs),
        "n_events": obs_events.validate_log(tel.events_path),
        "phase_breakdown": phase_breakdown(r_off),
        "kernel_estimates": step_estimates(r_off),
        "artifacts": paths,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--image-hw", type=int, default=28)
    ap.add_argument("--n-nodes", type=int, default=20)
    ap.add_argument("--comm", choices=sorted(fair.COMM_PRESETS),
                    default="full")
    ap.add_argument("--flush-every", type=int, default=FLUSH_EVERY)
    ap.add_argument("--repeats", type=int, default=REPEATS)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device, args.image_hw, args.n_nodes,
                         fair.COMM_PRESETS[args.comm], args.flush_every,
                         args.repeats), indent=1))


if __name__ == "__main__":
    main()
