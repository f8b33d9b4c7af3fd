"""Where the recorded LM run's Stiefel residual comes from on a device.

Runs one of the JAX package's recorded runs (``--arch``: smollm-135m's
``tests/data/lm_reference.json`` by default, or a run of
``tests/data/lm_models_reference.json``, through
:func:`repro_torch.launch.train.run_reference`) once per variant.
Each variant moves one stage of the Stiefel path to another
implementation:

  * ``card``: as the trainer runs it;
  * ``plain_project``: every tangent projection by the plain version
    (``ref.stiefel_project_ref``, products on the run's device) instead of
    the ``stiefel_project`` kernel;
  * ``cpu_project``: the tangent projections on the CPU;
  * ``cpu_retract``: the polar retraction on the CPU;
  * ``cpu_init``: the initial projection (QR) on the CPU;
  * ``cpu_stiefel``: the initial projection, the projections and the
    retraction on the CPU;
  * ``cpu``: the whole run on the CPU.

After the initial projection (step 0) and after every step it measures the
largest ``|| x^T x - I ||_F`` over the Stiefel leaves and the nodes in three
ways: on the run's device in fp32 (as the metric takes it), on the CPU in
fp32, and on the CPU in fp64.  The fp64 reading is the iterates' own
feasibility; the fp32 readings add the rounding of the residual's product.

    python -m repro_torch.launch.lm_residual [--variants card,cpu_retract]
        [--arch musicgen-large] [--device cuda]
        [--out chiprun_out/lm_residual.json]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
from pathlib import Path
from unittest import mock

import torch

from repro_torch.geometry import stiefel as st
from repro_torch.kernels import ops, ref
from repro_torch.launch import resolve_device
from repro_torch.launch.train import load_reference, run_reference
from repro_torch.tree import tree_flatten_with_path

VARIANTS = ("card", "plain_project", "cpu_project", "cpu_retract",
            "cpu_init", "cpu_stiefel", "cpu")


def _on_cpu(fn):
    """``fn`` computed on CPU copies of its tensor arguments, the result
    moved back to the first tensor's device."""
    def run(*args, **kw):
        dev = next(a.device for a in args if isinstance(a, torch.Tensor))
        out = fn(*[a.cpu() if isinstance(a, torch.Tensor) else a
                   for a in args], **kw)
        return out.to(dev)
    return run


def _project_leaves(on_cpu: bool):
    def project(xs, gs):
        if on_cpu:
            return [ref.stiefel_project_ref(x.cpu(), g.cpu()).to(x.device)
                    for x, g in zip(xs, gs)]
        return [ref.stiefel_project_ref(x, g) for x, g in zip(xs, gs)]
    return project


def _patches(variant: str) -> list:
    project = (_project_leaves(on_cpu=variant != "plain_project")
               if variant in ("plain_project", "cpu_project", "cpu_stiefel")
               else None)
    retract = variant in ("cpu_retract", "cpu_stiefel")
    init = variant in ("cpu_init", "cpu_stiefel")
    out = []
    if project is not None:
        out.append(mock.patch.object(ops, "stiefel_project_leaves", project))
    if retract:
        out.append(mock.patch.object(st, "retract_polar",
                                     _on_cpu(st.retract_polar)))
    if init:
        qr = _on_cpu(st.retract_qr)
        out.append(mock.patch.object(st.Stiefel, "feasible_init",
                                     lambda self, x: qr(torch.zeros_like(x),
                                                        x)))
    return out


def residuals(problem, x: dict) -> dict:
    """The largest residual over the Stiefel leaves and nodes, measured on
    the leaves' device (fp32), on the CPU (fp32) and on the CPU (fp64), and
    the leaf where the fp64 reading is largest."""
    paths, maps, _ = tree_flatten_with_path(problem.manifold_map)
    leaves = tree_flatten_with_path(x)[1]
    out = {"device_fp32": 0.0, "cpu_fp32": 0.0, "cpu_fp64": 0.0,
           "leaf": None}
    for path, m, xs in zip(paths, maps, leaves):
        if m.name != "stiefel":
            continue
        host = xs.detach().cpu()
        got = {"device_fp32": float(st.stiefel_error(xs).max()),
               "cpu_fp32": float(st.stiefel_error(host).max()),
               "cpu_fp64": float(st.stiefel_error(host.double()).max())}
        if got["cpu_fp64"] > out["cpu_fp64"]:
            out["leaf"] = path
        for k, v in got.items():
            out[k] = max(out[k], v)
    return out


def run_variant(reference: dict, variant: str, device) -> dict:
    dev = resolve_device("cpu" if variant == "cpu" else device)
    trace = []

    def observe(problem, t, state):
        trace.append({"step": t, **residuals(problem, state.x)})

    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for p in _patches(variant):
            stack.enter_context(p)
        res = run_reference(reference, dev, observe=observe)
    return {"variant": variant, "device": str(dev),
            "seconds": time.perf_counter() - t0,
            "final_loss": res["steps"][-1]["loss"],
            "evals": res["evals"], "trace": trace}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reference = load_reference(args.arch)
    want = {e["step"]: e["stiefel_residual"] for e in reference["evals"]}
    runs = []
    for variant in args.variants.split(","):
        if variant not in VARIANTS:
            raise SystemExit(f"unknown variant {variant!r}; one of "
                             f"{VARIANTS}")
        r = run_variant(reference, variant, args.device)
        runs.append(r)
        last = r["trace"][-1]
        print(f"{variant:13s} {r['device']:6s} {r['seconds']:7.1f} s  "
              f"step 0: {r['trace'][0]['device_fp32']:.3e} / "
              f"{r['trace'][0]['cpu_fp32']:.3e} / "
              f"{r['trace'][0]['cpu_fp64']:.3e}  step {last['step']}: "
              f"{last['device_fp32']:.3e} / {last['cpu_fp32']:.3e} / "
              f"{last['cpu_fp64']:.3e} ({last['leaf']})  metric at "
              + ", ".join(f"{e['step']}: {e['stiefel_residual']:.3e} (JAX "
                          f"{want[e['step']]:.3e})" for e in r["evals"]),
              flush=True)
    text = json.dumps({"reference_evals": reference["evals"], "runs": runs})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
