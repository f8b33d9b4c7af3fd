"""Elastic gossip: convergence under membership churn and stale hops.

The port's counterpart of ``benchmarks/elastic.py``: DRGDA on an 8-node
ring (k = 1) under six schedules (:data:`SCHEDULES`: no elastic engine,
one node leaving and rejoining, seeded random churn at 5% and 20%, 30%
stragglers at stale-hop tolerance 0 and 2) on two problems:

* fair classification (:func:`run_fair`): the CNN with Stiefel
  ``fc1``/``head``, 14x14 images, 32 per node, 4 batches as each node's
  full dataset, ``GDAHyper(alpha=0.5, beta=0.05, eta=0.2)`` (retraction
  ``"polar"``), 60 steps, M_t after the first step and every 10th;
* robust PCA (:func:`run_pca`): Gr(20, 3), 24 samples a node with 10%
  outliers at scale 1.5, ``GDAHyper(alpha=0.5, beta=0.1, eta=0.3)``, 200
  steps, M_t after the first step and every 25th.

Each curve point carries the live-node count (``live``) and, in elastic
mode, the membership mask (``active``).  :func:`run` adds the acceptance
check of the benchmark: the scripted leave-then-rejoin run of fair
classification stays finite and ends within 2x of the static ring's M_t.

The JAX package draws its churn and stragglers with ``jax.random``, which
no torch generator reproduces.  ``tests/data/elastic_reference.json``
(``tests/_reference_curves.py elastic``) records the JAX package's run:
the initial CNN weights, the robust-PCA data and start, every curve, the
uniforms behind every churn and straggler draw, and a gate for each curve
point.  :class:`RecordedDraws` replays those uniforms, so
:func:`run_reference` realizes the same membership as the reference run.
:func:`run_full_width` runs the leave-and-rejoin scenario at the main
path's configuration (20-node ring, 28x28 images, ``"polar_fused"``, 30
steps; node 3 leaves at step 10 and rejoins at step 20) beside the static
ring.

    python -m repro_torch.launch.elastic                 # on the card
    python -m repro_torch.launch.elastic --device cpu
    python -m repro_torch.launch.elastic --full-width
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.comms.elastic import ChurnSchedule, ElasticSpec
from repro_torch.core.gda import DRGDA, GDAHyper, broadcast_to_nodes
from repro_torch.core.gossip import GossipSpec
from repro_torch.core.metric import convergence_metric
from repro_torch.geometry import GRASSMANN
from repro_torch.kernels import ops
from repro_torch.launch import fair, resolve_device, synchronize
from repro_torch.objectives import robust_pca as rp

N = 8
PROBLEMS = ("fair_classification", "robust_pca")
SCHEDULES: dict[str, ElasticSpec | None] = {
    # no elastic engine at all: the exact main-path program
    "static": None,
    # the acceptance scenario: one node leaves, later rejoins
    "leave_rejoin": ElasticSpec(churn=ChurnSchedule(
        kind="scripted", events=((10, "leave", 3), (30, "join", 3)))),
    # sustained seeded churn at two rates
    "random_5pct": ElasticSpec(churn=ChurnSchedule(
        kind="random", leave_rate=0.05, join_rate=0.5)),
    "random_20pct": ElasticSpec(churn=ChurnSchedule(
        kind="random", leave_rate=0.20, join_rate=0.5)),
    # stragglers without and with stale-hop tolerance
    "straggle_tau0": ElasticSpec(tau=0, straggler_rate=0.3),
    "straggle_tau2": ElasticSpec(tau=2, straggler_rate=0.3),
}
FAIR = dict(steps=60, seed=0, image_hw=14, eval_every=10,
            hyper=GDAHyper(alpha=0.5, beta=0.05, eta=0.2))
PCA = dict(steps=200, seed=1, x0_seed=0, d=20, r=3, m=24, rho=0.5,
           outlier_frac=0.1, outlier_scale=1.5, eval_every=25,
           hyper=GDAHyper(alpha=0.5, beta=0.1, eta=0.3))
#: leave-and-rejoin at the main path's configuration
FULL_WIDTH = dict(n_nodes=20, image_hw=28, steps=30, eval_every=10,
                  retraction="polar_fused",
                  elastic=ElasticSpec(churn=ChurnSchedule(
                      kind="scripted",
                      events=((10, "leave", 3), (20, "join", 3)))))
#: the JAX package's run, in a checkout of the repository
REFERENCE = (Path(__file__).resolve().parents[3] / "tests" / "data"
             / "elastic_reference.json")


class RecordedDraws:
    """A draw source that replays recorded uniforms: ``churn`` maps
    ``"leave"`` / ``"join"`` to (rounds, n) arrays (the streams
    ``elastic/churn/leave|join``), ``straggle`` maps a slot to its (rounds,
    n) array (the stream ``{slot}/chan/straggle`` at hop 0).  Each array
    goes to a device once; a round's row is then a slice of it.  Any other
    draw raises."""

    def __init__(self, churn: dict, straggle: dict):
        self.arrays = {f"elastic/churn/{k}": v for k, v in churn.items()}
        self.arrays.update({f"{slot}/chan/straggle": v
                            for slot, v in straggle.items()})
        self._on: dict = {}

    def uniform(self, stream, rnd, index, shape, device):
        if stream not in self.arrays or index != 0:
            raise KeyError(f"no recorded draw for stream {stream!r} "
                           f"index {index}")
        key = (stream, torch.device(device))
        if key not in self._on:
            self._on[key] = torch.as_tensor(self.arrays[stream],
                                            device=device)
        rows = self._on[key]
        if rnd >= rows.shape[0] or tuple(rows.shape[1:]) != tuple(shape):
            raise KeyError(f"{stream}: recorded {tuple(rows.shape)}, "
                           f"asked round {rnd} of shape {tuple(shape)}")
        return rows[rnd]


def _membership_row(state, n: int) -> dict:
    mem = getattr(state.comm, "elastic", None) if state.comm else None
    if mem is None:
        return {"live": n}
    act = mem.active.cpu().numpy()
    return {"live": int(act.sum()), "active": act.astype(int).tolist()}


def _drive(opt, problem, state, batch, steps: int, eval_every: int,
           n: int, dev) -> dict:
    """``steps`` steps on ``batch`` (every node's full data), the curve
    after the first step and every ``eval_every``-th, the median
    synchronized step, and the kernel launches a step (the steps alone)."""
    curve, step_s = [], []
    launches = dict.fromkeys(ops.launch_counts(), 0)
    for t in range(steps):
        before = ops.launch_counts()
        synchronize(dev)
        t0 = time.perf_counter()
        state, metrics = opt.step(state, batch)
        synchronize(dev)
        step_s.append(time.perf_counter() - t0)
        for name, c in ops.launch_counts().items():
            launches[name] += c - before[name]
        if (t + 1) % eval_every == 0 or t == 0:
            m = convergence_metric(problem, state.x, state.y, batch)
            curve.append({"step": t + 1, "loss": float(metrics.loss),
                          "M_t": float(m["M_t"]),
                          "consensus_x": float(m["consensus_x"]),
                          "stiefel_residual": float(m["stiefel_residual"]),
                          **_membership_row(state, n)})
    return {"curve": curve, "final_M_t": curve[-1]["M_t"],
            "final_consensus": curve[-1]["consensus_x"],
            "finite": all(math.isfinite(p["M_t"]) for p in curve),
            "us_per_step": statistics.median(step_s) * 1e6,
            "launches_per_step": {k: c / steps for k, c in launches.items()},
            "device": str(dev)}


def run_fair(name: str, elastic: ElasticSpec | None, steps: int = 60,
             seed: int = 0, device="cuda", params: dict | None = None,
             draws=None, n_nodes: int = N, image_hw: int = 14,
             retraction: str = "polar", eval_every: int = 10) -> dict:
    """DRGDA on fair classification under schedule ``elastic`` (None: no
    elastic engine).  ``params``: one node's initial weights (port
    layout; default ``init_cnn`` seeded with ``seed``); ``draws``: the
    elastic engine's draw source."""
    hyper = GDAHyper(alpha=0.5, beta=0.05, eta=0.2, retraction=retraction)
    run = fair.prepare("drgda", True, seed=seed, hyper=hyper,
                       image_hw=image_hw, n_nodes=n_nodes, k_steps=1,
                       device=device, draws=draws, params=params,
                       elastic=elastic)
    res = _drive(run.opt, run.problem, run.state, run.full, steps,
                 eval_every, n_nodes, run.device)
    return {"problem": "fair_classification", "schedule": name,
            "n_nodes": n_nodes, "image_hw": image_hw, **res}


def pca_data(seed: int = 1, x0_seed: int = 0) -> tuple[dict, torch.Tensor]:
    """The robust-PCA batches ({"z": (N, m, d)}) and the start, drawn by
    the port from ``seed`` and ``x0_seed``."""
    batches, _ = rp.make_batches(
        torch.Generator().manual_seed(seed), n_nodes=N, m=PCA["m"],
        d=PCA["d"], r=PCA["r"], outlier_frac=PCA["outlier_frac"],
        outlier_scale=PCA["outlier_scale"])
    x0 = GRASSMANN.rand(PCA["d"], PCA["r"],
                        generator=torch.Generator().manual_seed(x0_seed),
                        device="cpu")
    return batches, x0


def run_pca(name: str, elastic: ElasticSpec | None, steps: int = 200,
            seed: int = 1, device="cuda", batches: dict | None = None,
            x0: torch.Tensor | None = None, draws=None,
            eval_every: int = 25) -> dict:
    """DRGDA on robust PCA (Gr(20, 3)) under schedule ``elastic``.
    ``batches`` and ``x0`` default to :func:`pca_data` of ``seed``."""
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if batches is None:
        batches, x0 = pca_data(seed)
    batches = {k: v.to(dev) for k, v in batches.items()}
    problem = rp.make_robust_pca_problem(rho=PCA["rho"])
    gossip = GossipSpec(topology="ring", n_nodes=N, k_steps=1,
                        elastic=elastic)
    opt = DRGDA(problem, gossip, PCA["hyper"], draws=draws)
    state = opt.init(broadcast_to_nodes({"w": x0.to(dev)}, N),
                     rp.init_y(N, PCA["m"], device=dev), batches)
    res = _drive(opt, problem, state, batches, steps, eval_every, N, dev)
    return {"problem": "robust_pca", "schedule": name, "n_nodes": N, **res}


def summarize(fair_rows: list, pca_rows: list) -> dict:
    """The benchmark's result: both problems' runs and the acceptance
    check (leave-then-rejoin finite and within 2x of the static M_t)."""
    by = {r["schedule"]: r for r in fair_rows}
    static, churn = by["static"], by["leave_rejoin"]
    ratio = churn["final_M_t"] / max(static["final_M_t"], 1e-12)
    return {"fair_classification": fair_rows, "robust_pca": pca_rows,
            "leave_rejoin_Mt_ratio": ratio,
            "leave_rejoin_within_2x": bool(churn["finite"] and ratio <= 2.0),
            "all_finite": all(r["finite"] for r in fair_rows + pca_rows)}


def run(steps_fair: int = 60, steps_pca: int = 200, device="cuda",
        fair_params: dict | None = None, pca_batches: dict | None = None,
        pca_x0: torch.Tensor | None = None, draws=None) -> dict:
    """Every schedule on both problems (:func:`summarize`).  Without
    ``fair_params`` / ``pca_batches`` and ``pca_x0`` the port draws its
    own; ``draws`` is every elastic run's draw source (default: the
    engine's own)."""
    fair_rows = [run_fair(name, spec, steps=steps_fair, seed=FAIR["seed"],
                          device=device, params=fair_params, draws=draws,
                          image_hw=FAIR["image_hw"],
                          eval_every=FAIR["eval_every"])
                 for name, spec in SCHEDULES.items()]
    pca_rows = [run_pca(name, spec, steps=steps_pca, seed=PCA["seed"],
                        device=device, batches=pca_batches, x0=pca_x0,
                        draws=draws, eval_every=PCA["eval_every"])
                for name, spec in SCHEDULES.items()]
    return summarize(fair_rows, pca_rows)


def run_full_width(device="cuda") -> dict:
    """:data:`FULL_WIDTH`'s leave-and-rejoin run beside the static ring,
    from the same weights: both rows, the M_t ratio and whether it is
    finite and within 2x."""
    cfg = {k: v for k, v in FULL_WIDTH.items() if k != "elastic"}
    static = run_fair("static", None, device=device, **cfg)
    churn = run_fair("leave_rejoin", FULL_WIDTH["elastic"], device=device,
                     **cfg)
    ratio = churn["final_M_t"] / max(static["final_M_t"], 1e-12)
    return {"static": static, "leave_rejoin": churn,
            "leave_rejoin_Mt_ratio": ratio,
            "leave_rejoin_within_2x": bool(churn["finite"] and ratio <= 2.0)}


# ---------------------------------------------------------------------------
# the JAX package's run
# ---------------------------------------------------------------------------


def _decode(v: dict) -> np.ndarray:
    return fair.decode(v).copy()


def load_reference(path=REFERENCE) -> dict:
    """The JAX package's elastic run (``tests/_reference_curves.py
    elastic``): ``init_params`` in the port's layout, ``pca_batches`` and
    ``pca_x0`` as CPU tensors, ``draws`` as a :class:`RecordedDraws`."""
    ref = fair.load_reference(path)
    ref["pca_batches"] = {k: torch.from_numpy(_decode(v))
                          for k, v in ref["pca_batches"].items()}
    ref["pca_x0"] = torch.from_numpy(_decode(ref["pca_x0"]))
    d = ref["draws"]
    ref["draws"] = RecordedDraws(
        {k: _decode(v) for k, v in d["churn"].items()},
        {k: _decode(v) for k, v in d["straggle"].items()})
    return ref


def run_reference(reference: dict, device="cuda", steps_fair: int = 60,
                  steps_pca: int = 200) -> dict:
    """:func:`run` from the weights, data and draws of a
    :func:`load_reference` file (whose settings are :data:`FAIR` and
    :data:`PCA`); with fewer steps the curves are a prefix of the
    reference's."""
    return run(steps_fair, steps_pca, device,
               fair_params=reference["init_params"],
               pca_batches=reference["pca_batches"],
               pca_x0=reference["pca_x0"], draws=reference["draws"])


def compare_to_reference(result: dict, reference: dict) -> dict:
    """Each curve against the reference's, point by point under the gates
    it records (``fair.compare_curves``, per problem; a shorter run is
    held against the reference's first points), and ``live``: every
    point whose live-node count differs from the reference's."""
    out, live = {}, []
    for problem in PROBLEMS:
        runs = [{"method": r["schedule"], "curve": r["curve"]}
                for r in result[problem]]
        n = {r["method"]: len(r["curve"]) for r in runs}
        want = [{"method": r["schedule"],
                 "curve": r["curve"][:n[r["schedule"]]]}
                for r in reference[problem]]
        tol = {name: {key: gates[:n[name]] for key, gates in per.items()}
               for name, per in reference["tolerance"][problem].items()}
        out[problem] = fair.compare_curves(runs, want, tol)
        got = {r["method"]: r["curve"] for r in runs}
        for ref_run in want:
            for a, b in zip(got[ref_run["method"]], ref_run["curve"]):
                if a["live"] != b["live"]:
                    live.append((problem, ref_run["method"], a["step"],
                                 a["live"], b["live"]))
    out["live"] = live
    return out


def within_reference(comparison: dict) -> bool:
    """Whether every gated point is inside its gate and every live count
    equals the reference's."""
    return not comparison["live"] and all(
        fair.within_reference(comparison[p]) for p in PROBLEMS)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full-width", action="store_true",
                    help="leave-and-rejoin at the main path's configuration")
    args = ap.parse_args(argv)
    if args.full_width:
        print(json.dumps(run_full_width(args.device), indent=1))
        return
    ref = load_reference()
    res = run_reference(ref, args.device)
    print(json.dumps(res, indent=1))
    comparison = compare_to_reference(res, ref)
    print(json.dumps({"comparison": comparison,
                      "within_reference": within_reference(comparison)}))


if __name__ == "__main__":
    main()
