"""Robust PCA on the Grassmann manifold with DRGDA, end to end.

The port's counterpart of ``examples/robust_pca.py``:

    min_{x in Gr(d,r)} max_{y in simplex_m}
        sum_j y_j ||z_j - x x^T z_j||^2 / ||z_j||^2  -  rho ||y - 1/m||^2

over a ring of nodes, rho = 0.5, ``GDAHyper(alpha=0.5, beta=0.1, eta=0.3)``
(retraction ``"polar"``), data with 10% outliers at scale 1.5.  Two sizes
(:data:`SIZES`):

* ``example``: the example's own, Gr(20, 3), 24 samples on each of 8
  nodes, gossip at the Theorem-1 steps of the ring (k = 8), 800 steps;
* ``full``: Gr(784, 64) (a PCA of 28x28 images to 64 components, the shape
  of the fair CNN's fc1), 256 samples on each node of the paper's 20-node
  ring with one gossip step (k = 1, as the paper's experiments), 100 steps.

:func:`run` returns the curve (after step t for t = 0 and every
``eval_every``, and after the last step): loss, M_t, consensus_x,
feasibility and the angle to the planted subspace; the worst-case
objective Phi(x) = max_y f(x, y) of DRGDA's first node and of pooled PCA;
the median synchronized step; the kernel launches a step; and the
example's four checks.  ``batches``, ``true_basis`` and ``x0`` may be
given (the JAX package's arrays, from ``tests/data/robust_pca_reference.json``
through :func:`load_reference`); otherwise they are drawn from ``seed``.

    python -m repro_torch.launch.robust_pca                  # on the card
    python -m repro_torch.launch.robust_pca --size full
    python -m repro_torch.launch.robust_pca --device cpu --reference
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path

import torch
from torch.func import vmap

from repro_torch.core.gda import DRGDA, GDAHyper, broadcast_to_nodes
from repro_torch.core.gossip import GossipSpec
from repro_torch.core.metric import convergence_metric
from repro_torch.geometry import GRASSMANN
from repro_torch.kernels import ops
from repro_torch.launch import fair, resolve_device, synchronize
from repro_torch.objectives import robust_pca as rp

RHO = 0.5
OUTLIER_FRAC, OUTLIER_SCALE = 0.1, 1.5
#: d, r, samples per node, nodes, gossip steps (None: Theorem 1), steps,
#: evaluation interval
SIZES = {
    "example": dict(d=20, r=3, m=24, n_nodes=8, k_steps=None, steps=800,
                    eval_every=200),
    "full": dict(d=784, r=64, m=256, n_nodes=20, k_steps=1, steps=100,
                 eval_every=25),
}
#: the example's four checks on the final point
CHECKS = {"M_t < 5e-3": lambda p, phi: p["M_t"] < 5e-3,
          "residual < 1e-4": lambda p, phi: p["stiefel_residual"] < 1e-4,
          "angle < 0.5": lambda p, phi: p["angle"] < 0.5,
          "phi_drgda <= phi_pca + 1e-4":
              lambda p, phi: phi["drgda"] <= phi["pca"] + 1e-4}
#: the JAX package's run of the example, in a checkout of the repository
REFERENCE = (Path(__file__).resolve().parents[3] / "tests" / "data"
             / "robust_pca_reference.json")


def hyper() -> GDAHyper:
    return GDAHyper(alpha=0.5, beta=0.1, eta=0.3)


def worst_case(x: torch.Tensor, batches: dict, rho: float = RHO) -> float:
    """Phi(x) = max_y f(x, y), by the closed-form global maximizer."""
    y_star = rp.robust_pca_y_star({"w": x}, batches, rho=rho)
    res = vmap(lambda z: rp.residuals(x, z))(batches["z"]).mean(0)
    m = res.shape[-1]
    return float(torch.dot(y_star, res) - rho * ((y_star - 1.0 / m) ** 2).sum())


def pooled_pca(batches: dict, r: int) -> torch.Tensor:
    """The top-r eigenvectors of the pooled second moment of every sample."""
    z = batches["z"].reshape(-1, batches["z"].shape[-1])
    return torch.linalg.eigh(z.T @ z)[1][:, -r:]


def prepare(size: str = "example", *, seed: int = 0, device="cuda",
            batches: dict | None = None, true_basis: torch.Tensor | None = None,
            x0: torch.Tensor | None = None) -> tuple[fair.Run, torch.Tensor]:
    """The problem, the data and DRGDA at one of :data:`SIZES`, initialized:
    a ``fair.Run`` (no stream; ``full`` is the node-stacked data) and the
    planted basis on the device.  ``batches`` ({"z": (n, m, d)}),
    ``true_basis`` (d, r) and ``x0`` (one node's basis, every node's start)
    default to draws from ``seed``: the data from a generator seeded with
    ``seed + 1``, x0 from one seeded with ``seed``."""
    cfg = SIZES[size]
    d, r, m, n = cfg["d"], cfg["r"], cfg["m"], cfg["n_nodes"]
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    if batches is None:
        batches, true_basis = rp.make_batches(
            torch.Generator().manual_seed(seed + 1), n_nodes=n, m=m, d=d,
            r=r, outlier_frac=OUTLIER_FRAC, outlier_scale=OUTLIER_SCALE)
    if x0 is None:
        x0 = GRASSMANN.rand(d, r, generator=torch.Generator().manual_seed(
            seed), device="cpu")
    if tuple(batches["z"].shape) != (n, m, d) or tuple(x0.shape) != (d, r):
        raise ValueError(f"{size}: batches {tuple(batches['z'].shape)} and "
                         f"x0 {tuple(x0.shape)} are not ({n}, {m}, {d}) "
                         f"and ({d}, {r})")
    batches = {k: v.to(dev) for k, v in batches.items()}
    problem = rp.make_robust_pca_problem(rho=RHO)
    opt = DRGDA(problem, GossipSpec(topology="ring", n_nodes=n,
                                    k_steps=cfg["k_steps"]),
                hyper())
    state = opt.init(broadcast_to_nodes({"w": x0.to(dev)}, n),
                     rp.init_y(n, m, device=dev), batches)
    return (fair.Run(opt=opt, problem=problem, stream=None, full=batches,
                     state=state, device=dev), true_basis.to(dev))


def run(size: str = "example", *, steps: int | None = None,
        eval_every: int | None = None, seed: int = 0, device="cuda",
        batches: dict | None = None, true_basis: torch.Tensor | None = None,
        x0: torch.Tensor | None = None) -> dict:
    """DRGDA on robust PCA at one of :data:`SIZES` (``steps`` and
    ``eval_every`` override the size's; the other arguments are
    :func:`prepare`'s)."""
    cfg = SIZES[size]
    steps = cfg["steps"] if steps is None else steps
    eval_every = cfg["eval_every"] if eval_every is None else eval_every
    run_, true_basis = prepare(size, seed=seed, device=device,
                               batches=batches, true_basis=true_basis, x0=x0)
    opt, problem, batches, dev = (run_.opt, run_.problem, run_.full,
                                  run_.device)
    state = run_.state

    def point(step: int, loss) -> dict:
        mt = convergence_metric(problem, state.x, state.y, batches)
        return {"step": step, "loss": float(loss), "M_t": float(mt["M_t"]),
                "consensus_x": float(mt["consensus_x"]),
                "stiefel_residual": float(mt["stiefel_residual"]),
                "angle": float(GRASSMANN.dist(state.x["w"][0], true_basis))}

    curve, step_s = [], []
    launches = dict.fromkeys(ops.launch_counts(), 0)
    for t in range(steps):
        before = ops.launch_counts()
        synchronize(dev)
        t0 = time.perf_counter()
        state, metrics = opt.step(state, batches)
        synchronize(dev)
        step_s.append(time.perf_counter() - t0)
        for name, c in ops.launch_counts().items():
            launches[name] += c - before[name]
        if t % eval_every == 0:
            curve.append(point(t, metrics.loss))
    curve.append(point(steps, metrics.loss))
    phi = {"drgda": worst_case(state.x["w"][0], batches),
           "pca": worst_case(pooled_pca(batches, cfg["r"]), batches)}
    return {"size": size, "d": cfg["d"], "r": cfg["r"], "m": cfg["m"],
            "n_nodes": cfg["n_nodes"], "k": opt.k, "steps": steps,
            "curve": curve, "phi": phi,
            "us_per_step": statistics.median(step_s) * 1e6,
            "launches_per_step": {k: c / steps for k, c in launches.items()},
            "checks": {name: bool(check(curve[-1], phi))
                       for name, check in CHECKS.items()},
            "device": str(dev)}


def _decode(v: dict) -> torch.Tensor:
    return torch.from_numpy(fair.decode(v).copy())


def load_reference(path=REFERENCE) -> dict:
    """The JAX package's run of the example (``tests/_reference_curves.py``),
    with ``batches``, ``true_basis`` and ``x0`` as CPU tensors."""
    ref = json.loads(Path(path).read_text())
    ref["batches"] = {k: _decode(v) for k, v in ref["batches"].items()}
    ref["true_basis"] = _decode(ref["true_basis"])
    ref["x0"] = _decode(ref["x0"])
    return ref


def run_reference(reference: dict, device="cuda") -> dict:
    """The example's run from the JAX package's arrays."""
    return run("example", steps=reference["settings"]["steps"],
               eval_every=reference["settings"]["eval_every"], device=device,
               batches=reference["batches"],
               true_basis=reference["true_basis"], x0=reference["x0"])


def compare_to_reference(result: dict, reference: dict) -> dict:
    """The curve against the JAX package's, point by point under the gates
    the file records (``curve``: ``fair.compare_curves``), and Phi of DRGDA
    and of pooled PCA (``phi``: relative gap, gate, ``over`` if past it)."""
    phi = {}
    for name, want in reference["phi"].items():
        gap = abs(result["phi"][name] - want) / abs(want)
        gate = reference["tolerance"]["phi"][name]
        phi[name] = {"gap": gap, "gate": gate, "over": gap > gate}
    return {"curve": fair.compare_curves(
        [{"method": "drgda", "curve": result["curve"]}],
        [{"method": "drgda", "curve": reference["curve"]}],
        {"drgda": reference["tolerance"]["drgda"]}), "phi": phi}


def within_reference(comparison: dict) -> bool:
    """Whether every gated point and Phi of :func:`compare_to_reference`
    are inside their gates."""
    return fair.within_reference(comparison["curve"]) and not any(
        c["over"] for c in comparison["phi"].values())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", choices=sorted(SIZES), default="example")
    ap.add_argument("--steps", type=int)
    ap.add_argument("--eval-every", type=int)
    ap.add_argument("--reference", action="store_true",
                    help="the example from the JAX package's arrays, held "
                         "against its curve")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.reference:
        ref = load_reference()
        res = run_reference(ref, args.device)
        comparison = compare_to_reference(res, ref)
        print(json.dumps({**res, "comparison": comparison,
                          "within_reference": within_reference(comparison)},
                         indent=1))
        return
    print(json.dumps(run(args.size, steps=args.steps,
                         eval_every=args.eval_every, device=args.device),
                     indent=1))


if __name__ == "__main__":
    main()
