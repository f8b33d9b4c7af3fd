"""Write the JAX package's runs to files, for the port to be held against
on a machine without JAX.

    PYTHONPATH=src python tests/_reference_curves.py [fair] [dro] [robust_pca]

(all three without arguments).  Each target runs the JAX package, then the
same run ``ENSEMBLE`` times more from perturbed initial weights, and
records the reference's own spread and a gate beside every curve point.

``fair``: ``run()`` of ``benchmarks/fair_classification.py`` (DRGDA and
GT-GDA on full local datasets for 120 steps, DRSGDA, GNSD-A, DM-HSGD and
GT-SRVR on minibatches for 150; a 20-node ring, seed 0), written to
``tests/data/fair_reference_curves.json``:

* ``settings``: what the runs were (read from the benchmark where it names
  them: its defaults, ``N_NODES``, ``RHO``, the stream's image size);
* ``init_params``: the one node's initial weights every node starts from
  (``fair.init_cnn`` with ``jax.random.PRNGKey(seed)``; the port cannot
  draw them), float32 little-endian in base64, conv kernels in HWIO;
* ``figures``: each method's curve (loss, M_t, consensus_x,
  stiefel_residual at step 1 and every ``eval_every`` steps), without the
  benchmark's ``us_per_step`` (a time of this machine's CPU);
* ``spread``: how far the JAX package moves from itself at each curve
  point under a perturbation of its initial weights of the size of fp32
  rounding (see :data:`ENSEMBLE`);
* ``tolerance``: the gate of each curve point, from the spread and the
  port's CPU gap (see :func:`tolerance`).

``dro``: ``run()`` of ``benchmarks/dro.py`` (DRSGDA and GNSD-A for 120
steps, DM-HSGD for 60, on the stream at ``hetero=0.9``), written to
``tests/data/dro_reference_curves.json``: ``settings`` (read from the
benchmark), ``init_params``, the curves under ``dro`` (loss, M_t,
worst_group_weight), ``spread`` and ``tolerance``.

``robust_pca``: the run of ``examples/robust_pca.py`` (DRGDA on Gr(20, 3),
8-node ring, 800 steps), rebuilt from the settings read with ``ast`` from
the example's source (importing the example runs it), written to
``tests/data/robust_pca_reference.json``: ``settings``, the arrays
``batches`` (z), ``true_basis`` and ``x0`` made with the example's keys,
the curve (after step t = 0, 200, 400, 600 and after the last step: loss,
M_t, consensus_x, stiefel_residual, angle to the planted subspace), the
worst-case objective ``phi`` of DRGDA and of pooled PCA, ``spread`` and
``tolerance``.

``fair`` takes about 12 minutes on a CPU, ``dro`` about 6, ``robust_pca``
about 1.  The script imports the JAX package and the benchmarks, and
nothing of the port.
"""
from __future__ import annotations

import ast
import base64
import dataclasses
import importlib.util
import inspect
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "tests" / "data" / "fair_reference_curves.json"
DRO_OUT = ROOT / "tests" / "data" / "dro_reference_curves.json"
PCA_OUT = ROOT / "tests" / "data" / "robust_pca_reference.json"
EXAMPLE = ROOT / "examples" / "robust_pca.py"
DRO_QUANTITIES = ("loss", "M_t", "worst_group_weight")
PCA_QUANTITIES = ("loss", "M_t", "consensus_x", "angle")
QUANTITIES = ("loss", "M_t", "consensus_x", "stiefel_residual")
FIGURES = {"figure1_deterministic": ["drgda", "gt-gda"],
           "figure2_stochastic": ["drsgda", "gnsd-a", "dm-hsgd", "gt-srvr"]}

# The gate is taken from the reference itself.  ``ENSEMBLE`` more runs of
# the JAX package start from its initial weights multiplied by (1 + 1e-7
# standard normal noise), the size of fp32 rounding; a curve point's
# *spread* is the largest gap of those runs from the unperturbed one there
# (as :func:`gap` counts it).  Where the reference reproduces itself to
# ``SPREAD_CAP``, its points are gated at ``SPREAD_FACTOR`` times the
# spread; from the first point of a method's quantity where the spread
# passes the cap on, the reference cannot tell a faulty port from rounding,
# and those points are reported, not gated (a null gate).  GT-SRVR and
# GT-GDA amplify rounding this way: their late points spread by O(1).
ENSEMBLE = 4
PERTURBATION = 1e-7
SPREAD_FACTOR = 10.0
SPREAD_CAP = 1e-3
# The port's largest gap from the reference on the CPU over the gated
# points, per method and quantity (relative), measured once with
# `python -m repro_torch.launch.fair --figures --device cpu`; the gate is
# never below ten times it, nor below 1e-4 relative.  The Stiefel residual
# (|x^T x - I|, rounding noise of about 1e-6 that two implementations do
# not share) is held at every point to 1e-4 absolute, the feasibility bound
# every curve point of the port is held to.
CPU_GAP = {
    "drgda": {"loss": 1.363e-05, "M_t": 3.889e-05, "consensus_x": 2.645e-05},
    "gt-gda": {"loss": 1.371e-05, "M_t": 5.234e-04, "consensus_x": 8.243e-05},
    "drsgda": {"loss": 4.345e-06, "M_t": 1.662e-05, "consensus_x": 3.338e-06},
    "gnsd-a": {"loss": 7.360e-07, "M_t": 6.961e-06, "consensus_x": 3.461e-04},
    "dm-hsgd": {"loss": 2.157e-05, "M_t": 2.343e-04,
                "consensus_x": 2.624e-04},
    "gt-srvr": {"loss": 0.0, "M_t": 1.697e-06, "consensus_x": 2.111e-06},
}
# The same for the DRO curves (`python -m repro_torch.launch.dro --device
# cpu`) and the robust-PCA example (`python -m repro_torch.launch.robust_pca
# --device cpu --reference`; ``phi``: the worst-case objective of DRGDA and
# of pooled PCA, relative).  The angle to the planted subspace is held
# absolutely: fp32 rounding of a cosine near 1 moves a small principal
# angle by about 5e-4 (arccos(1 - delta) ~ sqrt(2 delta)), so its floor is
# ``ANGLE_FLOOR``, not ``FLOOR``.
DRO_CPU_GAP = {
    "drsgda": {"loss": 2.376e-06, "M_t": 6.641e-06,
               "worst_group_weight": 1.310e-07},
    "gnsd-a": {"loss": 4.045e-03, "M_t": 1.193e-02,
               "worst_group_weight": 1.405e-02},
    "dm-hsgd": {"loss": 8.412e-07, "M_t": 1.482e-06,
                "worst_group_weight": 1.755e-07},
}
PCA_CPU_GAP = {
    "drgda": {"loss": 1.535e-07, "M_t": 2.538e-03, "consensus_x": 6.626e-04,
              "angle": 1.967e-06},
    "phi": {"drgda": 0.0, "pca": 1.175e-07},
}
CPU_FACTOR = 10.0
FLOOR = 1e-4
ANGLE_FLOOR = 1e-3
RESIDUAL_GATE = 1e-4
ABSOLUTE = ("stiefel_residual", "angle")


def benchmark(name: str = "fair_classification"):
    """``benchmarks/<name>.py`` as a module (the folder is not a
    package)."""
    sys.path.insert(0, str(ROOT / "src"))
    path = ROOT / "benchmarks" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _defaults(fn) -> dict:
    return {k: p.default for k, p in inspect.signature(fn).parameters.items()
            if p.default is not inspect.Parameter.empty}


def settings(fc) -> dict:
    """What ``fc.run()`` runs, from the benchmark's own definitions where
    it names them; the hyper-parameters are the ones its ``run_method``
    builds for each method (fair_classification.py:52-58)."""
    import dataclasses

    from repro.core.baselines import HSGDHyper, SRVRHyper
    from repro.core.gda import GDAHyper
    from repro.data.synthetic import ClassificationStream

    run, method, setup = (_defaults(fc.run), _defaults(fc.run_method),
                          _defaults(fc._setup))
    gda = dataclasses.asdict(GDAHyper(alpha=0.5, beta=0.05, eta=0.2))
    hyper = {name: gda for names in FIGURES.values() for name in names}
    hyper["dm-hsgd"] = dataclasses.asdict(HSGDHyper(beta=0.05, eta=0.2,
                                                    bx=0.1))
    hyper["gt-srvr"] = dataclasses.asdict(SRVRHyper(beta=0.05, eta=0.2,
                                                    q=16))
    return {
        "source": "benchmarks/fair_classification.py run()",
        "n_nodes": fc.N_NODES, "topology": "ring", "k_steps": 1,
        "rho": fc.RHO, "seed": method["seed"],
        "batch_per_node": setup["batch_per_node"],
        "image_hw": _defaults(ClassificationStream)["image_hw"],
        "full_batches": 4,
        "steps_det": run["steps_det"], "steps_stoch": run["steps_stoch"],
        "eval_every": method["eval_every"],
        "figures": FIGURES, "hyper": hyper,
    }


def tolerance(spread: dict, cpu_gap: dict | None = None,
              residual: bool = True) -> dict:
    """The gate of every curve point, per method and quantity: a list
    beside the curve, null where the point is reported and not gated.
    ``cpu_gap`` defaults to the figures' :data:`CPU_GAP`; ``residual``
    adds the Stiefel residual's gate at every point."""
    cpu_gap = CPU_GAP if cpu_gap is None else cpu_gap
    out = {}
    for name, per_key in spread.items():
        out[name] = {}
        for key, points in per_key.items():
            floor = ANGLE_FLOOR if key == "angle" else FLOOR
            gates, open_ = [], True
            for sp in points:
                open_ = open_ and sp <= SPREAD_CAP
                gates.append(max(SPREAD_FACTOR * sp,
                                 CPU_FACTOR * cpu_gap[name][key], floor)
                             if open_ else None)
            out[name][key] = gates
        if residual:
            n = len(next(iter(per_key.values())))
            out[name]["stiefel_residual"] = [RESIDUAL_GATE] * n
    return out


def _encode(a) -> dict:
    import numpy as np
    a = np.ascontiguousarray(np.asarray(a, dtype="<f4"))
    return {"shape": list(a.shape),
            "float32_base64": base64.b64encode(a.tobytes()).decode()}


def gap(a: dict, b: dict, key: str) -> float:
    """The gap of curve point ``a`` from the reference's ``b``: relative to
    the reference's value, absolute for the Stiefel residual (rounding
    noise of about 1e-6 that two implementations do not share) and for the
    angle to the planted subspace (see :data:`ANGLE_FLOOR`)."""
    if key in ABSOLUTE:
        return abs(a[key] - b[key])
    return abs(a[key] - b[key]) / max(abs(b[key]), 1e-30)


def spread(fc, s: dict, figures: dict) -> dict:
    """The reference's own spread at every curve point, per method and
    quantity: the largest gap of ``ENSEMBLE`` runs from perturbed initial
    weights (see :data:`ENSEMBLE`) from ``figures``."""
    import jax.numpy as jnp
    import numpy as np

    setup = fc._setup
    out = {r["method"]: {key: [0.0] * len(r["curve"])
                         for key in QUANTITIES[:3]}
           for runs in figures.values() for r in runs}
    for member in range(ENSEMBLE):
        rng = np.random.default_rng(member + 1)

        def perturbed(seed=0, **kw):
            stream, problem, x0, y0 = setup(seed, **kw)
            x0 = {k: v * jnp.asarray(1.0 + PERTURBATION * rng.standard_normal(
                v.shape[1:]), v.dtype)[None] for k, v in x0.items()}
            return stream, problem, x0, y0

        fc._setup = perturbed
        try:
            got = fc.run(s["steps_det"], s["steps_stoch"])
        finally:
            fc._setup = setup
        for fig, runs in figures.items():
            for r, want in zip(got[fig], runs):
                for key, points in out[r["method"]].items():
                    for i, (a, b) in enumerate(zip(r["curve"],
                                                   want["curve"])):
                        points[i] = max(points[i], gap(a, b, key))
        print(f"ensemble member {member + 1} of {ENSEMBLE} done", flush=True)
    return out


def fair_main() -> None:
    fc = benchmark()
    s = settings(fc)
    x0 = fc._setup(s["seed"])[2]
    init = {k: _encode(v[0]) for k, v in sorted(x0.items())}
    out = fc.run(s["steps_det"], s["steps_stoch"])
    figures = {}
    for fig, names in FIGURES.items():
        got = [r["method"] for r in out[fig]]
        if got != names:
            raise RuntimeError(f"{fig}: the benchmark ran {got}, not {names}")
        figures[fig] = [{"method": r["method"],
                         "deterministic": r["deterministic"],
                         "curve": r["curve"]} for r in out[fig]]
    sp = spread(fc, s, figures)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps({"settings": s, "spread": sp,
                               "tolerance": tolerance(sp),
                               "init_params": init, "figures": figures},
                              indent=1) + "\n")
    print(f"wrote {OUT}")


def _ensemble_gaps(out: dict, member_runs, want_runs, quantities) -> None:
    """Raise ``out[method][key][i]`` to each member run's gap there."""
    for r, want in zip(member_runs, want_runs):
        for key in quantities:
            points = out[r["method"]][key]
            for i, (a, b) in enumerate(zip(r["curve"], want["curve"])):
                points[i] = max(points[i], gap(a, b, key))


# ---------------------------------------------------------------------------
# DRO (benchmarks/dro.py)
# ---------------------------------------------------------------------------


def _calls(tree: ast.AST) -> dict:
    """name -> (positional args, keywords) of the last call of each
    function or method name in ``tree``."""
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(
                f, "id", None)
            out[name] = (node.args, {k.arg: k.value for k in node.keywords})
    return out


def _literal(node: ast.AST, names: dict):
    """A constant, a name of ``names``, or ``PRNGKey(seed)`` (its seed)."""
    if isinstance(node, ast.Name):
        return names[node.id]
    if isinstance(node, ast.Call):
        return _literal(node.args[0], names)
    return ast.literal_eval(node)


def dro_settings(dro) -> dict:
    """What ``dro.run()`` runs, read from the benchmark: ``N_NODES``, the
    defaults of ``run`` and ``run_method``, the stream's and the
    hyper-parameters' arguments in ``run_method``, the evaluation batch, and
    each method's steps as ``run`` computes them from its ``steps``."""
    from repro.core.baselines import HSGDHyper
    from repro.core.gda import GDAHyper
    from repro.data.synthetic import ClassificationStream

    tree = ast.parse(inspect.getsource(dro))
    calls = _calls(tree)
    stream = {k: _literal(v, {}) for k, v in calls["ClassificationStream"][1]
              .items() if k not in ("n_nodes", "seed")}
    stream.setdefault("image_hw", _defaults(ClassificationStream)["image_hw"])
    hsgd = {k: _literal(v, {}) for k, v in calls["HSGDHyper"][1].items()}
    gda = {k: _literal(v, {}) for k, v in calls["GDAHyper"][1].items()}
    steps = _defaults(dro.run)["steps"]
    methods = {}
    for node in ast.walk(ast.parse(inspect.getsource(dro.run))):
        if isinstance(node, ast.Call) and getattr(node.func, "id",
                                                  None) == "run_method":
            methods[ast.literal_eval(node.args[0])] = eval(  # noqa: S307
                compile(ast.Expression(node.args[1]), "run", "eval"),
                {"steps": steps})
    return {
        "source": "benchmarks/dro.py run()",
        "n_nodes": dro.N_NODES, "topology": "ring", "k_steps": 1,
        "seed": _defaults(dro.run_method)["seed"], "steps": steps,
        "stream": stream, "y0": 1.0 / 3.0,
        "eval_batches": next(
            ast.literal_eval(node.args[0]) for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "full"
            and getattr(node.func.value, "id", None) == "stream"),
        "eval_every": 10,
        "methods": methods,
        "hyper": {name: dataclasses.asdict(HSGDHyper(**hsgd)
                                           if name == "dm-hsgd"
                                           else GDAHyper(**gda))
                  for name in methods},
    }


def dro_tolerance(spread: dict) -> dict:
    """The gates of the DRO curves (no Stiefel residual in the benchmark's
    curves: the port holds its own to 1e-4 absolute)."""
    return tolerance(spread, DRO_CPU_GAP, residual=False)


def dro_runs(dro, steps: int, perturb=None) -> list:
    """``dro.run(steps)``'s runs without ``us_per_step``; ``perturb`` maps
    the initial weights ``init_cnn`` draws to the ones the runs start
    from."""
    init = dro.fair.init_cnn
    if perturb is not None:
        dro.fair.init_cnn = lambda *a, **kw: perturb(init(*a, **kw))
    try:
        out = dro.run(steps)["dro"]
    finally:
        dro.fair.init_cnn = init
    return [{"method": r["method"], "curve": r["curve"]} for r in out]


def dro_main() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    dro = benchmark("dro")
    s = dro_settings(dro)
    params = dro.fair.init_cnn(jax.random.PRNGKey(s["seed"]),
                               image_hw=s["stream"]["image_hw"])
    init = {k: _encode(v) for k, v in sorted(params.items())}
    runs = dro_runs(dro, s["steps"])
    if [r["method"] for r in runs] != list(s["methods"]):
        raise RuntimeError(f"the benchmark ran {[r['method'] for r in runs]}")
    sp = {r["method"]: {key: [0.0] * len(r["curve"])
                        for key in DRO_QUANTITIES} for r in runs}
    for member in range(ENSEMBLE):
        rng = np.random.default_rng(member + 1)

        def perturb(p):
            return {k: v * jnp.asarray(1.0 + PERTURBATION
                                       * rng.standard_normal(v.shape),
                                       v.dtype) for k, v in p.items()}

        _ensemble_gaps(sp, dro_runs(dro, s["steps"], perturb), runs,
                       DRO_QUANTITIES)
        print(f"dro ensemble member {member + 1} of {ENSEMBLE} done",
              flush=True)
    DRO_OUT.write_text(json.dumps({
        "settings": s, "spread": sp, "tolerance": dro_tolerance(sp),
        "init_params": init, "dro": runs}, indent=1) + "\n")
    print(f"wrote {DRO_OUT}")


# ---------------------------------------------------------------------------
# robust PCA (examples/robust_pca.py)
# ---------------------------------------------------------------------------


def pca_settings() -> dict:
    """The example's settings, read with ``ast`` from its source: the
    constants line ``D, R, M, N, RHO = ...``, the keys and arguments of its
    ``make_batches``, ``GRASSMANN.rand``, ``GossipSpec`` and ``GDAHyper``
    calls, the steps of its loop and its evaluation interval."""
    from repro.core.gda import GDAHyper
    from repro.core.gossip import GossipSpec

    tree = ast.parse(EXAMPLE.read_text())
    consts = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.targets[0],
                                                       ast.Tuple):
            names = [t.id for t in node.targets[0].elts]
            if names == ["D", "R", "M", "N", "RHO"]:
                consts = dict(zip(names, ast.literal_eval(node.value)))
    calls = _calls(tree)
    mb_args, mb_kw = calls["make_batches"]
    data = {k: _literal(v, consts) for k, v in mb_kw.items()}
    gossip = {k: _literal(v, consts) for k, v in calls["GossipSpec"][1]
              .items()}
    hyper = {k: _literal(v, consts) for k, v in calls["GDAHyper"][1].items()}
    steps = eval_every = None
    for node in ast.walk(tree):
        if isinstance(node, ast.For) and getattr(node.iter.func, "id",
                                                 None) == "range":
            steps = ast.literal_eval(node.iter.args[0])
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mod):
            eval_every = ast.literal_eval(node.right)
    if (consts["D"], consts["R"], consts["M"], consts["N"]) != (
            data["d"], data["r"], data["m"], data["n_nodes"]):
        raise RuntimeError(f"make_batches takes {data}, not {consts}")
    return {
        "source": "examples/robust_pca.py",
        "d": consts["D"], "r": consts["R"], "m": consts["M"],
        "n_nodes": consts["N"], "rho": consts["RHO"],
        "data_seed": _literal(mb_args[0], consts),
        "x0_seed": _literal(calls["rand"][0][0], consts),
        "make_batches": {k: v for k, v in data.items()
                         if k not in ("n_nodes", "m", "d", "r")},
        "topology": gossip["topology"], "k_steps": gossip.get("k_steps"),
        "k": GossipSpec(**gossip).k,
        "hyper": dataclasses.asdict(GDAHyper(**hyper)),
        "steps": steps, "eval_every": eval_every,
    }


def pca_arrays(s: dict) -> tuple:
    """(batches, true_basis, x0) as the example makes them."""
    import jax

    from repro.geometry import GRASSMANN
    from repro.objectives import robust_pca as rp

    batches, basis = rp.make_batches(
        jax.random.PRNGKey(s["data_seed"]), n_nodes=s["n_nodes"], m=s["m"],
        d=s["d"], r=s["r"], **s["make_batches"])
    x0 = GRASSMANN.rand(jax.random.PRNGKey(s["x0_seed"]), s["d"], s["r"])
    return batches, basis, x0


def pca_run(s: dict, x0=None, steps: int | None = None) -> dict:
    """The example's run (its code, with its settings ``s``): the curve
    after step t for t = 0 and every ``eval_every``, and after the last
    step, and Phi of DRGDA's first node and of pooled PCA.  ``x0``
    replaces the example's initial basis."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.core import DRGDA, GDAHyper, GossipSpec
    from repro.core.gda import broadcast_to_nodes
    from repro.core.metric import convergence_metric
    from repro.geometry import GRASSMANN
    from repro.objectives import robust_pca as rp

    batches, basis, x0_example = pca_arrays(s)
    x0 = x0_example if x0 is None else x0
    steps = s["steps"] if steps is None else steps
    n, m, rho = s["n_nodes"], s["m"], s["rho"]
    problem = rp.make_robust_pca_problem(rho=rho)
    opt = DRGDA(problem, GossipSpec(topology=s["topology"], n_nodes=n,
                                    k_steps=s["k_steps"]),
                GDAHyper(**s["hyper"]))
    state = opt.init(broadcast_to_nodes({"w": x0}, n), rp.init_y(n, m),
                     batches)
    step = opt.make_step(donate=False)

    def point(t, loss):
        mt = convergence_metric(problem, state.x, state.y, batches)
        return {"step": t, "loss": float(loss), "M_t": float(mt["M_t"]),
                "consensus_x": float(mt["consensus_x"]),
                "stiefel_residual": float(mt["stiefel_residual"]),
                "angle": float(GRASSMANN.dist(state.x["w"][0], basis))}

    curve = []
    for t in range(steps):
        state, metrics = step(state, batches)
        if t % s["eval_every"] == 0:
            curve.append(point(t, metrics.loss))
    curve.append(point(steps, metrics.loss))

    def worst_case(x):
        y_star = rp.robust_pca_y_star({"w": x}, batches, rho=rho)
        res = jnp.mean(jax.vmap(lambda z: rp.residuals(x, z))(
            batches["z"]), 0)
        return float(jnp.dot(y_star, res)
                     - rho * jnp.sum((y_star - 1.0 / m) ** 2))

    z = np.asarray(batches["z"].reshape(-1, s["d"]))
    pca_basis = jnp.asarray(np.linalg.eigh(z.T @ z)[1][:, -s["r"]:])
    return {"curve": curve, "phi": {"drgda": worst_case(state.x["w"][0]),
                                    "pca": worst_case(pca_basis)}}


def pca_tolerance(spread: dict) -> dict:
    """The gates of the example's curve, and of ``phi`` (relative; no
    horizon, one number each)."""
    tol = tolerance({"drgda": spread["drgda"]}, PCA_CPU_GAP)
    tol["phi"] = {name: max(SPREAD_FACTOR * v,
                            CPU_FACTOR * PCA_CPU_GAP["phi"][name], FLOOR)
                  for name, v in spread["phi"].items()}
    return tol


def pca_main() -> None:
    import jax.numpy as jnp
    import numpy as np

    s = pca_settings()
    batches, basis, x0 = pca_arrays(s)
    ref = pca_run(s)
    sp = {"drgda": {key: [0.0] * len(ref["curve"])
                    for key in PCA_QUANTITIES}}
    phi_sp = dict.fromkeys(ref["phi"], 0.0)
    for member in range(ENSEMBLE):
        rng = np.random.default_rng(member + 1)
        x0p = x0 * jnp.asarray(1.0 + PERTURBATION
                               * rng.standard_normal(x0.shape), x0.dtype)
        got = pca_run(s, x0p)
        _ensemble_gaps(sp, [{"method": "drgda", "curve": got["curve"]}],
                       [ref], PCA_QUANTITIES)
        for name, want in ref["phi"].items():
            phi_sp[name] = max(phi_sp[name],
                               abs(got["phi"][name] - want) / abs(want))
        print(f"robust_pca ensemble member {member + 1} of {ENSEMBLE} done",
              flush=True)
    sp["phi"] = phi_sp
    PCA_OUT.write_text(json.dumps({
        "settings": s, "spread": sp, "tolerance": pca_tolerance(sp),
        "batches": {"z": _encode(batches["z"])},
        "true_basis": _encode(basis), "x0": _encode(x0),
        "curve": ref["curve"], "phi": ref["phi"]}, indent=1) + "\n")
    print(f"wrote {PCA_OUT}")


TARGETS = {"fair": fair_main, "dro": dro_main, "robust_pca": pca_main}


def main(argv=None) -> None:
    os.environ.setdefault("REPRO_TUNE", "off")
    names = (sys.argv[1:] if argv is None else argv) or list(TARGETS)
    for name in names:
        TARGETS[name]()


if __name__ == "__main__":
    main()
