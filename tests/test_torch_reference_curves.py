"""The JAX package's runs that ``chip_smoke.py`` holds the card's runs
against (written by ``tests/_reference_curves.py``) still describe the JAX
package and the port's settings.

The curves of paper Figs. 1-2 (``tests/data/fair_reference_curves.json``):

* the file's settings are what the script reads from the benchmark today,
  and they are the port's own (``repro_torch.launch.fair``);
* its gates are the ones the script derives from the JAX package's
  recorded spread and the port's measured CPU gaps, one beside every curve
  point;
* its initial weights are the JAX package's ``init_cnn`` at the seed;
* the JAX package recomputes the step-1 points of DRGDA and GT-GDA to 1e-6;
* the port, from those weights on the CPU, reproduces the step-1 points of
  DRGDA and GT-GDA to 1e-5 (relative; absolute for the Stiefel residual),
  before the methods have amplified any rounding.

The DRO curves (``tests/data/dro_reference_curves.json``) and the
robust-PCA example (``tests/data/robust_pca_reference.json``): the
settings are the benchmark's and the example's (read from their sources)
and the port's; the gates are the ones derived from the recorded spread;
the initial weights, the example's data, planted basis and initial basis
are bitwise what the JAX package makes; the step-1 points of DRSGDA on DRO
and of the robust-PCA run are recomputed by the JAX package to 1e-6 and
reproduced by the port on the CPU to 1e-5.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

pytest.importorskip("jax")

import _reference_curves as rc  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import fair  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def bench():
    return rc.benchmark()


@pytest.fixture(scope="module")
def ref():
    return json.loads(rc.OUT.read_text())


@pytest.fixture(scope="module")
def init_params():
    return fair.load_reference(rc.OUT)["init_params"]


def test_settings_are_the_benchmarks_and_the_ports(bench, ref):
    s = ref["settings"]
    assert s == json.loads(json.dumps(rc.settings(bench)))
    assert ref["tolerance"] == rc.tolerance(ref["spread"])
    assert (s["batch_per_node"], s["full_batches"], s["rho"]) == (
        fair.BATCH_PER_NODE, fair.FULL_BATCHES, fair.RHO)
    assert {k: list(v) for k, v in fair.FIGURES.items()} == s["figures"]
    for name, hyper in s["hyper"].items():
        assert dataclasses.asdict(fair.default_hyper(name, "polar")) == hyper
    for fig, names in s["figures"].items():
        assert [r["method"] for r in ref["figures"][fig]] == names
        for r in ref["figures"][fig]:
            steps = s["steps_det"] if r["deterministic"] else s["steps_stoch"]
            assert [p["step"] for p in r["curve"]] == [1] + list(
                range(s["eval_every"], steps + 1, s["eval_every"]))
            for key in rc.QUANTITIES:
                assert len(ref["tolerance"][r["method"]][key]) == len(
                    r["curve"])


def test_init_params_are_the_jax_packages(bench, ref, init_params):
    x0 = bench._setup(ref["settings"]["seed"])[2]
    got = convert.params_to_reference(init_params)
    for key, v in x0.items():
        np.testing.assert_array_equal(got[key], np.asarray(v[0]))


def _first_point(ref, name):
    for runs in ref["figures"].values():
        for r in runs:
            if r["method"] == name:
                return r["curve"][0]
    raise KeyError(name)


@pytest.mark.parametrize("name", ["drgda", "gt-gda"])
def test_step_one_point(bench, ref, init_params, name):
    """The JAX package's step-1 point again (to 1e-6), and the port's from
    the file's weights on the CPU (to 1e-5, as ``rc.gap`` counts it)."""
    want = _first_point(ref, name)
    got = bench.run_method(name, 1, True)["curve"][0]
    for key in rc.QUANTITIES:
        assert abs(got[key] - want[key]) <= 1e-6, (key, got[key], want[key])
    s = ref["settings"]
    port = fair.run_method(name, 1, True, seed=s["seed"],
                           image_hw=s["image_hw"], n_nodes=s["n_nodes"],
                           retraction="polar", device="cpu",
                           params=init_params)
    point = port["curve"][0]
    for key in rc.QUANTITIES:
        assert rc.gap(point, want, key) <= 1e-5, (key, point[key],
                                                  want[key])


# ---------------------------------------------------------------------------
# DRO (tests/data/dro_reference_curves.json) and robust PCA
# (tests/data/robust_pca_reference.json)
# ---------------------------------------------------------------------------

from repro_torch.core.gossip import GossipSpec  # noqa: E402
from repro_torch.launch import dro  # noqa: E402
from repro_torch.launch import robust_pca  # noqa: E402


@pytest.fixture(scope="module")
def dro_bench():
    return rc.benchmark("dro")


@pytest.fixture(scope="module")
def dro_ref():
    return dro.load_reference(rc.DRO_OUT)


@pytest.fixture(scope="module")
def pca_ref():
    return json.loads(rc.PCA_OUT.read_text())


def test_dro_settings_are_the_benchmarks_and_the_ports(dro_bench, dro_ref):
    s = dro_ref["settings"]
    assert s == json.loads(json.dumps(rc.dro_settings(dro_bench)))
    assert dro_ref["tolerance"] == rc.dro_tolerance(dro_ref["spread"])
    assert (s["n_nodes"], s["stream"]["batch_per_node"],
            s["stream"]["hetero"], s["eval_batches"], s["eval_every"]) == (
        dro.N_NODES, dro.BATCH_PER_NODE, dro.HETERO, dro.EVAL_BATCHES,
        dro.EVAL_EVERY)
    assert list(s["methods"]) == list(dro.METHODS) == [
        r["method"] for r in dro_ref["dro"]]
    for name, steps in s["methods"].items():
        assert steps == (s["steps"] // 2 if name == "dm-hsgd"
                         else s["steps"])
        assert dataclasses.asdict(dro.hyper(name)) == s["hyper"][name]
    for r in dro_ref["dro"]:
        steps = s["methods"][r["method"]]
        assert [p["step"] for p in r["curve"]] == [1] + list(
            range(s["eval_every"], steps + 1, s["eval_every"]))
        for key in rc.DRO_QUANTITIES:
            assert len(dro_ref["tolerance"][r["method"]][key]) == len(
                r["curve"])
    import jax

    x0 = dro_bench.fair.init_cnn(jax.random.PRNGKey(s["seed"]),
                                 image_hw=s["stream"]["image_hw"])
    got = convert.params_to_reference(dro_ref["init_params"])
    for key, v in x0.items():
        np.testing.assert_array_equal(got[key], np.asarray(v))


def test_dro_step_one_point(dro_bench, dro_ref):
    """DRSGDA's step-1 point: the JAX package's again (to 1e-6), and the
    port's from the file's weights on the CPU (to 1e-5 relative)."""
    want = dro_ref["dro"][0]["curve"][0]
    got = dro_bench.run_method("drsgda", 1)["curve"][0]
    for key in rc.DRO_QUANTITIES:
        assert abs(got[key] - want[key]) <= 1e-6, (key, got[key], want[key])
    port = dro.run_method("drsgda", 1, device="cpu",
                          params=dro_ref["init_params"])["curve"][0]
    for key in rc.DRO_QUANTITIES:
        assert rc.gap(port, want, key) <= 1e-5, (key, port[key], want[key])


def test_robust_pca_settings_and_arrays_are_the_examples(pca_ref):
    s = pca_ref["settings"]
    assert s == json.loads(json.dumps(rc.pca_settings()))
    assert pca_ref["tolerance"] == rc.pca_tolerance(pca_ref["spread"])
    size = robust_pca.SIZES["example"]
    assert (s["d"], s["r"], s["m"], s["n_nodes"], s["k_steps"], s["steps"],
            s["eval_every"]) == tuple(size[k] for k in (
                "d", "r", "m", "n_nodes", "k_steps", "steps", "eval_every"))
    assert s["rho"] == robust_pca.RHO
    assert s["make_batches"] == {"outlier_frac": robust_pca.OUTLIER_FRAC,
                                 "outlier_scale": robust_pca.OUTLIER_SCALE}
    assert dataclasses.asdict(robust_pca.hyper()) == s["hyper"]
    assert GossipSpec(topology=s["topology"], n_nodes=s["n_nodes"],
                      k_steps=s["k_steps"]).k == s["k"]
    assert [p["step"] for p in pca_ref["curve"]] == list(
        range(0, s["steps"], s["eval_every"])) + [s["steps"]]
    batches, basis, x0 = rc.pca_arrays(s)
    loaded = robust_pca.load_reference(rc.PCA_OUT)
    np.testing.assert_array_equal(loaded["batches"]["z"].numpy(),
                                  np.asarray(batches["z"]))
    np.testing.assert_array_equal(loaded["true_basis"].numpy(),
                                  np.asarray(basis))
    np.testing.assert_array_equal(loaded["x0"].numpy(), np.asarray(x0))


def test_robust_pca_step_one_point(pca_ref):
    """The point after the first step: the JAX package's again (to 1e-6,
    as ``rc.gap`` counts it), and the port's from the file's arrays on the
    CPU (to 1e-5)."""
    s = pca_ref["settings"]
    want = pca_ref["curve"][0]
    got = rc.pca_run(s, steps=1)["curve"][0]
    keys = rc.PCA_QUANTITIES + ("stiefel_residual",)
    for key in keys:
        assert rc.gap(got, want, key) <= 1e-6, (key, got[key], want[key])
    loaded = robust_pca.load_reference(rc.PCA_OUT)
    port = robust_pca.run("example", steps=1, device="cpu",
                          batches=loaded["batches"],
                          true_basis=loaded["true_basis"],
                          x0=loaded["x0"])["curve"][0]
    for key in keys:
        assert rc.gap(port, want, key) <= 1e-5, (key, port[key], want[key])
