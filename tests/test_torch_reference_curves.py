"""The JAX package's curves of paper Figs. 1-2
(``tests/data/fair_reference_curves.json``, written by
``tests/_reference_curves.py``), which ``chip_smoke.py`` holds the card's
run against, still describe the JAX package and the port's settings:

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
