"""The port's numerical contracts (``repro_torch.analysis.contracts``)
against the JAX package's on the CPU, as ``tests/test_analysis.py`` holds
the JAX ones.

* ``matrix_findings``: on the same matrices (a scaled ring, an asymmetric
  pair, a negative self-weight, a non-square one, the clean ring) the
  port's findings equal the JAX package's, rule, place and message.
* ``doubly_stochastic_findings``: every channel schedule under drops and
  stragglers clean over 100 seeded rounds (the port's draws), as in the
  JAX test; a leaky channel fires.
* ``channel_sweep_findings`` and ``elastic_sweep_findings`` clean, as the
  JAX package's are (``tests/test_analysis.py``); the elastic sweep fires
  when a departed node's row is not the identity row.
* ``manifold_findings``: every retraction of every registered geometry
  lands on its manifold (the two registries list the same geometries, the
  port's retractions include the JAX package's); a retraction that leaves
  the manifold fires.
* ``run()`` returns no findings.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import geometry as jgeometry  # noqa: E402
from repro.analysis import contracts as jcontracts  # noqa: E402
from repro.core.gossip import ring_matrix as jring  # noqa: E402
from repro_torch import geometry  # noqa: E402
from repro_torch.analysis import Finding, contracts  # noqa: E402
from repro_torch.comms.channel import ChannelModel  # noqa: E402
from repro_torch.core.gossip import ring_matrix  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

BAD = {
    "scaled ring": np.asarray(jring(6), np.float32) * 0.9,
    "asymmetric": np.asarray([[0.6, 0.4], [0.3, 0.7]]),
    "negative self-weight": np.asarray([[-0.2, 0.6, 0.6], [0.6, 0.2, 0.2],
                                        [0.6, 0.2, 0.2]]),
    "not square": np.ones((2, 3)) / 3,
    "clean ring": np.asarray(jring(6), np.float32),
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_matrix_findings_match_reference(name):
    w = BAD[name]
    want = [(f.rule, f.where, f.message)
            for f in jcontracts.matrix_findings(w, where=name)]
    got = contracts.matrix_findings(torch.from_numpy(np.array(w)),
                                    where=name)
    assert [(f.rule, f.where, f.message) for f in got] == want
    assert bool(want) == (name != "clean ring")
    assert all(isinstance(f, Finding) and str(f).startswith(
        "[doubly-stochastic]") for f in got)


def test_matrix_findings_fire_on_substochastic():
    w = np.asarray(ring_matrix(6)) * 0.9
    findings = contracts.matrix_findings(w, where="scaled")
    assert any("row sums" in f.message for f in findings)
    assert not contracts.matrix_findings(np.asarray(ring_matrix(6)))
    assert findings[0].to_json() == {"rule": "doubly-stochastic",
                                     "where": "scaled",
                                     "message": findings[0].message}


@pytest.mark.parametrize("schedule", ["static", "round_robin", "matching"])
@pytest.mark.parametrize("drop,straggle", [(0.3, 0.0), (0.0, 0.3),
                                           (0.25, 0.25)])
def test_faulty_channels_stay_doubly_stochastic(schedule, drop, straggle):
    ch = ChannelModel(np.asarray(ring_matrix(8), np.float32),
                      schedule=schedule, drop_rate=drop,
                      straggler_rate=straggle)
    assert contracts.doubly_stochastic_findings(ch, rounds=100,
                                               device="cpu") == []


def test_doubly_stochastic_fires_on_leaky_channel():
    class Leaky:
        def w_t(self, rnd, key, device="cpu"):
            return torch.as_tensor(ring_matrix(4), dtype=torch.float32,
                                   device=device) * 0.95

    findings = contracts.doubly_stochastic_findings(Leaky(), rounds=2,
                                                   device="cpu")
    assert findings and findings[0].rule == "doubly-stochastic"
    assert findings[0].where == "channel round 0"


def test_channel_sweep_clean():
    assert contracts.channel_sweep_findings(rounds=5, device="cpu") == []


def test_elastic_sweep_clean_and_fires(monkeypatch):
    """Clean over the sweep's schedules and faults; a round view whose
    departed rows are not identity rows fires."""
    from repro_torch.comms import elastic

    assert contracts.elastic_sweep_findings(rounds=30, device="cpu") == []
    real = elastic.ElasticEngine.round_view

    def leaky(self, state, slot, rnd):
        view = real(self, state, slot, rnd)
        gone = view.active == 0
        if not bool(gone.any()):
            return view
        wt = view.wt.clone()
        i = int(torch.nonzero(gone).flatten()[0])
        wt[i, i] = 0.5
        wt[i, (i + 1) % wt.shape[0]] = 0.5
        return view._replace(wt=wt)

    monkeypatch.setattr(elastic.ElasticEngine, "round_view", leaky)
    findings = contracts.elastic_sweep_findings(rounds=30, device="cpu")
    assert findings and all(f.rule == "doubly-stochastic" for f in findings)
    assert any("identity row" in f.message for f in findings)


def test_manifold_feasibility_clean():
    assert sorted(geometry.REGISTRY) == sorted(jgeometry.REGISTRY)
    for name, m in geometry.REGISTRY.items():
        assert set(jgeometry.REGISTRY[name].retractions) <= \
            set(m.retractions), name
    assert contracts.manifold_findings(device="cpu") == []


def test_manifold_findings_fire_on_a_bad_retraction(monkeypatch):
    stiefel = geometry.REGISTRY["stiefel"]
    monkeypatch.setattr(type(stiefel), "retract",
                        lambda self, x, u, kind=None, **kw: x + 10.0 * u)
    findings = contracts.manifold_findings(names=["stiefel"],
                                            device="cpu")
    assert {f.where for f in findings} == {
        f"stiefel.retract[{k}]" for k in stiefel.retractions}
    assert all(f.rule == "manifold-feasibility" for f in findings)


def test_run_clean():
    assert contracts.run(device="cpu") == []
