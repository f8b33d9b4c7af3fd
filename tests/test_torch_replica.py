"""The port's replica weight sync (``repro_torch.serve.replica``) and its
comms registry (``repro_torch.comms.api``) against the JAX package on the
CPU.

* ``ReplicaGroup`` at smollm-135m's ``SMOKE``, 4 replicas: the JAX
  group perturbs, the port's group takes the same perturbed weights (its
  own draws come from a ``torch.Generator``) and the JAX engine's
  quantization draws (``tests/_jax_draws.py``); then 4 EF-int8 rounds on
  each side (k = 2: the fused first hop and one all-int8 tail hop).  The
  drift trace within 1e-6 relative, the synced weights within 1e-6
  absolute (the same int8 hops; the drift's sums and the stacked mean
  round in their own order), ``wire_stats`` equal.
* The port's group alone: the JAX test's bounds (drift does not rise
  round to round, the last under 0.2 x the first; the wire bytes under
  half the raw ones), ``replica`` telemetry events, a replica served by
  the paged engine.
* The registry: the same names and Protocols as the JAX package's;
  ``"stacked"`` constructs the stacked backend, ``"shard_map"`` raises
  ``NotImplementedError``, an unknown name ``ValueError``; a registered
  factory is what ``make_backend`` returns, and the trainer's gossip runs
  through it.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from _jax_draws import JaxDraws  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.comms import api as japi  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve.replica import ReplicaGroup as JReplicaGroup  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.comms import api, backend  # noqa: E402
from repro_torch.comms.elastic import ElasticSpec  # noqa: E402
from repro_torch.comms.spec import CommSpec  # noqa: E402
from repro_torch.serve import (ContinuousBatchingScheduler,  # noqa: E402
                               PagedKVSpec, ReplicaGroup, Request,
                               ServeEngine, serve_requests)
from repro_torch.tree import tree_flatten_with_path  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

ARCH = "smollm-135m"


@pytest.fixture(scope="module")
def smoke():
    jcfg = jconfigs.get_config(ARCH, smoke=True)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return (jcfg, jparams, configs.get_config(ARCH, smoke=True),
            convert.transformer_params_from_reference(jparams, "cpu"))


@pytest.fixture(scope="module")
def synced(smoke):
    """Both groups of 4 replicas after the JAX group's ``perturb(0.02)``
    (the port's group takes those weights) and 4 rounds each; the JAX
    group eagerly, as ``tests/test_torch_comms.py`` runs its engine (under
    ``jit`` XLA:CPU contracts the ring combine into an FMA, and a
    requantized value on a rounding edge moves one int8 level)."""
    jcfg, jparams, cfg, params = smoke
    jgroup = JReplicaGroup(jparams, 4, seed=0)
    d0 = jgroup.perturb(0.02)
    group = ReplicaGroup(params, 4, seed=0,
                         draws=JaxDraws(jgroup.gossip.comm))
    start = group.drift()
    group.params = convert.transformer_params_from_reference(jgroup.params,
                                                            "cpu")
    drifts = (d0, group.drift())
    with jax.disable_jit():
        want = jgroup.sync(rounds=4)
    got = group.sync(rounds=4)
    return {"start": start, "d0": drifts, "traces": (got, want),
            "groups": (group, jgroup)}


def test_replica_drift_trace_matches_reference(synced):
    assert synced["start"] == 0.0
    got0, want0 = synced["d0"][1], synced["d0"][0]
    np.testing.assert_allclose(got0, want0, rtol=1e-6)
    got, want = synced["traces"]
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_replica_wire_stats_match_reference(synced):
    group, jgroup = synced["groups"]
    got, want = group.wire_stats(), jgroup.wire_stats()
    assert got == pytest.approx(want, rel=1e-6)
    assert (got["rounds"], got["hops"]) == (4, 8)


def test_replica_weights_match_reference(synced):
    group, jgroup = synced["groups"]
    paths, leaves, _ = tree_flatten_with_path(
        convert.tree_to_reference(group.params))
    wpaths, wleaves, _ = tree_flatten_with_path(
        jax.tree.map(np.asarray, jgroup.params))
    assert paths == wpaths
    for p, a, w in zip(paths, leaves, wleaves):
        np.testing.assert_allclose(a, w, atol=1e-6, rtol=0, err_msg=p)


def test_replica_sync_reduces_drift_monotonically(smoke, tmp_path):
    from repro_torch.obs import Telemetry

    params, n = smoke[3], 2
    tel = Telemetry(out_dir=str(tmp_path), run="replica")
    group = ReplicaGroup(params, n, seed=0, telemetry=tel)
    d0 = group.perturb(0.02)
    assert d0 > 0.01
    trace = group.sync(rounds=4)
    assert all(b <= a * (1 + 1e-6) for a, b in zip(trace, trace[1:]))
    assert trace[-1] < 0.2 * d0
    wire = group.wire_stats()
    assert wire["rounds"] == 4 and wire["hops"] == 8
    assert wire["wire_bytes"] < 0.5 * wire["raw_bytes"]
    events = [json.loads(line) for line in
              (tmp_path / "replica.events.jsonl").read_text().splitlines()]
    replica = [e for e in events if e["type"] == "replica"]
    assert [e["data"]["round"] for e in replica] == [1, 2, 3, 4]
    assert replica[-1]["data"]["drift_after"] == pytest.approx(trace[-1])
    assert replica[-1]["data"]["wire_bytes"] == wire["wire_bytes"]
    # the same seed draws the same perturbation
    again = ReplicaGroup(params, n, seed=0)
    assert again.perturb(0.02) == d0


def test_replica_params_usable_by_engine(smoke):
    cfg, params = smoke[2], smoke[3]
    group = ReplicaGroup(params, 2, seed=0)
    group.perturb(0.01)
    spec = PagedKVSpec(page_size=4, n_pages=17, max_pages_per_slot=4)
    engine = ServeEngine(cfg, group.replica(0), kv_spec=spec, n_slots=1,
                         temperature=0.0)
    fin = serve_requests(engine, ContinuousBatchingScheduler(1, spec),
                         [Request(prompt=[1, 2, 3], max_new_tokens=3)])
    assert len(fin) == 1 and len(fin[0].tokens) == 3


def test_registry_matches_reference():
    assert api.__all__ == japi.__all__
    assert api.backend_names() == japi.backend_names() == ["shard_map",
                                                           "stacked"]
    stacked = backend.make_backend("stacked")
    assert stacked is backend.make_backend("auto")
    assert isinstance(stacked, api.MixBackendProtocol)
    assert stacked.name == "stacked"
    assert isinstance(CommSpec(compressor="int8"), api.CommLike)
    assert isinstance(ElasticSpec(), api.ElasticLike)
    assert not isinstance(object(), api.CommLike)
    for kind, mesh in (("shard_map", None), ("auto", object())):
        with pytest.raises(NotImplementedError, match="queue 1, item 7"):
            backend.make_backend(kind, mesh=mesh)
    with pytest.raises(ValueError, match="unknown mix backend 'ring'"):
        backend.make_backend("ring")


def test_registered_factory_is_constructed(monkeypatch):
    """A third-party backend registers under a name; ``build_trainer``
    constructs it through the registry and the trainer's gossip runs
    through it: one DRSGDA step mixes only there, and gives the stacked
    backend's state exactly (the backend defers to it)."""
    from repro_torch.convert import lm_batch_to_torch
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.launch.steps import build_trainer, init_train_state

    class Recording(backend.StackedBackend):
        name = "mine"
        calls = 0

        def mix(self, spec, tree, steps):
            Recording.calls += 1
            return super().mix(spec, tree, steps)

    made = []

    def factory(**kw):
        made.append(kw)
        return Recording()

    monkeypatch.setitem(api.BACKENDS, "mine", factory)
    assert "mine" in api.backend_names()
    assert backend.make_backend("mine").name == "mine"
    cfg = configs.get_config(ARCH, smoke=True)
    stream = TokenStream(2, 1, 8, cfg.vocab_size, n_groups=cfg.n_groups,
                         seed=0)
    states = {}
    for kind in ("mine", "stacked"):
        opt, _ = build_trainer(cfg, 2, mix_backend=kind)
        assert opt.gossip.backend is opt.backend
        state = init_train_state(torch.Generator().manual_seed(0), cfg,
                                 opt, 2, lm_batch_to_torch(stream.batch(0),
                                                           "cpu"))
        before = Recording.calls
        states[kind], _ = opt.step(state,
                                   lm_batch_to_torch(stream.batch(1), "cpu"))
        states[kind + "_mixes"] = Recording.calls - before
    assert made == [{"mesh": None}, {"mesh": None}]
    assert states["mine_mixes"] > 0 and states["stacked_mixes"] == 0
    paths, mine, _ = tree_flatten_with_path(states["mine"].x)
    _, stacked, _ = tree_flatten_with_path(states["stacked"].x)
    for path, a, b in zip(paths, mine, stacked):
        assert torch.equal(a, b), path
    assert torch.equal(states["mine"].y, states["stacked"].y)
