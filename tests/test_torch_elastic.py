"""The port's elastic gossip (``repro_torch.comms.elastic``) and its
experiment (``repro_torch.launch.elastic``), alone and against the JAX
package's, mirroring ``tests/test_elastic.py``.

The port's own behaviour: spec gating, the simulation-channel rejection,
the scripted timeline, seeded random churn with node 0 pinned, the
commit-once guard over the slots of a step, ``tau = 0`` at full membership
bitwise the port's channel drops, departed rows identity and every realized
``W_t`` symmetric doubly stochastic over the contracts sweep (rows and
columns summing to 1 within 1e-6, departed rows exactly the identity row),
stale-hop tolerance, the rejoin re-init, and compressed hats gated on
publish.

Against the JAX package, with its draws injected (``ElasticJaxDraws``):
``round_view``'s masks and ``W_t`` equal; one ``mix`` per mode within 1e-6
(the realized ``W_t`` is applied by einsum, a product each package sums in
its own order); 10-step DRGDA trajectories on the fair CNN (n = 4, 8x8
images) under a leave-then-rejoin and under 30% stragglers at ``tau = 2``
within 1e-5 per step in loss, every x leaf and y (as the exact
trajectories of ``tests/test_torch_fair.py``); and ``launch.elastic`` on the
CPU, replaying the recorded draws of ``tests/data/elastic_reference.json``,
inside the file's gates with the same live-node trace.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.comms.elastic import (ChurnSchedule, ElasticEngine,
                                       ElasticSpec, Membership)
from repro_torch.comms.layer import CommEngine, make_mixer, maybe_engine
from repro_torch.comms import elastic
from repro_torch.comms.compress import DrawKey, GeneratorDraws
from repro_torch.comms.spec import CommSpec
from repro_torch.core.gossip import GossipSpec
from repro_torch.launch import elastic as launch
from _torch_threads import one_thread  # noqa: E402,F401

N, HW, FC = 4, 8, 16


def _x(n, d=6, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(n, d)).astype(np.float32))


def _engine(n=8, draws=None, comm=None, **kw):
    return ElasticEngine(GossipSpec(topology="ring", n_nodes=n, k_steps=1,
                                    comm=comm, elastic=ElasticSpec(**kw)),
                         draws=draws)


# ---------------------------------------------------------------------------
# spec plumbing
# ---------------------------------------------------------------------------


def test_elastic_spec_enabled_gating():
    assert not ElasticSpec().enabled
    assert not ElasticSpec(churn=ChurnSchedule()).enabled
    assert ElasticSpec(straggler_rate=0.1).enabled
    assert ElasticSpec(drop_rate=0.1).enabled
    assert ElasticSpec(churn=ChurnSchedule(
        kind="scripted", events=((1, "leave", 0),))).enabled
    assert ElasticSpec(churn=ChurnSchedule(kind="random")).enabled
    with pytest.raises(ValueError, match="churn kind"):
        ChurnSchedule(kind="markov")


def test_disabled_elastic_builds_no_engine():
    """Static full membership and a clean channel: no engine, so the
    optimizer runs the exact program (the ring kernels)."""
    assert maybe_engine(GossipSpec(n_nodes=4, elastic=ElasticSpec())) is None
    assert maybe_engine(GossipSpec(n_nodes=4)) is None
    eng = maybe_engine(GossipSpec(n_nodes=4,
                                  elastic=ElasticSpec(straggler_rate=0.2)))
    assert isinstance(eng, ElasticEngine)
    assert isinstance(eng.churn_draws, GeneratorDraws)
    assert eng.churn_draws.seed == 0 and not eng._use_fused_hop()


def test_elastic_rejects_simulation_channel():
    g = GossipSpec(n_nodes=4, comm=CommSpec(drop_rate=0.3),
                   elastic=ElasticSpec(straggler_rate=0.2))
    with pytest.raises(ValueError, match="ElasticSpec"):
        ElasticEngine(g)
    with pytest.raises(ValueError, match="enabled"):
        ElasticEngine(GossipSpec(n_nodes=4, elastic=ElasticSpec()))


class _CountingDraws(GeneratorDraws):
    def __init__(self):
        super().__init__(0)
        self.streams = []

    def uniform(self, stream, rnd, index, shape, device):
        self.streams.append((stream, rnd))
        return super().uniform(stream, rnd, index, shape, device)


def test_membership_commits_once_per_round_across_slots():
    """One step mixes x, y, u and v against one state: only the first slot
    draws and commits the round's churn; the others replay it."""
    draws = _CountingDraws()
    eng = _engine(4, draws=draws, churn=ChurnSchedule(kind="random",
                                                      leave_rate=0.5))
    x = _x(4)
    st = eng.init_state({"x": x, "y": x, "u": x, "v": x})
    assert isinstance(st.elastic, Membership) and st.elastic.round == -1
    assert st.elastic.active is not st.elastic.prev_active
    mix, final = make_mixer(eng.gossip, eng, st, 0)
    for slot in ("x", "y", "u", "v"):
        mix(slot, x, 1)
    assert final().elastic.round == 0
    churn = [s for s in draws.streams if s[0].startswith("elastic/churn")]
    assert churn == [("elastic/churn/leave", 0), ("elastic/churn/join", 0)]
    np.testing.assert_array_equal(final().elastic.prev_active.numpy(),
                                  np.ones(4))


# ---------------------------------------------------------------------------
# churn schedules
# ---------------------------------------------------------------------------


def test_scripted_schedule_timeline():
    churn = ChurnSchedule(kind="scripted",
                          events=((2, "leave", 1), (5, "join", 1)))
    act = torch.ones(4)
    key = DrawKey(GeneratorDraws(0), "elastic/churn", 0)
    masks = [churn.active(act, r, key).numpy() for r in range(8)]
    assert masks[0][1] == 1 and masks[1][1] == 1
    assert masks[2][1] == 0 and masks[4][1] == 0          # left at round 2
    assert masks[5][1] == 1 and masks[7][1] == 1          # rejoined at 5
    assert all(m[[0, 2, 3]].all() for m in masks)         # others untouched


def test_random_schedule_is_seeded_and_pins_node0():
    churn = ChurnSchedule(kind="random", leave_rate=0.5, join_rate=0.5)
    act = torch.ones(8)
    key = DrawKey(GeneratorDraws(3), "elastic/churn", 4)
    np.testing.assert_array_equal(churn.active(act, 4, key).numpy(),
                                  churn.active(act, 4, key).numpy())
    draws = np.stack([churn.active(act, r, DrawKey(
        GeneratorDraws(3), "elastic/churn", r)).numpy() for r in range(32)])
    assert (draws[:, 0] == 1).all()                       # node 0 pinned
    assert draws.min() == 0                               # someone leaves


# ---------------------------------------------------------------------------
# tau = 0: bit for bit the port's simulation channel
# ---------------------------------------------------------------------------


def test_tau0_bitwise_the_channel_drops():
    comm = CommSpec(drop_rate=0.2, straggler_rate=0.4)
    sim = CommEngine(GossipSpec(n_nodes=8, comm=comm))
    ela = _engine(8, tau=0, drop_rate=0.2, straggler_rate=0.4)
    x = _x(8)
    st_s, st_e = sim.init_state({"x": x}), ela.init_state({"x": x})
    z_s = z_e = x
    for rnd in range(20):
        z_s, st_s = sim.mix(st_s, "x", z_s, steps=1, rnd=rnd)
        z_e, st_e = ela.mix(st_e, "x", z_e, steps=1, rnd=rnd)
        assert torch.equal(z_s, z_e), rnd
        np.testing.assert_array_equal(
            ela.realized_wt(st_e, "x", rnd + 1).numpy(),
            sim.channel.w_t(rnd + 1, sim._keys("x", rnd + 1)[1].fold_in(0)
                            ).numpy())


def test_elastic_step_runs_no_ring_kernel(monkeypatch):
    """Every mix of an elastic round applies the realized W_t by einsum."""
    from repro_torch.kernels import ops

    def refuse(*a, **kw):
        raise AssertionError("a ring kernel ran in an elastic round")

    monkeypatch.setattr(ops, "ring_mix_leaves", refuse)
    monkeypatch.setattr(ops, "multi_hop_mix_leaves", refuse)
    eng = _engine(8, churn=ChurnSchedule(kind="scripted",
                                         events=((1, "leave", 2),)))
    x = {"a": _x(8), "b": _x(8, 3)}
    st = eng.init_state({"x": x})
    for rnd in range(3):
        x, st = eng.mix(st, "x", x, steps=2, rnd=rnd)


# ---------------------------------------------------------------------------
# departures, staleness, rejoin
# ---------------------------------------------------------------------------


def test_n2_ring_departure_is_identity_round():
    eng = _engine(2, churn=ChurnSchedule(kind="scripted",
                                         events=((1, "leave", 1),)))
    x = _x(2)
    st = eng.init_state({"x": x})
    z, st = eng.mix(st, "x", x, steps=1, rnd=0)     # both live: real mix
    assert not torch.equal(z, x)
    np.testing.assert_array_equal(eng.realized_wt(st, "x", 1).numpy(),
                                  np.eye(2, dtype=np.float32))
    z2, st = eng.mix(st, "x", z, steps=1, rnd=1)    # node 1 gone: identity
    assert torch.equal(z2, z)


@pytest.mark.parametrize("fault", range(len(elastic.SWEEP_FAULTS)))
@pytest.mark.parametrize("schedule", sorted(elastic.SWEEP_SCHEDULES))
def test_realized_wt_doubly_stochastic_departed_rows_identity(schedule,
                                                              fault):
    """The contracts sweep: every realized W_t over 25 rounds threaded
    through the membership state is exactly symmetric, doubly stochastic
    to 1e-6, and a departed node's row is exactly the identity row."""
    tau, drop, strag = elastic.SWEEP_FAULTS[fault]
    assert elastic.sweep_findings(elastic.SWEEP_SCHEDULES[schedule], tau,
                                  drop, strag) == []


def test_sweep_findings_catches_a_bad_matrix(monkeypatch):
    """The sweep reports a W_t whose departed row is not the identity."""
    real = ElasticEngine.round_view

    def leaky(self, state, slot, rnd):
        view = real(self, state, slot, rnd)
        return view._replace(wt=torch.full_like(view.wt, 1.0 / 8))

    monkeypatch.setattr(ElasticEngine, "round_view", leaky)
    found = elastic.sweep_findings(elastic.SWEEP_SCHEDULES["scripted"])
    assert any("departed node 1" in f for f in found)


def test_stale_hop_tolerance_keeps_links_alive():
    """Every node straggling: tau = 0 freezes gossip (W_t = I), tau >= 1
    keeps mixing against the last-received buffers until they age out."""
    x = _x(8)
    frozen = _engine(8, tau=0, straggler_rate=1.0)
    st = frozen.init_state({"x": x})
    z, st = frozen.mix(st, "x", x, steps=1, rnd=0)
    assert torch.equal(z, x)                              # nobody published

    tol = _engine(8, tau=2, straggler_rate=1.0)
    st = tol.init_state({"x": x})
    assert st.elastic.stale["x"] is not x
    z, st = tol.mix(st, "x", x, steps=1, rnd=0)
    assert not torch.equal(z, x)                          # stale mixing ran
    for rnd in range(1, 5):
        z_prev = z
        z, st = tol.mix(st, "x", z, steps=1, rnd=rnd)
    assert torch.equal(z, z_prev)                         # aged out


def test_rejoin_reinit_consensus_mean_and_determinism():
    """A rejoining node's x is its live neighbours' mean projected through
    the registered manifold; two runs are bitwise equal; dual slots of a
    joining node restart from zero."""
    from repro_torch.geometry import get
    churn = ChurnSchedule(kind="scripted",
                          events=((1, "leave", 3), (3, "join", 3)))

    def run():
        eng = _engine(6, churn=churn, seed=11)
        eng.register_manifolds({"x": "stiefel"})
        x = get("stiefel").rand(8, 2, (6,),
                                generator=torch.Generator().manual_seed(0),
                                device="cpu")
        st = eng.init_state({"x": x, "u": x})
        z = x
        for rnd in range(3):                      # node 3 away at rnd 1, 2
            z, st = eng.mix(st, "x", z, steps=1, rnd=rnd)
        view = eng.round_view(st, "x", 3)
        reinit = eng._reinit_joined("x", z, view)
        nbr = (z[2] + z[4]) / 2
        dual = eng._reinit_joined("u", z, view)
        z4, st = eng.mix(st, "x", z, steps=1, rnd=3)
        z5, st = eng.mix(st, "x", z4, steps=1, rnd=4)
        return reinit, z5, nbr, dual, z

    (ra, a, nbr, dual, z), (rb, b, *_) = run(), run()
    assert torch.equal(a, b) and torch.equal(ra, rb)
    w = ra[3]
    assert float((w.T @ w - torch.eye(2)).abs().max()) < 1e-5
    from repro_torch.geometry.stiefel import project_stiefel
    torch.testing.assert_close(w, project_stiefel(nbr), atol=1e-6, rtol=0)
    assert torch.equal(ra[[0, 1, 2, 4, 5]], z[[0, 1, 2, 4, 5]])
    assert torch.equal(dual[3], torch.zeros_like(dual[3]))


def test_compressed_hats_gate_on_publish():
    """Compressed mode: the CHOCO hats are the stale buffers.  A joining
    node's hat restarts from zero and folds one payload; a non-publisher's
    hat stays put."""
    comm = CommSpec(compressor="int8", error_feedback=True, gamma=0.8)
    churn = ChurnSchedule(kind="scripted",
                          events=((1, "leave", 2), (2, "join", 2)))
    eng = _engine(4, comm=comm, churn=churn, tau=1, straggler_rate=0.5)
    assert not eng._use_fused_hop()
    x = _x(4)
    st = eng.init_state({"x": x})
    assert st.elastic.stale == {}
    z = x
    for rnd in range(6):
        view = eng.round_view(st, "x", rnd)
        old = st.hats["x"].clone()
        z, st = eng.mix(st, "x", z, steps=1, rnd=rnd)
        assert torch.isfinite(z).all()
        quiet = (view.publish == 0) & (view.joined == 0)
        assert torch.equal(st.hats["x"][quiet], old[quiet])
        if rnd == 2:
            assert view.joined[2] == 1


def test_optimizers_register_the_manifold_map():
    from repro_torch.core import OPTIMIZERS
    from repro_torch.core.baselines import GTGDA
    from repro_torch.core.gda import GDAHyper
    from repro_torch.objectives import robust_pca as rp
    problem = rp.make_robust_pca_problem(rho=0.5)
    g = GossipSpec(n_nodes=4, elastic=ElasticSpec(straggler_rate=0.2))
    for opt in (OPTIMIZERS["drgda"](problem, g, GDAHyper()),
                GTGDA(problem, g, GDAHyper())):
        assert opt.engine.manifolds == {"x": problem.manifold_map}


# ---------------------------------------------------------------------------
# the launcher and its reference file
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference():
    return launch.load_reference()


def test_launcher_settings_are_the_references(reference):
    s = reference["settings"]
    assert s["n_nodes"] == launch.N
    schedules = {name: None if spec is None else json.loads(json.dumps(
        dataclasses.asdict(spec))) for name, spec in launch.SCHEDULES.items()}
    assert schedules == s["schedules"]
    for key, cfg in (("fair", launch.FAIR), ("pca", launch.PCA)):
        for k, v in cfg.items():
            want = s[key][k]
            got = dataclasses.asdict(v) if k == "hyper" else v
            assert got == want, (key, k)
    assert s["fair"]["batch_per_node"] == launch.fair.BATCH_PER_NODE
    assert s["fair"]["full_batches"] == launch.fair.FULL_BATCHES
    assert s["fair"]["rho"] == launch.fair.RHO


def test_recorded_draws_refuse_other_streams(reference):
    draws = reference["draws"]
    u = draws.uniform("x/chan/straggle", 3, 0, (8,), "cpu")
    assert u.shape == (8,) and torch.equal(
        u, draws.uniform("x/chan/straggle", 3, 0, (8,), "cpu"))
    for stream, index in (("x/chan/drop", 0), ("x/chan/straggle", 1),
                          ("x", 0)):
        with pytest.raises(KeyError):
            draws.uniform(stream, 0, index, (8,), "cpu")


def test_short_cpu_run_inside_the_reference(reference):
    """``launch.elastic`` on the CPU, every schedule of both problems, from
    the file's weights, data and recorded draws, for the first curve point
    of fair classification (one step; random_20pct has lost a node by
    then) and the first two of robust PCA (25 steps): inside the file's
    gates, the same live-node trace, and the Stiefel residual gated at
    every point against the JAX run's (10x the port's CPU gap)."""
    res = launch.run_reference(reference, "cpu", steps_fair=1, steps_pca=25)
    comparison = launch.compare_to_reference(res, reference)
    assert comparison["live"] == []
    assert launch.within_reference(comparison), comparison
    for problem, points in (("fair_classification", 1), ("robust_pca", 2)):
        for row in res[problem]:
            assert len(row["curve"]) == points
            residual = comparison[problem][row["schedule"]][
                "stiefel_residual"]
            assert residual["gated_through"] == row["curve"][-1]["step"]


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


def _jax():
    jax = pytest.importorskip("jax")
    from _jax_draws import ElasticJaxDraws
    from repro.comms import elastic as je
    return jax, je, ElasticJaxDraws


CASES = {
    "tau0_faults": dict(tau=0, drop_rate=0.2, straggler_rate=0.4),
    "tau2_straggle": dict(tau=2, straggler_rate=0.3),
    "random_churn": dict(tau=1, straggler_rate=0.3, churn=dict(
        kind="random", leave_rate=0.3, join_rate=0.5)),
    "leave_rejoin": dict(churn=dict(kind="scripted", events=(
        (1, "leave", 3), (3, "join", 3)))),
}


def _pair(jax, je, draws_cls, case, n=8, comm=None):
    from repro.comms.spec import CommSpec as JCommSpec
    from repro.core.gossip import GossipSpec as JSpec
    kw = dict(CASES[case])
    churn = kw.pop("churn", None)
    jspec = je.ElasticSpec(churn=je.ChurnSchedule(**churn) if churn
                           else je.ChurnSchedule(), **kw)
    tspec = ElasticSpec(churn=ChurnSchedule(**churn) if churn
                        else ChurnSchedule(), **kw)
    jcomm = JCommSpec(**dataclasses.asdict(comm)) if comm else None
    jeng = je.ElasticEngine(JSpec(topology="ring", n_nodes=n, k_steps=1,
                                  comm=jcomm, elastic=jspec))
    teng = ElasticEngine(GossipSpec(topology="ring", n_nodes=n, k_steps=1,
                                    comm=comm, elastic=tspec),
                         draws=draws_cls(jspec, jcomm))
    return jeng, teng


@pytest.mark.parametrize("case", sorted(CASES))
def test_round_view_matches_reference(case):
    """Masks and W_t of every round equal the JAX package's under its
    draws, with the state threaded through both engines' mixes."""
    jax, je, draws_cls = _jax()
    import jax.numpy as jnp
    jeng, teng = _pair(jax, je, draws_cls, case)
    x = _x(8).numpy()
    js = jeng.init_state({"x": jnp.asarray(x)})
    ts = teng.init_state({"x": torch.from_numpy(x)})
    jz, tz = jnp.asarray(x), torch.from_numpy(x.copy())
    with jax.disable_jit():
        for rnd in range(6):
            jv, tv = jeng.round_view(js, "x", rnd), teng.round_view(ts, "x",
                                                                    rnd)
            for field in ("active", "prev", "joined", "publish", "fresh",
                          "link_mask", "wt", "staleness", "sched_live",
                          "act_links"):
                np.testing.assert_array_equal(
                    getattr(tv, field).numpy(),
                    np.asarray(getattr(jv, field)), err_msg=f"{field} {rnd}")
            assert tv.committed_round == int(jv.committed_round)
            jz, js = jeng.mix(js, "x", jz, steps=1, rnd=rnd)
            tz, ts = teng.mix(ts, "x", tz, steps=1, rnd=rnd)


@pytest.mark.parametrize("case,compressed", [
    ("tau0_faults", False), ("tau2_straggle", False),
    ("leave_rejoin", False), ("random_churn", True)])
def test_mix_matches_reference(case, compressed):
    """Each mode's mix (uncompressed at tau = 0, uncompressed with stale
    hops, a rejoin, compressed under churn) of two slots (x, registered
    Stiefel, and u) over 5 rounds: within 1e-6 of the JAX engine's jitted
    mix."""
    jax, je, draws_cls = _jax()
    import jax.numpy as jnp
    comm = CommSpec(compressor="int8", gamma=0.8) if compressed else None
    jeng, teng = _pair(jax, je, draws_cls, case, n=6, comm=comm)
    jeng.register_manifolds({"x": "stiefel"})
    teng.register_manifolds({"x": "stiefel"})
    rng = np.random.default_rng(2)
    x = np.linalg.qr(rng.normal(size=(6, 8, 2)))[0].astype(np.float32)
    u = rng.normal(size=(6, 8, 2)).astype(np.float32)
    js = jeng.init_state({"x": jnp.asarray(x), "u": jnp.asarray(u)})
    ts = teng.init_state({"x": torch.from_numpy(x), "u": torch.from_numpy(u)})
    jx, ju = jnp.asarray(x), jnp.asarray(u)
    tx, tu = torch.from_numpy(x.copy()), torch.from_numpy(u.copy())
    jmix = {slot: jax.jit(lambda st, z, r, slot=slot: jeng.mix(
        st, slot, z, steps=1, rnd=r)) for slot in ("x", "u")}
    for rnd in range(5):
        jx, js = jmix["x"](js, jx, rnd)
        ju, js = jmix["u"](js, ju, rnd)
        tx, ts = teng.mix(ts, "x", tx, steps=1, rnd=rnd)
        tu, ts = teng.mix(ts, "u", tu, steps=1, rnd=rnd)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx),
                                   atol=1e-6, rtol=0, err_msg=str(rnd))
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju),
                                   atol=1e-6, rtol=0, err_msg=str(rnd))
        np.testing.assert_array_equal(ts.elastic.active.numpy(),
                                      np.asarray(js.elastic.active))


@pytest.mark.parametrize("case", ["leave_rejoin", "straggle_tau2"])
def test_drgda_trajectory_matches_reference(case):
    """10 DRGDA steps on the fair CNN (n = 4, 8x8, "polar") under a
    leave at step 3 and rejoin at step 6, and under 30% stragglers at
    tau = 2: loss, every x leaf and y within 1e-5 of the JAX package's
    jitted steps, the same membership."""
    jax, je, draws_cls = _jax()
    import jax.numpy as jnp

    from repro.core import gda as jgda
    from repro.core.gossip import GossipSpec as JSpec
    from repro.data.synthetic import ClassificationStream as JStream
    from repro.objectives import fair as jfair
    from repro_torch import convert
    from repro_torch.core import gda as tgda
    from repro_torch.objectives import fair

    if case == "leave_rejoin":
        events = ((3, "leave", 2), (6, "join", 2))
        jspec = je.ElasticSpec(churn=je.ChurnSchedule(kind="scripted",
                                                      events=events))
        tspec = ElasticSpec(churn=ChurnSchedule(kind="scripted",
                                                events=events))
    else:
        jspec = je.ElasticSpec(tau=2, straggler_rate=0.3)
        tspec = ElasticSpec(tau=2, straggler_rate=0.3)
    params = jfair.init_cnn(jax.random.PRNGKey(0), image_hw=HW, fc=FC)
    stream = JStream(n_nodes=N, batch_per_node=8, image_hw=HW, seed=0)
    hyper = dict(alpha=0.5, beta=0.05, eta=0.2, retraction="polar")
    jopt = jgda.DRGDA(jfair.make_fair_problem(params),
                      JSpec(n_nodes=N, k_steps=1, elastic=jspec),
                      jgda.GDAHyper(**hyper))
    topt = tgda.DRGDA(fair.make_fair_problem({}),
                      GossipSpec(n_nodes=N, k_steps=1, elastic=tspec),
                      tgda.GDAHyper(**hyper), draws=draws_cls(jspec))
    x0 = jgda.broadcast_to_nodes(params, N)
    full = stream.full(2)
    jb = {k: jnp.asarray(v) for k, v in full.items()}
    tb = convert.batch_to_torch(full, "cpu")
    js = jax.jit(jopt.init)(x0, jnp.full((N, 3), 1.0 / 3.0), jb)
    ts = topt.init(convert.params_from_reference(x0, "cpu"),
                   torch.full((N, 3), 1.0 / 3.0), tb)
    step = jax.jit(jopt.step)
    lives = []
    for t in range(10):
        js, jm = step(js, jb)
        ts, tm = topt.step(ts, tb)
        assert abs(float(tm.loss) - float(jm.loss)) <= 1e-5, t
        tx = convert.params_to_reference(ts.x)
        for key in tx:
            np.testing.assert_allclose(tx[key], np.asarray(js.x[key]),
                                       atol=1e-5, err_msg=f"{key} {t}")
        np.testing.assert_allclose(ts.y.numpy(), np.asarray(js.y), atol=1e-5)
        np.testing.assert_array_equal(ts.comm.elastic.active.numpy(),
                                      np.asarray(js.comm.elastic.active))
        lives.append(int(ts.comm.elastic.active.sum()))
    if case == "leave_rejoin":
        assert lives == [N] * 3 + [N - 1] * 3 + [N] * 4


def test_recorded_draws_are_the_jax_draws(reference):
    """The file's uniforms are the JAX package's churn and straggler draws
    of the benchmark's schedules, at a few rounds."""
    jax, je, draws_cls = _jax()
    s = reference["settings"]
    spec = je.ElasticSpec(**{**s["schedules"]["straggle_tau2"],
                             "churn": je.ChurnSchedule()})
    src = draws_cls(spec)
    for rnd in (0, 7, 199):
        for stream in ("elastic/churn/leave", "elastic/churn/join",
                       "x/chan/straggle", "v/chan/straggle"):
            np.testing.assert_array_equal(
                reference["draws"].uniform(stream, rnd, 0, (8,), "cpu")
                .numpy(), src.uniform(stream, rnd, 0, (8,), "cpu").numpy())
