"""The port's telemetry (``repro_torch.obs``, ``launch/roofline.py``), alone
and against the JAX package's (``tests/test_obs.py``'s cases, on the CPU).

The port's own contracts: telemetry on is bitwise telemetry off for all
six optimizers, flushes at every ``flush_every``-th step; counters cumulative
and monotone, and equal to the analytical byte oracle (``est_hop_bytes``,
``wire_round_bytes``) within 1%; the event log validates and a malformed
event is rejected; the trace round-trips through its Chrome-trace JSON;
the dispatch wrappers record one estimate per grouped call and the same
calls a step with telemetry on and off.

Against the JAX package (same numpy inputs, its draws injected where the
counters read draws): the unpacked counters after a few DRGDA steps on the
exact ring at k = 1 and k = 3, under EF-int8, over a faulty channel and
under elastic leave-and-rejoin, integer fields equal and float fields
within 1e-6 relative (both accumulate the same f32 terms in the same
order, so they come out equal); every wrapper's estimate equal to the JAX
wrapper's on the same shapes; the per-kernel estimate totals of one step
equal for every kernel the JAX step records; ``place`` equal on the same
figures; the event schema byte-equal.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.comms.elastic import ChurnSchedule, ElasticSpec
from repro_torch.comms.spec import CommSpec
from repro_torch.core import OPTIMIZERS
from repro_torch.core.baselines import HSGDHyper, SRVRHyper
from repro_torch.core.gda import DRGDA, GDAHyper
from repro_torch.core.gossip import GossipSpec
from repro_torch.core.minimax import MinimaxProblem, project_simplex
from repro_torch.kernels import ops
from repro_torch.launch import roofline
from repro_torch.obs import Telemetry, WireCounters, unpack
from repro_torch.obs import estimates as obs_est
from repro_torch.obs import events as obs_events
from repro_torch.obs.telemetry import read_counter_series, summarize_run
from repro_torch.obs.trace import Trace
from _torch_threads import one_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
D, R, G, N_NODES = 10, 2, 3, 6
RHO = 1.0
FLOAT_RTOL = 1e-6


def _jax():
    jax = pytest.importorskip("jax")
    return jax


@pytest.fixture(autouse=True)
def _no_tuned_configs(monkeypatch):
    # the JAX package's tune cache may set other ns_iters or blocks; hold
    # both packages to their defaults
    monkeypatch.setenv("REPRO_TUNE", "off")


def _a():
    a = np.stack([np.random.RandomState(i).randn(D, D) for i in range(G)])
    return ((a + np.swapaxes(a, 1, 2)) / 2).astype(np.float32)


def _x0(n=N_NODES):
    w = np.linalg.qr(np.random.RandomState(5).randn(D, R))[0]
    return np.broadcast_to(w.astype(np.float32), (n, D, R)).copy()


def _batches(n=N_NODES):
    return (0.1 * np.random.RandomState(6).randn(n, G, D, D)).astype(
        np.float32)


def _problem():
    """The toy Stiefel minimax problem of ``tests/test_obs.py``."""
    a = torch.from_numpy(_a())

    def loss_fn(x, y, batch):
        lg = -torch.einsum("dr,gde,er->g", x["w"], a + batch, x["w"])
        return torch.dot(y, lg) - RHO * torch.sum((y - 1.0 / G) ** 2)

    return MinimaxProblem(loss_fn=loss_fn, project_y=project_simplex,
                          manifold_map={"w": "stiefel"})


def _jproblem():
    import jax.numpy as jnp
    from repro.core.minimax import MinimaxProblem as JProblem
    from repro.core.minimax import project_simplex as jsimplex
    a = jnp.asarray(_a())

    def loss_fn(x, y, batch):
        lg = -jnp.einsum("dr,gde,er->g", x["w"], a + batch, x["w"])
        return jnp.dot(y, lg) - RHO * jnp.sum((y - 1.0 / G) ** 2)

    return JProblem(loss_fn=loss_fn, project_y=jsimplex,
                    manifold_map={"w": "stiefel"})


HYPERS = {"drgda": GDAHyper(), "drsgda": GDAHyper(), "gt-gda": GDAHyper(),
          "gnsd-a": GDAHyper(), "dm-hsgd": HSGDHyper(),
          "gt-srvr": SRVRHyper(q=4)}


def _run(opt, steps=6):
    """``steps`` steps of ``opt`` (GT-SRVR anchors at every ``q``-th); the
    state after them."""
    b = torch.from_numpy(_batches())
    state = opt.init({"w": torch.from_numpy(_x0())},
                     torch.full((N_NODES, G), 1.0 / G), b)
    for t in range(steps):
        if getattr(opt, "name", "") == "gt-srvr" and t % opt.hyper.q == 0:
            state, _ = opt.anchor_step(state, b)
        else:
            state, _ = opt.step(state, b)
    return state


def _tensors(state):
    return {f.name: getattr(state, f.name)
            for f in dataclasses.fields(state)
            if f.name not in ("comm", "obs", "step")}


# ---------------------------------------------------------------------------
# bit-identity, flush cadence, monotone counters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_trajectory_bitwise_telemetry_on_off(name, tmp_path):
    """Telemetry on (flushes firing) and off agree bit for bit: the
    counters never touch the update."""
    spec = GossipSpec(topology="ring", n_nodes=N_NODES, k_steps=2)
    tel = Telemetry(run="bit", out_dir=str(tmp_path), flush_every=3)
    off = OPTIMIZERS[name](_problem(), spec, HYPERS[name])
    on = OPTIMIZERS[name](_problem(), spec, HYPERS[name], telemetry=tel)
    s_off, s_on = _run(off), _run(on)
    assert s_off.obs is None and s_on.obs is not None
    t_off, t_on = _tensors(s_off), _tensors(s_on)
    for key, leaf in t_off.items():
        for a, b in zip(*(x.values() if isinstance(x, dict) else [x]
                          for x in (leaf, t_on[key]))):
            assert torch.equal(a, b), key
    # every 3rd step (one cadence across GT-SRVR's two steps)
    assert [ev["step"] for ev in read_counter_series(tel.events_path)] \
        == [3, 6]


def test_counters_cumulative_and_monotone(tmp_path):
    spec = GossipSpec(topology="ring", n_nodes=N_NODES)
    tel = Telemetry(run="mono", out_dir=str(tmp_path), flush_every=2)
    opt = DRGDA(_problem(), spec, GDAHyper(), telemetry=tel)
    _run(opt)
    rows = read_counter_series(tel.events_path)
    assert [r["step"] for r in rows] == [2, 4, 6]
    for key in WireCounters._fields:
        series = [r["data"][key] for r in rows]
        assert series == sorted(series), key
    assert rows[0]["data"]["rounds"] == 8 and rows[-1]["data"]["rounds"] == 24
    summary = summarize_run(tel.events_path)
    assert summary["counters_step"] == 6 and summary["n_events"] == 4
    assert summary["bytes_per_hop"] == pytest.approx(
        rows[-1]["data"]["wire_bytes"] / rows[-1]["data"]["hops"])


# ---------------------------------------------------------------------------
# wire accounting against the analytical oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("comm", [None, CommSpec(compressor="int8", gamma=0.9),
                                  CommSpec(compressor="int8", gamma=0.9,
                                           quant_hops="all")],
                         ids=["exact", "int8", "int8_all_hops"])
def test_wire_counters_match_the_byte_oracle(comm, tmp_path):
    """bytes/hop of an exact ring equal the hop-weighted mean of the
    backend's est_hop_bytes over DRGDA's four slots; under an int8 engine
    the wire and raw bytes follow ``wire_round_bytes`` (below raw, and
    below the first-hop-only wire under quant_hops="all"), within 1%."""
    spec = GossipSpec(topology="ring", n_nodes=N_NODES, comm=comm)
    tel = Telemetry(run="oracle", out_dir=str(tmp_path), flush_every=100)
    opt = DRGDA(_problem(), spec, GDAHyper(), telemetry=tel)
    steps, k = 3, opt.k
    assert k > 1
    obs = unpack(_run(opt, steps=steps).obs)
    x0, y0 = {"w": torch.from_numpy(_x0())}, torch.zeros(N_NODES, G)
    slots = ((x0, k), (y0, k), (x0, k), (y0, 1))          # x, y, u, v
    assert obs.rounds == steps * 4
    assert obs.hops == steps * (3 * k + 1)
    assert obs.dropped_links == 0.0
    if comm is None:
        expect = sum(opt.backend.est_hop_bytes(spec, t) * h
                     for t, h in slots) / sum(h for _, h in slots)
        assert abs(obs.wire_bytes / obs.hops - expect) / expect < 0.01
        assert obs.wire_bytes == obs.raw_bytes
        return
    wire = sum(opt.engine.wire_round_bytes(t, h)[0] for t, h in slots)
    raw = sum(opt.engine.wire_round_bytes(t, h)[1] for t, h in slots)
    assert abs(obs.wire_bytes - steps * wire) / (steps * wire) < 0.01
    assert abs(obs.raw_bytes - steps * raw) / (steps * raw) < 0.01
    assert obs.wire_bytes < obs.raw_bytes
    if comm.quant_hops == "all":
        first = DRGDA(_problem(), dataclasses.replace(
            spec, comm=dataclasses.replace(comm, quant_hops="first")),
            GDAHyper()).engine
        assert wire < sum(first.wire_round_bytes(t, h)[0] for t, h in slots)


# ---------------------------------------------------------------------------
# event log, schema, dashboard, trace
# ---------------------------------------------------------------------------


def test_event_log_validates_and_rejects_malformed(tmp_path):
    tel = Telemetry(run="ev", out_dir=str(tmp_path))
    tel.event("dashboard", {"M_t": 1.0}, step=10)
    assert obs_events.validate_log(tel.events_path) == 2   # meta + dashboard
    with pytest.raises(ValueError):               # unknown type enum
        obs_events.make_event("bogus_type", "ev", {})
    with pytest.raises(ValueError):               # data must be an object
        obs_events.validate_event(
            {"type": "counters", "ts": 0.0, "run": "ev", "data": 3})
    with pytest.raises(ValueError):               # missing required field
        obs_events.validate_event({"type": "counters", "ts": 0.0, "run": "ev"})
    with pytest.raises(ValueError):               # step must be an integer
        obs_events.validate_event({"type": "span", "ts": 0.0, "run": "ev",
                                   "data": {}, "step": 1.5})
    bad = tmp_path / "bad.events.jsonl"
    bad.write_text(json.dumps({"type": "span", "run": "ev", "data": {}})
                   + "\n")                        # no ts
    with pytest.raises(ValueError):
        obs_events.validate_log(str(bad))


def test_event_schema_is_the_reference_schema():
    """The port reads its own copy of the schema, byte-equal to the JAX
    package's."""
    assert Path(obs_events.SCHEMA_PATH).read_bytes() == (
        ROOT / "src" / "repro" / "obs" / "event_schema.json").read_bytes()


def test_dashboard_streams_metric_components(tmp_path):
    tel = Telemetry(run="dash", out_dir=str(tmp_path))
    x = torch.from_numpy(_x0())
    x[1:] += 0.01 * torch.from_numpy(np.random.RandomState(3).randn(
        N_NODES - 1, D, R).astype(np.float32))
    ev = tel.dashboard(_problem(), {"w": x}, torch.full((N_NODES, G), 1 / G),
                       torch.from_numpy(_batches()), step=7,
                       extra={"loss": 1.5})
    for key in ("M_t", "grad_norm", "consensus_x", "loss"):
        assert key in ev["data"], key
    assert ev["data"]["drift"]["w"] > 0.0         # per-leaf cross-node drift
    assert obs_events.validate_log(tel.events_path) == 2


def test_trace_perfetto_roundtrip(tmp_path):
    tr = Trace(run="rt")
    with tr.span("outer", step=1):
        with tr.span("inner"):
            pass
    tr.instant("marker")
    tr.counter("wire", {"wire_bytes": 123.0})
    payload = tr.to_chrome_trace()
    assert payload["otherData"]["run"] == "rt"
    assert sorted(e["ph"] for e in payload["traceEvents"]) \
        == ["C", "X", "X", "i"]
    spans = {e["name"]: e for e in tr.spans()}
    assert spans["inner"]["dur"] <= spans["outer"]["dur"]
    rt = Trace.load(tr.save(str(tmp_path / "t.trace.json")))
    assert rt.run == "rt" and rt.events == tr.events


def test_serve_engine_spans_and_events(tmp_path):
    from repro_torch.configs.smollm_135m import SMOKE
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kv_cache import PagedKVSpec

    params = transformer.init_params(torch.Generator().manual_seed(0), SMOKE)
    tel = Telemetry(run="serve", out_dir=str(tmp_path))
    eng = ServeEngine(SMOKE, params, kv_spec=PagedKVSpec(
        page_size=4, n_pages=16, max_pages_per_slot=4), n_slots=2,
        telemetry=tel)
    eng.admit(0, [1, 2, 3, 4, 5], [1, 2])
    eng.step()
    assert [e["name"] for e in tel.trace.spans()] \
        == ["serve.prefill", "serve.step"]
    evs = list(obs_events.read_jsonl(tel.events_path))
    assert [e["type"] for e in evs] == ["meta", "serve"]
    assert evs[1]["data"] == {"kind": "admit", "slot": 0, "prompt_len": 5,
                              "pages": 2}


# ---------------------------------------------------------------------------
# kernel estimates and launches
# ---------------------------------------------------------------------------


def test_estimates_algebra_and_registry():
    e = obs_est.Estimates(ops=100.0, lds=20.0, mem=10.0)
    assert (e + e).ops == 200.0
    assert e.scaled(3).mem == 30.0
    assert e.intensity == 10.0
    assert set(obs_est.KERNELS) == set(ops.launch_counts())


def test_a_step_records_the_calls_it_makes(tmp_path):
    """One DRGDA polar_fused k=1 step records 4 grouped ring_mix calls, 1
    grouped projection and 2 retractions, with telemetry on and off; on
    the CPU nothing launches."""
    ops.reset_launch_counts()
    for tel in (None, Telemetry(out_dir=str(tmp_path), flush_every=1)):
        opt = DRGDA(_problem(), GossipSpec(n_nodes=N_NODES, k_steps=1),
                    GDAHyper(retraction="polar_fused"), telemetry=tel)
        b = torch.from_numpy(_batches())
        state = opt.init({"w": torch.from_numpy(_x0())},
                         torch.full((N_NODES, G), 1.0 / G), b)
        with obs_est.collect() as c:
            opt.step(state, b)
        assert {k: v["calls"] for k, v in c.snapshot().items()} == {
            "ring_mix": 4, "stiefel_project": 1, "fused_retract": 1}
    assert set(ops.launch_counts().values()) == {0}


def _ring_panel(a, halo):
    n = a.shape[0]
    return a.reshape(n, -1)[(np.arange(n + 2 * halo) - halo) % n]


def _wrapper_calls(name, rng):
    """(port call, JAX calls) of wrapper ``name`` on the same numpy inputs:
    the port's grouped call over the leaves, the JAX wrapper once per
    leaf."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops

    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    t, j = torch.from_numpy, jnp.asarray
    wc, ws = 1.0 / 3.0, 1.0 / 3.0
    if name == "stiefel_project":
        xs = [f32(3, 12, 4), f32(3, 6, 2)]
        return (lambda: ops.stiefel_project_leaves(
            [t(x) for x in xs], [t(x) for x in xs]),
            lambda: [jops.stiefel_project(j(x), j(x)) for x in xs])
    if name == "fused_retract":
        x = np.linalg.qr(f32(3, 12, 4))[0].astype(np.float32)
        return (lambda: ops.fused_retract(t(x), t(x)),
                lambda: [jops.fused_retract(j(x), j(x))])
    if name in ("ring_mix", "multi_hop_mix"):
        xs = [f32(5, 6), f32(5, 2, 3)]
        if name == "ring_mix":
            return (lambda: ops.ring_mix_leaves([t(x) for x in xs],
                                                w_self=wc, w_side=ws),
                    lambda: [jops.ring_mix(j(x), j(np.roll(x, 1, 0)),
                                           j(np.roll(x, -1, 0)), w_self=wc,
                                           w_side=ws) for x in xs])
        return (lambda: ops.multi_hop_mix_leaves(
            [t(x) for x in xs], hops=2, w_self=wc, w_side=ws),
            lambda: [jops.multi_hop_mix(j(_ring_panel(x, 2)), hops=2,
                                        out_rows=5, halo=2, w_self=wc,
                                        w_side=ws) for x in xs])
    if name in ("quant_mix", "multi_hop_mix_quant"):
        qs = [rng.integers(-127, 128, size=s).astype(np.int8)
              for s in ((5, 7), (5, 3))]
        ss = [np.abs(f32(5)) for _ in qs]
        if name == "quant_mix":
            return (lambda: ops.quant_mix_leaves(
                [t(q) for q in qs], [t(s) for s in ss],
                base=[t(f32(5, q.shape[1])) for q in qs], w_self=wc,
                w_side=ws),
                lambda: [jops.quant_mix(
                    j(q), j(np.roll(q, 1, 0)), j(np.roll(q, -1, 0)), j(s),
                    j(np.roll(s, 1, 0)), j(np.roll(s, -1, 0)), w_self=wc,
                    w_side=ws) for q, s in zip(qs, ss)])
        return (lambda: ops.multi_hop_mix_quant_leaves(
            [t(q) for q in qs], [t(s) for s in ss], hops=2, w_self=wc,
            w_side=ws),
            lambda: [jops.multi_hop_mix_quant(
                j(_ring_panel(q, 2)), j(_ring_panel(s, 2)), hops=2,
                out_rows=5, halo=2, w_self=wc, w_side=ws)
                for q, s in zip(qs, ss)])
    if name == "flash_attention":
        q, k, v = f32(1, 6, 4, 8), f32(1, 6, 2, 8), f32(1, 6, 2, 8)
        return (lambda: ops.flash_attention(t(q), t(k), t(v), window=4),
                lambda: [jops.flash_attention(j(q), j(k), j(v), window=4)])
    q, kp, vp = f32(2, 4, 8), f32(4, 4, 2, 8), f32(4, 4, 2, 8)
    bt = np.array([[1, 2], [3, -1]], np.int32)
    lens = np.array([6, 3], np.int32)
    return (lambda: ops.paged_decode_attention(t(q), t(kp), t(vp), t(bt),
                                               t(lens)),
            lambda: [jops.paged_decode_attention(j(q), j(kp), j(vp), j(bt),
                                                 j(lens))])


@pytest.mark.parametrize("name", sorted(obs_est.KERNELS))
def test_wrapper_estimates_match_reference(name):
    """Each dispatch wrapper records, per grouped call, the sum of the
    estimates the JAX wrapper records for its leaves, under the same
    name."""
    _jax()
    from repro.obs import estimates as jest
    port, ref = _wrapper_calls(name, np.random.default_rng(0))
    with obs_est.collect() as c:
        port()
    with jest.collect() as jc:
        ref()
    got, want = c.snapshot()[name], jc.snapshot()[name]
    assert got["calls"] == 1
    for key in ("ops", "lds", "mem"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("comm", [None, CommSpec(compressor="int8",
                                                 gamma=0.95)],
                         ids=["exact", "ef_int8"])
def test_step_estimate_totals_match_reference(comm):
    """One DRGDA polar_fused k=1 step: for every kernel the JAX step
    records (fused_retract; quant_mix per leaf under EF-int8) the port's
    totals are equal; the port also records what the JAX package computes
    with plain ops (the ring mixes, the gradient's projection)."""
    jax = _jax()
    import jax.numpy as jnp
    from repro.comms.spec import CommSpec as JCommSpec
    from repro.core.gda import DRGDA as JDRGDA
    from repro.core.gda import GDAHyper as JHyper
    from repro.core.gossip import GossipSpec as JSpec
    from repro.obs import estimates as jest

    jspec = JSpec(n_nodes=N_NODES, k_steps=1, comm=None if comm is None
                  else JCommSpec(**dataclasses.asdict(comm)))
    jopt = JDRGDA(_jproblem(), jspec, JHyper(retraction="polar_fused"))
    js = jopt.init({"w": jnp.asarray(_x0())},
                   jnp.full((N_NODES, G), 1.0 / G), jnp.asarray(_batches()))
    with jest.collect() as jc:
        jax.block_until_ready(jax.jit(jopt.step)(js, jnp.asarray(
            _batches())))
    topt = DRGDA(_problem(), GossipSpec(n_nodes=N_NODES, k_steps=1,
                                        comm=comm),
                 GDAHyper(retraction="polar_fused"))
    b = torch.from_numpy(_batches())
    ts = topt.init({"w": torch.from_numpy(_x0())},
                   torch.full((N_NODES, G), 1.0 / G), b)
    with obs_est.collect() as c:
        topt.step(ts, b)
    want, got = jc.snapshot(), c.snapshot()
    assert set(want) == ({"fused_retract"} if comm is None
                         else {"fused_retract", "quant_mix"})
    for name in want:
        for key in ("ops", "lds", "mem"):
            assert got[name][key] == pytest.approx(want[name][key],
                                                   rel=1e-12), (name, key)
    extra = {"stiefel_project"} | ({"ring_mix"} if comm is None else set())
    assert set(got) == set(want) | extra


# ---------------------------------------------------------------------------
# counters against the JAX package
# ---------------------------------------------------------------------------


LEAVE_REJOIN = ElasticSpec(churn=ChurnSchedule(
    kind="scripted", events=((10, "leave", 3), (30, "join", 3))))
COUNTER_CASES = {
    # name: (n, k, comm, elastic, steps)
    "ring_k1": (N_NODES, 1, None, None, 3),
    "ring_k3": (N_NODES, 3, None, None, 3),
    "ef_int8": (N_NODES, 1, CommSpec(compressor="int8", gamma=0.9), None, 3),
    "faulty_channel": (N_NODES, 2, CommSpec(drop_rate=0.3,
                                            straggler_rate=0.2, seed=4),
                       None, 4),
    # the elastic reference's leave-and-rejoin (8-node ring, k = 1, node 3
    # away for rounds 10-29), through the rejoin
    "elastic_leave_rejoin": (8, 1, None, LEAVE_REJOIN, 32),
}


def _jax_elastic(elastic):
    from repro.comms import elastic as je
    ch = elastic.churn
    return je.ElasticSpec(churn=je.ChurnSchedule(
        kind=ch.kind, events=ch.events, leave_rate=ch.leave_rate,
        join_rate=ch.join_rate), tau=elastic.tau, drop_rate=elastic.drop_rate,
        straggler_rate=elastic.straggler_rate, seed=elastic.seed)


@pytest.mark.parametrize("case", sorted(COUNTER_CASES))
def test_counters_match_reference(case, tmp_path):
    """DRGDA's counters after a few steps equal the JAX package's: rounds
    and hops exactly, the byte and link counts within 1e-6 relative."""
    jax = _jax()
    import jax.numpy as jnp
    from _jax_draws import ElasticJaxDraws, JaxDraws
    from repro.comms.spec import CommSpec as JCommSpec
    from repro.core.gda import DRGDA as JDRGDA
    from repro.core.gda import GDAHyper as JHyper
    from repro.core.gossip import GossipSpec as JSpec
    from repro.obs import Telemetry as JTelemetry
    from repro.obs import unpack as junpack

    n, k, comm, elastic, steps = COUNTER_CASES[case]
    jcomm = None if comm is None else JCommSpec(**dataclasses.asdict(comm))
    jel = None if elastic is None else _jax_elastic(elastic)
    draws = (ElasticJaxDraws(jel) if elastic is not None
             else JaxDraws(comm) if comm is not None else None)
    jtel = JTelemetry(run="j", out_dir=str(tmp_path / "j"), flush_every=10**6)
    tel = Telemetry(run="t", out_dir=str(tmp_path / "t"), flush_every=10**6)
    jopt = JDRGDA(_jproblem(), JSpec(n_nodes=n, k_steps=k, comm=jcomm,
                                     elastic=jel), JHyper(), telemetry=jtel)
    topt = DRGDA(_problem(), GossipSpec(n_nodes=n, k_steps=k, comm=comm,
                                        elastic=elastic), GDAHyper(),
                 draws=draws, telemetry=tel)
    x0, b = _x0(n), _batches(n)
    y0 = np.full((n, G), 1.0 / G, np.float32)
    js = jopt.init({"w": jnp.asarray(x0)}, jnp.asarray(y0), jnp.asarray(b))
    ts = topt.init({"w": torch.from_numpy(x0)}, torch.from_numpy(y0),
                   torch.from_numpy(b))
    jstep = jax.jit(jopt.step)
    checked = 0
    for t in range(steps):
        js, _ = jstep(js, jnp.asarray(b))
        ts, _ = topt.step(ts, torch.from_numpy(b))
        if t + 1 in (2, 12, steps):
            got, want = unpack(ts.obs), junpack(js.obs)
            assert got.rounds == want.rounds and got.hops == want.hops, t
            for key in ("wire_bytes", "raw_bytes", "active_links",
                        "dropped_links"):
                assert getattr(got, key) == pytest.approx(
                    getattr(want, key), rel=FLOAT_RTOL, abs=0), (t, key)
            checked += 1
    assert checked >= 2
    final = unpack(ts.obs)
    # the drawn terms hold the faulty channel's and the elastic rounds'
    # counts, and stay zero where nothing draws
    assert bool(ts.obs.drawn.any()) == (comm is not None and not
                                        comm.compressed or elastic
                                        is not None)
    if case == "faulty_channel":
        assert final.dropped_links > 0
    elif case == "elastic_leave_rejoin":
        # node 3's two links carried nothing for 20 rounds of 4 mixes
        assert final.dropped_links == 0
        assert final.active_links == final.hops * n - 20 * 4 * 2
    else:
        assert final.dropped_links == 0


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------


def test_hardware_models_and_place():
    assert roofline.get_hardware().name == "h100"
    assert roofline.get_hardware("h100_bf16").peak_flops == 989e12
    with pytest.raises(ValueError):
        roofline.get_hardware("tpu_v5e")
    hw = roofline.get_hardware()
    assert (hw.peak_flops, hw.hbm_bw) == (67e12, 3.35e12)
    assert roofline.HARDWARE["h100_tf32x3"].peak_flops == 495e12 / 3
    hot = obs_est.Estimates(ops=1e12, lds=1e6, mem=1e6)
    cold = obs_est.Estimates(ops=1e6, lds=1e9, mem=1e9)
    assert roofline.place(hot, hw)["bound"] == "compute"
    p = roofline.place(cold, hw)
    assert p["bound"] == "memory"
    assert p["attainable_flops"] == pytest.approx(hw.hbm_bw * cold.intensity)
    assert p["time_s"] == pytest.approx(cold.ops / p["attainable_flops"])


@pytest.mark.parametrize("hw_name", sorted(roofline.HARDWARE))
def test_place_matches_reference(hw_name):
    """``place`` gives the JAX package's numbers on the same estimates and
    hardware figures."""
    _jax()
    from repro.launch import roofline as jroof
    from repro.obs.estimates import Estimates as JEstimates

    hw = roofline.get_hardware(hw_name)
    jhw = jroof.HardwareModel(hw.name, peak_flops=hw.peak_flops,
                              hbm_bw=hw.hbm_bw, ici_bw=hw.ici_bw,
                              vmem_bytes=hw.vmem_bytes)
    for est in (obs_est.stiefel_project_est(784, 64, lead=20),
                obs_est.fused_retract_est(784, 64, lead=20),
                obs_est.ring_mix_est(20 * 51459),
                obs_est.flash_attention_est(1, 256, 256, 9, 64)):
        want = jroof.place(JEstimates(est.ops, est.lds, est.mem), jhw)
        assert roofline.place(est, hw) == want
