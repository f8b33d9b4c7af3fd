"""The port's comms engine against the JAX package's, on the same inputs.

Randomness: the port's engine takes its draws from a draw source; here
:class:`JaxDraws` hands it the JAX package's own draws (the same key
derivation: ``fold_in(fold_in(PRNGKey(seed), crc32(slot)), rnd)``, split
into quantization and channel keys, then per leaf or per hop), with conv
leaves transposed HWIO -> OIHW as the weights are.

Tolerances:

* ``quantize_det``, ``Int8Stochastic``, ``TopK``, ``ChannelModel.w_t`` and
  ``link_stats``: equal.
* ``LowRank``: 1e-5 (QR and the sketch products are LAPACK / BLAS calls
  that round in their own order in each package).
* one ``CommEngine.mix`` round on a clean ring, int8 and top-k, fixed and
  adaptive gamma, ``quant_hops`` first and all (the int8 first hop one
  ``quant_ring_hop_leaves`` call per tree, with or without error
  feedback, at n = 5 and on the 2-node ring): bitwise against the JAX
  engine run eagerly (``jax.disable_jit()``: under ``jit`` XLA:CPU
  contracts the ring combine into an FMA).  Low-rank: 1e-5, as above.  A
  faulty channel: 1e-6 (the effective W_t is applied by einsum, a BLAS
  product in each package).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.comms import compress as jcompress  # noqa: E402
from repro.comms import layer as jlayer  # noqa: E402
from repro.comms.channel import ChannelModel as JChannel  # noqa: E402
from repro.comms.spec import CommSpec as JCommSpec  # noqa: E402
from repro.core.gossip import GossipSpec as JGossip  # noqa: E402
from _jax_draws import JaxDraws  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.comms import compress  # noqa: E402
from repro_torch.comms.channel import ChannelModel  # noqa: E402
from repro_torch.comms.compress import DrawKey  # noqa: E402
from repro_torch.comms.layer import CommEngine, make_mixer  # noqa: E402
from repro_torch.comms.spec import CommSpec  # noqa: E402
from repro_torch.core.gossip import GossipSpec  # noqa: E402

_TO_OIHW = (0, 4, 3, 1, 2)
_TO_HWIO = (0, 3, 4, 2, 1)


def _np(t):
    return t.detach().cpu().numpy()


def _jtree(rng, n):
    """A node-stacked tree in the JAX package's layout (conv kernels HWIO),
    the fair CNN's leaves at a narrow width."""
    shapes = {"conv1": (n, 3, 3, 1, 2), "conv2": (n, 3, 3, 5, 6),
              "fc1": (n, 12, 6), "head": (n, 6, 3)}
    return {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}


def _assert_tree(got, want, atol=0.0):
    got = convert.params_to_reference(got) if isinstance(got, dict) \
        else _np(got)
    if isinstance(want, dict):
        for k in want:
            _close(got[k], np.asarray(want[k]), atol, k)
    else:
        _close(got, np.asarray(want), atol, "leaf")


def _close(got, want, atol, what):
    if atol == 0.0:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=what)


# ---------------------------------------------------------------------------
# compressors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(4, 7), (3, 2, 5, 4), (5, 1)])
def test_quantize_det_bitwise(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape).astype(np.float32)
    x[0] = 0.0                              # an all-zero row: the 1e-12 floor
    row = x.reshape(shape[0], -1)[1]
    if row.size >= 3:                       # scale 1: ties round to even
        row[:3] = [127.0, 0.5, -2.5]
    jq, js = jcompress.quantize_det(jnp.asarray(x))
    q, s = compress.quantize_det(torch.from_numpy(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(_np(q), np.asarray(jq))
    np.testing.assert_array_equal(_np(s), np.asarray(js))


@pytest.mark.parametrize("shape", [(4, 9), (3, 2, 1, 3, 3), (5, 12, 6)])
def test_int8_stochastic_bitwise_with_injected_draws(shape):
    rng = np.random.default_rng(len(shape))
    x = rng.normal(size=shape).astype(np.float32)
    comm = CommSpec(compressor="int8", seed=3)
    key = DrawKey(JaxDraws(comm), "u", 2).fold_in(1)
    jkey = jax.random.fold_in(JaxDraws(comm)._round("u", 2)[0], 1)
    jx = x.transpose(_TO_HWIO) if x.ndim == 5 else x
    jq, js = jcompress.Int8Stochastic().quantize(jkey, jnp.asarray(jx))
    q, s = compress.Int8Stochastic().quantize(key, torch.from_numpy(x))
    jq = np.asarray(jq)
    np.testing.assert_array_equal(
        _np(q), jq.transpose(_TO_OIHW) if x.ndim == 5 else jq)
    np.testing.assert_array_equal(_np(s).ravel(), np.asarray(js).ravel())
    deq = compress.Int8Stochastic()(key, torch.from_numpy(x))
    np.testing.assert_array_equal(_np(deq), _np(q.float() * s))


def test_topk_equal_and_lowrank_close():
    rng = np.random.default_rng(5)
    jt = _jtree(rng, 3)
    tt = convert.params_from_reference(jt, "cpu")
    comm = CommSpec(compressor="lowrank", rank=4, seed=1)
    draws = JaxDraws(comm)
    key = DrawKey(draws, "x", 0)
    jkey = draws._round("x", 0)[0]
    for comp, jcomp, atol in ((compress.TopK(0.2), jcompress.TopK(0.2), 0.0),
                              (compress.LowRank(4), jcompress.LowRank(4),
                               1e-5)):
        got = compress.compress_tree(comp, key, tt)
        want = jcompress.compress_tree(jcomp, jkey,
                                       {k: jnp.asarray(v) for k, v in jt.items()})
        _assert_tree(got, want, atol)
        assert compress.tree_bits(comp, tt) == jcompress.tree_bits(jcomp, jt)
    # the sketch changed the eligible leaves (fc1, and conv2 in the HWIO
    # view), and left the others alone
    got = compress.compress_tree(compress.LowRank(4), key, tt)
    assert not torch.equal(got["conv2"], tt["conv2"])
    assert torch.equal(got["conv1"], tt["conv1"])


# ---------------------------------------------------------------------------
# channel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 5])
@pytest.mark.parametrize("error_feedback", [True, False])
@pytest.mark.parametrize("quant_hops,k", [("first", 1), ("all", 3)])
def test_engine_first_hop_takes_one_backend_call_per_tree(
        monkeypatch, n, error_feedback, quant_hops, k):
    """The int8 first hop of a slot's tree, with error feedback's exact hop
    of the old public copies fused in, is ONE ``quant_ring_hop_leaves``
    call over all its leaves (one grouped ``quant_mix`` launch on the card,
    no ``ring_mix`` of the hats and no per-leaf add), and the round still
    matches the JAX engine bit for bit; a 2-node ring too, whose hat hop
    keeps ``mix_ring``'s own expression."""
    from repro_torch.comms.backend import StackedBackend
    from repro_torch.kernels import ops
    calls, rings = [], []
    grouped = StackedBackend.quant_ring_hop_leaves
    ring_leaves = ops.ring_mix_leaves

    def spy(self, spec, qs, scales, base=None):
        calls.append((len(qs), base is not None))
        return grouped(self, spec, qs, scales, base)

    def ring_spy(xs, **kw):
        rings.append(len(xs))
        return ring_leaves(xs, **kw)

    monkeypatch.setattr(StackedBackend, "quant_ring_hop_leaves", spy)
    monkeypatch.setattr(ops, "ring_mix_leaves", ring_spy)
    comm = CommSpec(compressor="int8", gamma=0.8, quant_hops=quant_hops,
                    error_feedback=error_feedback, seed=5)
    je, te = _engines(comm, n, k)
    rng = np.random.default_rng(13 + n)
    slots = _slots(rng, n)
    js = je.init_state({s: jax.tree.map(jnp.asarray, t)
                        for s, t in slots.items()})
    ts = te.init_state({s: _to_port(t) for s, t in slots.items()})
    for rnd in range(2):
        calls.clear()
        for slot, tree in slots.items():
            jout, js = _jround(je, js, slot, tree, k, rnd)
            tout, ts = te.mix(ts, slot, _to_port(tree), steps=k, rnd=rnd)
            _assert_tree(tout, jout)
            _assert_tree(ts.hats[slot], js.hats[slot])
        assert calls == [(4, error_feedback), (1, error_feedback)]
    # the hats' exact hop is inside the grouped int8 call (n > 2) or
    # mix_ring's own expression (n = 2): never a ring_mix call
    assert rings == []


@pytest.mark.parametrize("comm", [
    CommSpec(drop_rate=0.3), CommSpec(straggler_rate=0.25),
    CommSpec(schedule="round_robin"), CommSpec(schedule="matching"),
    CommSpec(drop_rate=0.2, straggler_rate=0.2, schedule="matching", seed=4),
])
@pytest.mark.parametrize("topology", ["ring", "full"])
def test_channel_w_t_with_injected_masks(comm, topology):
    n = 6
    jg = JGossip(topology=topology, n_nodes=n, comm=JCommSpec(
        **dataclasses.asdict(comm)))
    jch = JChannel.for_gossip(jg, jg.comm)
    ch = ChannelModel.for_gossip(GossipSpec(topology=topology, n_nodes=n),
                                 comm)
    assert ch.n_subsets == jch.n_subsets and ch.lam2 == jch.lam2
    draws = JaxDraws(comm, ch)
    for rnd in range(4):
        for hop in range(2):
            key = DrawKey(draws, "x/chan", rnd).fold_in(hop)
            jkey = jax.random.fold_in(draws._round("x", rnd)[1], hop)
            wt = _np(ch.w_t(rnd * 2 + hop, key))
            np.testing.assert_array_equal(wt, np.asarray(
                jch.w_t(rnd * 2 + hop, jkey)))
            np.testing.assert_allclose(wt.sum(0), 1.0, atol=1e-6)
            np.testing.assert_array_equal(wt, wt.T)
            for a, b in zip(ch.link_stats(rnd * 2 + hop, key),
                            jch.link_stats(rnd * 2 + hop, jkey)):
                assert float(a) == float(b)


def test_trivial_channel_is_the_ring_path():
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(5, 7)).astype(np.float32))
    ch = ChannelModel.for_gossip(GossipSpec(n_nodes=5), CommSpec())
    assert ch.trivial
    key = DrawKey(compress.GeneratorDraws(0), "x/chan", 0)
    want = GossipSpec(n_nodes=5).mix(x, steps=3)
    assert torch.equal(ch.mix(x, 0, key, steps=3), want)
    rate = ChannelModel.for_gossip(GossipSpec(n_nodes=8), CommSpec(
        drop_rate=0.3)).empirical_mixing_rate(rounds=16)
    assert 0.0 < rate["per_round_rate"] < 1.0


def test_generator_draws_are_stateless_per_round():
    draws = compress.GeneratorDraws(7)
    a = draws.uniform("x", 3, 1, (4, 5), "cpu")
    draws.uniform("y", 3, 1, (4, 5), "cpu")
    assert torch.equal(a, draws.uniform("x", 3, 1, (4, 5), "cpu"))
    assert not torch.equal(a, draws.uniform("x", 4, 1, (4, 5), "cpu"))
    assert not torch.equal(a, draws.uniform("x", 3, 2, (4, 5), "cpu"))
    assert torch.equal(a, compress.GeneratorDraws(7, on_cpu=True).uniform(
        "x", 3, 1, (4, 5), "cpu"))
    assert 0.0 <= float(a.min()) and float(a.max()) < 1.0


# ---------------------------------------------------------------------------
# one engine round against the JAX engine
# ---------------------------------------------------------------------------


def _engines(comm: CommSpec, n: int, k: int):
    jg = JGossip(topology="ring", n_nodes=n, k_steps=k,
                 comm=JCommSpec(**dataclasses.asdict(comm)))
    je = jlayer.CommEngine(jg)
    tg = GossipSpec(topology="ring", n_nodes=n, k_steps=k, comm=comm)
    te = CommEngine(tg, draws=JaxDraws(comm, je.channel))
    return je, te


def _slots(rng, n):
    return {"x": _jtree(rng, n),
            "y": rng.dirichlet(np.ones(3), size=n).astype(np.float32)}


def _to_port(tree):
    if isinstance(tree, dict):
        return convert.params_from_reference(tree, "cpu")
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def _jround(je, js, slot, tree, steps, rnd):
    with jax.disable_jit():
        jtree = jax.tree.map(jnp.asarray, tree)
        return je.mix(js, slot, jtree, steps=steps, rnd=rnd)


@pytest.mark.parametrize("gamma_mode", ["fixed", "adaptive"])
@pytest.mark.parametrize("quant_hops", ["first", "all"])
@pytest.mark.parametrize("compressor", ["int8", "topk", "lowrank"])
def test_engine_round_matches_reference(compressor, quant_hops, gamma_mode):
    """Round 0 on the JAX engine gives a mid-run state (non-zero hats,
    tracked deltas); it is carried into the port (convert), and round 1
    runs on both from there."""
    n, k = 5, 3
    comm = CommSpec(compressor=compressor, gamma=0.8, gamma_mode=gamma_mode,
                    quant_hops=quant_hops, topk_frac=0.3, seed=2)
    je, te = _engines(comm, n, k)
    rng = np.random.default_rng(11)
    slots0, slots1 = _slots(rng, n), _slots(rng, n)
    js = je.init_state({s: jax.tree.map(jnp.asarray, t)
                        for s, t in slots0.items()})
    for slot, tree in slots0.items():
        _, js = _jround(je, js, slot, tree, k, 0)
    jhats = {s: jax.tree.map(np.asarray, t) for s, t in js.hats.items()}
    jdeltas = None if js.deltas is None else \
        {s: np.asarray(d) for s, d in js.deltas.items()}
    ts = convert.comm_state_from_reference(jhats, jdeltas, "cpu")
    back, back_deltas = convert.comm_state_to_reference(ts)
    for slot in jhats:
        _assert_tree(_to_port(back[slot]) if slot == "y"
                     else convert.params_from_reference(back[slot], "cpu"),
                     jhats[slot])
    atol = 1e-5 if compressor == "lowrank" else 0.0
    for slot, tree in slots1.items():
        steps = k if slot != "y" else 1
        jout, js = _jround(je, js, slot, tree, steps, 1)
        tout, ts = te.mix(ts, slot, _to_port(tree), steps=steps, rnd=1)
        _assert_tree(tout, jout, atol)
        _assert_tree(ts.hats[slot], js.hats[slot], atol)
        if gamma_mode == "adaptive":
            _close(_np(ts.deltas[slot]), np.asarray(js.deltas[slot]), atol,
                   "delta")
    port_x = _to_port(slots1["x"])
    assert te.bits_per_mix(port_x) == je.bits_per_mix(slots1["x"])
    assert te.wire_round_bytes(port_x, k) == je.wire_round_bytes(
        slots1["x"], k)


def test_engine_all_hops_take_one_backend_call_per_tree(monkeypatch):
    """Under ``quant_hops="all"`` the k - 1 tail hops of a slot's tree are
    ONE ``quant_ring_hops_leaves`` call over all its leaves (one grouped
    kernel launch on the card), and the round still matches the JAX
    engine bit for bit."""
    from repro_torch.comms.backend import StackedBackend
    calls = []
    grouped = StackedBackend.quant_ring_hops_leaves

    def spy(self, spec, xs, steps):
        calls.append((len(xs), steps))
        return grouped(self, spec, xs, steps)

    monkeypatch.setattr(StackedBackend, "quant_ring_hops_leaves", spy)
    n, k = 5, 3
    comm = CommSpec(compressor="int8", gamma=0.8, quant_hops="all", seed=4)
    je, te = _engines(comm, n, k)
    rng = np.random.default_rng(12)
    slots = _slots(rng, n)
    js = je.init_state({s: jax.tree.map(jnp.asarray, t)
                        for s, t in slots.items()})
    ts = te.init_state({s: _to_port(t) for s, t in slots.items()})
    for rnd in range(2):
        calls.clear()
        for slot, tree in slots.items():
            jout, js = _jround(je, js, slot, tree, k, rnd)
            tout, ts = te.mix(ts, slot, _to_port(tree), steps=k, rnd=rnd)
            _assert_tree(tout, jout)
            _assert_tree(ts.hats[slot], js.hats[slot])
        assert calls == [(4, k - 1), (1, k - 1)]


@pytest.mark.parametrize("comm", [
    CommSpec(drop_rate=0.3, seed=1),
    CommSpec(compressor="int8", gamma=0.9, drop_rate=0.2,
             straggler_rate=0.2, schedule="round_robin"),
])
def test_engine_round_over_a_faulty_channel(comm):
    n, k = 6, 2
    je, te = _engines(comm, n, k)
    tree = _slots(np.random.default_rng(3), n)["x"]
    js = je.init_state({"x": jax.tree.map(jnp.asarray, tree)})
    ts = te.init_state({"x": _to_port(tree)})
    for rnd in range(3):
        jout, js = _jround(je, js, "x", tree, k, rnd)
        tout, ts = te.mix(ts, "x", _to_port(tree), steps=k, rnd=rnd)
        _assert_tree(tout, jout, 1e-6)


def test_make_mixer_threads_the_state():
    n = 4
    comm = CommSpec(compressor="int8")
    spec = GossipSpec(n_nodes=n, k_steps=1, comm=comm)
    engine = CommEngine(spec)
    x = torch.randn(n, 6)
    state = engine.init_state({"x": x})
    mix, final = make_mixer(spec, engine, state, rnd=0)
    out = mix("x", x, 1)
    assert out.shape == x.shape and not torch.equal(final().hats["x"],
                                                    state.hats["x"])
    exact, none = make_mixer(GossipSpec(n_nodes=n, k_steps=1))
    assert torch.equal(exact("x", x, 2), GossipSpec(n_nodes=n).mix(x, 2))
    assert none() is None
    with pytest.raises(ValueError, match="enabled"):
        CommEngine(GossipSpec(n_nodes=n))
