"""Decentralized LM training in the port, held against the JAX package on
the CPU, from the same NumPy inputs.

* ``TokenStream`` batches equal the JAX package's byte for byte;
  ``SMOKE``/``CONFIG`` of smollm-135m equal its configs in every field the
  port has (``comm_spec()`` included);
* the group-DRO objective (``objectives/lm.py``): ``token_ce`` (both
  impls, the padded-vocab mask), ``group_losses`` (a group absent from
  the batch), ``lm_minimax_loss`` with its gradients in x and y, and
  ``lm_y_star``, within 1e-5, at ``SMOKE`` from the JAX initial weights;
* ``build_trainer`` + ``init_train_state`` + 3 DRSGDA steps (fresh
  minibatches) and 3 DRGDA steps (one fixed batch) on 4 nodes: loss,
  ``grad_norm_x`` and ``consensus_x`` at every step, then M_t and every
  parameter and y, within 1e-5 of the JAX trainer (one jitted step per
  optimizer, built once per module);
* ``launch.train.main`` on the CPU with telemetry, checkpoints and elastic
  churn; the builders' refusals; ``abstract_params`` and
  ``lm_params_from_seed`` against the JAX package's parameter tree; the
  manifold map against the JAX problem's.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.metric import convergence_metric as jmetric  # noqa: E402
from repro.data.synthetic import TokenStream as JTokenStream  # noqa: E402
from repro.launch.steps import build_trainer as jbuild  # noqa: E402
from repro.launch.steps import init_train_state as jinit  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.objectives import lm as jlm  # noqa: E402
from repro_torch import checkpoint, configs  # noqa: E402
from repro_torch.configs import uniform_stages  # noqa: E402
from repro_torch.convert import (lm_batch_to_torch,  # noqa: E402
                                 lm_params_from_seed,
                                 transformer_params_from_reference,
                                 tree_to_reference)
from repro_torch.core.gda import broadcast_to_nodes  # noqa: E402
from repro_torch.core.metric import convergence_metric  # noqa: E402
from repro_torch.data.synthetic import TokenStream  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.steps import (TrainSpec, build_trainer,  # noqa: E402
                                      init_train_state)
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.objectives import lm  # noqa: E402
from repro_torch.tree import tree_flatten_with_path  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

TOL = 1e-5
N_NODES, BATCH, SEQ, STEPS = 4, 2, 16, 3


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.fixture(scope="module")
def smoke():
    """The SMOKE configs of both packages and the JAX initial weights."""
    jcfg = jconfigs.get_config("smollm-135m", smoke=True)
    cfg = configs.get_config("smollm-135m", smoke=True)
    raw = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0),
                                                  jcfg))
    return jcfg, cfg, raw


def _leaves(tree) -> dict:
    paths, leaves, _ = tree_flatten_with_path(tree)
    return dict(zip(paths, leaves))


# ---------------------------------------------------------------------------
# data and configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(n_nodes=4, batch_per_node=3, seq_len=17, vocab_size=256,
         n_groups=4, seed=0),
    dict(n_nodes=2, batch_per_node=2, seq_len=5, vocab_size=50, n_groups=3,
         n_codebooks=2, hetero=0.3, seed=7)])
def test_token_stream_batches_equal_the_reference(kw):
    port, ref = TokenStream(**kw), JTokenStream(**kw)
    for step in (0, 1, 9):
        got, want = port.batch(step), ref.batch(step)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes()


def _same_fields(port, ref, where: str) -> None:
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            _same_fields(a, b, f"{where}.{f.name}")
        elif isinstance(a, tuple) and a and dataclasses.is_dataclass(a[0]):
            assert len(a) == len(b), f"{where}.{f.name}"
            for i, (x, y) in enumerate(zip(a, b)):
                _same_fields(x, y, f"{where}.{f.name}[{i}]")
        else:
            assert a == b, (f"{where}.{f.name}", a, b)


@pytest.mark.parametrize("smoke_cfg", [False, True], ids=["CONFIG", "SMOKE"])
def test_configs_equal_the_reference(smoke_cfg):
    port = configs.get_config("smollm-135m", smoke=smoke_cfg)
    ref = jconfigs.get_config("smollm-135m", smoke=smoke_cfg)
    _same_fields(port, ref, port.name)
    assert port.comm_spec() is None and ref.comm_spec() is None
    knobs = dict(comm_compressor="int8", comm_gamma=0.95, comm_drop_rate=0.05)
    got = dataclasses.asdict(dataclasses.replace(port, **knobs).comm_spec())
    want = dataclasses.asdict(dataclasses.replace(ref, **knobs).comm_spec())
    assert {k: v for k, v in want.items() if k in got} == got


def test_parameter_trees_match_the_reference(smoke):
    """abstract_params and lm_params_from_seed have the JAX tree's paths
    and shapes; the seeded attention leaves are orthonormal."""
    jcfg, cfg, raw = smoke
    want = {p: v.shape for p, v in _leaves(raw).items()}
    assert {p: tuple(v.shape) for p, v in
            _leaves(T.abstract_params(cfg)).items()} == want
    seeded = _leaves(lm_params_from_seed(cfg, 0))
    assert {p: v.shape for p, v in seeded.items()} == want
    assert all(v.dtype == np.float32 for v in seeded.values())
    wk = seeded["stages/s0/b0/attn/wk"][0]
    _close(wk.T @ wk, np.eye(wk.shape[1]), 1e-5)
    assert abs(seeded["embed"].std() - 0.02) < 2e-3
    again = _leaves(lm_params_from_seed(cfg, 0))
    assert all(np.array_equal(v, again[p]) for p, v in seeded.items())


def test_manifold_map_matches_the_reference(smoke):
    jcfg, cfg, raw = smoke
    jopt, _ = jbuild(jcfg, N_NODES)
    _, problem = build_trainer(cfg, N_NODES)
    jflat = jax.tree_util.tree_flatten_with_path(jopt.problem.manifold_map)[0]
    want = {"/".join(str(k.key) for k in path): m.name for path, m in jflat}
    assert {p: m.name for p, m in _leaves(problem.manifold_map).items()} \
        == want
    assert sorted(p for p, n in want.items() if n == "stiefel") == [
        f"stages/s0/b0/attn/{w}" for w in ("wk", "wo", "wq", "wv")]


# ---------------------------------------------------------------------------
# the objective
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["gather", "dot"])
def test_token_ce_matches_the_reference(impl):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 5, 40)).astype(np.float32) * 3
    targets = rng.integers(0, 33, size=(3, 5)).astype(np.int32)
    for true_vocab in (0, 33):
        got = lm.token_ce(torch.from_numpy(logits),
                          torch.from_numpy(targets).long(), impl=impl,
                          true_vocab=true_vocab)
        want = jlm.token_ce(jnp.asarray(logits), jnp.asarray(targets),
                            impl=impl, true_vocab=true_vocab)
        _close(got, want)


def test_group_losses_match_the_reference():
    per_seq = np.array([1.0, 2.5, 0.5, 4.0, 3.0], np.float32)
    gids = np.array([0, 2, 2, 0, 3], np.int32)         # group 1 absent
    got = lm.group_losses(torch.from_numpy(per_seq),
                          torch.from_numpy(gids).long(), 4)
    want = jlm.group_losses(jnp.asarray(per_seq), jnp.asarray(gids), 4)
    _close(got, want)
    assert float(got[1]) == pytest.approx(float(per_seq.mean()))


def test_loss_gradients_and_y_star_match_the_reference(smoke):
    jcfg, cfg, raw = smoke
    stream = TokenStream(N_NODES, BATCH, SEQ, cfg.vocab_size,
                         n_groups=cfg.n_groups, seed=3)
    b = stream.batch(0)
    one = {k: v[0] for k, v in b.items()}
    y = np.array([0.1, 0.4, 0.3, 0.2], np.float32)
    params = transformer_params_from_reference(raw, "cpu")
    loss_fn = torch.func.grad_and_value(
        lambda x, y_: lm.lm_minimax_loss(x, y_, lm_batch_to_torch(one, "cpu"),
                                         cfg), argnums=(0, 1))
    (gx, gy), val = loss_fn(params, torch.from_numpy(y))
    jb = {k: jnp.asarray(v) for k, v in one.items()}
    jval, (jgx, jgy) = jax.jit(jax.value_and_grad(
        lambda x, y_: jlm.lm_minimax_loss(x, y_, jb, jcfg),
        argnums=(0, 1)))(raw, jnp.asarray(y))
    _close(val, jval)
    _close(gy, jgy)
    for p, g in _leaves(tree_to_reference(gx)).items():
        _close(g, _leaves(jax.tree.map(np.asarray, jgx))[p])
    got = lm.lm_y_star(params, lm_batch_to_torch(b, "cpu"), cfg)
    want = jax.jit(lambda x, bb: jlm.lm_y_star(x, bb, jcfg))(
        raw, {k: jnp.asarray(v) for k, v in b.items()})
    _close(got, want)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("optimizer", ["drsgda", "drgda"])
def test_trainer_matches_the_reference(smoke, optimizer):
    """3 steps on 4 nodes from the JAX initial weights (each package
    projects them onto the manifold itself): DRSGDA on fresh minibatches,
    DRGDA on one fixed batch."""
    jcfg, cfg, raw = smoke
    stream = TokenStream(N_NODES, BATCH, SEQ, cfg.vocab_size,
                         n_groups=cfg.n_groups, seed=0)
    batches = [stream.batch(0 if optimizer == "drgda" else t)
               for t in range(STEPS + 1)]

    def jb(b):
        return {k: jnp.asarray(v) for k, v in b.items()}

    jopt, jproblem = jbuild(jcfg, N_NODES, optimizer=optimizer)
    jstate = jinit(jax.random.PRNGKey(0), jcfg, jopt, N_NODES,
                   jb(batches[0]))
    jstep = jopt.make_step(donate=False)
    opt, problem = build_trainer(cfg, N_NODES, TrainSpec(optimizer=optimizer))
    state = init_train_state(None, cfg, opt, N_NODES,
                             lm_batch_to_torch(batches[0], "cpu"),
                             params=transformer_params_from_reference(
                                 raw, "cpu"))
    for t in range(1, STEPS + 1):
        jstate, jm = jstep(jstate, jb(batches[t]))
        state, m = opt.step(state, lm_batch_to_torch(batches[t], "cpu"))
        for key in ("loss", "grad_norm_x", "consensus_x"):
            _close(getattr(m, key), getattr(jm, key))
    want = _leaves(jax.tree.map(np.asarray, jstate.x))
    for p, x in _leaves(tree_to_reference(state.x)).items():
        _close(x, want[p])
    _close(state.y, jstate.y)
    got = convergence_metric(problem, state.x, state.y,
                             lm_batch_to_torch(batches[-1], "cpu"))
    ref = jmetric(jproblem, jstate.x, jstate.y, jb(batches[-1]))
    for key in ("M_t", "consensus_x", "dist_y_star"):
        _close(got[key], ref[key])


def test_builders_refuse_what_the_port_does_not_run():
    cfg = configs.get_config("smollm-135m", smoke=True)
    with pytest.raises(NotImplementedError, match="queue 1, item 7"):
        build_trainer(cfg, 2, mix_backend="shard_map")
    with pytest.raises(NotImplementedError):
        build_trainer(cfg, 2, mesh=object())
    with pytest.raises(ValueError, match="unknown mix backend"):
        build_trainer(cfg, 2, mix_backend="ring")
    opt, _ = build_trainer(cfg, 2, mix_backend="stacked")
    assert opt.gossip.n_nodes == 2 and opt.k == 1


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_train_cli_writes_events_and_checkpoints(tmp_path, capsys):
    tel, ckpt = tmp_path / "tel", tmp_path / "ckpt"
    rc = train.main(["--device", "cpu", "--smoke", "--steps", "4", "--nodes",
                     "2", "--batch-per-node", "2", "--seq-len", "16",
                     "--eval-every", "2", "--telemetry", "--telemetry-dir",
                     str(tel), "--telemetry-run", "lm", "--checkpoint-dir",
                     str(ckpt), "--checkpoint-every", "2"])
    assert rc == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    steps = [r for r in rows if "step" in r]
    assert [r["step"] for r in steps] == [2, 4]
    assert all(np.isfinite(r["loss"]) and r["stiefel_residual"] < 1e-2
               for r in steps)
    events = [json.loads(line) for line in
              (tel / "lm.events.jsonl").read_text().splitlines()]
    kinds = [e["type"] for e in events]
    assert kinds.count("dashboard") == 2 and kinds.count("counters") == 2
    spans = json.loads((tel / "lm.trace.json").read_text())
    names = {e.get("name") for e in spans["traceEvents"]}
    assert {"init", "train", "eval", "checkpoint"} <= names
    assert checkpoint.latest_step(str(ckpt)) == 4
    cfg = configs.get_config("smollm-135m", smoke=True)
    like = broadcast_to_nodes(
        T.init_params(torch.Generator().manual_seed(0), cfg), 2)
    x = checkpoint.restore(str(ckpt), 4, like, device="cpu")
    assert x["embed"].shape == (2, cfg.vocab_size, cfg.d_model)


def test_train_cli_elastic_churn_logs_membership(tmp_path):
    tel = tmp_path / "tel"
    rc = train.main(["--device", "cpu", "--smoke", "--steps", "4", "--nodes",
                     "4", "--batch-per-node", "1", "--seq-len", "8",
                     "--eval-every", "2", "--churn", "random",
                     "--churn-leave-rate", "0.3", "--tau", "1",
                     "--telemetry", "--telemetry-dir", str(tel),
                     "--telemetry-run", "el"])
    assert rc == 0
    members = [json.loads(line) for line in
               (tel / "el.events.jsonl").read_text().splitlines()
               if '"membership"' in line]
    assert [e["step"] for e in members] == [2, 4]
    assert all(len(e["data"]["active"]) == 4 for e in members)


def test_reference_comparison_gates_every_point():
    """The recorded run held against itself is within every gate; a point
    moved past its gate is reported."""
    ref = train.load_reference()
    same = {"steps": ref["steps"], "evals": ref["evals"]}
    assert train.within_reference(train.compare_to_reference(same, ref))
    moved = json.loads(json.dumps(same))
    moved["steps"][3]["loss"] *= 1.0 + 2 * ref["tolerance"]["steps"]["loss"][3]
    comparison = train.compare_to_reference(moved, ref)
    assert not train.within_reference(comparison)
    assert comparison["steps"]["loss"]["over"][0][0] == 4


def test_reference_residual_gate_reports_a_drift():
    """The Stiefel residual's gate is ten times the port's CPU gap, of the
    residual's own size, not the 1e-4 floor five times above it: a run
    whose residual reads three times the recorded one is reported (the
    streaming projection with its products accumulated in the mma read
    3.9 times on the card)."""
    ref = train.load_reference()
    gates = ref["tolerance"]["evals"]["stiefel_residual"]
    assert all(g < 2 * e["stiefel_residual"]
               for g, e in zip(gates, ref["evals"]))
    drifted = json.loads(json.dumps({"steps": ref["steps"],
                                     "evals": ref["evals"]}))
    drifted["evals"][-1]["stiefel_residual"] *= 3.0
    comparison = train.compare_to_reference(drifted, ref)
    assert comparison["evals"]["stiefel_residual"]["over"][0][0] == \
        ref["evals"][-1]["step"]


@pytest.mark.parametrize("variant", ["shipped", "accumulated in the mma",
                                     "accumulated in the mma, lo lo"])
def test_projection_accuracy_variants_apply_to_the_shipped_header(variant):
    """Each variant of ``launch/project_accuracy.py`` edits text that occurs
    once, in turn, in the shipped ``csrc/tall.cuh``."""
    from repro_torch.kernels import build
    from repro_torch.launch.project_accuracy import VARIANTS

    text = (build.CSRC / "tall.cuh").read_text()
    for old, new in VARIANTS[variant]:
        assert text.count(old) == 1
        text = text.replace(old, new)
    assert ("part[mt][nt]" in text) == (variant == "shipped")


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "deepseek-v2-236b",
                                  "smollm-135m"])
def test_reference_config_keeps_the_published_pattern(arch):
    """A cut in depth takes the distinct blocks of the published pattern
    in turn, as the recording script cuts it (``tests/_reference_curves.
    py`` ``lm_config``): zamba2-2.7b a Mamba2 block, then attention;
    deepseek-v2-236b a dense MLA layer, then MoE; a uniform configuration
    one stacked stage."""
    import _reference_curves as rc

    settings = {"arch": arch, "n_layers": 2, "smoke": False}
    cfg = train.reference_config(settings)
    want = rc.lm_config(settings)
    assert [b.kind for b in cfg.flat_blocks()] == \
        [b.kind for b in want.flat_blocks()]
    assert [(len(st.blocks), st.repeat) for st in cfg.stages] == \
        [(len(st.blocks), st.repeat) for st in want.stages]
    assert cfg.name == want.name == f"{arch}-2L"
    kinds = {"zamba2-2.7b": ["mamba", "attn"],
             "deepseek-v2-236b": ["attn", "moe_attn"],
             "smollm-135m": ["attn", "attn"]}[arch]
    assert [b.kind for b in cfg.flat_blocks()] == kinds
    assert cfg.d_model == configs.get_config(arch).d_model


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "musicgen-large",
                                  "deepseek-v2-236b", "llama-3.2-vision-11b",
                                  "zamba2-2.7b", "xlstm-1.3b"])
def test_models_reference_gates_every_run(arch):
    """Each recorded run of ``tests/data/lm_models_reference.json`` held
    against itself is within every gate; its settings name the recorded
    size, and a configuration cut in depth is rebuilt as it was recorded
    (two layers of its first block: the uniform ones keep one stacked
    stage); a gated loss point moved past its gate is reported; the gates
    follow the recipe (max(10x spread, 10x the CPU gap, 1e-4) while the
    spread stays under 1e-3, null after)."""
    ref = train.load_reference(arch)
    s = ref["settings"]
    assert s["arch"] == arch and s["n_nodes"] == 4 and s["steps"] == 10
    cfg = train.reference_config(s)
    assert cfg.name.endswith("-smoke") == bool(s["smoke"])
    assert s["smoke"] or (cfg.n_layers, s["n_layers"]) == (2, 2)
    if not s["smoke"]:
        first = configs.get_config(arch).stages[0].blocks[0]
        assert cfg.stages == uniform_stages(first, 2)
    same = {"steps": ref["steps"], "evals": ref["evals"]}
    assert train.within_reference(train.compare_to_reference(same, ref))
    gates = ref["tolerance"]["steps"]["loss"]
    spread = ref["spread"]["steps"]["loss"]
    for i, (g, sp) in enumerate(zip(gates, spread)):
        if all(x <= 1e-3 for x in spread[:i + 1]):
            assert g >= max(10 * sp, 1e-4)
        else:
            assert g is None
    i = next(i for i, g in enumerate(gates) if g is not None)
    moved = json.loads(json.dumps(same))
    moved["steps"][i]["loss"] *= 1.0 + 2 * gates[i]
    assert not train.within_reference(train.compare_to_reference(moved,
                                                                 ref))
