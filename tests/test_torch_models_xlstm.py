"""xlstm-1.3b in the port (an mLSTM and an sLSTM block at ``SMOKE``),
against the JAX package from its initial weights
(``tests/_torch_model_parity.py``), and at 4 layers: the same supercell
repeated twice, so that the decode writes into views of the stacked
caches (``tests/test_models.py`` cuts a config the same way).

The parameter tree (``mlstm``: ``w_up``, ``conv``, ``wq``, ``wk``,
``wv``, ``w_if``, ``if_bias``, ``norm``, ``w_down``; ``slstm``: ``w_in``,
``r``, ``bias``, ``norm``, ``w_ff_gate``, ``w_ff_down``; no MLP and no
``ln2``) carried across and back.  At ``SMOKE``: train-mode logits over
40 tokens (two mLSTM chunks of 32, the second padded), prefill and 3
decode steps with every cache (``{C, n, m, conv}``, the sLSTM ``state``
tuple ``(c, n, h, m)``) within 1e-5 absolute (the logits; measured
3.6e-6 to 4.5e-6 at logits up to 5.1 over six draws,
``tests/_xlstm_logit_gap.py``), each cache leaf within 1e-5 of its
largest |value| (the sLSTM normalizer, summed over every token, reaches
about 10 and lies 1.6e-5 apart); greedy ``generate`` tokens equal.  At 4
layers the logits within 1e-5 of the largest |logit|: each package's
fp32 logits lie 8e-6 to 2.2e-5 from a float64 forward of the port, in
their own directions, and 7.9e-6 to 2.3e-5 from each other (5.7e-6 of
the largest |logit| at most), so an absolute 1e-5 would judge two
roundings.  The port's decode against its own teacher-forced forward
within 5e-5 (the zamba2 test's rule).  In float64 (the 4-layer weights
cast; the cells then keep their gates and states in float64) the decode
from a prefill on the recurrence lies within 1e-10 of the teacher-forced
forward on the recurrence (measured 0 to 2.4e-15,
``launch.decode_check``, the check ``chip_smoke.py`` runs at 48 layers),
and each fault of ``decode_check.FAULTS`` (every state, the conv windows,
the sLSTM states, the last repeat's states, zeroed after the prefill)
lies past it.  The paged engine refuses the xLSTM blocks and the serving
launcher takes the contiguous path.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import _torch_model_parity as mp  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.launch import decode_check as dc  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

ARCH = "xlstm-1.3b"


@pytest.fixture(scope="module")
def model():
    return mp.carried(ARCH)


@pytest.fixture(scope="module")
def model4(model):
    """The SMOKE supercell stacked twice (4 layers), JAX initial weights
    carried over."""
    jcfg, _, cfg, _ = model
    jcfg = dataclasses.replace(jcfg, stages=jconfigs.base.patterned_stages(
        jcfg.stages[0].blocks, 4))
    cfg = dataclasses.replace(cfg, stages=configs.patterned_stages(
        cfg.stages[0].blocks, 4))
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, cfg, convert.transformer_params_from_reference(
        jparams, "cpu")


def test_parameter_trees_cross(model):
    mp.check_parameter_trees(model)
    cfg, params = model[2], model[3]
    cell = params["stages"]["s0"]
    assert set(cell["b0"]) == {"ln1", "mlstm"}
    assert set(cell["b0"]["mlstm"]) == {"w_up", "conv", "wq", "wk", "wv",
                                        "w_if", "if_bias", "norm", "w_down"}
    assert set(cell["b1"]) == {"ln1", "slstm"}
    assert set(cell["b1"]["slstm"]) == {"w_in", "r", "bias", "norm",
                                        "w_ff_gate", "w_ff_down"}
    d, h = cfg.d_model, cfg.n_heads
    assert cell["b1"]["slstm"]["r"].shape == (h, d // h, 4 * d // h)
    assert cell["b0"]["mlstm"]["w_if"].dtype == torch.float32


def test_forward_logits_match_reference(model):
    cfg = model[2]
    logits, aux = mp.check_forward(model, mp.prompts(cfg, 2, 40, seed=1))
    assert logits.shape == (2, 40, cfg.vocab_size) and float(aux) == 0.0


def test_prefill_and_decode_match_reference(model):
    cfg = model[2]
    caches = mp.check_prefill_and_decode(
        model, mp.prompts(cfg, 2, 45, seed=2), 3, scaled_states=True)
    spec = cfg.stages[0].blocks[0].xlstm
    d_inner = int(cfg.d_model * spec.proj_factor)
    dk = d_inner // cfg.n_heads
    m = caches["s0"]["b0"]
    assert {k: tuple(v.shape) for k, v in m.items()} == {
        "C": (2, cfg.n_heads, dk, dk), "n": (2, cfg.n_heads, dk),
        "m": (2, cfg.n_heads), "conv": (2, spec.conv_window - 1, d_inner)}
    state = caches["s0"]["b1"]["state"]
    assert len(state) == 4 and all(tuple(t.shape) == (2, cfg.d_model)
                                   and t.dtype == torch.float32
                                   for t in state)
    empty = T.init_cache(cfg, 2, 48)
    assert {k: v.shape for k, v in empty["s0"]["b0"].items()} == \
        {k: v.shape for k, v in m.items()}
    assert [t.shape for t in empty["s0"]["b1"]["state"]] == \
        [t.shape for t in state]


def test_generate_tokens_equal_reference(model):
    cfg = model[2]
    got = mp.check_generate(model, mp.prompts(cfg, 2, 45, seed=3), 6)
    assert got.shape == (2, 6)


def test_stacked_repeats_match_reference(model4):
    """Two stacked repeats: the forward, the prefill and 3 decode steps
    (every stacked cache leaf within 1e-5 of its largest |value|) with
    the logits within 1e-5 of the largest |logit|, and greedy tokens
    equal: a decode that lost the in-place write into a repeat's view
    would part from the JAX package here."""
    cfg = model4[2]
    assert [(len(st.blocks), st.repeat) for st in cfg.stages] == [(2, 2)]
    tokens = mp.prompts(cfg, 2, 45, seed=2)
    jl = np.asarray(mp._jforward(model4[1], model4[0],
                                 jax.numpy.asarray(tokens))[0])
    tol = 1e-5 * float(np.abs(jl).max())
    mp.check_forward(model4, mp.prompts(cfg, 2, 40, seed=1), tol=tol)
    caches = mp.check_prefill_and_decode(model4, tokens, 3, tol=tol,
                                         scaled_states=True)
    assert caches["s0"]["b0"]["C"].shape[0] == 2
    mp.check_generate(model4, mp.prompts(cfg, 2, 45, seed=3), 6)


def test_decode_matches_teacher_forced_forward(model4):
    """Greedy decode steps from the prefill's caches against a forward of
    the prompt and the tokens so far (5e-5), at 2 stacked repeats; every
    step writes the stacked caches in place."""
    cfg, params = model4[2], model4[3]
    toks = torch.from_numpy(mp.prompts(cfg, 2, 37, seed=4)).long()
    lp, _, caches = T.forward(params, cfg, toks, mode="prefill",
                              cache_len=toks.shape[1] + 4)
    held = (caches["s0"]["b0"]["C"], caches["s0"]["b1"]["state"][0])
    cur, ld, errs = toks, lp[:, -1], []
    for t in range(3):
        nxt = ld.argmax(-1)
        cur = torch.cat([cur, nxt[:, None]], 1)
        lf, _, _ = T.forward(params, cfg, cur)
        pos = torch.full((2,), toks.shape[1] + t, dtype=torch.int32)
        ld, caches = T.decode_step(params, cfg, nxt, pos, caches)
        errs.append(float((ld - lf[:, -1]).abs().max()))
        assert caches["s0"]["b0"]["C"] is held[0]
        assert caches["s0"]["b1"]["state"][0] is held[1]
    assert max(errs) < 5e-5, errs


@pytest.fixture(scope="module")
def float64_decode(model4):
    """The 4-layer model in float64: the forward on the recurrence and the
    decode (and each fault's) fed the same greedy tokens."""
    cfg = model4[2]
    p64 = tree_map(lambda t: t.double(), model4[3])
    prompts = torch.from_numpy(mp.prompts(cfg, 2, 45, seed=5)).long()
    with torch.no_grad(), dc.sequential_scans():
        runs = dc.decode_logits(cfg, p64, prompts, 5, faults=dc.FAULTS)[0]
        ref = dc.forced_logits(cfg, p64, prompts,
                               runs["served"].argmax(-1))
    return ref, runs


@pytest.mark.parametrize("run", ("served", *dc.FAULTS))
def test_float64_decode_holds_its_forward_and_sees_each_fault(
        model4, float64_decode, run):
    ref, runs = float64_decode
    assert dc.faults(model4[2]) == dc.FAULTS
    assert ref.dtype == runs[run].dtype == torch.float64
    gaps = dc.step_gaps(ref, runs[run])
    if run == "served":
        assert float(gaps.max()) <= 1e-10, gaps
    else:
        # the prefill's own logits hold; every decode step parts
        assert float(gaps[0]) <= 1e-10 and float(gaps[1:].min()) > 1e-2, \
            gaps


def test_paged_engine_refuses_xlstm_and_the_launcher_serves_it(model,
                                                               capsys):
    with pytest.raises(ValueError, match="kind='mlstm'"):
        ServeEngine(model[2], model[3])
    from repro_torch.launch import serve
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "35", "--new-tokens", "3", "--temperature", "0"]
    assert serve.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["mode"] == "legacy" and len(out["sample"]) == 3
    assert np.isfinite(out["tok_per_s"])
