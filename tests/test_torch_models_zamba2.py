"""zamba2-2.7b in the port (Mamba2 blocks beside GQA attention, a 1:1
supercell at ``SMOKE``), against the JAX package at ``SMOKE`` from its
initial weights (``tests/_torch_model_parity.py``).

The parameter tree (``mamba``: ``in_proj``, ``conv``, ``a_log``,
``d_skip``, ``dt_bias``, ``norm``, ``out_proj``; no MLP and no ``ln2`` in
a Mamba2 block) carried across and back; train-mode logits within
2e-5 over 40 tokens (two SSD chunks of 32, the second padded); prefill and
3 contiguous decode steps within 2e-5, the ``{ssm, conv}`` states and the
attention caches included (2e-5 absolute is 5e-6 of the largest |logit|,
about 4: each package's fp32 input projection lies 1.3e-6 and 1.9e-6 from
fp64, rounded apart, and the model carries that to 7.0e-6 (seed 1, 40
tokens) and 1.12e-5 (seed 2, 45 tokens) in the logits, above the other
models' 1e-5).  The gap is two fp32 roundings, not a fault of either
package (``tests/_zamba2_logit_gap.py``): over seeds 1-7 at 33-100
tokens each package's logits lie 4.5e-6 to 1.9e-5 from a float64
forward of the port, in their own directions, and the gap between them
is 7.0e-6 to 2.2e-5, more at longer prompts (with both packages on the
sequential SSD, 3.1e-6 to 1.2e-5).  So 2e-5 holds
these draws by 1.8x and 2.9x, and would not hold every prompt of 100
tokens.  Greedy ``generate`` tokens equal to the JAX package's; the
port's decode against its own teacher-forced forward within 5e-5, the
JAX test's rule (``tests/test_models.py`` ``test_hybrid_mamba_decode``);
the decode writes the stacked caches in place; the paged engine refuses
Mamba2 blocks, and the serving launcher takes the contiguous path for
zamba2-2.7b.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import _torch_model_parity as mp  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

ARCH = "zamba2-2.7b"
TOL = 2e-5


@pytest.fixture(scope="module")
def model():
    return mp.carried(ARCH)


def test_parameter_trees_cross(model):
    mp.check_parameter_trees(model)
    cfg, params = model[2], model[3]
    mamba = params["stages"]["s0"]["b0"]
    assert set(mamba) == {"ln1", "mamba"}
    assert set(mamba["mamba"]) == {"in_proj", "conv", "a_log", "d_skip",
                                   "dt_bias", "norm", "out_proj"}
    spec = cfg.stages[0].blocks[0].ssm
    d_inner = spec.expand * cfg.d_model
    h = d_inner // spec.head_dim
    assert mamba["mamba"]["in_proj"].shape == (
        cfg.d_model, 2 * d_inner + 2 * spec.n_groups * spec.d_state + h)
    assert set(params["stages"]["s0"]["b1"]) == {"ln1", "attn", "ln2", "mlp"}


def test_forward_logits_match_reference(model):
    cfg = model[2]
    logits, aux = mp.check_forward(model, mp.prompts(cfg, 2, 40, seed=1),
                                   tol=TOL)
    assert logits.shape == (2, 40, cfg.vocab_size) and float(aux) == 0.0


def test_prefill_and_decode_match_reference(model):
    cfg = model[2]
    caches = mp.check_prefill_and_decode(model, mp.prompts(cfg, 2, 45,
                                                           seed=2), 3,
                                         tol=TOL)
    spec = cfg.stages[0].blocks[0].ssm
    state = caches["s0"]["b0"]
    assert set(state) == {"ssm", "conv"}
    d_inner = spec.expand * cfg.d_model
    assert state["ssm"].shape == (2, d_inner // spec.head_dim, spec.d_state,
                                  spec.head_dim)
    assert state["ssm"].dtype == torch.float32
    assert state["conv"].shape == (2, spec.d_conv - 1,
                                   d_inner + 2 * spec.d_state)
    empty = T.init_cache(cfg, 2, 48)
    assert {k: v.shape for k, v in empty["s0"]["b0"].items()} == \
        {k: v.shape for k, v in state.items()}


def test_generate_tokens_equal_reference(model):
    cfg = model[2]
    got = mp.check_generate(model, mp.prompts(cfg, 2, 45, seed=3), 6)
    assert got.shape == (2, 6)


def test_decode_matches_teacher_forced_forward(model):
    """Greedy decode steps from the prefill's caches against a forward of
    the prompt and the tokens so far (5e-5); every step writes the
    stacked caches in place."""
    cfg, params = model[2], model[3]
    toks = torch.from_numpy(mp.prompts(cfg, 2, 37, seed=4)).long()
    lp, _, caches = T.forward(params, cfg, toks, mode="prefill",
                              cache_len=toks.shape[1] + 4)
    held = caches["s0"]["b0"]["ssm"]
    cur, ld, errs = toks, lp[:, -1], []
    for t in range(3):
        nxt = ld.argmax(-1)
        cur = torch.cat([cur, nxt[:, None]], 1)
        lf, _, _ = T.forward(params, cfg, cur)
        pos = torch.full((2,), toks.shape[1] + t, dtype=torch.int32)
        ld, caches = T.decode_step(params, cfg, nxt, pos, caches)
        errs.append(float((ld - lf[:, -1]).abs().max()))
        assert caches["s0"]["b0"]["ssm"] is held
    assert max(errs) < 5e-5, errs


def test_paged_engine_refuses_mamba_and_the_launcher_serves_it(model,
                                                               capsys):
    with pytest.raises(ValueError, match="kind='mamba'"):
        ServeEngine(model[2], model[3])
    from repro_torch.launch import serve
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "35", "--new-tokens", "3", "--temperature", "0"]
    assert serve.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["mode"] == "legacy" and len(out["sample"]) == 3
    assert np.isfinite(out["tok_per_s"])
