"""The dense GQA configurations the port serves beside smollm-135m,
granite-3-2b, granite-3-8b and gemma3-27b (5:1 local:global, a sliding
window of 8 at ``SMOKE``), against the JAX package at ``SMOKE`` from its
initial weights (``tests/_torch_model_parity.py``; their configs are held
value for value in ``tests/test_torch_serve.py``).

Per model: the parameter tree carried across and back; train-mode logits
within 1e-5; prefill and 3 contiguous decode steps within 1e-5 (gemma3's
prompt of 13 tokens is longer than its window, so its local layers' ring
caches wrap); greedy ``generate`` tokens equal to the JAX package's; for
the granites, the paged engine's greedy tokens equal to the JAX
``ServeEngine``'s.  gemma3's paged engine refuses its windows.
"""
from __future__ import annotations

import pytest

jax = pytest.importorskip("jax")

import _torch_model_parity as mp  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

ARCHS = ("granite-3-2b", "granite-3-8b", "gemma3-27b")


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return mp.carried(request.param)


def test_parameter_trees_cross(model):
    mp.check_parameter_trees(model)


def test_forward_logits_match_reference(model):
    cfg = model[2]
    logits, aux = mp.check_forward(model, mp.prompts(cfg, 2, 11, seed=1))
    assert logits.shape == (2, 11, cfg.vocab_size) and float(aux) == 0.0


def test_prefill_and_decode_match_reference(model):
    cfg = model[2]
    mp.check_prefill_and_decode(model, mp.prompts(cfg, 2, 13, seed=2), 3)


def test_generate_tokens_equal_reference(model):
    cfg = model[2]
    got = mp.check_generate(model, mp.prompts(cfg, 2, 13, seed=3), 6)
    assert got.shape == (2, 6)


def test_engine_tokens_equal_reference_engine(model):
    cfg, params = model[2], model[3]
    if cfg.name.startswith("gemma3"):
        with pytest.raises(ValueError, match="--legacy"):
            ServeEngine(cfg, params)
        return
    want, got, engine = mp.serve_both(model, mp.ragged(cfg, (5, 14), 4),
                                      n_slots=2, n_new=7)
    assert got == want and all(len(t) == 7 for t in got.values())
    assert engine.steps_run == 6
