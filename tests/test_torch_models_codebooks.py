"""musicgen-large in the port (4 parallel codebook streams: the
codebooks' embeddings summed, one output head each), against the JAX
package at ``SMOKE`` from its initial weights
(``tests/_torch_model_parity.py``).

The parameter tree ((CB, V, d) embeddings, a (CB, d, V) head) carried
across and back; train-mode logits (B, S, 4, V) within 1e-5 and an aux of
0; prefill and 3 contiguous decode steps of (B, 4) tokens within 1e-5;
greedy ``generate`` tokens (B, n_new, 4) equal to the JAX package's.  The
paged engine, whose requests are one token list, refuses the config and
names the contiguous path; the trainer refuses it
(``tests/test_torch_models_moe.py``).
"""
from __future__ import annotations

import pytest

jax = pytest.importorskip("jax")

import _torch_model_parity as mp  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402


@pytest.fixture(scope="module")
def model():
    return mp.carried("musicgen-large")


def test_parameter_trees_cross(model):
    mp.check_parameter_trees(model)
    cfg, params = model[2], model[3]
    assert params["embed"].shape == (4, cfg.vocab_size, cfg.d_model)
    assert params["lm_head"].shape == (4, cfg.d_model, cfg.vocab_size)


def test_forward_logits_match_reference(model):
    cfg = model[2]
    logits, aux = mp.check_forward(model, mp.prompts(cfg, 2, 9, seed=1))
    assert logits.shape == (2, 9, 4, cfg.vocab_size) and float(aux) == 0.0


def test_prefill_and_decode_match_reference(model):
    cfg = model[2]
    mp.check_prefill_and_decode(model, mp.prompts(cfg, 2, 9, seed=2), 3)


def test_generate_tokens_equal_reference(model):
    cfg = model[2]
    got = mp.check_generate(model, mp.prompts(cfg, 2, 9, seed=3), 6)
    assert got.shape == (2, 6, 4)


def test_paged_engine_refuses_codebooks(model):
    with pytest.raises(ValueError, match="--legacy"):
        ServeEngine(model[2], model[3])
