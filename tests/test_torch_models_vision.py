"""llama-3.2-vision-11b in the port (self-attention layers and
cross-attention layers onto a stubbed vision frontend: precomputed patch
embeddings projected by ``frontend_proj``, then each cross layer's
``wk_x`` / ``wv_x``), against the JAX package at ``SMOKE`` from its
initial weights (``tests/_torch_model_parity.py``), with the same NumPy
frontend embeddings on both sides.

The parameter tree (``frontend_proj``, ``ln_x``, ``wk_x``, ``wv_x``)
carried across and back; train-mode logits within 1e-5 with the frontend
and without it (the cross sublayer skipped, as in the JAX package);
prefill and 3 contiguous decode steps within 1e-5, the frontend's K/V
projected anew at every step; greedy ``generate`` tokens equal to the
JAX package's; the paged engine refuses cross-attention with
``ValueError``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import _torch_model_parity as mp  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def model():
    return mp.carried("llama-3.2-vision-11b")


def test_parameter_trees_cross(model):
    mp.check_parameter_trees(model)
    cfg, params = model[2], model[3]
    assert params["frontend_proj"].shape == (cfg.frontend.embed_dim,
                                             cfg.d_model)
    cross = params["stages"]["s0"]["b1"]
    assert {"wk_x", "wv_x"} <= set(cross["attn"]) and "ln_x" in cross
    assert "wk_x" not in params["stages"]["s0"]["b0"]["attn"]


def test_forward_logits_match_reference(model):
    cfg = model[2]
    tokens = mp.prompts(cfg, 2, 11, seed=1)
    fe = mp.frontend(cfg, 2, seed=4)
    with_fe, _ = mp.check_forward(model, tokens, fe)
    without, aux = mp.check_forward(model, tokens)
    assert float(aux) == 0.0
    assert float((with_fe - without).abs().max()) > 1e-3


def test_prefill_and_decode_match_reference(model):
    cfg = model[2]
    mp.check_prefill_and_decode(model, mp.prompts(cfg, 2, 13, seed=2), 3,
                                mp.frontend(cfg, 2, seed=5))


def test_generate_tokens_equal_reference(model):
    cfg = model[2]
    mp.check_generate(model, mp.prompts(cfg, 2, 13, seed=3), 6,
                      mp.frontend(cfg, 2, seed=6))


def test_project_frontend_needs_a_frontend(model):
    cfg, params = model[2], model[3]
    fe = torch.from_numpy(mp.frontend(cfg, 1, seed=7))
    got = T.project_frontend(params, cfg, fe)
    np.testing.assert_allclose(got.numpy(),
                               fe.numpy() @ params["frontend_proj"].numpy(),
                               rtol=1e-6, atol=1e-6)
    assert T.project_frontend(params, cfg, None) is None


def test_paged_engine_refuses_cross_attention(model):
    with pytest.raises(ValueError, match="cross-attention"):
        ServeEngine(model[2], model[3])
