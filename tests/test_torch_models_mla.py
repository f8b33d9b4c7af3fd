"""deepseek-v2-236b in the port (MLA attention: the latent c_kv and the
shared rotary key cached, K/V expanded at attention time; a dense first
layer, then MoE layers with a shared expert), against the JAX package at
``SMOKE`` from its initial weights (``tests/_torch_model_parity.py``).

The parameter tree (``w_dq``, ``w_uq``, ``w_dkv``, ``w_uk``, ``w_uv``,
``wo``) carried across and back; train-mode logits and the router's
auxiliary loss within 1e-5; prefill and 3 contiguous decode steps within
1e-5, the compressed cache ``{c_kv, k_rope, pos}`` included; greedy
``generate`` tokens equal to the JAX package's; the paged engine refuses
MLA with ``ValueError`` and names the contiguous path, which the serving
launcher takes for MLA and cross-attention without ``--legacy``.
"""
from __future__ import annotations

import pytest

jax = pytest.importorskip("jax")

import _torch_model_parity as mp  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def model():
    return mp.carried("deepseek-v2-236b")


def test_parameter_trees_cross(model):
    mp.check_parameter_trees(model)
    cfg, params = model[2], model[3]
    a = cfg.stages[0].blocks[0].attn
    attn = params["stages"]["s0"]["b0"]["attn"]
    assert set(attn) == {"w_dq", "w_uq", "w_dkv", "w_uk", "w_uv", "wo"}
    assert attn["w_dkv"].shape == (cfg.d_model,
                                   a.kv_lora_rank + a.qk_rope_head_dim)
    assert "shared" in params["stages"]["s1"]["b0"]["moe"]


def test_forward_logits_and_aux_match_reference(model):
    cfg = model[2]
    logits, aux = mp.check_forward(model, mp.prompts(cfg, 2, 11, seed=1))
    assert logits.shape == (2, 11, cfg.vocab_size) and float(aux) > 0.0


def test_prefill_and_decode_match_reference(model):
    cfg = model[2]
    caches = mp.check_prefill_and_decode(model, mp.prompts(cfg, 2, 13,
                                                           seed=2), 3)
    a = cfg.stages[0].blocks[0].attn
    layer0 = caches["s0"]["b0"]
    assert set(layer0) == {"c_kv", "k_rope", "pos"}
    assert layer0["c_kv"].shape == (2, 16, a.kv_lora_rank)
    assert layer0["k_rope"].shape == (2, 16, a.qk_rope_head_dim)
    assert layer0["pos"][0].tolist() == list(range(16))
    empty = T.init_cache(cfg, 2, 16)
    assert {k: v.shape for k, v in empty["s1"]["b0"].items()} == \
        {k: v.shape for k, v in caches["s1"]["b0"].items()}


def test_generate_tokens_equal_reference(model):
    cfg = model[2]
    mp.check_generate(model, mp.prompts(cfg, 2, 13, seed=3), 6)


def test_paged_engine_refuses_mla(model):
    with pytest.raises(ValueError, match="GQA attention blocks only"):
        ServeEngine(model[2], model[3])


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "llama-3.2-vision-11b"])
def test_serve_cli_takes_the_contiguous_path(arch, capsys):
    """The launcher picks the path by architecture: MLA and
    cross-attention, which the paged engine refuses, decode through
    ``generate`` without ``--legacy`` (llama-vision with its seeded
    frontend embeddings); a GQA model stays on the engine."""
    import json

    from repro_torch.launch import serve

    argv = ["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len",
            "6", "--new-tokens", "3", "--temperature", "0"]
    assert serve.main(["--arch", arch, *argv]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["mode"] == "legacy" and len(out["sample"]) == 3
    assert serve.main(["--arch", "granite-3-2b", *argv]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["mode"] == "paged"
