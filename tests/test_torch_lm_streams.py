"""The LM trainer of the port on the configurations with several token
streams or a second stream of input, and on the dense ones, held against
the JAX trainer on the CPU at ``SMOKE``: 3 DRSGDA steps on a 4-node ring
within 1e-5 (``tests/_torch_lm_parity.py``).

* musicgen-large: 4 codebook streams, tokens (B, S, 4), targets
  ``tokens[..., 1:, :]``, the cross-entropy averaged over positions and
  codebooks;
* llama-3.2-vision-11b: cross-attention layers onto frontend embeddings
  carried in the batch as float32, the same NumPy embeddings on both
  sides (the attention gradient at S != T, not causal); and the training
  CLI's own draw of the embeddings;
* granite-3-2b (head dim 16), granite-3-8b (head dim 20: the attention
  kernels' SIMT routes on the card) and gemma3-27b (sliding-window local
  layers beside global ones);
* zamba2-2.7b: a Mamba2 block (the chunked SSD scan, 16 tokens in one
  chunk of 32, through ``torch.func.vmap(grad)``; its leaves Euclidean)
  beside a GQA block whose wq, wk, wv and wo are on the Stiefel manifold;
* xlstm-1.3b: an mLSTM block (the chunked cell, 16 tokens in one chunk of
  32, ``torch.cummax`` and the masked exponential under
  ``torch.func.vmap(grad)``; its wq, wk, wv and w_down on the Stiefel
  manifold) beside an sLSTM block (its recurrence a Python loop over the
  tokens).

The cases share one file: pytest-xdist's ``loadfile`` queues files by
their number of tests, so one-test files would run last, as the suite's
tail.
"""
from __future__ import annotations

import math

import pytest

jax = pytest.importorskip("jax")

import _torch_lm_parity as lp  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401


@pytest.mark.parametrize("arch", ["musicgen-large", "llama-3.2-vision-11b",
                                  "granite-3-2b", "granite-3-8b",
                                  "gemma3-27b", "zamba2-2.7b",
                                  "xlstm-1.3b"])
def test_trainer_matches_the_reference(arch):
    m = lp.check_trainer(arch)
    assert math.isfinite(float(m.loss))


def test_train_cli_feeds_the_frontend(capsys):
    """The CLI draws one set of node-stacked frontend embeddings from
    ``--seed`` and feeds it with every batch: two runs from the same seed
    print the same rows; one step on 2 nodes keeps the JAX CLI's rule."""
    import json

    import torch

    from repro_torch import configs
    from repro_torch.launch import frontend_embeds, train

    argv = ["--arch", "llama-3.2-vision-11b", "--smoke", "--device", "cpu",
            "--steps", "2", "--nodes", "2", "--batch-per-node", "2",
            "--seq-len", "8", "--eval-every", "1"]
    rows = []
    for _ in range(2):
        assert train.main(argv) == 0
        rows.append([json.loads(line) for line in
                     capsys.readouterr().out.splitlines()
                     if line.startswith("{")])
    strip = [[{k: v for k, v in r.items() if k != "wall_s"} for r in run]
             for run in rows]
    assert strip[0] == strip[1] and len(strip[0]) == 2
    assert all(math.isfinite(r["loss"]) and r["stiefel_residual"] < 1e-2
               for r in strip[0])
    cfg = configs.get_config("llama-3.2-vision-11b", smoke=True)
    fe = frontend_embeds(cfg, (2, 2), 0, "cpu")
    assert fe.shape == (2, 2, cfg.frontend.n_tokens,
                        cfg.frontend.embed_dim) and fe.dtype == torch.float32
    assert frontend_embeds(configs.get_config("smollm-135m", smoke=True),
                           (2, 2), 0, "cpu") is None
