#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and turns TF32 off for matmuls and cuDNN.
2. Builds the nine CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, in parallel) and prints the build time.
3. Kernel phase: every kernel against its plain PyTorch version on the card,
   at the shapes one main-path step gives it and at stress shapes, with its
   gate: bitwise for the ring mixes (fp32 and int8), <= 5e-5 absolute for
   fused_retract, <= 1e-5 relative for stiefel_project.  Times from CUDA
   events: ``ms`` the median of single calls after warm-up (the host's
   launch work included), ``device_ms`` 50 back-to-back calls between two
   events over 50 (the device's pace where it is the slower), both for the
   kernel and for its library call, beside the least time the card could
   take,
   and for the fp32 ring mixes beside one ``torch.matmul`` by W^k (the
   library call that computes the same function, up to rounding; no single
   PyTorch call computes the int8 ones).  The fp32 ring mixes run as the
   main path calls them, one grouped call per mixed tree, and
   multi_hop_mix also on a 40-node ring (its shared-memory kernel); the
   registers and occupancy of its register kernel at n = 20 are printed.
   stiefel_project as the step calls it, one grouped call for the fc1 and
   head leaves (its on-chip route), and at stress shapes (the streaming
   3xTF32 route at (20, 4096, 256) and (20, 4096, 99)); fused_retract at
   the same shapes and at smollm-135m's Stiefel leaves as the full-width
   ``"polar_fused"`` step calls it, stacked over 30 layers and 8 nodes:
   (240, 576, 576) on its global route (r > 256, the (r, r) stage as
   tensor-core GEMMs over global memory; the kernel line's row of that
   route), (240, 576, 192) on its cluster route; then (8, 576, 576) and
   (8, 576, 257) on the global route; each repeated bit for bit, its
   device time also read by ``torch.profiler`` and split by CUDA kernel;
   and at xlstm-1.3b's Stiefel leaves as its cut's ``"polar_fused"`` step
   calls it on 4 nodes, (4, 4096, 4096) and (4, 4096, 2048), both on the
   global route, within the same 5e-5 (a call of about a second: 3 timed
   calls each).
   Every fp32 matrix product is bounded at the 3xTF32
   rate (495 / 3 TFLOP/s), whichever unit the kernel uses; a product that
   is symmetric in exact arithmetic counts one triangle.  quant_mix as the EF-int8 step calls
   it: one grouped call for each of the x, u, y and v trees with the old
   hats' exact hop fused in, beside the chain it replaces (ring_mix of the
   hats, quant_mix per leaf, the adds: same bits, timed in the same run),
   and without a base.  multi_hop_mix_quant as the EF-int8 k = 67 step
   calls it: one grouped call for each of the x, u and y trees.
   A CUDA operand of another dtype must raise, not fall back.  The
   attention kernels in fp32 and bf16
   (gates 2e-5 and 2e-2 absolute, the JAX package's): flash_attention at
   smollm-135m's prefill (S=256) and contiguous-decode (S=1, T=288)
   shapes, at S=T=4096 causal and with window 48, and non-causal (its
   tensor-core route), and at hd=40, hdv=24 (its SIMT route; both routes
   must run), beside one ``scaled_dot_product_attention`` call with the
   same mask, its fp32 tensor-core rows bounded at the 3xTF32 rate
   (495 / 3 TFLOP/s); in bf16 also with every output in [4, 8), against
   the reference's unrounded fp32 result;
   paged_decode at the engine's decode shape (4 slots, ragged seq_lens up
   to 288, one empty) and at 64 slots of 2048 tokens (no PyTorch call
   gathers through a block table).  In fp32 also at the served
   configurations' shapes (MODEL_ATTENTION, MODEL_PAGED): head dim 128,
   GQA 1, 2 and 4, gemma3's window of 1024 at S = 1536 and against a
   wrapped ring of 1024 slots, the SMOKE head dims 16, 20 (SIMT) and
   32, deepseek-v2's MLA (q/k head dim 192, v head dim 128, 128 heads:
   the SIMT route; at SMOKE 48 / 32 on the tensor cores) and
   llama-vision's cross-attention (not causal, 512 or 1 queries over
   1600 frontend keys; at SMOKE 13 over 16) and zamba2-2.7b's head dim 80
   (32:32, a prefill of 2 x 1000 tokens and a decode step over 1015
   keys), each on the route its shape takes.  Query rows without keys and empty
   slots must be exact zeros.
   The attention backward kernel (``flash_attention_bwd``, no TPU
   counterpart; its tensor-core route at hd = 64, handed the forward's lse
   as the gradient hands it) against ``ref.attention_backward`` (1e-5
   relative to the largest plain value) at the trainer's shape (B = 32,
   S = T = 63, GQA 9:3, fp32), at S = T = 512 with window 48, and at
   S = T = 2048 causal, and at MLA's and cross-attention's shapes
   (BWD_SHAPES: hd 48 / hdv 32 on the tensor cores, 40 / 24 on the SIMT
   route, causal and not, S != T up to 256 queries over 1600 keys), and at
   zamba2-2.7b's training shape (hd 80, 32:32, B = 16, S = T = 63),
   beside SDPA's backward (``torch.autograd.grad`` of
   one SDPA call under the same mask), the trainer's shape also read by
   ``torch.profiler`` (the trainer's shape runs at the host's pace under
   CUDA events), bound at the 165 TFLOP/s of fp32
   products on the tensor cores (3xTF32); every case repeats bit for
   bit, rows without keys pass exact zeros, bf16 raises.
   Then the Mamba2 block's SSD core (plain PyTorch) at zamba2-2.7b's full
   width (B 2, S 1000 in chunks of 256, H 80, N 64, P 64, fp32): chunked
   against sequential within 1e-4 of the largest |y|, and the card's
   chunked output no further from an fp64 recurrence than twice the
   CPU's.  Then the mLSTM cell (plain PyTorch) at xlstm-1.3b's full
   width (B 2, S 1000 in chunks of 256, H 4, dk 1024, fp32): the chunked
   form and the recurrence on the card and on the CPU (the CPU's
   recurrence over the first chunk), each against a float64 recurrence,
   every gap and the largest |y| reported (not gated:
   the chunked form is the JAX package's; a non-finite output fails).
   Then the geometries: Grassmann (polar and QR), oblique, sphere and a
   Product of all five on node-stacked (20, 784, 64) and (20, 20, 3) inputs
   from a seed, every op on the card against the CPU (1e-5 relative; dist
   1e-4 absolute) and the axioms on the card (R_x(0) = x to 1e-5, check
   < 1e-5 after a step).  Then ``analysis.contracts.run`` on the card: no
   findings (every W_t of the channel and elastic sweeps symmetric doubly
   stochastic, every retraction of every geometry on its manifold).  Then
   the analysis CLI on the card (``python -m repro_torch.analysis`` in
   process: every pass, the kernels' Hopper budgets included, exit 0 and
   no finding; ``--selftest``: every fixture fires) and each kernel's
   registers a thread, shared memory a block and resident blocks over the
   budget pass's launch configurations.
4. Main path, three paths, each with the launch counts set to 0 just
   before it and read just after:
   * full precision: DRGDA (full batch, polar_fused) and DRSGDA (minibatch)
     through ``repro_torch.launch.fair.run_method`` on the paper's 20-node
     ring with k = 1 and 28x28 images, 30 steps each, then DRGDA at the
     Theorem-1 k = 67 for 5 steps;
   * EF-int8 gossip: DRGDA with ``CommSpec(compressor="int8", gamma=0.95)``
     at k = 1 for 30 steps, the same with ``quant_hops="all"`` at k = 67
     for 5 steps, and the 5%-drop channel at k = 1 for 10 steps;
   * the paper's baselines: GT-GDA (full batch), GNSD-A, DM-HSGD and GT-SRVR
     (minibatches; GT-SRVR anchors at t = 0 and 16) for 30 steps each,
     GT-SRVR over EF-int8 gossip for 10, and DRGDA under the Cayley
     retraction for 10;
   losses finite, Stiefel residual <= 1e-4, every kernel of the path
   launched, and the ring mixes, the int8 kernels and (for the baselines
   and Cayley) stiefel_project, fused_retract and multi_hop_mix exactly as
   often as the init, the steps and the evaluations need (one grouped ring
   call per mixed tree; for EF-int8 one grouped first hop per tree and no
   ring_mix, one grouped int8 tail call per tree; a baseline step projects
   nothing, a Cayley step 5 times).  Then the figures: paper Figs. 1-2 at
   the JAX package's settings (20 nodes, 14x14 images, seed 0, 120 and 150
   steps) from its initial weights, every curve point held against its
   curves (``tests/data/fair_reference_curves.json``) within the gate the
   file records for it, where the JAX package reproduces itself, and the
   gap reported where it does not, with the launches of the whole run.
   Then robust PCA on the Grassmann manifold
   (``repro_torch.launch.robust_pca``): the example's run (Gr(20, 3), 8
   nodes, 800 steps) from the JAX package's data and initial basis, held
   against its curve and Phi under the gates
   ``tests/data/robust_pca_reference.json`` records, with the example's
   four checks; the full-width run (Gr(784, 64), 20 nodes, 256 samples a
   node, 100 steps), finite, feasible and its loss falling; and the full
   width for 5 steps on
   the card against the CPU (1e-4 relative in loss and M_t).  Then the DRO
   experiment (``repro_torch.launch.dro``: DRSGDA, GNSD-A, DM-HSGD at the
   settings of ``benchmarks/dro.py``) from the JAX package's initial
   weights, held against ``tests/data/dro_reference_curves.json``.  Then
   elastic gossip (``repro_torch.launch.elastic``, the counterpart of
   ``benchmarks/elastic.py``): DRGDA on an 8-node ring under six churn and
   straggler schedules, fair classification and robust PCA, from the JAX
   package's weights, data and recorded draws, every curve point inside
   the gate and with the live-node count of
   ``tests/data/elastic_reference.json``, leave-and-rejoin within 2x of
   the static ring; every realized W_t of the contract sweep on the card
   symmetric, doubly stochastic to 1e-6, departed rows identity; and
   leave-and-rejoin at the main path's configuration (20 nodes, 28x28,
   30 steps) beside the static ring, within 2x.  Then telemetry and
   checkpoints (``repro_torch.launch.obs``): DRGDA at the main path's
   configuration, exact ring and EF-int8, with telemetry off and on in
   interleaved 50-step blocks (one counter flush a block): the overhead
   and the counters' own host work timed alone, both final states bitwise equal (deterministic cuDNN), the counters'
   bytes per hop within 1% of ``est_hop_bytes`` and of
   ``wire_round_bytes``, the events valid, a non-flushing step free of
   host syncs (``torch.cuda.set_sync_debug_mode("error")``), the phase
   breakdown, each kernel's estimate of a step on the H100 roofline, one
   step's launches as the profile asserts them with telemetry off and on;
   a DRGDA state checkpointed on the card after 5 steps and resumed into
   a fresh run, bitwise the 10-step run; and for each kernel table row the
   port's analytical estimate (``obs/estimates.py``) beside this script's
   count.  An elastic step launches
   no ring kernel (its W_t is applied by einsum).  Every
   robust-PCA, DRO and elastic run's launches are asserted: no stiefel_project and
   no fused_retract in a robust-PCA step, one grouped ring_mix call per
   mixed tree (the example at the ring's Theorem-1 k = 8: one ring_mix and
   three multi_hop_mix), 5 projections a DRSGDA step.  Then a profile of a
   DRGDA k = 1 step, an EF-int8 k = 1 step, a DRGDA k = 67 step, an EF-int8
   quant_hops="all" k = 67 step, a GT-GDA step and a DM-HSGD step, and a
   step of each of the six methods as the figures phase runs it, a
   robust-PCA step at the example's size and at full width, a DRO
   DRSGDA step, and an elastic leave-and-rejoin step at full width (wall
   time, device time and busy share, the kernels that take the most, and
   the port's launches a step: one stiefel_project launch, for EF-int8 four
   quant_mix and no ring_mix, for the baselines four ring_mix and no
   projection, asserted; for the baselines also the projection back alone,
   its share of the step's wall and device time), and small runs on the
   card against the same runs on the CPU (plain versions): DRGDA full
   precision and EF-int8, GT-SRVR with q = 4, DRGDA under Cayley.
5. Serving path: smollm-135m at its published widths (30 layers, fp32,
   random weights from a seed) through the paged engine
   (``repro_torch.serve``): 8 requests with ragged prompts of 24-256
   tokens, 32 greedy tokens each, over 4 slots of 16-token pages, once to
   record the logits and once timed with the launch counts set to 0 just
   before it (flash_attention exactly 30 per prefill, paged_decode exactly
   30 per decode wave; every request finishes, no page leaks).  The
   contiguous-cache path fed the engine's tokens gives the same per-step
   logits (1e-3 absolute) and argmax where the top-2 margin exceeds 1e-3.
   Prints tokens/s, TTFT, the decode-wave time, launches per wave and the
   device busy share of a wave and of one prefill of 256 tokens (host wall,
   CUDA events, profiler device time, the kernels that take the most),
   Then the other served configurations at their published widths, one
   at a time, each freed before the next: granite-3-2b, granite-3-8b
   and granite-moe-1b-a400m through the paged engine at the same traffic
   and with the same checks (for MoE the contiguous path prefills the
   engine's padded group, and a wave's group of 4 slots is asserted to
   fit an expert's capacity, so no wave drops a token), gemma3-27b (cut
   to 14 layers: 62 do not fit one card; 2 prompts of 1536 tokens, so
   its local layers' ring caches of 1024 wrap) and musicgen-large (4
   prompts of 32 x 4 codebooks), deepseek-v2-236b (its dense MLA layer
   0 and 2 of its 59 MoE layers, 37 GB; 4 prompts of 256 tokens) and
   llama-3.2-vision-11b (all 40 layers, 39 GB; 2 prompts of 512 tokens,
   each with 1600 frontend tokens of width 1280 from seed 0) through
   ``launch.serve.generate`` (flash_attention exactly once a layer, and
   once more a cross-attention layer, for the prefill and for each
   decode step; every step's logits within 1e-3 of a teacher-forced
   forward, for deepseek's MoE the prefill's last position against a
   forward of the prompts, the same dispatch group, with every decode
   step's group asserted to fit the experts' capacity) and zamba2-2.7b
   (all 54 layers, 2.9 B parameters; 2 prompts of 1000 tokens, 16 new;
   9 attention layers, so 144 flash_attention launches; first cut to its
   first supercell of 6 layers, every step within 1e-3 of the forward;
   at 54 layers within ``DECODE_TOL`` with every SSD the sequential one,
   the chunked pair reported; a decode with the Mamba2 states zeroed
   after the prefill, all of them, the conv windows alone or the last
   repeat's alone, must fail that gate) and xlstm-1.3b (all 48 layers,
   3.57 B parameters, no attention: no kernel launches, asserted; 2
   prompts of 1000 tokens, 16 new; first its first supercell of 7 mLSTM
   and 1 sLSTM layers, every step within 1e-3 of the forward with the
   chunked mLSTM and with the recurrence; at 48 layers against a float64
   forward of the same weights on the card (``F64_WITNESS``): the
   float64 decode within ``XLSTM_F64_TOL``, each fp32 decode within
   ``XLSTM_F32_RATIO`` times its fp32 forward's gap; every state, the
   conv windows, the sLSTM states and the last repeat's states, each
   zeroed after the prefill, must fail the float64 gate (in fp32
   reported); the decode step's and the
   prefill's bounds printed): tokens/s, the median wave or step, TTFT
   and peak memory serving and at init.
   Then every SMOKE config (the nine) on the card against the CPU.  Then
   the replica sync (``serve.ReplicaGroup``): 4 replicas of smollm-135m
   at its published widths, ``perturb(0.02)``, 4 EF-int8 rounds of k = 2
   with the launch counts set to 0 just before them: the drift never
   rises and ends under 0.2 x the first, the wire bytes under half the
   raw ones, quant_mix and multi_hop_mix_quant exactly once a round (a
   tree of 12 leaves), the ms a round; then replica 0 serves 3 requests
   through the paged engine.
   This phase runs after the main path's profile and agreement.
6. LM training (``repro_torch.launch.train``), after serving, as its
   full-width states take half the card: the JAX package's recorded run
   (``tests/data/lm_reference.json``: smollm-135m at its published widths
   cut to 2 layers, 4 nodes, DRSGDA, 10 steps, from
   ``convert.lm_params_from_seed``) held at every step's loss,
   grad_norm_x and consensus_x and at M_t and the Stiefel residual of
   steps 5 and 10 within the gates the file records; the CLI at full
   width (30 layers, 8 nodes, 4 x 64 tokens a node, its default hyper)
   for 20 steps with ``--eval-every 10``, telemetry and one checkpoint,
   exiting 0 under the JAX success rule; in both runs the launches of
   ``flash_attention``, ``flash_attention_bwd``, ``stiefel_project`` and
   ``ring_mix`` as the code derives them (``_train_launches``) and no call
   of a plain attention version; then the full-width step's median wall,
   its polar retraction alone, and one profiled step (device time, busy
   share, top kernels); then the same under ``GDAHyper(retraction=
   "polar_fused")``, whose step launches ``fused_retract`` once per
   Stiefel leaf (4: the leaves are stacked over the layers; wq and wo,
   240 matrices of 576 x 576 each, on its global route, counted by the
   wrapper where it launches: ``ops.route_launch_counts()``) and
   ``stiefel_project`` only for the gradient's tree.  Then the other
   trained configurations: every recorded JAX run of
   ``tests/data/lm_models_reference.json`` (granite-moe-1b-a400m and
   musicgen-large at their published widths cut to 2 layers,
   deepseek-v2-236b, llama-3.2-vision-11b, zamba2-2.7b and xlstm-1.3b at
   SMOKE, 4 nodes of 2 x 64 tokens, 10 steps) held within its gates with
   its launches derived, then each on 4 nodes of 4 x 64 tokens
   (zamba2-2.7b at its published widths cut to a Mamba2 block and an
   attention block, xlstm-1.3b to an mLSTM and an sLSTM block, 313.7 M
   parameters a node): the median step, device busy, launches a step,
   peak memory, the JAX CLI's success rule; xlstm-1.3b's cut also one
   step under ``"polar_fused"`` (its four Stiefel leaves through
   fused_retract's global route).
7. Prints the kernel table as one JSON line (``launches`` from the path a
   kernel belongs to, the backward kernel's from the LM training path,
   fused_retract's four times: its cluster routes from the fair main
   path, its global route (r > 256) from the ``"polar_fused"`` LM step,
   and xlstm-1.3b's two leaf shapes from its cut's ``"polar_fused"``
   step;
   ``path_launches`` from every path), the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises, and the script exits non-zero without the last
line.  It needs a CUDA device and the repository's ``src/`` beside it.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published peaks of one H100 SXM (NVIDIA data sheet): fp32 on CUDA cores
# and HBM3 bandwidth.  bound_ms = max(flops / PEAK_FLOPS, bytes / PEAK_BYTES).
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
PEAK_FLOPS_BF16 = 989e12     # dense bf16 on the tensor cores
# fp32-accurate products on the tensor cores: 3xTF32, three TF32 products
# (495 TFLOP/s dense) per fp32 product
PEAK_FLOPS_TF32X3 = 495e12 / 3
DEVICE_CALLS = 50            # back-to-back calls per device_ms reading

KERNEL_META = {
    "stiefel_project": ("src/repro_torch/kernels/csrc/stiefel_project.cu",
                        "src/repro/kernels/stiefel_project.py:59"),
    "fused_retract": ("src/repro_torch/kernels/csrc/retract.cu",
                      "src/repro/kernels/retract.py:119"),
    "ring_mix": ("src/repro_torch/kernels/csrc/ring_mix.cu",
                 "src/repro/kernels/ring_mix.py:36"),
    "multi_hop_mix": ("src/repro_torch/kernels/csrc/multi_hop_mix.cu",
                      "src/repro/kernels/multi_hop_mix.py:117"),
    "quant_mix": ("src/repro_torch/kernels/csrc/quant_mix.cu",
                  "src/repro/kernels/quant_mix.py:46"),
    "multi_hop_mix_quant": (
        "src/repro_torch/kernels/csrc/multi_hop_mix_quant.cu",
        "src/repro/kernels/multi_hop_mix.py:190"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:80"),
    "paged_decode": ("src/repro_torch/kernels/csrc/paged_decode.cu",
                     "src/repro/kernels/paged_decode.py:98"),
    # no TPU kernel: the JAX package differentiates its plain attention
    "flash_attention_bwd": ("src/repro_torch/kernels/csrc/"
                            "flash_attention_bwd.cu",
                            "src/repro/kernels/ops.py:95 (no TPU kernel: "
                            "jax.grad of ref.blockwise_attention)"),
}
# the path each kernel belongs to (its launches in the table come from it)
FULL_PATH = ("stiefel_project", "fused_retract", "ring_mix", "multi_hop_mix")
INT8_PATH = ("stiefel_project", "fused_retract", "quant_mix",
             "multi_hop_mix_quant")
SERVE_PATH = ("flash_attention", "paged_decode")
BASELINE_PATH = ("stiefel_project", "ring_mix", "quant_mix")
TRAIN_PATH = ("flash_attention_bwd",)

# Main-path geometry: 20 nodes, 28x28x1 images, init_cnn's widths.
N_NODES = 20
K_THEOREM1 = 67
# node-stacked leaves of x (port layout: conv kernels OIHW) and of y
X_LEAVES = [(N_NODES, 8, 1, 3, 3), (N_NODES, 16, 8, 3, 3),
            (N_NODES, 784, 64), (N_NODES, 64, 3)]
Y_LEAF = (N_NODES, 3)
STIEFEL_LEAVES = [(N_NODES, 784, 64), (N_NODES, 64, 3)]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, reps: int = 15, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` from CUDA events, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, calls: int = DEVICE_CALLS, warmup: int = 3) -> float:
    """Milliseconds per call of ``fn`` over ``calls`` back-to-back calls
    between two CUDA events, after warm-up: the device's pace where it is
    slower than the host's launches, the host's where it is not."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def bound(flops: float, nbytes: float,
          peak: float = PEAK_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------


def _stiefel_inputs(shape, gen, device):
    """x on St(d, r) and an update direction, both contiguous as the
    optimizer's leaves are (the QR factor comes out column-major)."""
    import torch
    x = torch.linalg.qr(torch.randn(shape, generator=gen,
                                    device=device))[0].contiguous()
    # an update direction of the optimizer's size: alpha*[Wx]_i - beta*u
    g = 0.5 * x + 0.1 * torch.randn(shape, generator=gen, device=device)
    return x, g


def _project_cost(shape):
    """4 d r^2 flops a node (x^T g and x S) plus the subtraction, counted
    at the 3xTF32 rate; x and g read and the result written once."""
    b = math.prod(shape[:-2])
    d, r = shape[-2:]
    return b * (4 * d * r * r + d * r), 3 * b * d * r * 4


def _retract_cost(shape, ns_iters=20):
    """The least work of the function a node, at the 3xTF32 rate: the
    Grams x^T g (2 d r^2) and g^T g (d r (r + 1), symmetric), the apply
    x M1 + g M2 (4 d r^2); in the (r, r) stage B^T S and M1 (2 r^3 each)
    and the products that are symmetric in exact arithmetic, S S and the
    three of each Newton-Schulz iteration (r^2 (r + 1) each: a triangle
    and its diagonal).  x and g read and the result written once."""
    b = math.prod(shape[:-2])
    d, r = shape[-2:]
    sym = r * r * (r + 1)
    return (b * (6 * d * r * r + d * r * (r + 1) + 4 * r ** 3
                 + (1 + 3 * ns_iters) * sym),
            3 * b * d * r * 4)


def _mix_cost(shape, hops):
    n = math.prod(shape)
    return 4 * n * hops, 2 * n * 4


def _quant_cost(shape, hops):
    """Per element, hop 0: one dequantizing product (an element's decoded
    value is shared by the three outputs that read it) and the 4-operation
    combine, as :func:`_mix_cost` counts a hop; every later hop: a
    division, a rounding, two clips, an absolute value and a max (the row
    maxima), one product and the combine.  Bytes: the int8 payload and the
    n scales read once, the fp32 result written once."""
    n = math.prod(shape)
    return (5 * n + 11 * n * (hops - 1),
            n * 1 + shape[0] * 4 + n * 4)


def _fused_hop_cost(shape):
    """The int8 hop (:func:`_quant_cost`) plus the exact hop of an fp32
    base (4 operations, 4 bytes read an element) and the sum (1 operation
    an element)."""
    flops, nbytes = _quant_cost(shape, 1)
    n = math.prod(shape)
    return flops + 5 * n, nbytes + 4 * n


def _flat(results) -> list:
    """The outputs of a list of calls, a grouped call's list spread out."""
    out = []
    for r in results:
        out.extend(r if isinstance(r, (list, tuple)) else [r])
    return out


def profiled_ms(fn, calls: int) -> tuple[float, list]:
    """Device milliseconds per call of ``fn`` from ``torch.profiler`` (the
    device's own time, where events would read the host's pace), and its
    kernels, most time first, as :func:`_device_kernels` gives them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = _device_kernels(prof, calls)
    return sum(k[0] for k in kernels) / 1e3, kernels


def _kernel_split(kernels) -> str:
    """us a call per CUDA kernel, the name without its anonymous
    namespaces, template arguments and parameters."""
    def short(key):
        key = key.removeprefix("void ").replace("(anonymous namespace)::", "")
        return re.split(r"[<(]", key, maxsplit=1)[0]
    return ", ".join(f"{short(key)} {us:.1f} us x{count:.0f}"
                     for us, count, key in kernels[:6])


def run_case(name, calls, plain_calls, gate, costs, label,
             library_calls=None, peak=PEAK_FLOPS, lib_gate=1e-4,
             chain_calls=None, profile_calls=0, reps=15,
             device_calls=DEVICE_CALLS):
    """calls/plain_calls/library_calls: lists of thunks over the same
    inputs, each returning one output or (a grouped call) a list of them,
    the same outputs in the same order in all three; library_calls, where
    given, are one PyTorch call each that computes the same function up to
    rounding, within ``lib_gate`` of the plain version relative to its
    largest value.  ``peak``: the card's operation rate for the inputs'
    type.
    ``chain_calls``, where given: the calls a fused kernel replaces, timed
    beside it and held to the same gate.  With ``profile_calls``, the
    kernel's (and the library call's) device time a call is also read by
    :func:`profiled_ms` over that many calls, split by CUDA kernel.
    ``reps`` and ``device_calls``: the timed calls of ``ms`` and
    ``device_ms`` (fewer for a call of a second or so)."""
    import torch
    from repro_torch.obs import estimates as obs_est
    with obs_est.collect() as recorded:
        outs = _flat([c() for c in calls])
    torch.cuda.synchronize()
    want = _flat([p() for p in plain_calls])
    if len(outs) != len(want):
        raise AssertionError(f"{name} {label}: {len(outs)} outputs, the "
                             f"plain version has {len(want)}")
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(outs, want))
    scale = max(float(b.float().abs().max()) for b in want)
    ok, gate_txt = gate(outs, want, err, scale)
    ms = time_ms(lambda: [c() for c in calls], reps=reps)
    dev_ms = device_ms(lambda: [c() for c in calls], calls=device_calls)
    plain_ms = time_ms(lambda: [p() for p in plain_calls], reps=reps)
    library_ms, library_dev_ms, lib_txt = None, None, ""
    if library_calls is not None:
        lib_err = max(float((a.float() - b.float()).abs().max()) for a, b
                      in zip(_flat([lc() for lc in library_calls]), want))
        # the library call rounds in another order (one product by
        # W^k against k rounded hops; bf16 probabilities in SDPA): it
        # only has to compute the same function, which lib_gate shows
        if lib_err > lib_gate * scale:
            raise AssertionError(f"{name} {label}: the library call "
                                 f"differs by {lib_err:.3e}")
        library_ms = time_ms(lambda: [lc() for lc in library_calls])
        library_dev_ms = device_ms(lambda: [lc() for lc in library_calls])
        lib_txt = (f" library={library_ms:.4f} ms device={library_dev_ms:.4f}"
                   f" ms (err {lib_err:.1e})")
    # a cost is (flops, bytes), the flops at ``peak``
    flops = sum(c[0] for c in costs)
    nbytes = sum(c[1] for c in costs)
    b_ms, b_by = bound(flops, nbytes, peak)
    chain_ms, chain_dev_ms, chain_txt = None, None, ""
    if chain_calls is not None:
        chain = _flat([cc() for cc in chain_calls])
        torch.cuda.synchronize()
        if not gate(outs, chain, err, scale)[0]:
            raise AssertionError(f"{name} {label}: differs from the chain "
                                 f"it replaces")
        chain_ms = time_ms(lambda: [cc() for cc in chain_calls])
        chain_dev_ms = device_ms(lambda: [cc() for cc in chain_calls])
        chain_txt = (f" chain={chain_ms:.4f} ms device={chain_dev_ms:.4f} ms "
                     f"(equal)")
    log(f"  {name:16s} {label:34s} max_abs_err={err:.3e} "
        f"({gate_txt}) kernel={ms:.4f} ms device={dev_ms:.4f} ms "
        f"plain={plain_ms:.4f} ms"
        f"{lib_txt}{chain_txt} bound={b_ms:.5f} ms ({b_by})")
    prof_ms, lib_prof_ms = None, None
    if profile_calls:
        prof_ms, kernels = profiled_ms(lambda: [c() for c in calls],
                                       profile_calls)
        log(f"    profiler: kernel {prof_ms:.4f} ms a call "
            f"({_kernel_split(kernels)})")
        if library_calls is not None:
            lib_prof_ms, kernels = profiled_ms(
                lambda: [lc() for lc in library_calls], profile_calls)
            log(f"    profiler: library {lib_prof_ms:.4f} ms a call "
                f"({_kernel_split(kernels)})")
    if not ok:
        raise AssertionError(f"{name} {label}: outside its gate "
                             f"({gate_txt}), max_abs_err={err:.3e}")
    # the port's analytical estimate of the same calls (obs/estimates.py),
    # bounded on the same peak, beside this script's own count
    est = recorded.snapshot().get(name, {"calls": 0, "ops": 0.0, "lds": 0.0,
                                         "mem": 0.0})
    return {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms, "library_device_ms": library_dev_ms,
            "chain_ms": chain_ms, "chain_device_ms": chain_dev_ms,
            "profiler_ms": prof_ms, "library_profiler_ms": lib_prof_ms,
            "label": label, "cost": {"flops": flops, "bytes": nbytes},
            "estimate": {**est, "bound_ms": bound(est["ops"], est["mem"],
                                                  peak)[0]}}


def bitwise(outs, want, err, scale):
    import torch
    return all(torch.equal(a, b) for a, b in zip(outs, want)), "bitwise"


def absolute(tol):
    return lambda outs, want, err, scale: (err <= tol, f"<= {tol:g} abs")


def relative(tol):
    return lambda outs, want, err, scale: (err <= tol * scale,
                                           f"<= {tol:g} rel")


def kernel_phase(device="cuda") -> dict:
    """Each kernel against its plain version; returns the table rows."""
    import numpy as np
    import torch
    from repro_torch.core.gossip import ring_matrix
    from repro_torch.kernels import multi_hop_mix as _mh
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=device).manual_seed(0)
    wc = 1.0 / 3.0
    ws = (1.0 - wc) / 2.0
    rows = {}

    # -- stiefel_project: the main step's two Stiefel leaves in one grouped
    # call (the on-chip route), then the stress shapes one leaf a call
    # ((20, 1000, 37) on chip; the other two stream through the 3xTF32
    # tensor-core Gram and apply, bounded at that rate)
    from repro_torch.kernels import stiefel_project as _sp
    pairs = [_stiefel_inputs(s, gen, device) for s in STIEFEL_LEAVES]
    rows["stiefel_project"] = run_case(
        "stiefel_project",
        [lambda: ops.stiefel_project_leaves([a for a, _ in pairs],
                                            [b for _, b in pairs])],
        [lambda a=a, b=b: ref.stiefel_project_ref(a, b) for a, b in pairs],
        relative(1e-5), [_project_cost(s) for s in STIEFEL_LEAVES],
        "main step (20,784,64)+(20,64,3), 1 call", peak=PEAK_FLOPS_TF32X3)
    for shape in ((N_NODES, 4096, 256), (N_NODES, 4096, 99),
                  (N_NODES, 1000, 37)):
        a, b = _stiefel_inputs(shape, gen, device)
        ctas = _sp.cluster_size(*shape[1:])
        route = f"on chip, {ctas} CTAs" if ctas else "streaming"
        run_case("stiefel_project", [lambda: ops.stiefel_project(a, b)],
                 [lambda: ref.stiefel_project_ref(a, b)], relative(1e-5),
                 [_project_cost(shape)], f"stress {shape} [{route}]",
                 peak=PEAK_FLOPS_TF32X3)
    # -- fused_retract: its Gram and apply are the same tensor-core products
    rows["fused_retract"] = run_case(
        "fused_retract",
        [lambda a=a, b=b: ops.fused_retract(a, b) for a, b in pairs],
        [lambda a=a, b=b: ref.fused_retract_ref(a, b) for a, b in pairs],
        absolute(5e-5), [_retract_cost(s) for s in STIEFEL_LEAVES],
        "main step (20,784,64)+(20,64,3)", peak=PEAK_FLOPS_TF32X3)
    for shape in ((N_NODES, 4096, 256), (N_NODES, 4096, 99),
                  (N_NODES, 1000, 37)):
        a, b = _stiefel_inputs(shape, gen, device)
        run_case("fused_retract", [lambda: ops.fused_retract(a, b)],
                 [lambda: ref.fused_retract_ref(a, b)], absolute(5e-5),
                 [_retract_cost(shape)], f"stress {shape}",
                 peak=PEAK_FLOPS_TF32X3)
    # smollm-135m's Stiefel leaves under "polar_fused", as the full-width
    # step calls the kernel: each leaf stacked over the 30 layers and 8
    # nodes, wq / wo (576 x 576) on the global route (the (r, r) stage as
    # tensor-core GEMMs over global memory), wk / wv (576 x 192) on the
    # cluster route; then one layer's (8 nodes) and r = 257 on the global
    # route; each call repeated bit for bit
    from repro_torch import configs
    from repro_torch.kernels import retract as _rt
    stacked = TRAIN_NODES * configs.get_config("smollm-135m").n_layers
    for shape, calls in (((stacked, 576, 576), 3), ((stacked, 576, 192), 3),
                         ((TRAIN_NODES, 576, 576), 10),
                         ((TRAIN_NODES, 576, 257), 10)):
        a, b = _stiefel_inputs(shape, gen, device)
        ctas = _rt.cluster_size(shape[-1])
        route = f"cluster of {ctas}" if ctas else "global"
        row = run_case("fused_retract", [lambda: ops.fused_retract(a, b)],
                       [lambda: ref.fused_retract_ref(a, b)], absolute(5e-5),
                       [_retract_cost(shape)], f"LM leaf {shape} [{route}]",
                       peak=PEAK_FLOPS_TF32X3, profile_calls=calls)
        if not torch.equal(ops.fused_retract(a, b), ops.fused_retract(a, b)):
            raise AssertionError(f"fused_retract {shape}: two calls differ")
        if (shape[-1] > _rt.MAX_R) != (ctas == 0):
            raise AssertionError(f"fused_retract {shape}: route {ctas}")
        if shape == (stacked, 576, 576):
            rows["fused_retract_global"] = row
        del a, b
    log("  fused_retract: the LM leaves repeat bit for bit")
    # xlstm-1.3b's Stiefel leaves under "polar_fused", as the step of its
    # cut to one mLSTM and one sLSTM block calls the kernel on 4 nodes:
    # wq, wk, wv (4096 x 4096) and w_down (4096 x 2048), both on the
    # global route; a call takes about a second, so fewer timed calls
    for shape in ((TRAIN_MODELS_NODES, 4096, 4096),
                  (TRAIN_MODELS_NODES, 4096, 2048)):
        a, b = _stiefel_inputs(shape, gen, device)
        if _rt.cluster_size(shape[-1]) != 0:
            raise AssertionError(f"fused_retract {shape}: not the global "
                                 f"route")
        row = run_case("fused_retract", [lambda: ops.fused_retract(a, b)],
                       [lambda: ref.fused_retract_ref(a, b)], absolute(5e-5),
                       [_retract_cost(shape)],
                       f"xlstm leaf {shape} [global]",
                       peak=PEAK_FLOPS_TF32X3, profile_calls=1, reps=3,
                       device_calls=3)
        rows[f"fused_retract {shape}"] = row
        del a, b

    # -- the library call of the ring mixes: W^k x as one fp32 GEMM per
    # leaf, with W^k taken in float64 and cast, as the dense mix path does
    def library(xs, k):
        wk = {n: torch.as_tensor(
            np.linalg.matrix_power(ring_matrix(n, wc), k),
            dtype=torch.float32, device=device)
            for n in {x.shape[0] for x in xs}}
        return [lambda x=x: torch.matmul(wk[x.shape[0]], x.view(
            x.shape[0], -1)).view(x.shape) for x in xs]

    def trees(n, n_trees):
        """``n_trees`` trees of x's leaves on an n-node ring, then y alone:
        the grouped calls of one step's mixes."""
        return ([[torch.randn((n, *s[1:]), generator=gen, device=device)
                  for s in X_LEAVES] for _ in range(n_trees)]
                + [[torch.randn((n, *Y_LEAF[1:]), generator=gen,
                                device=device)]])

    # -- ring_mix: one step mixes x and u (4 leaves each), y and v: four
    # grouped calls, beside ten GEMMs
    groups = trees(N_NODES, 2) + trees(N_NODES, 0)
    xs = _flat(groups)
    rows["ring_mix"] = run_case(
        "ring_mix", [lambda g=g: ops.ring_mix_leaves(g, w_self=wc, w_side=ws)
                     for g in groups],
        [lambda x=x: ref.ring_mix_ref(x, x.roll(1, 0), x.roll(-1, 0), wc, ws)
         for x in xs], bitwise, [_mix_cost(x.shape, 1) for x in xs],
        "main step 4 calls, 10 leaves", library(xs, 1))
    big = torch.randn((N_NODES, 1 << 20), generator=gen, device=device)
    run_case("ring_mix", [lambda: ops.ring_mix(big, w_self=wc, w_side=ws)],
             [lambda: ref.ring_mix_ref(big, big.roll(1, 0), big.roll(-1, 0),
                                       wc, ws)],
             bitwise, [_mix_cost(big.shape, 1)], "stress (20, 1M)",
             library([big], 1))

    # -- multi_hop_mix: the k = 67 step mixes x, y and u with W^k ----------
    def hops_plain(x, k):
        z = x
        for _ in range(k):
            z = ref.ring_mix_ref(z, z.roll(1, 0), z.roll(-1, 0), wc, ws)
        return z

    def grouped_hops(groups, k):
        return [lambda g=g: ops.multi_hop_mix_leaves(g, hops=k, w_self=wc,
                                                     w_side=ws)
                for g in groups]

    # the main step: x, u and y, three grouped calls beside nine GEMMs
    groups = trees(N_NODES, 2)
    xs = _flat(groups)
    rows["multi_hop_mix"] = run_case(
        "multi_hop_mix", grouped_hops(groups, K_THEOREM1),
        [lambda x=x: hops_plain(x, K_THEOREM1) for x in xs], bitwise,
        [_mix_cost(x.shape, K_THEOREM1) for x in xs],
        f"main step k={K_THEOREM1}, 3 calls, 9 leaves",
        library(xs, K_THEOREM1))
    res = _mh.resources(N_NODES)
    regs, blocks, width = res["regs"], res["resident"], res["threads"]
    log(f"  multi_hop_mix    register kernel N={N_NODES}: {regs} registers "
        f"a thread, {blocks} blocks of {width} threads per SM = "
        f"{blocks * width // 32} of 64 warps")
    # the shared-memory kernel (n > 32): one step's x and y trees on a
    # 40-node ring
    groups = trees(40, 1)
    xs = _flat(groups)
    for k in (1, K_THEOREM1):
        run_case("multi_hop_mix", grouped_hops(groups, k),
                 [lambda x=x, k=k: hops_plain(x, k) for x in xs], bitwise,
                 [_mix_cost(x.shape, k) for x in xs],
                 f"n=40 (shared memory) 2 calls, 5 leaves k={k}",
                 library(xs, k))
    for k in (1, 3, K_THEOREM1):
        run_case("multi_hop_mix",
                 [lambda k=k: ops.multi_hop_mix(big, hops=k, w_self=wc,
                                                w_side=ws)],
                 [lambda k=k: hops_plain(big, k)], bitwise,
                 [_mix_cost(big.shape, k)], f"stress (20, 1M) k={k}",
                 library([big], k))
    # the halo-panel oracle of the JAX package's interface, on the wrapped
    # panel: the same numbers as k repeated hops
    small = big[:, :4096]
    panel = ref.multi_hop_mix_ref(ref.ring_panel(small, K_THEOREM1),
                                  hops=K_THEOREM1, out_rows=N_NODES,
                                  halo=K_THEOREM1, w_self=wc, w_side=ws)
    if not torch.equal(panel, ops.multi_hop_mix(small, hops=K_THEOREM1,
                                                w_self=wc, w_side=ws)):
        raise AssertionError("multi_hop_mix differs from the panel oracle")
    log("  multi_hop_mix    bitwise equal to the halo-panel oracle (k=67)")

    # -- the int8 ring mixes: payloads of quantize_det, one scale per row --
    from repro_torch.comms.compress import quantize_det

    def payload(x):
        q, s = quantize_det(x)
        return q.reshape(N_NODES, -1), s.reshape(N_NODES, 1)

    def quant_plain(q, s):
        return ref.quant_mix_ref(q, q.roll(1, 0), q.roll(-1, 0), s,
                                 s.roll(1, 0), s.roll(-1, 0), wc, ws)

    def quant_hops_plain(q, s, k):
        return ref.multi_hop_mix_quant_ref(
            ref.ring_panel(q, k), ref.ring_panel(s, k), hops=k, w_self=wc,
            w_side=ws)[k:k + N_NODES]

    # quant_mix: the first hop of one EF-int8 step, one grouped call for
    # each of the trees x, u (4 leaves each), y and v, with the old public
    # copies' exact hop fused in; beside the chain it replaces (ring_mix of
    # the 4 hat trees, quant_mix of the 10 leaves, 10 adds)
    tree_shapes = [X_LEAVES, X_LEAVES, [Y_LEAF], [Y_LEAF]]
    qtrees = [[payload(torch.randn(s, generator=gen, device=device))
               for s in tree] for tree in tree_shapes]
    hats = [[torch.randn((N_NODES, q.shape[1]), generator=gen, device=device)
             for q, _ in tree] for tree in qtrees]

    def fused(tree, base):
        return ops.quant_mix_leaves([q for q, _ in tree], [s for _, s in tree],
                                    base=base, w_self=wc, w_side=ws)

    def chain(tree, base):
        mixed = ops.ring_mix_leaves(base, w_self=wc, w_side=ws)
        return [m + ops.quant_mix(q, s, w_self=wc, w_side=ws)
                for m, (q, s) in zip(mixed, tree)]

    def fused_plain(q, s, h):
        return ref.ring_mix_ref(h, h.roll(1, 0), h.roll(-1, 0), wc, ws) \
            + quant_plain(q, s)

    rows["quant_mix"] = run_case(
        "quant_mix",
        [lambda t=t, h=h: fused(t, h) for t, h in zip(qtrees, hats)],
        [lambda q=q, s=s, h=h: fused_plain(q, s, h)
         for t, hs in zip(qtrees, hats) for (q, s), h in zip(t, hs)],
        bitwise, [_fused_hop_cost(q.shape) for t in qtrees for q, _ in t],
        "main step 4 calls + hats, 10 leaves",
        chain_calls=[lambda t=t, h=h: chain(t, h)
                     for t, h in zip(qtrees, hats)])
    run_case("quant_mix",
             [lambda t=t: fused(t, None) for t in qtrees],
             [lambda q=q, s=s: quant_plain(q, s) for t in qtrees
              for q, s in t], bitwise,
             [_quant_cost(q.shape, 1) for t in qtrees for q, _ in t],
             "main step 4 calls, no base")
    qbig, sbig = payload(big)
    hbig = torch.randn(big.shape, generator=gen, device=device)
    run_case("quant_mix", [lambda: fused([(qbig, sbig)], [hbig])],
             [lambda: fused_plain(qbig, sbig, hbig)], bitwise,
             [_fused_hop_cost(big.shape)], "stress (20, 1M) + hat",
             chain_calls=[lambda: chain([(qbig, sbig)], [hbig])])
    run_case("quant_mix", [lambda: ops.quant_mix(qbig, sbig, w_self=wc,
                                                 w_side=ws)],
             [lambda: quant_plain(qbig, sbig)], bitwise,
             [_quant_cost(big.shape, 1)], "stress (20, 1M)")

    # multi_hop_mix_quant: the k = 67 step's tail of x, u and y (66 hops),
    # one grouped call per tree, as the comms engine makes them
    tail = K_THEOREM1 - 1
    trees = [X_LEAVES, X_LEAVES, [Y_LEAF]]
    groups = [[payload(torch.randn(s, generator=gen, device=device))
               for s in tree] for tree in trees]
    rows["multi_hop_mix_quant"] = run_case(
        "multi_hop_mix_quant",
        [lambda g=g: ops.multi_hop_mix_quant_leaves(
            [q for q, _ in g], [s for _, s in g], hops=tail, w_self=wc,
            w_side=ws) for g in groups],
        [lambda q=q, s=s: quant_hops_plain(q, s, tail)
         for g in groups for q, s in g],
        bitwise, [_quant_cost(s, tail) for tree in trees for s in tree],
        f"main step {tail} hops, 3 calls, 9 leaves")
    for k in (1, 3, tail):
        run_case("multi_hop_mix_quant",
                 [lambda k=k: ops.multi_hop_mix_quant(qbig, sbig, hops=k,
                                                      w_self=wc, w_side=ws)],
                 [lambda k=k: quant_hops_plain(qbig, sbig, k)], bitwise,
                 [_quant_cost(big.shape, k)], f"stress (20, 1M) hops={k}")
    # the JAX package's stacked schedule, hop by hop: quantize_det + one
    # compressed hop, the same numbers as the one-launch schedule
    z = big[:, :4096]
    want = z
    for _ in range(tail):
        q, s = payload(want)
        want = quant_plain(q, s)
    q, s = payload(z)
    if not torch.equal(ops.multi_hop_mix_quant(q, s, hops=tail, w_self=wc,
                                               w_side=ws), want):
        raise AssertionError("multi_hop_mix_quant differs from the hop-by-hop "
                             "schedule")
    log(f"  multi_hop_mix_quant bitwise equal to {tail} hops of quantize_det "
        f"+ quant_mix")

    # -- a CUDA operand the kernel does not take raises --------------------
    for call in (lambda: ops.ring_mix(big.double(), w_self=wc, w_side=ws),
                 lambda: ops.fused_retract(*(t.double() for t in pairs[0])),
                 lambda: ops.stiefel_project_leaves(
                     [t.double() for t, _ in pairs], [t for _, t in pairs]),
                 lambda: ops.quant_mix_leaves([qbig], [sbig],
                                              base=[hbig.double()],
                                              w_self=wc, w_side=ws),
                 lambda: ops.quant_mix(qbig.float(), sbig, w_self=wc,
                                       w_side=ws),
                 lambda: ops.multi_hop_mix_quant(qbig, sbig.double(), hops=3,
                                                 w_self=wc, w_side=ws)):
        try:
            call()
        except TypeError as exc:
            log(f"  operand of another dtype raises: {exc}")
        else:
            raise AssertionError("a CUDA operand of another dtype did not "
                                 "raise")
    torch.cuda.synchronize()
    return rows


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------


class PathRun(NamedTuple):
    """One ``run_method`` call of a path, and the launches each of its
    steps must make (``expect``: kernel -> launches a step)."""
    name: str
    steps: int
    det: bool
    k: int
    comm: object
    expect: dict
    retraction: str = "polar_fused"


# launches of one evaluation (a curve point of run_method): M_t's Riemannian
# gradient projects fc1 and head in one grouped stiefel_project call; and
# of DRGDA's and DRSGDA's init, which projects the first gradient so
# (the baselines' init takes Euclidean gradients)
EVAL_LAUNCHES = {"stiefel_project": 1}
INIT_LAUNCHES = {"drgda": {"stiefel_project": 1},
                 "drsgda": {"stiefel_project": 1}}


def _run_path(label: str, runs, kernels) -> dict:
    """Drive ``runs`` (:class:`PathRun`) through ``run_method`` with the
    launch counts set to 0 just before and read just after; every kernel
    in ``kernels`` must have launched, and each run's kernels of
    ``expect`` exactly as often as its steps and evaluations need.
    Returns the path's counts."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.fair import run_method

    ops.reset_launch_counts()
    for run in runs:
        before = ops.launch_counts()
        res = run_method(run.name, run.steps, run.det, image_hw=28,
                         n_nodes=N_NODES, k_steps=run.k,
                         retraction=run.retraction, eval_every=10,
                         device="cuda", comm=run.comm)
        torch.cuda.synchronize()
        after = ops.launch_counts()
        got = {n: after[n] - before[n] for n in after}
        last = res["curve"][-1]
        tag = f"{label} {run.name} k={run.k}" + (
            "" if run.retraction == "polar_fused" else f" {run.retraction}")
        log(f"  {tag:22s} steps={run.steps:<3d} "
            f"final loss={last['loss']:.6f} M_t={last['M_t']:.6f} "
            f"stiefel_residual={last['stiefel_residual']:.3e} "
            f"us_per_step={res['us_per_step']:.1f} "
            f"x_bits/param={res['x_bits_per_param_per_mix']:.3f} "
            f"launches={got}")
        _check_curve(tag, res["curve"])
        evals = len(res["curve"])
        for kernel, per_step in run.expect.items():
            want = (per_step * run.steps + EVAL_LAUNCHES.get(kernel, 0)
                    * evals + INIT_LAUNCHES.get(run.name, {}).get(kernel, 0))
            if got[kernel] != want:
                raise AssertionError(f"{tag}: {kernel} launched {got[kernel]} "
                                     f"times, the init, steps and "
                                     f"evaluations need {want}")
    counts = ops.launch_counts()
    missing = [n for n in kernels if counts[n] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the {label} path: "
                             f"{missing}")
    return counts


def _check_curve(tag: str, curve) -> None:
    """Finite curve points, each on the manifold to 1e-4."""
    for point in curve:
        if not all(math.isfinite(point[key]) for key in
                   ("loss", "M_t", "consensus_x", "stiefel_residual")):
            raise AssertionError(f"{tag}: non-finite {point}")
        if point["stiefel_residual"] > 1e-4:
            raise AssertionError(f"{tag}: Stiefel residual "
                                 f"{point['stiefel_residual']:.3e}")


# a baseline step: every mix one hop, one grouped ring_mix call per mixed
# tree (x, y, u, v; DM-HSGD mixes its estimators as u and v); the
# projection back is plain products, so no stiefel_project (core/
# baselines.py), no fused_retract and no multi_hop_mix
BASELINE_STEP = {"ring_mix": 4, "stiefel_project": 0, "fused_retract": 0,
                 "multi_hop_mix": 0}
# a DRGDA step under the "polar" or "cayley" retraction (core/gda.py): the
# gradient's projection, one grouped call for fc1 and head, then
# descent_update's two single-leaf projections (alpha P_x(mx) and P_x(u))
# on each of fc1 and head: 1 + 2 * 2 launches; the retraction itself is
# plain products
PLAIN_RETRACTION_STEP = {"ring_mix": 4, "stiefel_project": 5,
                         "fused_retract": 0, "multi_hop_mix": 0}


def main_path_phase() -> dict:
    """The port's main paths through its entry point; returns each
    kernel's launch count from every path (full, int8, baselines)."""
    from repro_torch.launch.fair import COMM_PRESETS

    # per step: one grouped ring call for each mixed tree, x, y, u and v
    # (core/gda.py), with k hops for x, y and u and one hop for v
    full = _run_path("full", (
        PathRun("drgda", 30, True, 1, None,
                {"ring_mix": 4, "multi_hop_mix": 0}),
        PathRun("drsgda", 30, False, 1, None,
                {"ring_mix": 4, "multi_hop_mix": 0}),
        PathRun("drgda", 5, True, K_THEOREM1, None,
                {"ring_mix": 1, "multi_hop_mix": 3})), FULL_PATH)
    int8 = COMM_PRESETS["int8_ef"]
    int8_all = dataclasses.replace(int8, quant_hops="all")
    # per step: one grouped compressed first hop for each of the trees x,
    # y, u and v, with the error-feedback hop of its old hats fused in (no
    # ring_mix); under quant_hops="all" at k > 1 one grouped tail launch
    # for each of the trees x, y and u (v mixes with one hop).  The drop
    # channel mixes by einsum.
    ef = _run_path("int8", (
        PathRun("drgda", 30, True, 1, int8,
                {"quant_mix": 4, "ring_mix": 0, "multi_hop_mix_quant": 0}),
        PathRun("drgda", 5, True, K_THEOREM1, int8_all,
                {"quant_mix": 4, "ring_mix": 0, "multi_hop_mix_quant": 3,
                 "multi_hop_mix": 0}),
        PathRun("drgda", 10, True, 1, COMM_PRESETS["int8_ef_drop5"],
                {"quant_mix": 0, "ring_mix": 0, "multi_hop_mix_quant": 0})),
        INT8_PATH)
    # the paper's baselines (GT-SRVR anchors at t = 0 and 16), one of them
    # over EF-int8 gossip (one grouped first hop per tree), and DRGDA
    # under the Cayley retraction
    base = _run_path("baselines", (
        PathRun("gt-gda", 30, True, 1, None, BASELINE_STEP),
        PathRun("gnsd-a", 30, False, 1, None, BASELINE_STEP),
        PathRun("dm-hsgd", 30, False, 1, None, BASELINE_STEP),
        PathRun("gt-srvr", 30, False, 1, None, BASELINE_STEP),
        PathRun("gt-srvr", 10, False, 1, int8,
                {**BASELINE_STEP, "ring_mix": 0, "quant_mix": 4,
                 "multi_hop_mix_quant": 0}),
        PathRun("drgda", 10, True, 1, None, PLAIN_RETRACTION_STEP,
                retraction="cayley")), BASELINE_PATH)
    return {"full": full, "int8": ef, "baselines": base}


def figures_phase() -> dict:
    """Paper Figs. 1-2 on the card at the JAX package's settings (20-node
    ring, 14x14 images, seed 0, 120 and 150 steps, evaluation every 10),
    from its initial weights, held curve point by curve point against its
    curves (``tests/data/fair_reference_curves.json``) under the gate the
    file records for each point: taken from the JAX package's own spread
    under a perturbation of its initial weights and the port's CPU gap;
    points where the JAX package does not reproduce itself are reported,
    not gated.  Returns the path's counts."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.fair import (compare_to_reference, load_reference,
                                         run_reference_figures,
                                         within_reference)

    ref = load_reference(ROOT / "tests" / "data"
                         / "fair_reference_curves.json")
    s = ref["settings"]
    ops.reset_launch_counts()
    figs = run_reference_figures(ref, "cuda")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    comparison = compare_to_reference(figs, ref)
    steps = evals = riemannian_steps = inits = 0
    for fig, runs in figs.items():
        ref_runs = {r["method"]: r for r in ref["figures"][fig]}
        for res in runs:
            name = res["method"]
            _check_curve(f"figures {name}", res["curve"])
            steps += res["curve"][-1]["step"]
            evals += len(res["curve"])
            if name in INIT_LAUNCHES:
                riemannian_steps += res["curve"][-1]["step"]
                inits += INIT_LAUNCHES[name]["stiefel_project"]
            last = ref_runs[name]["curve"][-1]
            log(f"  {name:8s} steps={res['curve'][-1]['step']:<4d} final "
                f"loss={res['final_loss']:.6f} (JAX {last['loss']:.6f}) "
                f"M_t={res['final_M_t']:.6f} (JAX {last['M_t']:.6f}) "
                f"us_per_step={res['us_per_step']:.1f}")
            for key, c in comparison[name].items():
                reported = ("" if c["reported"] is None else
                            f"; after it, reported: {c['reported']:.3e}")
                log(f"    {key:16s} largest gap {c['gated']:.3e} over the "
                    f"gated points (through step {c['gated_through']})"
                    f"{reported}; over the gate: {c['over'] or 'none'}")
    # every step mixes x, y, u and v in one grouped ring call each; DRGDA
    # and DRSGDA under "polar" project 5 times a step
    # (PLAIN_RETRACTION_STEP) and once at init, the
    # baselines never; each evaluation once
    want = {"ring_mix": 4 * steps, "stiefel_project": 5 * riemannian_steps
            + inits + evals, "fused_retract": 0, "multi_hop_mix": 0,
            "quant_mix": 0}
    if any(counts[n] != c for n, c in want.items()):
        raise AssertionError(f"figures: launches {counts}, want {want}")
    log(f"  {s['n_nodes']} nodes, {s['image_hw']}x{s['image_hw']} images, "
        f"{steps} steps, {evals} curve points; launches {counts}")
    if not within_reference(comparison):
        raise AssertionError("figures: curve points outside the "
                             "reference's gate (above)")
    return counts


# ---------------------------------------------------------------------------
# the other geometries, robust PCA and DRO
# ---------------------------------------------------------------------------

GEOMETRY_SHAPES = [(N_NODES, 784, 64), (N_NODES, 20, 3)]
GEOMETRY_CASES = [("grassmann", "polar"), ("grassmann", "qr"),
                  ("oblique", "normalize"), ("sphere", "normalize")]
GEOMETRY_REL = 1e-5
# dist: principal angles (Grassmann) and great-circle angles, absolute, at
# the CPU tests' tolerance (tests/test_torch_geometries.py)
GEOMETRY_DIST_ABS = 1e-4


def geometry_phase() -> None:
    """Grassmann (polar and QR retractions), oblique, sphere and a Product
    of all five geometries on node-stacked inputs from a seed:
    tangent_project, retract, project, consensus_mean, dist and check on the
    card against the same calls on the CPU (1e-5 relative to the largest
    value; dist 1e-4 absolute), and the axioms on the card: R_x(0) = x to
    1e-5, and check < 1e-5 after a step."""
    import torch
    from repro_torch import geometry as G

    def rel(tag, got, want):
        if isinstance(want, dict):
            return max(rel(f"{tag} {k}", got[k], want[k]) for k in want)
        err = float((got.cpu() - want).abs().max())
        scale = max(float(want.abs().max()), 1e-30)
        if err > GEOMETRY_REL * scale:
            raise AssertionError(f"geometry {tag}: card vs CPU "
                                 f"{err:.3e} (scale {scale:.3e})")
        return err / scale

    def one(m, kind, x, y, g, tag):
        """Every op of ``m`` on the card against the CPU; returns the
        largest relative gap and the dist gap."""
        xc, yc, gc = (_leafwise(lambda t: t.cuda(), t) for t in (x, y, g))
        gaps = []
        u = m.tangent_project(x, g)
        gaps.append(rel(f"{tag} tangent_project",
                        m.tangent_project(xc, gc), u))
        step = _scaled(u, 0.3)
        stepc = _scaled(m.tangent_project(xc, gc), 0.3)
        gaps.append(rel(f"{tag} retract {kind}", m.retract(xc, stepc, kind),
                        m.retract(x, step, kind)))
        a = _leafwise(lambda xi, gi: xi + 0.05 * gi, x, g)
        ac = _leafwise(lambda xi, gi: xi + 0.05 * gi, xc, gc)
        gaps.append(rel(f"{tag} project", m.project(ac), m.project(a)))
        gaps.append(rel(f"{tag} consensus_mean", m.consensus_mean(ac),
                        m.consensus_mean(a)))
        gaps.append(rel(f"{tag} check", m.check(ac), m.check(a)))
        dist_gap = float((m.dist(xc, yc).cpu() - m.dist(x, y)).abs().max())
        if dist_gap > GEOMETRY_DIST_ABS:
            raise AssertionError(f"geometry {tag}: dist card vs CPU "
                                 f"{dist_gap:.3e}")
        r0 = m.retract(xc, _leafwise(torch.zeros_like, xc), kind)
        at_zero = float(_leafwise_max(lambda a, b: (a - b).abs().max(),
                                      r0, xc))
        after = float(m.check(m.retract(xc, stepc, kind)).max())
        if at_zero > 1e-5 or after > 1e-5:
            raise AssertionError(f"geometry {tag}: R_x(0) - x {at_zero:.3e}"
                                 f", check after a step {after:.3e}")
        log(f"  {tag:36s} card vs CPU: largest relative gap "
            f"{max(gaps):.3e}, dist {dist_gap:.3e}; R_x(0) - x "
            f"{at_zero:.3e}, check after a step {after:.3e}")

    gen = torch.Generator().manual_seed(0)
    for name, kind in GEOMETRY_CASES:
        m = G.get(name)
        for shape in GEOMETRY_SHAPES:
            x, y = (m.rand(*shape[1:], shape[:1], generator=gen,
                           device="cpu") for _ in range(2))
            g = torch.randn(shape, generator=gen)
            one(m, kind, x, y, g, f"{name} {kind} {shape}")
    spec = {"g": "grassmann", "o": "oblique", "s": "sphere", "w": "stiefel",
            "e": "euclidean"}
    pm = G.Product(spec)
    big, small = GEOMETRY_SHAPES
    like = {"g": big, "o": small, "s": big, "w": big, "e": small}
    x, y = (pm.rand({k: torch.empty(v) for k, v in like.items()},
                    generator=gen, device="cpu") for _ in range(2))
    g = {k: torch.randn(v, generator=gen) for k, v in like.items()}
    for kind in ("polar", "qr"):
        one(pm, kind, x, y, g, f"product of five {kind}")


def _leafwise(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: fn(*(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leafwise_max(fn, *trees):
    import torch
    if isinstance(trees[0], dict):
        return torch.stack([fn(*(t[k] for t in trees))
                            for k in trees[0]]).max()
    return fn(*trees)


def _scaled(u, norm):
    """Each node's tangent step scaled to Frobenius norm ``norm`` (a tree:
    leaf by leaf)."""
    return _leafwise(lambda ui: norm * ui / ui.flatten(1).norm(dim=1)
                     .clamp_min(1e-9).view(-1, *[1] * (ui.ndim - 1)), u)


# a robust-PCA DRGDA step (core/gda.py; geometry/grassmann.py): the
# Grassmann projection is plain products (no symmetrization, not the
# Stiefel kernel), so no stiefel_project; Grassmann has no fused retraction;
# the metric projects by the same plain products.  Mixes: the full-width
# run gossips once a step on the 20-node ring (k = 1): one grouped ring
# call for each of x, y, u and v.  The example gossips at the ring's
# Theorem-1 steps, as examples/robust_pca.py does (GossipSpec's default,
# k = 8 for 8 nodes): x, y and u with one grouped multi-hop call each,
# v with one ring hop.
PCA_FULL_STEP = {"ring_mix": 4, "multi_hop_mix": 0, "stiefel_project": 0,
                 "fused_retract": 0}
PCA_EXAMPLE_STEP = {"ring_mix": 1, "multi_hop_mix": 3, "stiefel_project": 0,
                    "fused_retract": 0}
PCA_AGREE_REL = 1e-4


def _launched(before: dict) -> dict:
    from repro_torch.kernels import ops
    return {n: c - before[n] for n, c in ops.launch_counts().items()}


def _check_launches(tag: str, got: dict, want: dict) -> None:
    if any(got[n] != c for n, c in want.items()):
        raise AssertionError(f"{tag}: launches {got}, want {want}")


def robust_pca_phase() -> dict:
    """Robust PCA on the Grassmann manifold through
    ``repro_torch.launch.robust_pca``:

    1. the example's run (Gr(20, 3), 8 nodes, 800 steps) from the JAX
       package's data, planted basis and initial basis
       (``tests/data/robust_pca_reference.json``), every curve point and
       Phi held against its run under the gates the file records, and the
       example's four checks;
    2. the full-width run, Gr(784, 64) on the 20-node ring with 256 samples
       a node, 100 steps: every point finite, feasible to 1e-4, the loss
       lower at every curve point than at the one before;
    3. the full-width run for 5 steps on the card and on the CPU: loss and
       M_t at every step within 1e-4 relative.

    The launches of each run are asserted (PCA_EXAMPLE_STEP,
    PCA_FULL_STEP; init and evaluations launch nothing).  Returns the
    counts of runs 1 and 2."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import robust_pca as rp

    ref = rp.load_reference(ROOT / "tests" / "data"
                            / "robust_pca_reference.json")
    ops.reset_launch_counts()
    before = ops.launch_counts()
    res = rp.run_reference(ref, "cuda")
    torch.cuda.synchronize()
    _check_launches("robust PCA example", _launched(before),
                    {n: c * res["steps"] for n, c in
                     PCA_EXAMPLE_STEP.items()})
    comparison = rp.compare_to_reference(res, ref)
    last, want = res["curve"][-1], ref["curve"][-1]
    log(f"  example Gr(20, 3) n=8 k={res['k']} steps={res['steps']}: final "
        f"loss={last['loss']:.6f} (JAX {want['loss']:.6f}) "
        f"M_t={last['M_t']:.4e} (JAX {want['M_t']:.4e}) "
        f"angle={last['angle']:.4f} (JAX {want['angle']:.4f}) "
        f"residual={last['stiefel_residual']:.3e}; Phi DRGDA "
        f"{res['phi']['drgda']:.6f} (JAX {ref['phi']['drgda']:.6f}) PCA "
        f"{res['phi']['pca']:.6f} (JAX {ref['phi']['pca']:.6f}); "
        f"us_per_step={res['us_per_step']:.1f}; launches a step "
        f"{ {n: c for n, c in res['launches_per_step'].items() if c} }")
    for q, v in comparison["curve"]["drgda"].items():
        log(f"    {q:16s} largest gap {v['gated']:.3e} over the gated "
            f"points (through step {v['gated_through']}); over the gate: "
            f"{v['over'] or 'none'}")
    for name, c in comparison["phi"].items():
        log(f"    Phi {name:12s} gap {c['gap']:.3e} (gate {c['gate']:.1e})")
    if not rp.within_reference(comparison):
        raise AssertionError("robust PCA example: outside the reference's "
                             "gates (above)")
    failed = [name for name, ok in res["checks"].items() if not ok]
    if failed:
        raise AssertionError(f"robust PCA example: checks failed {failed}")
    log(f"    the example's checks hold: {', '.join(res['checks'])}")

    before = ops.launch_counts()
    full = rp.run("full", device="cuda")
    torch.cuda.synchronize()
    _check_launches("robust PCA full width", _launched(before),
                    {n: c * full["steps"] for n, c in PCA_FULL_STEP.items()})
    for p in full["curve"]:
        if not all(math.isfinite(p[k]) for k in ("loss", "M_t",
                                                 "consensus_x", "angle")):
            raise AssertionError(f"robust PCA full width: non-finite {p}")
        if p["stiefel_residual"] > 1e-4:
            raise AssertionError(f"robust PCA full width: residual {p}")
    # progress: the loss falls from one curve point to the next.  M_t does
    # not fall in 100 steps: the random start is near a saddle, where the
    # gradient is small and grows as x leaves it (on the CPU, M_t rises
    # from 0.0602 after step 1 to 0.0915 at step 500 and is below 0.0602
    # again only at step 1500)
    losses = [p["loss"] for p in full["curve"]]
    if not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"robust PCA full width: the loss does not "
                             f"fall at every curve point: {losses}")
    first, last = full["curve"][0], full["curve"][-1]
    log(f"  full width Gr(784, 64) n=20 m=256 k={full['k']} "
        f"steps={full['steps']}: M_t {first['M_t']:.4e} after step 1 -> "
        f"{last['M_t']:.4e}, loss {first['loss']:.6f} -> "
        f"{last['loss']:.6f}, angle {last['angle']:.4f}, residual "
        f"{last['stiefel_residual']:.3e}, Phi DRGDA "
        f"{full['phi']['drgda']:.6f} PCA {full['phi']['pca']:.6f}; "
        f"us_per_step={full['us_per_step']:.1f}; launches a step "
        f"{ {n: c for n, c in full['launches_per_step'].items() if c} }")
    counts = ops.launch_counts()

    gpu, cpu = (rp.run("full", steps=5, eval_every=1, device=dev)
                for dev in ("cuda", "cpu"))
    worst = 0.0
    for a, b in zip(gpu["curve"], cpu["curve"]):
        for key in ("loss", "M_t"):
            gap = abs(a[key] - b[key]) / abs(b[key])
            worst = max(worst, gap)
            if gap > PCA_AGREE_REL:
                raise AssertionError(f"robust PCA full width, card vs CPU "
                                     f"at step {a['step']}: {key} {a[key]} "
                                     f"vs {b[key]}")
    log(f"  full width, 5 steps, card vs CPU: largest relative gap in loss "
        f"and M_t {worst:.3e} (gate {PCA_AGREE_REL:g}); final M_t "
        f"{gpu['curve'][-1]['M_t']:.6f} vs {cpu['curve'][-1]['M_t']:.6f}")
    return counts


def dro_phase() -> dict:
    """The DRO experiment (``benchmarks/dro.py``) through
    ``repro_torch.launch.dro`` at the reference's settings (20-node ring,
    14x14 images, ``hetero=0.9``, 120 / 120 / 60 steps) from the JAX
    package's initial weights, every curve point held against its curves
    (``tests/data/dro_reference_curves.json``) under the gate the file
    records (reported, not gated, where the JAX package does not reproduce
    itself), each point's Stiefel residual against the JAX run's (10x the
    port's CPU gap), and the launches of each method asserted.  Returns the
    path's counts."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import dro
    from repro_torch.launch.fair import within_reference

    ref = dro.load_reference(ROOT / "tests" / "data"
                             / "dro_reference_curves.json")
    s = ref["settings"]
    ops.reset_launch_counts()
    runs = []
    for name, steps in s["methods"].items():
        before = ops.launch_counts()
        res = dro.run_method(name, steps, seed=s["seed"], device="cuda",
                             params=ref["init_params"])
        torch.cuda.synchronize()
        evals = len(res["curve"])
        # DRSGDA under "polar": 5 projections a step and one at init
        # (PLAIN_RETRACTION_STEP, INIT_LAUNCHES); the baselines none; every
        # evaluation one (EVAL_LAUNCHES); one grouped ring call per mixed
        # tree a step
        per_step = PLAIN_RETRACTION_STEP if name == "drsgda" \
            else BASELINE_STEP
        want = {n: c * steps for n, c in per_step.items()}
        want["stiefel_project"] += (
            EVAL_LAUNCHES["stiefel_project"] * evals
            + INIT_LAUNCHES.get(name, {}).get("stiefel_project", 0))
        got = _launched(before)
        _check_launches(f"dro {name}", got, want)
        # the Stiefel residual is gated below, point by point against the
        # JAX run's (compare_to_reference)
        for p in res["curve"]:
            if not all(math.isfinite(p[k]) for k in (
                    "loss", "M_t", "worst_group_weight", "stiefel_residual")):
                raise AssertionError(f"dro {name}: point {p}")
        runs.append(res)
    comparison = dro.compare_to_reference({"dro": runs}, ref)
    for res in runs:
        name, last = res["method"], res["curve"][-1]
        c = comparison[name]
        gated = max(v["gated"] for v in c.values() if v["gated"] is not None)
        log(f"  {name:8s} steps={last['step']:<4d} final loss="
            f"{last['loss']:.6f} M_t={last['M_t']:.6f} worst_group_weight="
            f"{last['worst_group_weight']:.6f} residual="
            f"{last['stiefel_residual']:.3e}; largest gated gap {gated:.3e}; "
            f"us_per_step={res['us_per_step']:.1f}")
        for key, v in c.items():
            reported = ("" if v["reported"] is None else
                        f"; after it, reported: {v['reported']:.3e}")
            log(f"    {key:18s} largest gap {v['gated']:.3e} over the gated "
                f"points (through step {v['gated_through']}){reported}; "
                f"over the gate: {v['over'] or 'none'}")
    if not within_reference(comparison):
        raise AssertionError("dro: curve points outside the reference's "
                             "gate (above)")
    counts = ops.launch_counts()
    log(f"  launches {counts}")
    return counts


# an elastic step applies each round's realized W_t by einsum: no ring
# kernel; DRGDA's projections are those of its retraction ("polar" at the
# reference's settings: PLAIN_RETRACTION_STEP's 5, "polar_fused" at full
# width: one projection and two retractions), and robust PCA launches no
# projection kernel (PCA_FULL_STEP)
ELASTIC_FAIR_STEP = {**PLAIN_RETRACTION_STEP, "ring_mix": 0}
ELASTIC_PCA_STEP = {**PCA_FULL_STEP, "ring_mix": 0}
ELASTIC_FULL_STEP = {"stiefel_project": 1, "fused_retract": 2, "ring_mix": 0,
                     "multi_hop_mix": 0}


def elastic_phase() -> dict:
    """Elastic gossip (``repro_torch.launch.elastic``, the counterpart of
    ``benchmarks/elastic.py``):

    1. the reference run: DRGDA on an 8-node ring under the six schedules,
       fair classification (14x14, 60 steps) and robust PCA (Gr(20, 3),
       200 steps), from the JAX package's weights, data and recorded churn
       and straggler draws (``tests/data/elastic_reference.json``), every
       curve point inside the file's gate and its live-node count equal to
       the file's, the Stiefel residual within 10x the port's CPU gap
       from the JAX run's (the file's gate), the leave-and-rejoin
       M_t within 2x of the static ring's;
    2. the W_t contract on the card: every realized W_t of the sweep
       (static, scripted and random churn, each at tau = 0 with 30%
       stragglers and tau = 2 with 20% drops and 30% stragglers, 25
       rounds) exactly symmetric, rows and columns summing to 1 within
       1e-6, each departed node's row exactly the identity row;
    3. full width: DRGDA at the main path's configuration (20-node ring,
       28x28, "polar_fused", 30 steps) with node 3 leaving at step 10 and
       rejoining at step 20, beside the static ring: finite, M_t within 2x,
       both median steps printed.

    Each run's launches a step are asserted (ELASTIC_FAIR_STEP,
    ELASTIC_PCA_STEP, ELASTIC_FULL_STEP; the static schedule
    PLAIN_RETRACTION_STEP, PCA_FULL_STEP, STEP_LAUNCHES["full k=1"]), and
    each part's total (plus one projection per fair evaluation and one at
    init).  Returns the phase's counts."""
    import torch
    from repro_torch.comms import elastic as ce
    from repro_torch.kernels import ops
    from repro_torch.launch import elastic as el

    ref = el.load_reference(ROOT / "tests" / "data"
                            / "elastic_reference.json")
    ops.reset_launch_counts()
    res = el.run_reference(ref, "cuda")
    torch.cuda.synchronize()
    want = dict.fromkeys(ops.launch_counts(), 0)
    for problem in el.PROBLEMS:
        fair_run = problem == "fair_classification"
        for row in res[problem]:
            name = row["schedule"]
            static = el.SCHEDULES[name] is None
            per_step = (
                (PLAIN_RETRACTION_STEP if static else ELASTIC_FAIR_STEP)
                if fair_run else (PCA_FULL_STEP if static
                                  else ELASTIC_PCA_STEP))
            _check_launches(f"elastic {problem} {name} step",
                            row["launches_per_step"], per_step)
            steps, evals = row["curve"][-1]["step"], len(row["curve"])
            for n, c in per_step.items():
                want[n] += c * steps
            if fair_run:
                want["stiefel_project"] += (
                    EVAL_LAUNCHES["stiefel_project"] * evals
                    + INIT_LAUNCHES["drgda"]["stiefel_project"])
            # the Stiefel residual is gated point by point against the
            # JAX run's (compare_to_reference, below)
            for p in row["curve"]:
                if not all(math.isfinite(p[k]) for k in (
                        "loss", "M_t", "consensus_x", "stiefel_residual")):
                    raise AssertionError(f"elastic {problem} {name}: "
                                         f"point {p}")
    _check_launches("elastic reference run", ops.launch_counts(), want)
    comparison = el.compare_to_reference(res, ref)
    for problem in el.PROBLEMS:
        want_rows = {r["schedule"]: r for r in ref[problem]}
        for row in res[problem]:
            name, last = row["schedule"], row["curve"][-1]
            c = comparison[problem][name]
            gated = max(v["gated"] for v in c.values()
                        if v["gated"] is not None)
            reported = [v["reported"] for v in c.values()
                        if v["reported"] is not None]
            live = "/".join(str(p["live"]) for p in row["curve"])
            log(f"  {problem:19s} {name:13s} steps={last['step']:<4d} final "
                f"M_t={last['M_t']:.6f} (JAX "
                f"{want_rows[name]['final_M_t']:.6f}) live {live}; largest "
                f"gated gap {gated:.3e}"
                + (f", reported {max(reported):.3e}" if reported else "")
                + f"; us_per_step={row['us_per_step']:.1f}; launches a step "
                f"{ {n: c for n, c in row['launches_per_step'].items() if c} }")
            for key, v in c.items():
                if v["over"]:
                    log(f"    {key}: over the gate {v['over']}")
    if comparison["live"]:
        raise AssertionError(f"elastic: live-node counts differ from the "
                             f"reference's: {comparison['live']}")
    if not el.within_reference(comparison):
        raise AssertionError("elastic: curve points outside the "
                             "reference's gate (above)")
    log(f"  leave_rejoin / static M_t {res['leave_rejoin_Mt_ratio']:.4f} "
        f"(JAX {ref['leave_rejoin_Mt_ratio']:.4f}); within 2x "
        f"{res['leave_rejoin_within_2x']}")
    if not res["leave_rejoin_within_2x"]:
        raise AssertionError("elastic: leave_rejoin not within 2x of static")

    checked, rounds = 0, 25
    for name, churn in ce.SWEEP_SCHEDULES.items():
        for tau, drop, strag in ce.SWEEP_FAULTS:
            found = ce.sweep_findings(churn, tau, drop, strag, rounds=rounds,
                                      device="cuda")
            if found:
                raise AssertionError(f"elastic W_t sweep {name} tau={tau} "
                                     f"drop={drop} strag={strag}: {found}")
            checked += rounds
    log(f"  W_t contract on the card: {checked} realized matrices "
        f"(static, scripted, random churn; tau 0 and 2) symmetric, doubly "
        f"stochastic to 1e-6, departed rows identity")

    before = ops.launch_counts()
    full = el.run_full_width("cuda")
    torch.cuda.synchronize()
    want = dict.fromkeys(before, 0)
    for name, per_step in (("static", STEP_LAUNCHES["full k=1"]),
                           ("leave_rejoin", ELASTIC_FULL_STEP)):
        row = full[name]
        _check_launches(f"elastic full width {name} step",
                        row["launches_per_step"], per_step)
        _check_curve(f"elastic full width {name}", row["curve"])
        for n, c in per_step.items():
            want[n] += c * row["curve"][-1]["step"]
        want["stiefel_project"] += (
            EVAL_LAUNCHES["stiefel_project"] * len(row["curve"])
            + INIT_LAUNCHES["drgda"]["stiefel_project"])
    _check_launches("elastic full width", _launched(before), want)
    ratio = full["leave_rejoin_Mt_ratio"]
    log(f"  full width, 20 nodes, 28x28, polar_fused, 30 steps: static "
        f"M_t={full['static']['final_M_t']:.6f} "
        f"us_per_step={full['static']['us_per_step']:.1f}; leave_rejoin "
        f"(node 3 away for steps 11-20) M_t="
        f"{full['leave_rejoin']['final_M_t']:.6f} us_per_step="
        f"{full['leave_rejoin']['us_per_step']:.1f}, live "
        + "/".join(str(p["live"]) for p in full["leave_rejoin"]["curve"])
        + f"; M_t ratio {ratio:.4f}")
    if not full["leave_rejoin_within_2x"]:
        raise AssertionError(f"elastic full width: leave_rejoin M_t ratio "
                             f"{ratio} (finite "
                             f"{full['leave_rejoin']['finite']})")
    counts = ops.launch_counts()
    log(f"  launches {counts}")
    return counts

# the telemetry path: DRGDA k = 1 over the exact ring and over EF-int8
OBS_PATH = ("stiefel_project", "fused_retract", "ring_mix", "quant_mix")
OBS_REPEATS = 10         # timed blocks of launch/obs.py's 50 steps per arm
OBS_GATE = 0.01          # counter bytes/hop against the byte oracles


def obs_phase(rows: dict) -> dict:
    """Telemetry and checkpoints on the card (``repro_torch.obs``,
    ``repro_torch.checkpoint``, through ``repro_torch.launch.obs``): DRGDA
    at the main path's configuration (20 nodes, 28x28, ``"polar_fused"``,
    k = 1) over the exact ring and over EF-int8 gossip, telemetry off and
    on for the same steps.  Gates: the final states bitwise equal (under
    deterministic cuDNN, where runs repeat); the counters' raw bytes per
    hop within 1% of ``est_hop_bytes`` and their wire bytes within 1% of
    ``wire_round_bytes``; the events validate; a step that does not flush
    raises nothing under ``torch.cuda.set_sync_debug_mode("error")``; one
    step launches ``STEP_LAUNCHES``'s kernels with telemetry off, and the
    same with it on.  Then a DRGDA state saved from the card after 5 steps,
    restored to the card into a fresh run and stepped 5 more: bitwise the
    10-step run, counters equal (deterministic cuDNN).  Last, for each row
    of the kernel table, the port's analytical estimate of the row's calls
    (``obs/estimates.py``, recorded by the wrappers) beside this script's
    count.  Returns the path's launch counts (set to 0 just before)."""
    import torch
    from repro_torch import checkpoint
    from repro_torch.kernels import ops
    from repro_torch.launch import obs as launch_obs
    from repro_torch.launch.fair import COMM_PRESETS, prepare
    from repro_torch.obs import Telemetry, unpack

    out = ROOT / "build" / "obs"
    ops.reset_launch_counts()
    for label, comm in (("full k=1", None),
                        ("EF-int8 k=1", COMM_PRESETS["int8_ef"])):
        tag = label.replace(" ", "_").replace("=", "")
        res = launch_obs.run("cuda", comm=comm, repeats=OBS_REPEATS,
                             out_dir=str(out / tag))
        ph = res["phase_breakdown"]["us_per_call"]
        log(f"  {label}: us/step off={res['us_per_step_off']:.1f} "
            f"on={res['us_per_step_on']:.1f} (min of {OBS_REPEATS} blocks "
            f"of {res['flush_every']}; off "
            + "/".join(f"{t:.1f}" for t in res["us_per_step_off_all"])
            + ", on " + "/".join(f"{t:.1f}" for t in res["us_per_step_on_all"])
            + f") overhead={res['overhead_pct']:.2f}% (medians "
            f"{res['overhead_median_pct']:.2f}%) counters' own host work="
            f"{res['counter_cost']['us_per_step']:.2f} us/step (account "
            f"{res['counter_cost']['account_us_per_step']:.2f} us + flush "
            f"{res['counter_cost']['flush_us']:.1f} us / "
            f"{res['flush_every']}; {res['counter_cost_pct']:.3f}% of off) "
            f"bit_identical={res['bit_identical']} raw bytes/hop="
            f"{res['raw_bytes_per_hop']:.1f} (est_hop_bytes "
            f"{res['est_hop_bytes']:.1f}, err {res['raw_rel_err']:.2e}) wire "
            f"bytes/hop={res['wire_bytes_per_hop']:.1f} (expected "
            f"{res['wire_bytes_per_hop_expected']:.1f}, err "
            f"{res['wire_rel_err']:.2e}) events={res['n_events']} "
            f"sync-free step off/on={res['sync_free_step']['off']}/"
            f"{res['sync_free_step']['on']} counters={res['counters']}")
        log(f"  {label} phases (us, CUDA events over 20 calls; mix is slot "
            f"x's through this gossip): "
            + " ".join(f"{k}={v:.1f}" for k, v in ph.items()))
        for name, rec in res["kernel_estimates"].items():
            log(f"  {label} estimate {name}: calls={rec['calls']} "
                f"ops={rec['ops']:.6g} lds={rec['lds']:.6g} "
                f"mem={rec['mem']:.6g} {rec['roofline']['bound']}-bound on "
                f"{rec['roofline']['hw']}, "
                f"{rec['roofline']['time_s'] * 1e6:.3f} us")
        bad = [what for what, ok in (
            ("bit-identity", res["bit_identical"]),
            ("raw bytes/hop", res["raw_rel_err"] <= OBS_GATE),
            ("wire bytes/hop", res["wire_rel_err"] <= OBS_GATE),
            ("events", res["n_events"] >= 2 + OBS_REPEATS),
            ("sync-free step", res["sync_free_step"]["on"])) if not ok]
        if bad:
            raise AssertionError(f"obs {label}: {bad}")
        for tel in (None, Telemetry(run=f"{tag}-launches",
                                    out_dir=str(out / tag))):
            run = prepare("drgda", True, image_hw=28, n_nodes=N_NODES,
                          k_steps=1, device="cuda", comm=comm, telemetry=tel)
            before = ops.launch_counts()
            run.opt.step(run.state, run.full)
            torch.cuda.synchronize()
            _check_launches(f"obs {label} telemetry "
                            f"{'on' if tel else 'off'}", _launched(before),
                            STEP_LAUNCHES[label])

    with launch_obs.deterministic_cudnn():
        def fresh():
            return prepare("drgda", True, image_hw=28, n_nodes=N_NODES,
                           k_steps=1, device="cuda", telemetry=Telemetry(
                               run="resume", out_dir=str(out / "resume")))
        ref = fresh()
        state = ref.state
        for t in range(10):
            state, _ = ref.opt.step(state, ref.full)
            if t == 4:
                path = checkpoint.save(str(out / "ckpt"), 5, state)
        run = fresh()
        resumed = checkpoint.restore(str(out / "ckpt"), 5, run.state,
                                     device="cuda")
        on_card = all(t.is_cuda for t in launch_obs.state_tensors(resumed))
        for _ in range(5):
            resumed, _ = run.opt.step(resumed, run.full)
        torch.cuda.synchronize()
    same = launch_obs.bitwise_equal(resumed, state)
    counters = unpack(resumed.obs) == unpack(state.obs)
    log(f"  checkpoint {Path(path).name} ({Path(path).stat().st_size} "
        f"bytes): restored on the card={on_card}, 5 + 5 steps bitwise the "
        f"10-step run={same}, counters equal={counters}")
    if not (on_card and same and counters and resumed.step == 10):
        raise AssertionError("obs: the resumed run is not the 10-step run")

    log("  estimates against this script's counts, per kernel table row "
        "(the row's calls; bound at the row's peak):")
    # the backward kernel has no TPU counterpart, so no JAX formula
    for name in (n for n in KERNEL_META if n not in TRAIN_PATH):
        row = rows[name]
        est, cost = row["estimate"], row["cost"]
        log(f"    {name:20s} {row['label']:40s} estimate: calls="
            f"{est['calls']} ops={est['ops']:.6g} lds={est['lds']:.6g} "
            f"mem={est['mem']:.6g} bound={est['bound_ms']:.5f} ms | "
            f"script: flops={cost['flops']:.6g} bytes={cost['bytes']:.6g} "
            f"bound={row['bound_ms']:.5f} ms ({row['bound_by']})")
    counts = ops.launch_counts()
    missing = [n for n in OBS_PATH if counts[n] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the obs path: "
                             f"{missing}")
    log(f"  launches {counts}")
    return counts


def own_kernels() -> re.Pattern:
    """A pattern that finds, in a profiler event's name, any ``__global__``
    function of the port's CUDA sources: every kernel the port can launch,
    whatever its name."""
    names = set()
    for src in sorted((SRC / "repro_torch/kernels/csrc").glob("*.cu*")):
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
            src.read_text()))
    if not names:
        raise RuntimeError("no __global__ function in the port's sources")
    return re.compile(r"(?<!\w)(?:" + "|".join(sorted(names)) + r")(?=[<(])")


# launches of one optimizer step (no evaluation) in the profile phase: the
# step's Stiefel leaves projected by one grouped call (the on-chip route),
# and for EF-int8 one grouped first hop per tree with no ring_mix of the
# hats; a baseline step projects nothing (BASELINE_STEP)
STEP_LAUNCHES = {
    "full k=1": {"stiefel_project": 1, "fused_retract": 2, "ring_mix": 4},
    "EF-int8 k=1": {"stiefel_project": 1, "fused_retract": 2,
                    "quant_mix": 4, "ring_mix": 0},
    f"full k={K_THEOREM1}": {"stiefel_project": 1, "ring_mix": 1,
                             "multi_hop_mix": 3},
    f"EF-int8 all k={K_THEOREM1}": {"stiefel_project": 1, "quant_mix": 4,
                                    "ring_mix": 0, "multi_hop_mix_quant": 3},
    "gt-gda k=1": BASELINE_STEP,
    "dm-hsgd k=1": BASELINE_STEP,
    **{f"figures {name}": PLAIN_RETRACTION_STEP if name in ("drgda", "drsgda")
       else BASELINE_STEP for name in ("drgda", "gt-gda", "drsgda", "gnsd-a",
                                       "dm-hsgd", "gt-srvr")},
    "robust PCA example": PCA_EXAMPLE_STEP,
    "robust PCA full width": PCA_FULL_STEP,
    "DRO drsgda": PLAIN_RETRACTION_STEP,
    "elastic leave_rejoin k=1": ELASTIC_FULL_STEP,
}


class StepConfig(NamedTuple):
    """A step to profile: method, full batch or minibatch, comms, gossip
    steps, image size and retraction; or ``setup``, a function that returns
    the initialized run (``launch.fair.Run``) of another problem."""
    name: str
    det: bool
    comm: object = None
    k: int = 1
    image_hw: int = 28
    retraction: str = "polar_fused"
    setup: object = None


def _dro_setup():
    """DRSGDA on the DRO problem as the DRO phase runs it (14x14,
    ``hetero=0.9``, ``"polar"``)."""
    from repro_torch.data.synthetic import ClassificationStream
    from repro_torch.launch import dro
    from repro_torch.launch.fair import prepare
    from repro_torch.objectives.fair import make_dro_problem

    stream = ClassificationStream(n_nodes=N_NODES,
                                  batch_per_node=dro.BATCH_PER_NODE,
                                  hetero=dro.HETERO, seed=0)
    return prepare("drsgda", False, hyper=dro.hyper("drsgda"),
                   device="cuda", problem=make_dro_problem, stream=stream)


def _elastic_setup():
    """DRGDA at the main path's configuration with node 3 leaving at step
    10 and rejoining at step 20 (``launch.elastic.FULL_WIDTH``)."""
    from repro_torch.launch import elastic
    from repro_torch.launch.fair import prepare

    cfg = elastic.FULL_WIDTH
    return prepare("drgda", True, image_hw=cfg["image_hw"],
                   n_nodes=cfg["n_nodes"], k_steps=1,
                   retraction=cfg["retraction"], device="cuda",
                   elastic=cfg["elastic"])


def _robust_pca_setup(size: str):
    """A robust-PCA run at ``size`` (``launch.robust_pca.SIZES``),
    initialized."""
    from repro_torch.launch import robust_pca
    return lambda: robust_pca.prepare(size, device="cuda")[0]


def _device_kernels(prof, calls: int) -> list:
    """(device us, launches, name) per kernel and call, device-side events
    only: a CPU op's self device time repeats the time of the kernels it
    launched."""
    from torch.autograd import DeviceType
    kernels = [(e.self_device_time_total / calls, e.count / calls, e.key)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    kernels.sort(reverse=True)
    return kernels


def profile_phase(configs: dict, steps: int = 10) -> None:
    """Where a main-path step spends its time, for each
    ``label: StepConfig`` of ``configs``: the step's
    wall time (median of synchronized steps, as ``run_method`` times them),
    the device time of its kernels under ``torch.profiler``, and the kernels
    that take the most.  A stochastic method steps on one minibatch.  For
    the baselines also the projection back (``_project_back``, plain
    Newton--Schulz products) alone: its wall, device time and launches, and
    its share of the step's.

    Every wall time is taken before the first profiler session of the
    process, the configurations interleaved; the walls after the sessions
    are printed too, to show what a session leaves behind.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.convert import batch_to_torch
    from repro_torch.core.baselines import ALL_BASELINES, _project_back
    from repro_torch.kernels import ops
    from repro_torch.launch.fair import prepare

    own = own_kernels()
    runs, states, batches = {}, {}, {}
    for label, c in configs.items():
        runs[label] = c.setup() if c.setup is not None else prepare(
            c.name, c.det, image_hw=c.image_hw, n_nodes=N_NODES, k_steps=c.k,
            device="cuda", comm=c.comm, retraction=c.retraction)
        batches[label] = runs[label].full if c.det else batch_to_torch(
            runs[label].stream.batch(1), runs[label].device)
        states[label] = runs[label].state
        for _ in range(3):
            states[label], _ = runs[label].opt.step(states[label],
                                                    batches[label])

    def project(label):
        run = runs[label]
        return _project_back(run.problem.manifold_map, states[label].x,
                             run.opt.hyper.invsqrt)

    def walls() -> tuple[dict, dict]:
        step_us = {label: [] for label in configs}
        proj_us = {label: [] for label in configs
                   if configs[label].name in ALL_BASELINES}
        for _ in range(2):
            for label, run in runs.items():
                for _ in range(steps // 2):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    states[label], _ = run.opt.step(states[label],
                                                    batches[label])
                    torch.cuda.synchronize()
                    step_us[label].append((time.perf_counter() - t0) * 1e6)
                    if label in proj_us:
                        t0 = time.perf_counter()
                        project(label)
                        torch.cuda.synchronize()
                        proj_us[label].append(
                            (time.perf_counter() - t0) * 1e6)
        return step_us, proj_us

    before, proj_before = walls()
    for label, run in runs.items():
        ops.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                states[label], _ = run.opt.step(states[label],
                                                batches[label])
            torch.cuda.synchronize()
        per_step = {n: c / steps for n, c in ops.launch_counts().items()
                    if c}
        want = STEP_LAUNCHES.get(label, {})
        if any(per_step.get(n, 0) != c for n, c in want.items()):
            raise AssertionError(f"{label} step: launches {per_step}, want "
                                 f"{want}")
        kernels = _device_kernels(prof, steps)
        device_us = sum(k[0] for k in kernels)
        launches = sum(k[1] for k in kernels)
        own_us = sum(k[0] for k in kernels if own.search(k[2]))
        step_us = before[label]
        wall_us = statistics.median(step_us)
        log(f"  {label} {configs[label].name} step: {wall_us:.1f} us wall "
            f"without the profiler (median of {steps} synchronized steps; "
            f"min {min(step_us):.1f}, max {max(step_us):.1f}); "
            f"{device_us:.1f} us of device time in {launches:.0f} kernels "
            f"(device busy {100 * device_us / wall_us:.1f}% of the wall); "
            f"the port's CUDA kernels {own_us:.1f} us; the port's launches "
            f"a step {per_step}")
        for us, count, key in kernels[:12]:
            log(f"    {us:9.1f} us/step  x{count:4.0f}  {key[:100]}")
        if label in proj_before:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(steps):
                    project(label)
                torch.cuda.synchronize()
            proj = _device_kernels(prof, steps)
            proj_dev = sum(k[0] for k in proj)
            proj_wall = statistics.median(proj_before[label])
            log(f"    projection back (fc1, head; Newton--Schulz, plain "
                f"products): {proj_wall:.1f} us wall ({100 * proj_wall / wall_us:.1f}% "
                f"of the step's), {proj_dev:.1f} us of device time in "
                f"{sum(k[1] for k in proj):.0f} kernels "
                f"({100 * proj_dev / device_us:.1f}% of the step's)")
    after, _ = walls()
    log("  wall after the profiler sessions: " + ", ".join(
        f"{label} {statistics.median(us):.1f} us" for label, us
        in after.items()))


def agreement_phase() -> None:
    """Small runs on the card (kernels) against the same runs on the CPU
    (plain versions): per-step loss and M_t at every curve point.

    Full precision (DRGDA at k = 3, GT-SRVR with q = 4 so that it anchors
    at t = 0, 4 and 8, DRGDA under the Cayley retraction): 1e-4, relative
    where the value is above 1.  EF-int8 (DRGDA, k = 3,
    ``quant_hops="all"``): both runs take one draw source that draws on the
    CPU, so they see the same uniforms; but the card's convolutions round
    in another order (a few 1e-7), which moves a stochastic rounding
    ``floor(x/scale + u)`` across an integer now and then, and error
    feedback carries that int8 step on.  So the two trajectories separate
    slowly, and are held to 1e-3 in loss and 5e-3 in M_t, relative where
    above 1 (the CPU tests measure 1e-4 and 4e-4 between the port and the
    JAX package over 10 such steps)."""
    from repro_torch.comms.compress import GeneratorDraws
    from repro_torch.comms.spec import CommSpec
    from repro_torch.core.baselines import SRVRHyper
    from repro_torch.launch.fair import run_method

    kw = dict(image_hw=8, n_nodes=6, k_steps=3, eval_every=5)
    comm = CommSpec(compressor="int8", gamma=0.95, quant_hops="all")
    exact = {"loss": 1e-4, "M_t": 1e-4}
    for label, name, det, extra, tols in (
            ("full precision", "drgda", True, {}, exact),
            ("q=4", "gt-srvr", False,
             dict(hyper=SRVRHyper(beta=0.05, eta=0.2, q=4)), exact),
            ("cayley", "drgda", True, dict(retraction="cayley"), exact),
            ("EF-int8 quant_hops=all", "drgda", True,
             dict(comm=comm, draws=GeneratorDraws(0, on_cpu=True)),
             {"loss": 1e-3, "M_t": 5e-3})):
        gpu, cpu = (run_method(name, 10, det, device=dev, **extra, **kw)
                    for dev in ("cuda", "cpu"))
        for a, b in zip(gpu["curve"], cpu["curve"]):
            for key, tol in tols.items():
                if abs(a[key] - b[key]) > tol * max(1.0, abs(b[key])):
                    raise AssertionError(
                        f"{label}: card vs CPU at step {a['step']}: {key} "
                        f"{a[key]} vs {b[key]}")
        log(f"  card vs CPU, {name} {label} (n=6, 8x8, 10 steps): final M_t "
            f"{gpu['final_M_t']:.6f} vs {cpu['final_M_t']:.6f}, "
            f"loss {gpu['final_loss']:.6f} vs {cpu['final_loss']:.6f}")


# ---------------------------------------------------------------------------
# attention kernels
# ---------------------------------------------------------------------------

# smollm-135m's serving geometry (src/repro_torch/configs/smollm_135m.py)
N_LAYERS, N_HEADS, N_KV_HEADS, HEAD_DIM = 30, 9, 3, 64
SERVE_SLOTS, SERVE_REQUESTS, SERVE_NEW, PAGE_SIZE = 4, 8, 32, 16
PROMPT_LENGTHS = (24, 256)       # ragged prompt lengths, drawn from a seed
ATTN_GATES = {"float32": 2e-5, "bfloat16": 2e-2}


def _attn_mask(qpos, kvpos, causal, window):
    """(B, S, T) bool: the keys each query may use, as the kernels mask."""
    qp, kp = qpos[:, :, None], kvpos[:, None, :]
    mask = kp >= 0
    if causal:
        mask = mask & (kp <= qp)
    if window is not None:
        mask = mask & ((qp - kp) < window)
    return mask


def _flash_cost(q, k, v, mask):
    """4 (hd + hdv) / 2 flops per unmasked (query, key) pair and head; q,
    k, v, the output and the positions moved once."""
    b, s, h, hd = q.shape
    hdv = v.shape[-1]
    flops = 2 * (hd + hdv) * h * float(mask.sum())
    nbytes = ((q.numel() + k.numel() + v.numel() + b * s * h * hdv)
              * q.element_size() + 4 * (b * s + b * k.shape[1]))
    return flops, nbytes


def _sdpa(q, k, v, mask, plain_causal):
    """One ``scaled_dot_product_attention`` call computing the same
    function, on (B, H, S, hd) copies made here, outside the timed call:
    no mask where every key is usable, ``is_causal`` where the mask is the
    plain causal one, else the boolean mask."""
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    kw = {}
    if plain_causal:
        kw["is_causal"] = True
    elif not bool(mask.all()):
        kw["attn_mask"] = mask[:, None]
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, enable_gqa=True, **kw).transpose(1, 2)


def _paged_inputs(gen, seq, m_pages, n_pages, dtype, device="cuda",
                  heads=(N_HEADS, N_KV_HEADS, HEAD_DIM)):
    """q, pools and a block table of distinct random pages (page 0 never
    handed out) for decode slots holding ``seq`` tokens; ``heads`` is
    (query heads, KV heads, head dim)."""
    import torch
    h, hkv, hd = heads
    shape = (n_pages, PAGE_SIZE, hkv, hd)
    q = torch.randn((len(seq), h, hd), generator=gen,
                    device=device).to(dtype)
    kp = torch.randn(shape, generator=gen, device=device).to(dtype)
    vp = torch.randn(shape, generator=gen, device=device).to(dtype)
    order = torch.randperm(n_pages - 1, generator=gen, device=device) + 1
    bt = torch.full((len(seq), m_pages), -1, dtype=torch.int32, device=device)
    used = 0
    for i, sl in enumerate(seq):
        n = -(-sl // PAGE_SIZE)
        bt[i, :n] = order[used:used + n]
        used += n
    return q, kp, vp, bt, torch.tensor(seq, dtype=torch.int32, device=device)


def _paged_cost(q, kp, vp, bt, seq, window):
    """4 (hd + hdv) / 2 flops per usable key and head; the pages holding
    usable keys, q, the output, the table and seq_lens moved once."""
    s, h, hd = q.shape
    ps, hkv, hdv = kp.shape[1], kp.shape[2], vp.shape[-1]
    keys = pages = 0
    for sl in seq.tolist():
        lo = max(0, sl - window) if window else 0
        keys += sl - lo
        pages += -(-sl // ps) - lo // ps
    flops = 2 * (hd + hdv) * h * keys
    nbytes = ((pages * ps * hkv * (hd + hdv) + q.numel() + s * h * hdv)
              * q.element_size() + 4 * (bt.numel() + s))
    return flops, nbytes


def _flash_large_outputs(gen, gate, device="cuda") -> None:
    """bf16 flash_attention with v in [6, 7.9], so that every output lies
    in [4, 8), at the S=256 prefill and causal S=T=1024, against the
    reference's fp32 arithmetic on the same bf16 inputs: there a bf16 ulp
    is 2^-5, the output's own rounding takes up to 2^-6 of the 2e-2 gate,
    and a kernel that rounds P or the scaled q to bf16 fails."""
    import torch
    from repro_torch.kernels import flash_attention as _fa
    from repro_torch.kernels import ops, ref

    for label, s, h, hkv in (("prefill S=T=256", 256, N_HEADS, N_KV_HEADS),
                             ("causal S=T=1024", 1024, 2, 1)):
        q = torch.randn((1, s, h, HEAD_DIM), generator=gen,
                        device=device).to(torch.bfloat16)
        k = torch.randn((1, s, hkv, HEAD_DIM), generator=gen,
                        device=device).to(torch.bfloat16)
        v = (6.0 + 1.9 * torch.rand((1, s, hkv, HEAD_DIM), generator=gen,
                                    device=device)).to(torch.bfloat16)
        route = _fa.route(q, k, v)
        want = ref.blockwise_attention(q.float(), k.float(), v.float())
        if not (4.0 <= float(want.min()) and float(want.max()) < 8.0):
            raise AssertionError("flash_attention bf16: outputs outside "
                                 "[4, 8)")
        pos = torch.arange(s, dtype=torch.int32, device=device)[None]
        run_case("flash_attention", [lambda: ops.flash_attention(q, k, v)],
                 [lambda: ref.blockwise_attention(q.float(), k.float(),
                                                  v.float())],
                 absolute(gate),
                 [_flash_cost(q, k, v, _attn_mask(pos, pos, True, None))],
                 f"bfloat16 |out| in [4, 8) {label} [{route}]",
                 peak=PEAK_FLOPS_BF16)


# The attention shapes of the served configurations (src/repro_torch/
# configs): (label, batch, S, T, heads, KV heads, head dim, window, ring).
# Prefill as the paged engine runs it (one prompt of up to 256 tokens) or
# as ``generate`` does (gemma3: 2 prompts of 1536 tokens, its local
# layers' window of 1024 masking the oldest keys; musicgen: 4 prompts of
# 32); contiguous decode against a full cache, gemma3's local layers
# against a ring of 1024 slots that has wrapped (``ring``); and the
# SMOKE configs' head dims 16, 20 (the SIMT route) and 32.
MODEL_ATTENTION = (
    ("granite-3-2b prefill 32:8 hd=64", 1, 256, 256, 32, 8, 64, None, False),
    ("granite-3-8b prefill 32:8 hd=128", 1, 256, 256, 32, 8, 128, None,
     False),
    ("granite-moe prefill 16:8 hd=64", 1, 256, 256, 16, 8, 64, None, False),
    ("musicgen prefill 32:32 hd=64", 4, 32, 32, 32, 32, 64, None, False),
    ("musicgen decode T=64 32:32", 4, 1, 64, 32, 32, 64, None, False),
    ("gemma3 local prefill S=1536 win 1024", 2, 1536, 1536, 32, 16, 128,
     1024, False),
    ("gemma3 global prefill S=1536 32:16", 2, 1536, 1536, 32, 16, 128, None,
     False),
    ("gemma3 local decode ring 1024", 2, 1, 1024, 32, 16, 128, 1024, True),
    ("gemma3 global decode T=1552", 2, 1, 1552, 32, 16, 128, None, False),
    ("granite-3-2b SMOKE 8:2 hd=16", 1, 24, 24, 8, 2, 16, None, False),
    ("granite-3-8b SMOKE 8:2 hd=20", 1, 24, 24, 8, 2, 20, None, False),
    ("gemma3 SMOKE 4:2 hd=32 win 8", 2, 13, 13, 4, 2, 32, 8, False),
    ("musicgen SMOKE 4:4 hd=32", 2, 9, 9, 4, 4, 32, None, False),
    # MLA (q/k head dim != v head dim; 192 takes the SIMT route) and
    # cross-attention (not causal, S != T): (..., hdv, causal) appended
    ("deepseek MLA prefill 128:128 hd=192 hdv=128", 4, 256, 256, 128, 128,
     192, None, False, 128, True),
    ("deepseek MLA decode T=272 hd=192 hdv=128", 4, 1, 272, 128, 128, 192,
     None, False, 128, True),
    ("llama-vision prefill 32:8 hd=128 S=512", 2, 512, 512, 32, 8, 128,
     None, False),
    ("llama-vision cross S=512 T=1600 32:8", 2, 512, 1600, 32, 8, 128, None,
     False, 128, False),
    ("llama-vision cross decode S=1 T=1600", 2, 1, 1600, 32, 8, 128, None,
     False, 128, False),
    ("deepseek SMOKE MLA hd=48 hdv=32", 2, 13, 13, 4, 4, 48, None, False, 32,
     True),
    ("llama-vision SMOKE cross S=13 T=16", 2, 13, 16, 4, 2, 32, None, False,
     32, False),
    # zamba2-2.7b: head dim 80 on the tensor cores, 32:32; its served
    # traffic (2 prompts of 1000 tokens, 16 new: the last step reads 1015)
    ("zamba2 prefill 32:32 hd=80 S=1000", 2, 1000, 1000, 32, 32, 80, None,
     False),
    ("zamba2 decode T=1015 32:32 hd=80", 2, 1, 1015, 32, 32, 80, None,
     False),
)
# paged decode waves of the paged models (4 slots, one empty)
MODEL_PAGED = (("granite-3-2b 32:8 hd=64", (32, 8, 64)),
               ("granite-3-8b 32:8 hd=128", (32, 8, 128)),
               ("granite-moe 16:8 hd=64", (16, 8, 64)))


def _model_attention_cases(gen, gate, device="cuda") -> set:
    """flash_attention and paged_decode (fp32) at the served
    configurations' shapes (MODEL_ATTENTION, MODEL_PAGED) against their
    plain versions under ``gate``, beside one SDPA call; returns the
    flash routes they ran."""
    import torch
    from repro_torch.kernels import flash_attention as _fa
    from repro_torch.kernels import ops, ref

    routes = set()
    for label, b, s, t, h, hkv, hd, window, ring, *rest in MODEL_ATTENTION:
        hdv, causal = rest or (hd, True)
        q = torch.randn((b, s, h, hd), generator=gen, device=device)
        k = torch.randn((b, t, hkv, hd), generator=gen, device=device)
        v = torch.randn((b, t, hkv, hdv), generator=gen, device=device)
        last = 1536 + 16 - 1 if ring else t - 1
        qpos = torch.arange(last - s + 1, last + 1, dtype=torch.int32,
                            device=device)[None].expand(b, s).contiguous()
        kvpos = torch.arange(t, dtype=torch.int32, device=device)
        if ring:   # slot j holds the newest position p <= last, p = j mod t
            kvpos = torch.where(kvpos + t <= last, kvpos + t, kvpos)
        kvpos = kvpos[None].expand(b, t).contiguous()
        route = _fa.route(q, k, v)
        routes.add(route)
        mask = _attn_mask(qpos, kvpos, causal, window)
        if window is not None and not ring and s > window \
                and bool(mask[:, -1, 0].any()):
            raise AssertionError(f"{label}: no key fell out of the window")
        want_route = "tensor_core" if (hd % 16 == 0 and hdv % 16 == 0 and
                                       max(hd, hdv) <= 128) else "simt"
        if route != want_route:
            raise AssertionError(f"{label}: {route} route, want {want_route}")
        kw = dict(causal=causal, window=window, q_positions=qpos,
                  kv_positions=kvpos)
        run_case(
            "flash_attention", [lambda: ops.flash_attention(q, k, v, **kw)],
            [lambda: ref.blockwise_attention(q, k, v, **kw)], absolute(gate),
            [_flash_cost(q, k, v, mask)], f"{label} [{route}]",
            [_sdpa(q, k, v, mask, causal and window is None and s == t
                   and not ring)],
            peak=PEAK_FLOPS_TF32X3 if route == "tensor_core" else PEAK_FLOPS)
    for label, heads in MODEL_PAGED:
        seq = [288, 37, 0, 161]
        args = _paged_inputs(gen, seq, 18, len(seq) * 18 * 2 + 1,
                             torch.float32, heads=heads)
        out = ops.paged_decode_attention(*args)
        if not bool(torch.all(out[args[4] == 0] == 0)):
            raise AssertionError(f"paged_decode {label}: an empty slot is "
                                 f"not exact zeros")
        run_case("paged_decode", [lambda: ops.paged_decode_attention(*args)],
                 [lambda: ref.paged_decode_attention_ref(*args)],
                 absolute(gate), [_paged_cost(*args, None)],
                 f"wave 4 slots {label}")
    return routes


def attention_kernel_phase(device="cuda") -> dict:
    """flash_attention and paged_decode against their plain versions in
    fp32 and bf16; returns the table rows (fp32, the serving path's
    shapes: one prefill of 256 tokens, one decode wave of 4 slots)."""
    import torch
    from repro_torch.kernels import flash_attention as _fa
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=device).manual_seed(1)
    rows = {}
    routes = set()
    for dtype_name, gate in ATTN_GATES.items():
        dtype = getattr(torch, dtype_name)
        peak = PEAK_FLOPS_BF16 if dtype == torch.bfloat16 else PEAK_FLOPS
        for label, s, t, causal, window, hd, hdv in (
                ("prefill S=T=256", 256, 256, True, None, HEAD_DIM, HEAD_DIM),
                ("contiguous decode S=1 T=288", 1, 288, True, None, HEAD_DIM,
                 HEAD_DIM),
                ("stress S=T=4096", 4096, 4096, True, None, HEAD_DIM,
                 HEAD_DIM),
                ("stress S=T=4096 window 48", 4096, 4096, True, 48, HEAD_DIM,
                 HEAD_DIM),
                ("non-causal S=T=256", 256, 256, False, None, HEAD_DIM,
                 HEAD_DIM),
                ("hd=40 hdv=24 S=T=256", 256, 256, True, None, 40, 24)):
            q = torch.randn((1, s, N_HEADS, hd), generator=gen,
                            device=device).to(dtype)
            k = torch.randn((1, t, N_KV_HEADS, hd), generator=gen,
                            device=device).to(dtype)
            v = torch.randn((1, t, N_KV_HEADS, hdv), generator=gen,
                            device=device).to(dtype)
            route = _fa.route(q, k, v)
            routes.add(route)
            # fp32 on the tensor cores is 3xTF32: its bound uses that rate
            case_peak = (PEAK_FLOPS_TF32X3 if dtype == torch.float32
                         and route == "tensor_core" else peak)
            qpos = torch.arange(t - s, t, dtype=torch.int32,
                                device=device)[None]
            kvpos = torch.arange(t, dtype=torch.int32, device=device)[None]
            mask = _attn_mask(qpos, kvpos, causal, window)
            kw = dict(causal=causal, window=window, q_positions=qpos,
                      kv_positions=kvpos)
            row = run_case(
                "flash_attention", [lambda: ops.flash_attention(q, k, v, **kw)],
                [lambda: ref.blockwise_attention(q, k, v, **kw)],
                absolute(gate), [_flash_cost(q, k, v, mask)],
                f"{dtype_name} {label} [{route}]",
                [_sdpa(q, k, v, mask, causal and window is None and s == t)],
                peak=case_peak,
                lib_gate=1e-4 if dtype == torch.float32 else 1e-2)
            if dtype == torch.float32 and label == "prefill S=T=256":
                rows["flash_attention"] = row
        if dtype == torch.bfloat16:
            _flash_large_outputs(gen, gate)
        else:
            routes |= _model_attention_cases(gen, gate)
        # query rows without a usable key: exact zeros
        q = torch.randn((1, 256, N_HEADS, HEAD_DIM), generator=gen,
                        device=device).to(dtype)
        pos = torch.arange(256, dtype=torch.int32, device=device)[None]
        kvpos = torch.where(pos < 64, -1, pos)
        out = ops.flash_attention(q, q[:, :, :N_KV_HEADS], q[:, :, :N_KV_HEADS],
                                  q_positions=pos, kv_positions=kvpos)
        want = ref.blockwise_attention(q, q[:, :, :N_KV_HEADS],
                                       q[:, :, :N_KV_HEADS], q_positions=pos,
                                       kv_positions=kvpos)
        err = float((out.float() - want.float()).abs().max())
        if not (bool(torch.all(out[:, :64] == 0)) and err <= gate):
            raise AssertionError(f"flash_attention {dtype_name}: rows without "
                                 f"keys not exact zeros, or err {err:.3e}")
        log(f"  flash_attention  {dtype_name} 64 rows without keys: exact "
            f"zeros (rest max_abs_err={err:.3e})")

        for label, seq, m_pages, window in (
                ("decode wave 4 slots", [288, 37, 0, 161], 18, None),
                ("decode wave 4 slots window 48", [288, 37, 0, 161], 18, 48),
                ("stress 64 slots x 2048", [2048] * 64, 128, None)):
            n_pages = len(seq) * m_pages * 2 + 1
            q, kp, vp, bt, sl = _paged_inputs(gen, seq, m_pages, n_pages,
                                              dtype)
            args = (q, kp, vp, bt, sl)
            out = ops.paged_decode_attention(*args, window=window)
            empty = sl == 0
            if not bool(torch.all(out[empty] == 0)):
                raise AssertionError("paged_decode: an empty slot is not "
                                     "exact zeros")
            row = run_case(
                "paged_decode",
                [lambda: ops.paged_decode_attention(*args, window=window)],
                [lambda: ref.paged_decode_attention_ref(*args,
                                                        window=window)],
                absolute(gate), [_paged_cost(*args, window)],
                f"{dtype_name} {label}", peak=peak)
            if dtype == torch.float32 and label == "decode wave 4 slots":
                rows["paged_decode"] = row
        log(f"  paged_decode     {dtype_name}: empty slots exact zeros")

    if routes != {"tensor_core", "simt"}:
        raise AssertionError(f"flash_attention ran the routes {routes}, "
                             f"not both")
    q = torch.zeros((1, 8, 4, 16), device=device, dtype=torch.float64)
    bt = torch.zeros((1, 1), dtype=torch.int64, device=device)
    for call in (lambda: ops.flash_attention(q, q, q),
                 lambda: ops.paged_decode_attention(
                     q[0, :1].float(), q.float(), q.float(), bt,
                     bt[0].int())):
        try:
            call()
        except TypeError as exc:
            log(f"  operand of another dtype raises: {exc}")
        else:
            raise AssertionError("a CUDA operand of another dtype did not "
                                 "raise")
    torch.cuda.synchronize()
    return rows


# ---------------------------------------------------------------------------
# LM training: the attention gradient and the trainer
# ---------------------------------------------------------------------------

# the trainer's attention at the CLI defaults: 8 nodes x 4 sequences folded
# into B, 63 positions (64 tokens, the targets shifted off), smollm-135m's
# heads
TRAIN_NODES, TRAIN_BATCH, TRAIN_SEQ = 8, 4, 64
TRAIN_STEPS, TRAIN_EVAL_EVERY = 20, 10
# the backward kernel against ref.attention_backward: 3xTF32 products on
# the tensor cores (fp32 on the CUDA cores off that route), sums over up
# to 2048 keys and 3 query heads in another order than the plain
# version's GEMMs
BWD_GATE = 1e-5     # relative to the largest |plain| value of dq, dk, dv
# the backward at MLA's and cross-attention's shapes: (label, B, S, T, H,
# Hkv, hd, hdv, causal, route); the trainer's batch at SMOKE is 4 nodes x
# 2 sequences of 15 tokens, and llama-vision's SMOKE frontend 16 tokens
BWD_SHAPES = (
    ("deepseek SMOKE MLA hd=48 hdv=32", 8, 15, 15, 4, 4, 48, 32, True,
     "tensor_core"),
    ("hd=40 hdv=24 S=37 T=45", 2, 37, 45, 4, 2, 40, 24, True, "simt"),
    ("llama-vision SMOKE cross S=15 T=16", 8, 15, 16, 4, 2, 32, 32, False,
     "tensor_core"),
    ("cross S=256 T=1600 32:8 hd=128", 1, 256, 1600, 32, 8, 128, 128, False,
     "tensor_core"),
    ("cross hd=40 hdv=24 S=37 T=61", 2, 37, 61, 4, 2, 40, 24, False,
     "simt"),
    # zamba2-2.7b's training shape: 4 nodes x 4 sequences of 63 tokens,
    # 32:32 at head dim 80
    ("zamba2 trainer hd=80 B=16 S=T=63 32:32", 16, 63, 63, 32, 32, 80, 80,
     True, "tensor_core"),
)


def _bwd_cost(q, k, v, mask):
    """The least work of the gradient, per usable (query, key) pair and
    query head: the five products q.k, d_out.v, P^T d_out, dS k and
    dS^T q, 2 (3 hd + 2 hdv) flops (the kernel recomputes q.k and d_out.v
    in more passes than this); q, k, v, out, d_out and the positions read
    once, dq, dk, dv written once."""
    b, s, h, hd = q.shape
    hdv = v.shape[-1]
    flops = 2 * (3 * hd + 2 * hdv) * h * float(mask.sum())
    nbytes = ((2 * (q.numel() + k.numel() + v.numel()) + 2 * b * s * h * hdv)
              * 4 + 4 * (b * s + b * k.shape[1]))
    return flops, nbytes


def _sdpa_backward(q, k, v, d_out, mask=None):
    """SDPA's backward (``torch.autograd.grad`` of one
    ``scaled_dot_product_attention`` call, its graph built here, outside the
    timed call) in the port's layout: the library's attention gradient.
    Causal, or under the boolean (S, T) ``mask`` (a window), where the kv
    heads are repeated for the query heads inside the graph."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    if mask is None:
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
    else:
        g = q.shape[2] // k.shape[2]
        out = F.scaled_dot_product_attention(
            qt, kt.repeat_interleave(g, dim=1), vt.repeat_interleave(g, dim=1),
            attn_mask=mask)
    go = d_out.transpose(1, 2).contiguous()
    return lambda: [g.transpose(1, 2) for g in torch.autograd.grad(
        out, (qt, kt, vt), go, retain_graph=True)]


def attention_backward_phase(device="cuda") -> dict:
    """The attention backward kernel against ``ref.attention_backward`` at
    the trainer's shape, with a window, and at S=T=2048 (GQA 9:3, fp32,
    hd 64: the tensor-core route), handed the forward's lse as the gradient
    hands it, beside SDPA's backward under the same mask; bitwise repeats;
    rows without keys pass zero gradient; bf16 raises.  Returns the table
    row (the trainer's shape)."""
    import torch
    from repro_torch.kernels import flash_attention as _fa
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=device).manual_seed(2)
    rows = {}
    for label, b, s, window in (
            (f"trainer B={TRAIN_NODES * TRAIN_BATCH} S=T={TRAIN_SEQ - 1}",
             TRAIN_NODES * TRAIN_BATCH, TRAIN_SEQ - 1, None),
            ("S=T=512 window 48", 2, 512, 48),
            ("stress S=T=2048", 1, 2048, None)):
        q = torch.randn((b, s, N_HEADS, HEAD_DIM), generator=gen,
                        device=device)
        k = torch.randn((b, s, N_KV_HEADS, HEAD_DIM), generator=gen,
                        device=device)
        v = torch.randn((b, s, N_KV_HEADS, HEAD_DIM), generator=gen,
                        device=device)
        d_out = torch.randn((b, s, N_HEADS, HEAD_DIM), generator=gen,
                            device=device)
        out, lse = ops.flash_attention(q, k, v, window=window,
                                       return_lse=True)
        pos = torch.arange(s, dtype=torch.int32, device=device)[None]
        mask = _attn_mask(pos, pos, True, window).expand(b, s, s)
        args = (q, k, v, out, d_out)
        route = _fa.backward_route(*args)
        if route != "tensor_core":
            raise AssertionError(f"flash_attention_bwd {label}: {route} route")
        row = run_case(
            "flash_attention_bwd",
            [lambda: ops.flash_attention_backward(*args, window=window,
                                                  lse=lse)],
            [lambda: ref.attention_backward(*args, window=window)],
            relative(BWD_GATE), [_bwd_cost(q, k, v, mask)],
            f"{label} [{route}]",
            [_sdpa_backward(q, k, v, d_out,
                            mask[0] if window else None)],
            peak=PEAK_FLOPS_TF32X3, lib_gate=1e-3, profile_calls=10)
        first = ops.flash_attention_backward(*args, window=window, lse=lse)
        again = ops.flash_attention_backward(*args, window=window, lse=lse)
        if not all(torch.equal(a, b_) for a, b_ in zip(first, again)):
            raise AssertionError(f"flash_attention_bwd {label}: two calls "
                                 f"differ")
        if label.startswith("trainer"):
            rows["flash_attention_bwd"] = row
    # the new shapes of MLA and cross-attention: q/k head dim != v head
    # dim on both routes, and not causal with S != T
    for label, b, s, t, h, hkv, hd, hdv, causal, want_route in BWD_SHAPES:
        q = torch.randn((b, s, h, hd), generator=gen, device=device)
        k = torch.randn((b, t, hkv, hd), generator=gen, device=device)
        v = torch.randn((b, t, hkv, hdv), generator=gen, device=device)
        out, lse = ops.flash_attention(q, k, v, causal=causal,
                                       return_lse=True)
        d_out = torch.randn(out.shape, generator=gen, device=device)
        qpos = torch.arange(s, dtype=torch.int32, device=device)[None]
        kpos = torch.arange(t, dtype=torch.int32, device=device)[None]
        mask = _attn_mask(qpos, kpos, causal, None).expand(b, s, t)
        args = (q, k, v, out, d_out)
        route = _fa.backward_route(*args)
        if route != want_route:
            raise AssertionError(f"flash_attention_bwd {label}: {route} "
                                 f"route, want {want_route}")
        run_case(
            "flash_attention_bwd",
            [lambda: ops.flash_attention_backward(*args, causal=causal,
                                                  lse=lse)],
            [lambda: ref.attention_backward(*args, causal=causal)],
            relative(BWD_GATE), [_bwd_cost(q, k, v, mask)],
            f"{label} [{route}]",
            [_sdpa_backward(q, k, v, d_out, None if causal and s == t
                            else mask[0])],
            peak=PEAK_FLOPS_TF32X3 if route == "tensor_core" else PEAK_FLOPS,
            lib_gate=1e-3)
        first = ops.flash_attention_backward(*args, causal=causal, lse=lse)
        again = ops.flash_attention_backward(*args, causal=causal, lse=lse)
        if not all(torch.equal(a, b_) for a, b_ in zip(first, again)):
            raise AssertionError(f"flash_attention_bwd {label}: two calls "
                                 f"differ")
    log("  flash_attention_bwd: every case repeats bit for bit")
    # kv positions of -1: the first 64 queries have no usable key
    q = torch.randn((2, 256, N_HEADS, HEAD_DIM), generator=gen,
                    device=device)
    kv = torch.randn((2, 256, N_KV_HEADS, HEAD_DIM), generator=gen,
                     device=device)
    pos = torch.arange(256, dtype=torch.int32, device=device)[None]
    kvpos = torch.where(pos < 64, -1, pos)
    kw = dict(q_positions=pos, kv_positions=kvpos)
    out, lse = ops.flash_attention(q, kv, kv, return_lse=True, **kw)
    d_out = torch.randn(out.shape, generator=gen, device=device)
    got = ops.flash_attention_backward(q, kv, kv, out, d_out, lse=lse, **kw)
    want = ref.attention_backward(q, kv, kv, out, d_out, **kw)
    err = max(float((a - w).abs().max()) for a, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    if not (bool(torch.all(got[0][:, :64] == 0)) and err <= BWD_GATE * scale):
        raise AssertionError(f"flash_attention_bwd: rows without keys pass "
                             f"gradient, or err {err:.3e}")
    log(f"  flash_attention_bwd kv positions -1: rows without keys pass "
        f"exact zeros (max_abs_err={err:.3e})")
    try:
        ops.flash_attention_backward(*(x.to(torch.bfloat16) for x in
                                       (q, kv, kv, out, d_out)), lse=lse,
                                     **kw)
    except TypeError as exc:
        log(f"  bf16 raises: {exc}")
    else:
        raise AssertionError("flash_attention_bwd took bf16")
    torch.cuda.synchronize()
    return rows


def _attention_calls(cfg, frontend: bool = False) -> list:
    """(hd, hdv, H, Hkv) of every ``flash_attention`` call of one forward
    of ``cfg``: one per attention layer (MLA: q/k head dim qk_nope +
    qk_rope, v head dim v_head_dim, H kv heads: K and V expanded per
    head), and with a frontend one more per cross-attention layer; a
    Mamba2 layer calls none."""
    calls = []
    for st in cfg.stages:
        for sp in st.blocks * st.repeat:
            a = sp.attn
            if a is None:
                continue
            if a.kind == "mla":
                calls.append((a.qk_nope_head_dim + a.qk_rope_head_dim,
                              a.v_head_dim, cfg.n_heads, cfg.n_heads))
            else:
                calls.append((cfg.hd, cfg.hd, cfg.n_heads, cfg.n_kv_heads))
            if a.cross_attn and frontend:
                calls.append((cfg.hd, cfg.hd, cfg.n_heads, cfg.n_kv_heads))
    return calls


def _train_launches(cfg, steps: int, metric_calls: int,
                    retraction: str = "polar"):
    """The trainer's launches, derived from the code: (per step, in all)
    for ``steps`` DRSGDA steps after the init and ``metric_calls``
    ``convergence_metric`` calls.  A gradient runs the forward kernel once
    per attention call (:func:`_attention_calls`: a layer, and a
    cross-attention layer once more with its frontend) and the backward
    kernels (``flash_attention.backward_launches``: dq, dk/dv and, on the
    tensor-core route under GQA, the group sum) per call, and projects
    the Stiefel tree in one grouped call (``stiefel_project_leaves``: one
    launch per ``MAX_LEAVES`` on-chip leaves, two per streaming leaf); a
    step takes one gradient, that projection, and the retraction of each
    Stiefel leaf:
    under ``"polar"`` the ``descent_update``'s two single-leaf projections
    and plain products, under ``"polar_fused"`` one ``fused_retract``
    launch (the projection inside it), on the global route where
    ``retract.cluster_size(r)`` is 0 (``fused_retract_global``, a part of
    ``fused_retract``); it mixes x, u (one grouped ring call per
    ``MAX_LEAVES`` leaves) and y, v (one leaf each); a metric call takes
    the global gradient at the consensus point (forward, backward,
    projection) and y* (forward)."""
    from repro_torch.kernels import flash_attention as _fa
    from repro_torch.kernels import leaves as _lv
    from repro_torch.kernels import retract as _rt
    from repro_torch.kernels import stiefel_project as _sp
    from repro_torch.models import transformer as T
    from repro_torch.objectives import lm
    from repro_torch.tree import tree_flatten

    params = T.abstract_params(cfg)
    problem = lm.make_lm_problem(cfg, params)
    xs = tree_flatten(params)[0]
    stiefel = [tuple(x.shape[-2:]) for m, x in
               zip(tree_flatten(problem.manifold_map)[0], xs)
               if m.name == "stiefel"]

    def project(leaves):
        onchip = sum(1 for d, r in leaves if _sp.cluster_size(d, r))
        return -(-onchip // _lv.MAX_LEAVES) + 2 * (len(leaves) - onchip)

    tree = project(stiefel)
    calls = _attention_calls(cfg, cfg.frontend is not None)
    fwd = len(calls)
    # the backward's route: tensor cores for head dims that are multiples
    # of 16 up to 128, three launches under GQA
    bwd = sum(_fa.backward_launches(
        "tensor_core" if hd % 16 == 0 and hdv % 16 == 0
        and max(hd, hdv) <= 128 else "simt", h, hkv)
        for hd, hdv, h, hkv in calls)
    fused = retraction == "polar_fused"
    per_step = {"flash_attention": fwd, "flash_attention_bwd": bwd,
                "stiefel_project": tree + (0 if fused else 2 * sum(
                    project([leaf]) for leaf in stiefel)),
                "ring_mix": 2 * -(-len(xs) // _lv.MAX_LEAVES) + 2,
                "fused_retract": len(stiefel) if fused else 0,
                "fused_retract_global": sum(
                    1 for _, r in stiefel if _rt.cluster_size(r) == 0)
                if fused else 0}
    init = {"flash_attention": fwd, "flash_attention_bwd": bwd,
            "stiefel_project": tree, "ring_mix": 0, "fused_retract": 0,
            "fused_retract_global": 0}
    metric = {"flash_attention": 2 * fwd,
              "flash_attention_bwd": bwd, "stiefel_project": tree,
              "ring_mix": 0, "fused_retract": 0, "fused_retract_global": 0}
    total = {k: steps * per_step[k] + init[k] + metric_calls * metric[k]
             for k in per_step}
    return per_step, total


class _PlainAttentionCalls:
    """Counts calls of the plain attention versions (``ref.
    blockwise_attention``, ``ref.attention_backward``) while it is open:
    the card's path must run none."""

    def __enter__(self):
        from repro_torch.kernels import ref
        self.calls = 0
        self.saved = {n: getattr(ref, n) for n in
                      ("blockwise_attention", "attention_backward")}
        for name, fn in self.saved.items():
            setattr(ref, name, self._counted(fn))
        return self

    def _counted(self, fn):
        def wrapper(*args, **kwargs):
            self.calls += 1
            return fn(*args, **kwargs)
        return wrapper

    def __exit__(self, *exc):
        from repro_torch.kernels import ref
        for name, fn in self.saved.items():
            setattr(ref, name, fn)


def _all_counts() -> dict:
    from repro_torch.kernels import ops
    return {**ops.launch_counts(), **ops.backward_launch_counts(),
            **ops.route_launch_counts()}


def train_phase() -> dict:
    """The LM trainer on the card (``repro_torch.launch.train``):
    (b) the recorded JAX run (``tests/data/lm_reference.json``:
    full-width smollm-135m cut in depth, 4 nodes, DRSGDA) held point by
    point within its gates; (c) the CLI at full width (30 layers) with its
    defaults (8 nodes, 4 x 64 tokens a node), ``TRAIN_STEPS`` steps,
    ``--eval-every`` 10, telemetry and one checkpoint, exiting 0 under the
    JAX success rule; (d) in both, the launches as :func:`_train_launches`
    derives them and no call of a plain attention version; (e) the
    full-width step: median synchronized wall, the polar retraction of its
    Stiefel leaves alone, one profiled step's device time, busy share and
    top kernels.  Returns the CLI run's launch counts."""
    import tempfile

    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    # (b) the reduced-depth run against the JAX package's
    reference = train.load_reference()
    s = reference["settings"]
    per_step, want = _train_launches(train.reference_config(s), s["steps"],
                                     len(s["eval_steps"]))
    ops.reset_launch_counts()
    with _PlainAttentionCalls() as plain:
        res = train.run_reference(reference, "cuda")
    got = _all_counts()
    comparison = train.compare_to_reference(res, reference)
    for curve, per_key in comparison.items():
        log(f"  reference {curve}: " + ", ".join(
            f"{key} {q['gated']:.3e}" for key, q in per_key.items()))
    log(f"  reference run ({s['n_layers']} layers at full width, "
        f"{s['n_nodes']} nodes, {s['steps']} steps): final loss "
        f"{res['steps'][-1]['loss']:.6f} (JAX "
        f"{reference['steps'][-1]['loss']:.6f}), M_t "
        f"{res['evals'][-1]['M_t']:.6f} (JAX "
        f"{reference['evals'][-1]['M_t']:.6f}), {res['us_per_step']:.1f} "
        f"us/step; launches {got}")
    if not train.within_reference(comparison):
        raise AssertionError(f"LM reference run outside its gates: "
                             f"{comparison}")
    _check_launches("LM reference run", got, want)
    if plain.calls:
        raise AssertionError(f"a plain attention version ran {plain.calls} "
                             f"times on the card")

    # (c) the CLI at full width
    cfg = configs.get_config("smollm-135m")
    evals = -(-TRAIN_STEPS // TRAIN_EVAL_EVERY)
    # every evaluation runs the metric twice: the row and the dashboard
    per_step, want = _train_launches(cfg, TRAIN_STEPS, 2 * evals)
    log(f"  launches a full-width step, derived: {per_step}")
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp, \
            _PlainAttentionCalls() as plain:
        t0 = time.perf_counter()
        rc = train.main([
            "--steps", str(TRAIN_STEPS), "--eval-every",
            str(TRAIN_EVAL_EVERY), "--telemetry", "--telemetry-dir",
            f"{tmp}/tel", "--telemetry-run", "lm", "--checkpoint-dir",
            f"{tmp}/ckpt", "--checkpoint-every", str(TRAIN_STEPS),
            "--log-json", f"{tmp}/history.json"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        history = json.loads(Path(f"{tmp}/history.json").read_text())
        kinds = [json.loads(line)["type"] for line in
                 Path(f"{tmp}/tel/lm.events.jsonl").read_text().splitlines()]
        ckpt = sorted(Path(f"{tmp}/ckpt").iterdir())
        ckpt_bytes = sum(p.stat().st_size for p in ckpt)
    got = _all_counts()
    last = history[-1]
    log(f"  CLI full width ({cfg.n_layers} layers, {TRAIN_NODES} nodes, "
        f"{TRAIN_STEPS} steps): rc {rc}, {wall:.1f} s wall with the "
        f"evaluations, peak {torch.cuda.max_memory_allocated() / 2**30:.1f} "
        f"GiB; " + "; ".join(
            f"step {r['step']} loss {r['loss']:.6f} M_t {r['M_t']:.6f} "
            f"stiefel_residual {r['stiefel_residual']:.3e}" for r in history)
        + f"; events {kinds.count('dashboard')} dashboards, "
        f"{kinds.count('counters')} counter flushes; checkpoint "
        f"{[p.name for p in ckpt]} {ckpt_bytes} bytes; launches {got}")
    if rc != 0 or not (math.isfinite(last["loss"])
                       and last["stiefel_residual"] < 1e-2):
        raise AssertionError(f"LM CLI failed its success rule: rc {rc}, "
                             f"{last}")
    _check_launches("LM CLI", got, want)
    if plain.calls or len(ckpt) != 1 or kinds.count("dashboard") != evals:
        raise AssertionError(f"LM CLI: plain attention calls {plain.calls}, "
                             f"checkpoints {ckpt}, events {kinds}")
    counts = dict(got)
    _train_step_profile(cfg, per_step)
    torch.cuda.empty_cache()
    # (f) the same step under "polar_fused": fused_retract on every Stiefel
    # leaf, wq / wo (576 x 576) on its global route
    per_step, _ = _train_launches(cfg, 1, 0, "polar_fused")
    fused = _train_step_profile(cfg, per_step, "polar_fused")
    torch.cuda.empty_cache()
    return counts, fused


# the other trained configurations: the recorded JAX runs of
# tests/data/lm_models_reference.json (granite-moe-1b-a400m and
# musicgen-large at their published widths cut to 2 layers, deepseek-v2-236b,
# llama-3.2-vision-11b and zamba2-2.7b at SMOKE), then each on a 4-node ring
# of TRAIN_BATCH x TRAIN_SEQ tokens a node: at its recorded size, or where
# TRAIN_MODELS_CUT names it at its published widths cut to that many
# blocks (``launch.train.reference_config``: zamba2-2.7b's are a Mamba2
# block, then attention, 2560 wide)
TRAIN_MODELS_NODES = 4
TRAIN_MODELS_CUT = {"zamba2-2.7b": 2, "xlstm-1.3b": 2}


def train_models_phase() -> dict:
    """Every run of ``tests/data/lm_models_reference.json`` on the card
    (``launch.train.run_reference``), held point by point within the gates
    the file records (a point whose gate is null is reported), its
    launches as :func:`_train_launches` derives them and no call of a
    plain attention version; then the same configuration on
    TRAIN_MODELS_NODES nodes of TRAIN_BATCH x TRAIN_SEQ tokens
    (:func:`_train_step_profile`: the median step, device busy, launches
    a step, peak memory, the JAX CLI's success rule), the recurrent ones
    at their published widths cut to TRAIN_MODELS_CUT blocks, and
    xlstm-1.3b's cut once more under ``"polar_fused"``.  Returns each
    recorded run's launch counts, and the ``"polar_fused"`` step's."""
    import gc

    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    paths = {}
    runs = json.loads(train.MODELS_REFERENCE.read_text())["runs"]
    for arch, reference in runs.items():
        s = reference["settings"]
        cfg = train.reference_config(s)
        per_step, want = _train_launches(cfg, s["steps"],
                                         len(s["eval_steps"]))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        with _PlainAttentionCalls() as plain:
            res = train.run_reference(reference, "cuda")
        got = _all_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        comparison = train.compare_to_reference(res, reference)
        size = "SMOKE" if s.get("smoke") else \
            f"published widths cut to {s['n_layers']} layers"
        log(f"  {arch} reference run ({size}, {s['n_nodes']} nodes x "
            f"{s['batch_per_node']} x {s['seq_len']} tokens, "
            f"{s['steps']} steps): final loss "
            f"{res['steps'][-1]['loss']:.6f} (JAX "
            f"{reference['steps'][-1]['loss']:.6f}), M_t "
            f"{res['evals'][-1]['M_t']:.6f} (JAX "
            f"{reference['evals'][-1]['M_t']:.6f}), "
            f"{res['us_per_step']:.1f} us/step, peak {peak:.2f} GiB; "
            f"launches {got}")
        def gaps(q):
            return " ".join(f"{kind} {q[kind]:.3e}" for kind in
                            ("gated", "reported") if q[kind] is not None)
        for curve, per_key in comparison.items():
            log(f"    {curve}: " + ", ".join(
                f"{key} {gaps(q)}" for key, q in per_key.items()))
        if not train.within_reference(comparison):
            raise AssertionError(f"{arch} reference run outside its gates: "
                                 f"{comparison}")
        _check_launches(f"{arch} reference run", got, want)
        if plain.calls:
            raise AssertionError(f"{arch}: a plain attention version ran "
                                 f"{plain.calls} times on the card")
        paths[f"train {arch}"] = dict(got)
        gc.collect()
        torch.cuda.empty_cache()
        if arch in TRAIN_MODELS_CUT:
            n = TRAIN_MODELS_CUT[arch]
            cfg = train.reference_config({"arch": arch, "n_layers": n})
            size = (f"published widths cut to {n} blocks: " + ", ".join(
                b.kind for b in cfg.flat_blocks()))
        per_step, _ = _train_launches(cfg, 1, 0)
        log(f"  {arch} ({size}): launches a step derived from the code "
            f"{per_step}")
        # xlstm's cut takes 3.7 s a "polar" step: fewer timed steps
        slow = arch == "xlstm-1.3b"
        _train_step_profile(cfg, per_step, steps=2 if slow else 5,
                            nodes=TRAIN_MODELS_NODES, label=f"{arch} ({size})",
                            retract_reps=2 if slow else 5)
        if arch == "xlstm-1.3b":
            # its cut also takes a step under "polar_fused": every Stiefel
            # leaf through fused_retract's global route
            gc.collect()
            torch.cuda.empty_cache()
            per_step, _ = _train_launches(cfg, 1, 0, "polar_fused")
            paths[f"train {arch} polar_fused"] = _train_step_profile(
                cfg, per_step, "polar_fused", steps=1,
                nodes=TRAIN_MODELS_NODES, label=f"{arch} ({size})",
                retract_reps=2)
        gc.collect()
        torch.cuda.empty_cache()
    return paths


def _train_step_profile(cfg, per_step: dict, retraction: str = "polar",
                        steps: int = 10, nodes: int = TRAIN_NODES,
                        label: str = "full-width",
                        retract_reps: int = 5) -> dict:
    """(e) The DRSGDA step of ``cfg`` on ``nodes`` nodes of TRAIN_BATCH x
    TRAIN_SEQ tokens at the CLI defaults (its hyper with ``retraction``;
    a frontend's embeddings as the CLI draws them): the median of
    ``steps`` synchronized steps after 3 warm-up steps, the retraction of
    the Stiefel leaves alone (``retract_reps`` CUDA-event timings), and
    one profiled step: device
    time, busy share, the port's kernels, the top kernels, and its
    launches against ``per_step``; the peak memory of the run; then the
    JAX CLI's success rule at the last state (a finite loss, Stiefel
    residual under 1e-2).  Returns the profiled step's launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.convert import lm_batch_to_torch
    from repro_torch.core.gda import GDAHyper
    from repro_torch.core.metric import convergence_metric
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import (TrainSpec, build_trainer,
                                          init_train_state)
    from repro_torch.launch import frontend_embeds
    from repro_torch.tree import tree_flatten

    torch.cuda.reset_peak_memory_stats()
    # build_trainer's default hyper, with the retraction named
    hyper = GDAHyper(alpha=0.5, beta=0.02, eta=0.05, retraction=retraction)
    opt, problem = build_trainer(cfg, nodes, TrainSpec(hyper=hyper))
    stream = TokenStream(nodes, TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size,
                         n_groups=cfg.n_groups, n_codebooks=cfg.n_codebooks,
                         seed=0)
    fe = frontend_embeds(cfg, (nodes, TRAIN_BATCH), 0, "cuda")

    def to_torch(b):
        out = lm_batch_to_torch(b, "cuda")
        if fe is not None:
            out["frontend_embeds"] = fe
        return out

    state = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                             cfg, opt, nodes, to_torch(stream.batch(0)))
    batch = to_torch(stream.batch(1))
    for _ in range(3):
        state, _ = opt.step(state, batch)
    walls = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = opt.step(state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e6)
    wall_us = statistics.median(walls)
    h = opt.hyper
    leaves = [(m, x, u) for m, x, u in zip(
        tree_flatten(problem.manifold_map)[0], tree_flatten(state.x)[0],
        tree_flatten(state.u)[0]) if m.name == "stiefel"]

    def retract():
        if retraction == "polar_fused":
            return [m.retract(x, h.alpha * x - h.beta * u, retraction)
                    for m, x, u in leaves]
        return [m.descent_update(x, x, u, alpha=h.alpha, beta=h.beta,
                                 kind="polar", method=h.invsqrt)
                for m, x, u in leaves]
    retract_ms = time_ms(retract, reps=retract_reps, warmup=1)
    ops.reset_launch_counts()
    own = own_kernels()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, metrics = opt.step(state, batch)
        torch.cuda.synchronize()
    got = _all_counts()
    if any(got[k] != v for k, v in per_step.items()):
        raise AssertionError(f"LM step launches {got}, want {per_step}")
    m = convergence_metric(problem, state.x, state.y, batch)
    loss, resid = float(metrics.loss), float(m["stiefel_residual"])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not (math.isfinite(loss) and resid < 1e-2):
        raise AssertionError(f"{cfg.name} step: loss {loss}, Stiefel "
                             f"residual {resid:.3e}")
    kernels = _device_kernels(prof, 1)
    device_us = sum(k[0] for k in kernels)
    own_us = sum(k[0] for k in kernels if own.search(k[2]))
    bwd_us = sum(k[0] for k in kernels if "attn_bwd" in k[2])
    log(f"  {cfg.name}: {nodes} nodes x {TRAIN_BATCH} x {TRAIN_SEQ} tokens, "
        f"after {steps + 4} steps loss {loss:.6f}, M_t "
        f"{float(m['M_t']):.6f}, Stiefel residual {resid:.3e} (< 1e-2), "
        f"peak {peak:.2f} GiB")
    log(f"  {label} DRSGDA step, {retraction!r}: {wall_us:.1f} us wall "
        f"(median of "
        f"{steps} synchronized steps; min {min(walls):.1f}, max "
        f"{max(walls):.1f}); {device_us:.1f} us of device time in "
        f"{sum(k[1] for k in kernels):.0f} kernels (device busy "
        f"{100 * device_us / wall_us:.1f}% of the wall); the port's CUDA "
        f"kernels {own_us:.1f} us, of which the attention backward "
        f"{bwd_us:.1f}; the {retraction} "
        f"retraction of the {len(leaves)} Stiefel leaves alone "
        f"{retract_ms:.3f} ms (CUDA events); launches {got}")
    for us, count, key in kernels[:12]:
        log(f"    {us:9.1f} us/step  x{count:4.0f}  {key[:100]}")
    return got


# ---------------------------------------------------------------------------
# serving path
# ---------------------------------------------------------------------------


def _serve(cfg, params, spec, prompts, *, record: bool):
    """Serve ``prompts`` through the paged engine (greedy, SERVE_NEW tokens
    each) with ``serve_requests``.  Times every prefill (to its first token)
    and decode wave on the host clock (both end in a device sync); with
    ``record``, keeps each request's per-step logits on the host."""
    import torch
    from repro_torch.serve import (ContinuousBatchingScheduler, Request,
                                   ServeEngine, serve_requests)

    engine = ServeEngine(cfg, params, kv_spec=spec, n_slots=SERVE_SLOTS,
                         temperature=0.0)
    sched = ContinuousBatchingScheduler(SERVE_SLOTS, spec)
    logits, waves, prefills = {}, [], []
    admit, step = engine.admit, engine.step

    def timed_admit(slot, prompt, pages):
        t0 = time.perf_counter()
        tok = admit(slot, prompt, pages)
        prefills.append(time.perf_counter() - t0)
        if record:
            logits[sched.slots[slot].request.rid] = [engine.last_logits.cpu()]
        return tok

    def timed_step():
        live = {i: sched.slots[i].request.rid for i in sched.active_slots()}
        t0 = time.perf_counter()
        toks = step()
        waves.append(time.perf_counter() - t0)
        if record:
            lg = engine.last_logits.cpu()
            for i, rid in live.items():
                logits[rid].append(lg[i])
        return toks

    engine.admit, engine.step = timed_admit, timed_step
    reqs = [Request(prompt=p, max_new_tokens=SERVE_NEW) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fin = serve_requests(engine, sched, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if sorted(len(r.tokens) for r in fin) != [SERVE_NEW] * len(prompts):
        raise AssertionError("not every request finished with its tokens")
    if sched.pool.n_free != spec.n_pages - 1:
        raise AssertionError(f"pages leaked: {sched.pool.n_free} free of "
                             f"{spec.n_pages - 1}")
    return fin, engine, wall, waves, prefills, logits


def _has_moe(cfg) -> bool:
    return any(sp.kind == "moe_attn" for st in cfg.stages
               for sp in st.blocks)


def _gap_list(gaps) -> str:
    return "[" + ", ".join(f"{float(g):.1e}" for g in gaps) + "]"


def _contiguous_logits(cfg, params, prompt, tokens, device,
                       page_size=None, frontend_embeds=None):
    """Per-step logits of the contiguous-cache path (prefill, then the
    serve step of ``launch.steps``) fed ``tokens``: row i predicts
    ``tokens[i]``.  With ``page_size`` the prompt is prefilled right-padded
    with zeros to whole pages, as the paged engine prefills it: an MoE
    block's capacity is per dispatch group, so the same group drops the
    same tokens (the pad rows lie at later positions, masked until the
    decode overwrites them).  ``frontend_embeds`` (1, N, embed_dim) feed
    a model's cross-attention layers."""
    import torch
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import transformer as T

    serve_step = make_serve_step(cfg)
    n = len(prompt)
    padded = list(prompt) + [0] * (-n % page_size if page_size else 0)
    logits, _, caches = T.forward(
        params, cfg, torch.tensor([padded], device=device),
        frontend_embeds=frontend_embeds, mode="prefill",
        cache_len=max(len(padded), n + len(tokens)),
        last_logits_only=not page_size)
    out = [logits[0, n - 1 if page_size else -1]]
    for i, tok in enumerate(tokens[:-1]):
        lg, caches = serve_step(
            params, torch.tensor([tok], device=device),
            torch.tensor([n + i], dtype=torch.int32, device=device),
            caches, frontend_embeds=frontend_embeds)
        out.append(lg[0])
    return torch.stack(out).float().cpu()


def _check_argmax(cont, tokens, label):
    """Tokens equal the argmax of ``cont`` (steps, [codebooks,] V)
    wherever its top-2 margin exceeds 1e-3; returns how many (step,
    codebook) choices were that clear."""
    import torch
    top2 = cont.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 1e-3
    agree = cont.argmax(-1) == torch.tensor(tokens)
    if not bool(agree[clear].all()):
        raise AssertionError(f"{label}: argmax differs where the margin is "
                             f"clear")
    return int(clear.sum())


def _serve_prompts(cfg) -> list:
    """smollm-135m's traffic: SERVE_REQUESTS prompts of PROMPT_LENGTHS
    tokens, drawn from seed 0."""
    import numpy as np
    rng = np.random.default_rng(0)
    lengths = rng.integers(PROMPT_LENGTHS[0], PROMPT_LENGTHS[1] + 1,
                           SERVE_REQUESTS)
    return [rng.integers(0, cfg.vocab_size, int(n)).tolist()
            for n in lengths]


def _serve_paged(cfg, params) -> tuple[dict, dict]:
    """``cfg`` at its widths through the paged engine at smollm-135m's
    traffic (:func:`_serve_prompts`, SERVE_NEW greedy tokens each,
    SERVE_SLOTS slots of PAGE_SIZE-token pages): once to record the
    logits, once timed with the launch counts set to 0 just before it
    (flash_attention exactly once a layer per prefill, paged_decode once a
    layer per decode wave, no other kernel; every request finishes, no
    page leaks); then the contiguous path fed the engine's tokens against
    the engine's logits (1e-3).  Returns the serving launches and the
    figures (tokens/s, waves, TTFT)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import paged_spec
    from repro_torch.models import moe

    prompts = _serve_prompts(cfg)
    spec = paged_spec(SERVE_SLOTS, PROMPT_LENGTHS[1] + SERVE_NEW, PAGE_SIZE)
    pool_bytes = 2 * cfg.n_layers * spec.n_pages * PAGE_SIZE \
        * cfg.n_kv_heads * cfg.hd * 4
    log(f"  {cfg.name}: pools {spec.n_pages} pages of {PAGE_SIZE} "
        f"({pool_bytes / 1e9:.3f} GB); prompt lengths "
        f"{[len(p) for p in prompts]}")
    page_size = None
    if _has_moe(cfg):
        # a decode wave dispatches SERVE_SLOTS tokens as one group, and a
        # token takes an expert at most once: while that group's capacity
        # holds them all no wave drops a token, nor does the contiguous
        # path (one token a step); its prefill dispatches the engine's own
        # padded group (page_size)
        caps = {moe.capacity(SERVE_SLOTS, sp.moe) for st in cfg.stages
                for sp in st.blocks}
        if min(caps) < SERVE_SLOTS:
            raise AssertionError(f"{cfg.name}: a wave of {SERVE_SLOTS} "
                                 f"slots can overflow an expert "
                                 f"(capacity {min(caps)})")
        page_size = PAGE_SIZE
        log(f"  MoE: a wave's group of {SERVE_SLOTS} tokens against an "
            f"expert capacity of {min(caps)}: no wave drops a token")

    rec, _, _, _, _, logits = _serve(cfg, params, spec, prompts, record=True)
    ops.reset_launch_counts()
    fin, engine, wall, waves, prefills, _ = _serve(cfg, params, spec,
                                                   prompts, record=False)
    counts = ops.launch_counts()
    tokens = {r.rid - fin[0].rid: r.tokens for r in fin}
    if sorted(r.tokens for r in rec) != sorted(tokens.values()):
        raise AssertionError("the timed run's tokens differ from the first")
    want = {"flash_attention": cfg.n_layers * SERVE_REQUESTS,
            "paged_decode": cfg.n_layers * engine.steps_run}
    got = {n: counts[n] for n in SERVE_PATH}
    others = {n: c for n, c in counts.items() if n not in SERVE_PATH and c}
    if got != want or others:
        raise AssertionError(f"serving launches {counts}, want {want}")
    n_tok = sum(len(r.tokens) for r in fin)
    stats = {"tokens_per_s": n_tok / wall, "waves": engine.steps_run,
             "wave_ms": 1e3 * statistics.median(waves),
             "prefill_ms": 1e3 * statistics.median(prefills),
             "ttft_ms": 1e3 * statistics.median(r.ttft for r in fin)}
    log(f"  paged engine: {SERVE_REQUESTS} requests x {SERVE_NEW} tokens in "
        f"{wall:.3f} s ({stats['tokens_per_s']:.1f} tokens/s); "
        f"{engine.steps_run} decode waves, median {stats['wave_ms']:.2f} ms "
        f"(min {1e3 * min(waves):.2f}, max {1e3 * max(waves):.2f}); prefill "
        f"median {stats['prefill_ms']:.2f} ms; median TTFT "
        f"{stats['ttft_ms']:.1f} ms (queue wait included); launches {got} "
        f"(exactly {cfg.n_layers} per prefill and per wave)")

    # the contiguous path fed the engine's tokens
    max_err, clear = 0.0, 0
    for r in rec:
        cont = _contiguous_logits(cfg, params, r.prompt, r.tokens, "cuda",
                                  page_size)
        paged = torch.stack(logits[r.rid]).float()
        max_err = max(max_err, float((cont - paged).abs().max()))
        clear += _check_argmax(cont, r.tokens, "paged vs contiguous")
    if max_err > 1e-3:
        raise AssertionError(f"paged vs contiguous logits differ by "
                             f"{max_err:.3e}")
    log(f"  teacher-forced contiguous path vs paged engine: logits "
        f"max_abs_err={max_err:.3e} (<= 1e-3); argmax equal at every one "
        f"of the {clear} steps (of {n_tok}) with a top-2 margin > 1e-3")
    return got, stats


def _init_model(cfg) -> dict:
    """Random fp32 weights of ``cfg`` from seed 0, drawn on the card."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves

    t0 = time.perf_counter()
    params = T.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"  {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, heads "
        f"{cfg.n_heads}:{cfg.n_kv_heads}, hd {cfg.hd}, vocab "
        f"{cfg.vocab_size}; {n_params} parameters fp32 "
        f"({n_params * 4 / 1e9:.3f} GB), init "
        f"{time.perf_counter() - t0:.1f} s")
    return params


def serve_phase() -> dict:
    """smollm-135m at its published widths through the paged engine
    (:func:`_serve_paged`), then a profiled decode wave and prefill;
    returns the serving kernels' launch counts from the timed run."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.launch.serve import paged_spec

    cfg = configs.get_config("smollm-135m")
    assert (cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.hd) == \
        (N_LAYERS, N_HEADS, N_KV_HEADS, HEAD_DIM)
    params = _init_model(cfg)
    got, _ = _serve_paged(cfg, params)
    spec = paged_spec(SERVE_SLOTS, PROMPT_LENGTHS[1] + SERVE_NEW, PAGE_SIZE)
    _profile_wave(cfg, params, spec, _serve_prompts(cfg)[:SERVE_SLOTS])
    _profile_prefill(cfg, params, spec, np.random.default_rng(0).integers(
        0, cfg.vocab_size, PROMPT_LENGTHS[1]).tolist())
    return got


# The other served configurations (src/repro_torch/configs), each at its
# published widths, one at a time: the paged ones at smollm-135m's
# traffic, the contiguous ones (sliding windows, codebooks) through
# ``generate`` with (prompts, prompt tokens, new tokens).  gemma3-27b is
# cut in depth only: 62 layers (about 28.4 B parameters, 114 GB in fp32)
# do not fit one card; 14 do (``patterned_stages(cell, 14)``: two
# supercells of 5 local and 1 global layers, then 2 local, the shape
# 62 = 6 x 10 + 2 takes).
SERVED_PAGED = ("granite-3-2b", "granite-3-8b", "granite-moe-1b-a400m")
SERVED_CONTIGUOUS = {"gemma3-27b": (2, 1536, 16),
                     "musicgen-large": (4, 32, 32),
                     "deepseek-v2-236b": (4, 256, 16),
                     "llama-3.2-vision-11b": (2, 512, 16),
                     "zamba2-2.7b": (2, 1000, 16),
                     "xlstm-1.3b": (2, 1000, 16)}
GEMMA3_LAYERS = 14
# The full-depth decode of a recurrent model against its teacher-forced
# forward, every chunked form the recurrence.  zamba2-2.7b (54 layers): a
# fixed 5e-3, five times the 1e-3 that its first supercell holds.  The 54
# random-weight layers carry the rounding of the two paths (B = 2 prefill
# and single-token steps, B = 1 forwards) to 1.552e-03 (H100, PERF.md
# section 6).
DECODE_TOL = {"zamba2-2.7b": 5e-3}
# xlstm-1.3b (48 layers) is judged against a float64 forward of the same
# weights on the card, every mLSTM the recurrence (``F64_WITNESS``).  Its
# fp32 pairs lie about 1e-2 apart (2.405e-02 decode against forward, and
# 1.6e-02 already at the prefill's last position, where no decode step
# runs), so no fixed fp32 gate tells rounding from a lost state.  Two
# gates, both set before the run that first read them (PERF.md section
# 6):
#   * float64: the decode from a float64 prefill against the float64
#     forward within XLSTM_F64_TOL.  The fp32 reading scaled by the unit
#     roundoffs' ratio (2.405e-02 x 2^-29 = 4.5e-11) is 200 times below;
#     on the CPU the two agree to 4.4e-16 (SMOKE widths);
#   * fp32: each fp32 decode no further from the float64 forward than
#     XLSTM_F32_RATIO times the fp32 forward of its form (the recurrence,
#     and the chunked mLSTM as served): the served precision no worse
#     than the forward's.  Both run the same cells; the steps' own fp32
#     gaps spread 2x over 16 steps, hence the room.
# Every fault of ``decode_check.FAULTS`` (every state, the conv windows
# alone, the sLSTM states alone, the last repeat's states alone, zeroed
# after the prefill) must fail the float64 gate, which sees what fp32
# rounding hides; the same faults in fp32 are reported beside the fp32
# bound (on the CPU at d_model 128 the fp32 forward lies 2.4e-03 from
# float64, 24 times its gap to the fp32 decode, and the card's may lie
# near a fault's size, so that bound is no fault detector).
F64_WITNESS = ("xlstm-1.3b",)
XLSTM_F64_TOL = 1e-8
XLSTM_F32_RATIO = 3.0
# deepseek-v2-236b: its dense MLA layer 0 and the first DEEPSEEK_MOE_LAYERS
# of its 59 MoE layers (about 15.9 GB each in fp32; 2 so that the stacked
# repeats' loop runs), about 37 GB of weights with the embedding and head
DEEPSEEK_MOE_LAYERS = 2


def _served_config(arch: str, smoke: bool = False):
    from repro_torch import configs
    cfg = configs.get_config(arch, smoke=smoke)
    if arch == "gemma3-27b" and not smoke:
        cfg = dataclasses.replace(
            cfg, name=f"{cfg.name} (cut to {GEMMA3_LAYERS} layers)",
            stages=configs.patterned_stages(cfg.stages[0].blocks,
                                            GEMMA3_LAYERS))
    if arch == "deepseek-v2-236b" and not smoke:
        first, moe = cfg.stages
        cfg = dataclasses.replace(
            cfg, name=f"{cfg.name} (cut to 1 + {DEEPSEEK_MOE_LAYERS} layers)",
            stages=(first, dataclasses.replace(moe,
                                               repeat=DEEPSEEK_MOE_LAYERS)))
    return cfg


def _serve_contiguous(cfg, params, batch: int, prompt_len: int,
                      n_new: int, tol: float | None = 1e-3,
                      chunked_gate: bool = True) -> tuple[dict, dict, dict]:
    """``launch.serve.generate`` (greedy) of ``batch`` seeded prompts of
    ``prompt_len`` tokens ((B, S, CB) with codebooks; with a frontend,
    each with its seeded embeddings), ``n_new`` tokens: first the same
    prefill and decode steps timed one by one (TTFT, the median step),
    recording each step's logits; then ``generate`` with the launch counts
    set to 0 just before it (flash_attention exactly once a layer, and
    once more a cross-attention layer, for the prefill and for each of
    the n_new - 1 decode steps, no other kernel), its tokens the argmax of
    the recorded logits wherever the top-2 margin exceeds 1e-3; then the
    logits against a teacher-forced forward of prompt plus tokens
    (``tol``):
    every step's, or with MoE blocks, whose capacity is per dispatch
    group, the prefill's last position's against a forward of the prompts
    alone, the same group (a decode step's group of ``batch`` tokens is
    asserted to fit every expert's capacity: no decode step drops a
    token).  With recurrent blocks (Mamba2, mLSTM, sLSTM) the prefill and
    decode steps run once more under the recurrences a decode step runs
    (``decode_check.sequential_scans``), fed ``generate``'s tokens,
    against the teacher-forced forward under them; the chunked pair (as
    served) is held to ``tol`` too unless ``chunked_gate`` is false, and
    then reported only (at zamba2's 54 layers its two forwards lie
    6.937e-03 apart, PERF.md section 6); and the same decode after each
    fault of ``decode_check.faults(cfg)`` (states zeroed after the
    prefill) must lie past ``tol``, so that the gate sees a lost state.
    ``tol`` None reports the pairs and leaves the gates to the caller
    (``_f64_witness``).  Returns the launches, the figures and the
    readings: the prompts, tokens and logits on the CPU."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import decode_check as dc
    from repro_torch.launch import frontend_embeds
    from repro_torch.launch.serve import generate
    from repro_torch.models import moe
    from repro_torch.models import transformer as T

    cb = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, prompt_len, *cb))).to("cuda")
    fe = frontend_embeds(cfg, (batch,), 0, "cuda")
    has_moe = _has_moe(cfg)
    if has_moe:
        for st in cfg.stages:
            for sp in st.blocks:
                if sp.kind == "moe_attn" and moe.capacity(
                        batch, sp.moe) < batch:
                    raise AssertionError(f"{cfg.name}: a decode step of "
                                         f"{batch} tokens can drop tokens")
    outs, ttft, steps = dc.decode_logits(cfg, params, prompts, n_new,
                                         frontend_embeds=fe)
    loop = outs["served"]

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens = generate(cfg, params, prompts, n_new, frontend_embeds=fe)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    per_call = len(_attention_calls(cfg, fe is not None))
    want = {"flash_attention": per_call * n_new, "paged_decode": 0}
    got = {n: counts[n] for n in SERVE_PATH}
    others = {n: c for n, c in counts.items() if n not in SERVE_PATH and c}
    if got != want or others:
        raise AssertionError(f"generate launches {counts}, want {want}")
    if tuple(tokens.shape) != (batch, n_new, *cb):
        raise AssertionError(f"generate returned {tuple(tokens.shape)}")
    clear = sum(_check_argmax(loop[b], tokens[b].tolist(), "generate")
                for b in range(batch))

    max_err = 0.0
    readings = {"prompts": prompts, "tokens": tokens, "served": loop}
    if has_moe:
        full, _, _ = T.forward(params, cfg, prompts, frontend_embeds=fe,
                               last_logits_only=True)
        max_err = float((full[:, -1].cpu() - loop[:, 0]).abs().max())
        del full
        compared = "the prefill's last position vs a forward of the prompts"
    else:
        forced = dc.forced_logits(cfg, params, prompts, tokens, fe)
        readings["forced"] = forced
        max_err = float((forced - loop).abs().max())
        compared = "teacher-forced forward vs every step's logits"
        if dc.has_recurrent(cfg):
            # the decode recurrence and the conv state held against the
            # forward with every SSD and mLSTM the recurrence; the chunked
            # pair as served beside it
            faults = dc.faults(cfg)
            with dc.sequential_scans():
                seq = dc.forced_logits(cfg, params, prompts, tokens, fe)
                runs = dc.decode_logits(cfg, params, prompts, n_new,
                                        feed=tokens, faults=faults,
                                        frontend_embeds=fe)[0]
            readings.update(sequential=seq, runs=runs)
            gap_q = dc.step_gaps(seq, runs["served"])
            gap_c = dc.step_gaps(forced, loop)
            spread = dc.step_gaps(forced, seq)
            lost = {f: dc.step_gaps(seq, runs[f]) for f in faults}
            max_err = float(gap_q.max())
            if chunked_gate:
                max_err = max(max_err, float(gap_c.max()))
            if tol is not None:
                caught = {f: float(g[1:].max()) > tol
                          for f, g in lost.items()}
                if not all(caught.values()):
                    raise AssertionError(
                        f"generate: with states zeroed after the prefill "
                        f"the decode stays within {tol:.0e} of the forward "
                        f"({ {f: _gap_list(g) for f, g in lost.items()} }): "
                        f"the gate cannot see a lost state")
            compared = (
                f"under the recurrences, teacher-forced forward vs every "
                f"step's logits {float(gap_q.max()):.3e}, per step "
                f"{_gap_list(gap_q)}; with the chunked forms (as served) "
                f"{float(gap_c.max()):.3e}, per step {_gap_list(gap_c)} "
                f"({'gated' if chunked_gate and tol else 'reported, not gated'}"
                f"); the chunked and sequential forwards apart "
                f"{float(spread.max()):.3e}, per step {_gap_list(spread)}; "
                + "; ".join(f"with {f} zeroed after the prefill (a "
                            f"fault) {float(g[1:].max()):.3e}, per step "
                            f"{_gap_list(g)}" for f, g in lost.items())
                + f"; max |logit| {float(loop.abs().max()):.3f}; gate "
                + (f"{tol:.0e}" if tol is not None
                   else "against a float64 forward, below"))
    if tol is not None and max_err > tol:
        raise AssertionError(f"generate: {compared} differ by "
                             f"{max_err:.3e}")
    stats = {"tokens_per_s": batch * n_new / wall, "waves": n_new - 1,
             "wave_ms": 1e3 * statistics.median(steps),
             "prefill_ms": 1e3 * ttft, "ttft_ms": 1e3 * ttft}
    extra = f" x {cfg.n_codebooks} codebooks" if cb else ""
    if fe is not None:
        extra += (f", each with {cfg.frontend.n_tokens} frontend tokens of "
                  f"width {cfg.frontend.embed_dim}")
    log(f"  generate: {batch} prompts of {prompt_len} tokens{extra}, "
        f"{n_new} new in {wall:.3f} s ({stats['tokens_per_s']:.1f} "
        f"tokens/s); {n_new - 1} decode steps, median "
        f"{stats['wave_ms']:.2f} ms (min {1e3 * min(steps):.2f}, max "
        f"{1e3 * max(steps):.2f}); TTFT (prefill and first token) "
        f"{stats['ttft_ms']:.1f} ms; launches {got} (exactly {per_call} "
        f"per prefill and per step); {compared} max_abs_err={max_err:.3e}"
        + (f" (<= {tol:.3e})" if tol is not None else "")
        + f"; tokens = argmax at every one of the {clear} clear choices "
        f"(of {tokens.numel()})")
    return got, stats, readings


def _f64_witness(cfg, params, readings: dict) -> None:
    """The decode of a model whose fp32 rounding no fixed gate tells from
    a lost state, judged against float64 (the gates by ``F64_WITNESS``):
    the same weights in float64 on the card, every mLSTM and SSD the
    recurrence, fed the served tokens.  The float64 decode against the
    float64 forward within XLSTM_F64_TOL; each fp32 decode of
    ``_serve_contiguous`` (from the recurrent prefill, and as served)
    against the float64 forward within XLSTM_F32_RATIO times its fp32
    forward's gap (the recurrence, the chunked form); each fault of
    ``decode_check.faults`` past the float64 gate, and reported in fp32
    beside the fp32 bound."""
    import torch
    from repro_torch.launch import decode_check as dc
    from repro_torch.tree import tree_map

    prompts, tokens = readings["prompts"], readings["tokens"]
    faults = dc.faults(cfg)
    t0 = time.perf_counter()
    p64 = tree_map(lambda t: t.double(), params)
    with dc.sequential_scans():
        ref = dc.forced_logits(cfg, p64, prompts, tokens)
        runs = dc.decode_logits(cfg, p64, prompts, tokens.shape[1],
                                feed=tokens, faults=faults)[0]
    del p64
    torch.cuda.empty_cache()
    if ref.dtype != torch.float64:
        raise AssertionError(f"the float64 forward returned {ref.dtype}")
    wall = time.perf_counter() - t0
    gap64 = dc.step_gaps(ref, runs["served"])
    lost64 = {f: float(dc.step_gaps(ref, runs[f])[1:].max()) for f in faults}
    fwd32 = float(dc.step_gaps(ref, readings["sequential"]).max())
    chunk32 = float(dc.step_gaps(ref, readings["forced"]).max())
    f32 = readings["runs"]
    dec32 = float(dc.step_gaps(ref, f32["served"]).max())
    served32 = float(dc.step_gaps(ref, readings["served"]).max())
    lost32 = {f: float(dc.step_gaps(ref, f32[f])[1:].max()) for f in faults}
    bound32 = XLSTM_F32_RATIO * fwd32
    line = (f"  {cfg.name} against a float64 forward (every mLSTM the "
            f"recurrence; {wall:.1f} s): float64 decode "
            f"{float(gap64.max()):.3e}, per step {_gap_list(gap64)} (<= "
            f"{XLSTM_F64_TOL:.0e}); fp32 forwards: recurrence {fwd32:.3e}, "
            f"chunked {chunk32:.3e}; fp32 decodes: from the recurrent "
            f"prefill {dec32:.3e} (<= {XLSTM_F32_RATIO:g} x {fwd32:.3e} = "
            f"{bound32:.3e}), as served {served32:.3e} (<= "
            f"{XLSTM_F32_RATIO:g} x {chunk32:.3e} = "
            f"{XLSTM_F32_RATIO * chunk32:.3e}); faults, float64 (> "
            f"{XLSTM_F64_TOL:.0e}) / fp32 (reported; bound {bound32:.3e}): "
            + ", ".join(f"{f} {lost64[f]:.3e} / {lost32[f]:.3e}"
                        for f in faults)
            + f"; max |logit| {float(ref.abs().max()):.3f}")
    log(line)
    missed = []
    if not float(gap64.max()) <= XLSTM_F64_TOL:
        missed.append("the float64 decode")
    if not dec32 <= bound32:
        missed.append("the fp32 decode from the recurrent prefill")
    if not served32 <= XLSTM_F32_RATIO * chunk32:
        missed.append("the fp32 decode as served")
    missed += [f"the fault '{f}' passes the float64 gate" for f in faults
               if not lost64[f] > XLSTM_F64_TOL]
    if missed:
        raise AssertionError(f"{cfg.name} against float64: "
                             + "; ".join(missed))


def _xlstm_serve_bounds(cfg, params, batch: int, prompt_len: int) -> str:
    """The least times of xlstm-1.3b's serving on the card: a decode step
    moves every weight but the embedding table once (two of its rows) and
    reads and writes every mLSTM state {C, n, m} (fp32), at 3.35 TB/s; the
    prefill's products (every block's matrices and the head's last
    position, 2 flops a weight a token, and the chunked mLSTM's per chunk
    and head: q k^T, the scores by v and by k, 2 L^2 dk each; q C and the
    state's update, 2 L dk^2 each; the sequence padded to whole chunks)
    at 67 TFLOP/s (fp32, TF32 off)."""
    from repro_torch.models import xlstm
    from repro_torch.tree import tree_leaves

    weights = sum(t.numel() for t in tree_leaves(params)) \
        - params["embed"].numel()
    blocks = [sp for st in cfg.stages for sp in st.blocks * st.repeat]
    n_m = sum(sp.kind == "mlstm" for sp in blocks)
    spec = next(sp.xlstm for sp in blocks if sp.kind == "mlstm")
    _, h, dk = xlstm._mdims(cfg, spec)
    state = n_m * batch * h * (dk * dk + dk + 1) * 4
    step_ms = 1e3 * (weights * 4 + 2 * state) / PEAK_BYTES
    dense = weights - params["lm_head"].numel() - cfg.d_model * (
        1 + len(blocks))
    ell = min(spec.chunk, prompt_len)
    chunks = -(-prompt_len // ell)
    flops = (2 * dense * batch * prompt_len
             + 2 * params["lm_head"].numel() * batch
             + n_m * batch * h * chunks * (6 * ell * ell * dk
                                           + 4 * ell * dk * dk))
    return (f"bounds: a decode step moves {weights * 4 / 1e9:.2f} GB of "
            f"weights and reads and writes {state / 1e9:.2f} GB of mLSTM "
            f"state ({n_m} layers x {batch} sequences), at least "
            f"{step_ms:.2f} ms at 3.35 TB/s; the prefill's products "
            f"{flops / 1e12:.2f} TFLOP, at least "
            f"{1e3 * flops / PEAK_FLOPS:.1f} ms at 67 TFLOP/s fp32")


def serve_models_phase() -> dict:
    """Every other served configuration at its published widths
    (SERVED_PAGED, SERVED_CONTIGUOUS), one at a time, freed before the
    next; per model its launches, figures and peak memory (while serving,
    and during init).  The recurrent ones (zamba2-2.7b, xlstm-1.3b) first
    at their published widths cut to their first supercell (5 Mamba2
    layers and attention; 7 mLSTM layers and an sLSTM layer), held to the
    teacher-forced forward within 1e-3 with the chunked forms and with the
    recurrences; at full depth zamba2-2.7b's 54 layers with the
    recurrences within ``DECODE_TOL`` (the chunked pair reported) and
    xlstm-1.3b's 48 against float64 (``_f64_witness``), with its bounds.
    Returns each model's serving launches."""
    import gc

    import torch
    from repro_torch import configs
    from repro_torch.launch.decode_check import has_recurrent

    paths = {}
    for arch in (*SERVED_PAGED, *SERVED_CONTIGUOUS):
        cfg = _served_config(arch)
        if has_recurrent(cfg):
            cell = dataclasses.replace(
                cfg, name=f"{cfg.name} (cut to its first supercell)",
                stages=configs.patterned_stages(cfg.stages[0].blocks,
                                                len(cfg.stages[0].blocks)))
            gc.collect()
            torch.cuda.empty_cache()
            params = _init_model(cell)
            _serve_contiguous(cell, params, *SERVED_CONTIGUOUS[arch])
            del params
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = _init_model(cfg)
        # init draws each stacked repeat into its slice: one repeat above
        # the weights; serving is read from here on
        init_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        if arch in SERVED_PAGED:
            got, stats = _serve_paged(cfg, params)
        else:
            got, stats, readings = _serve_contiguous(
                cfg, params, *SERVED_CONTIGUOUS[arch],
                **({"tol": DECODE_TOL[arch], "chunked_gate": False}
                   if arch in DECODE_TOL else {"tol": None}
                   if arch in F64_WITNESS else {}))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"  {cfg.name}: peak memory serving {peak:.2f} GiB (init "
            f"{init_peak:.2f} GiB); "
            f"{json.dumps({k: round(v, 4) for k, v in stats.items()})}")
        if arch in F64_WITNESS:
            _f64_witness(cfg, params, readings)
            del readings
        if arch == "xlstm-1.3b":
            log(f"  {cfg.name}: "
                + _xlstm_serve_bounds(cfg, params,
                                      *SERVED_CONTIGUOUS[arch][:2]))
        paths[f"serving {arch}"] = got
        del params
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def _profile_calls(label: str, fn, n: int) -> None:
    """``n`` calls of ``fn`` (each ends in a host sync): host wall, CUDA-event
    span and profiler device time per call, side by side, and the kernels
    that take the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    walls, spans = [], []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        walls.append(1e3 * (time.perf_counter() - t0))
        end.synchronize()
        spans.append(start.elapsed_time(end))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = [(e.self_device_time_total / n, e.count / n, e.key)
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    events.sort(reverse=True)
    device = sum(e[0] for e in events) / 1e3
    wall = statistics.median(walls)
    span = statistics.median(spans)
    log(f"  {label}: {wall:.3f} ms wall (median of {n}; min {min(walls):.3f},"
        f" max {max(walls):.3f}), {span:.3f} ms CUDA-event span, "
        f"{device:.3f} ms device time in {sum(e[1] for e in events):.0f} "
        f"device events (busy {100 * device / wall:.1f}% of the wall, "
        f"{100 * device / span:.1f}% of the span)")
    for us, count, key in events[:8]:
        log(f"    {us:9.1f} us/call  x{count:4.0f}  {key[:90]}")


def _profile_wave(cfg, params, spec, prompts, n: int = 10) -> None:
    """A full decode wave (every slot live), profiled as _profile_calls
    does; the wave ends in its tokens' copy to the host."""
    from repro_torch.serve import (ContinuousBatchingScheduler, Request,
                                   ServeEngine)

    assert 3 + 2 * n < SERVE_NEW, "the waves would outrun the reservation"
    engine = ServeEngine(cfg, params, kv_spec=spec, n_slots=SERVE_SLOTS,
                         temperature=0.0)
    sched = ContinuousBatchingScheduler(SERVE_SLOTS, spec)
    for p in prompts:
        sched.submit(Request(prompt=p, max_new_tokens=SERVE_NEW))
    for slot, req in sched.admit(0.0):
        engine.admit(slot, req.prompt, sched.slots[slot].pages)
    for _ in range(3):
        engine.step()
    _profile_calls(f"decode wave, {SERVE_SLOTS} live slots", engine.step, n)


def _profile_prefill(cfg, params, spec, prompt, n: int = 5) -> None:
    """One prefill of ``prompt`` into slot 0 (admit, then release, so the
    next one finds the slot free), profiled as _profile_calls does; the
    prefill ends in its first token's copy to the host."""
    from repro_torch.serve import ServeEngine

    engine = ServeEngine(cfg, params, kv_spec=spec, n_slots=SERVE_SLOTS,
                         temperature=0.0)
    pages = list(range(1, 1 + spec.max_pages_per_slot))

    def prefill():
        engine.admit(0, prompt, pages)
        engine.release(0)

    for _ in range(2):
        prefill()
    _profile_calls(f"prefill of {len(prompt)} tokens", prefill, n)


def serve_agreement_phase() -> None:
    """The SMOKE config of smollm-135m and of every other served
    configuration on the card against the CPU (plain versions), with the
    same port weights and prompts: the paged ones through the engine (3
    requests x 12 tokens, 2 slots), the contiguous ones through
    ``generate`` (3 prompts of 17 tokens, longer than gemma3's window of
    8, 12 new; llama-vision's each with its seeded frontend embeddings);
    the card's greedy tokens equal the CPU's argmax wherever the CPU's
    top-2 margin exceeds 1e-3 (teacher-forced on the card's tokens, an MoE
    prompt prefilled padded to whole pages as the engine prefills it; at
    SMOKE no dispatch group of deepseek's drops a token, alone or in the
    batch of 3)."""
    import numpy as np
    import torch
    from repro_torch.launch import frontend_embeds
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as T
    from repro_torch.serve import (ContinuousBatchingScheduler, PagedKVSpec,
                                   Request, ServeEngine, serve_requests)
    from repro_torch.tree import tree_map

    spec = PagedKVSpec(page_size=4, n_pages=33, max_pages_per_slot=12)
    for arch in ("smollm-135m", *SERVED_PAGED, *SERVED_CONTIGUOUS):
        cfg = _served_config(arch, smoke=True)
        p_cpu = T.init_params(torch.Generator().manual_seed(1), cfg)
        rng = np.random.default_rng(1)
        served = {}
        fe = frontend_embeds(cfg, (3,), 0, "cpu")
        if arch in SERVED_CONTIGUOUS:
            cb = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
            prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                    (3, 17, *cb)))
            for dev in ("cuda", "cpu"):
                params = tree_map(lambda t: t.to(dev), p_cpu)
                toks = generate(cfg, params, prompts.to(dev), 12,
                                frontend_embeds=None if fe is None
                                else fe.to(dev)).cpu()
                served[dev] = {tuple(map(tuple, prompts[b].tolist()))
                               if cb else tuple(prompts[b].tolist()):
                               toks[b].tolist() for b in range(3)}
            plist = [prompts[b].tolist() for b in range(3)]
            page_size, what = None, "generate"
        else:
            plist = [rng.integers(0, cfg.vocab_size, n).tolist()
                     for n in (5, 17, 30)]
            for dev in ("cuda", "cpu"):
                params = tree_map(lambda t: t.to(dev), p_cpu)
                engine = ServeEngine(cfg, params, kv_spec=spec, n_slots=2)
                fin = serve_requests(engine,
                                     ContinuousBatchingScheduler(2, spec),
                                     [Request(prompt=p, max_new_tokens=12)
                                      for p in plist])
                served[dev] = {tuple(r.prompt): r.tokens for r in fin}
            page_size = spec.page_size if _has_moe(cfg) else None
            what = "engine"
        clear = same = total = 0
        for i, p in enumerate(plist):
            key = tuple(map(tuple, p)) if isinstance(p[0], list) \
                else tuple(p)
            card, cpu = served["cuda"][key], served["cpu"][key]
            cont = _contiguous_logits(cfg, p_cpu, p, card, "cpu", page_size,
                                      None if fe is None else fe[i:i + 1])
            clear += _check_argmax(cont, card, f"{arch} card vs CPU")
            a, b = np.asarray(card), np.asarray(cpu)
            same += int((a == b).sum())
            total += a.size
        log(f"  card vs CPU, {cfg.name} ({what}, 3 requests x 12 tokens): "
            f"card tokens = CPU argmax at every one of the {clear} choices "
            f"(of {total}) with a top-2 margin > 1e-3; {same} of {total} "
            f"tokens equal to the CPU's")


# the SSD core at zamba2-2.7b's full width: B, S (4 chunks of 256, the last
# padded), H, N, P
SSD_SHAPE, SSD_CHUNK = (2, 1000, 80, 64, 64), 256
SSD_ATOL = 1e-4      # the JAX package's test (tests/test_models.py)


def _ssd_fp64(x, b_, c_, dt, la):
    """The SSD recurrence of ``ssm.ssd_reference`` in fp64, token by
    token: the oracle both fp32 versions are measured against."""
    import torch
    x, b_, c_, dt, la = (t.double() for t in (x, b_, c_, dt, la))
    xb = x * dt[..., None]
    bsz, s, h, p = x.shape
    hst = x.new_zeros((bsz, h, b_.shape[-1], p))
    ys = []
    for t in range(s):
        hst = hst * torch.exp(la[:, t])[..., None, None] + torch.einsum(
            "bhn,bhp->bhnp", b_[:, t], xb[:, t])
        ys.append(torch.einsum("bhn,bhnp->bhp", c_[:, t], hst))
    return torch.stack(ys, dim=1), hst


def ssd_phase() -> None:
    """The Mamba2 block's SSD core (plain PyTorch, as it is plain ``jnp``
    in the JAX package) at zamba2-2.7b's full width on the card, TF32 off:
    the chunked form (``ssm._ssd_chunked``) against the sequential one
    (``ssm.ssd_reference``) on the same seeded fp32 inputs, drawn as the
    JAX test draws them, and both against an fp64 recurrence; the same
    chunked call on the CPU beside it.  Gates: chunked against sequential
    within the JAX test's 1e-4 taken relative to the largest |y| (the
    JAX test's outputs stay near 20, these reach about 200, and fp32
    rounds relative to the value), and the card's chunked output no
    further from fp64 than twice the CPU's: a reduction the card sums
    another way, as the plain polar retraction's long products did,
    would show here."""
    import numpy as np
    import torch
    from repro_torch.models import ssm

    b, s, h, p, n = SSD_SHAPE
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32)
    b_ = rng.standard_normal((b, s, h, n), dtype=np.float32)
    c_ = rng.standard_normal((b, s, h, n), dtype=np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0).astype(np.float32)
    la = (-dt * np.exp(0.5 * rng.standard_normal((b, s, h)))).astype(
        np.float32)
    host = [torch.from_numpy(a) for a in (x, b_, c_, dt, la)]
    card = [a.to("cuda") for a in host]
    y, hfin = ssm._ssd_chunked(*card, SSD_CHUNK)
    chunked_ms = time_ms(lambda: ssm._ssd_chunked(*card, SSD_CHUNK), reps=5,
                         warmup=1)
    y0, h0 = ssm.ssd_reference(*card)
    seq_ms = time_ms(lambda: ssm.ssd_reference(*card), reps=3, warmup=1)
    y64, h64 = _ssd_fp64(*card)
    y_cpu, _ = ssm._ssd_chunked(*host, SSD_CHUNK)
    y, y0, hfin, h0 = (t.cpu() for t in (y, y0, hfin, h0))
    y64, h64 = y64.cpu(), h64.cpu()
    scale = float(y0.abs().max())
    gap = float((y - y0).abs().max())
    hgap = float((hfin - h0).abs().max())
    card64 = float((y.double() - y64).abs().max())
    cpu64 = float((y_cpu.double() - y64).abs().max())
    seq64 = float((y0.double() - y64).abs().max())
    card_cpu = float((y - y_cpu).abs().max())
    held = "held" if gap <= SSD_ATOL else "not held"
    log(f"  SSD (B, S, H, N, P) = {SSD_SHAPE}, chunk {SSD_CHUNK} (S padded "
        f"to {-(-s // SSD_CHUNK) * SSD_CHUNK}), fp32: chunked vs sequential "
        f"on the card max_abs_err={gap:.3e} (max |y| {scale:.3f}; gate "
        f"{SSD_ATOL:.0e} x max |y| = {SSD_ATOL * scale:.3e}; the JAX test's "
        f"absolute {SSD_ATOL:.0e} {held}), "
        f"final state {hgap:.3e}; vs fp64: chunked card {card64:.3e}, "
        f"chunked CPU {cpu64:.3e}, sequential card {seq64:.3e}; card vs "
        f"CPU chunked {card_cpu:.3e}; chunked {chunked_ms:.3f} ms, "
        f"sequential {seq_ms:.3f} ms (CUDA events)")
    if not (gap <= SSD_ATOL * scale and hgap <= SSD_ATOL * float(
            h0.abs().max()) and card64 <= 2.0 * cpu64):
        raise AssertionError(f"SSD on the card: chunked vs sequential "
                             f"{gap:.3e}, state {hgap:.3e}, vs fp64 card "
                             f"{card64:.3e} CPU {cpu64:.3e}")


# the mLSTM at xlstm-1.3b's full width: B, S (4 chunks of 256, the last
# padded), H, dk; the CPU's recurrence over the first chunk only (50 s of
# host time over all of S)
MLSTM_SHAPE, MLSTM_CHUNK = (2, 1000, 4, 1024), 256


def mlstm_phase() -> None:
    """The mLSTM cell (plain PyTorch, as it is plain ``jnp`` in the JAX
    package) at xlstm-1.3b's full width, TF32 off: the chunked form
    (``xlstm._mlstm_chunked``) and the recurrence a decode step runs
    (``xlstm.mlstm_reference``) on the same seeded fp32 inputs (drawn as
    the JAX test draws them, k scaled by dk^-1/2 as the model scales it)
    on the card and on the CPU, each against the recurrence in float64
    on the card: over all of S the card's two forms and the CPU's chunked
    form, over the first chunk (MLSTM_CHUNK positions, where every form
    reads the same inputs) all four, the CPU's recurrence among them.
    Reports every gap and the largest |y|, and times both forms on the
    card: no gate, as the chunked form is the JAX package's (its own test
    allows 2e-3 between the two); only a non-finite output fails."""
    import numpy as np
    import torch
    from repro_torch.models import xlstm

    b, s, h, dk = MLSTM_SHAPE
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((b, s, h, dk), dtype=np.float32)
               for _ in range(3))
    k = (k * dk ** -0.5).astype(np.float32)
    li = (2.0 * rng.standard_normal((b, s, h))).astype(np.float32)
    lf = (-np.logaddexp(0.0, -(rng.standard_normal((b, s, h)) + 2.0))
          ).astype(np.float32)
    host = [torch.from_numpy(a) for a in (q, k, v, li, lf)]
    card = [a.to("cuda") for a in host]
    y = xlstm._mlstm_chunked(*card, MLSTM_CHUNK)[0]
    chunked_ms = time_ms(lambda: xlstm._mlstm_chunked(*card, MLSTM_CHUNK),
                         reps=5, warmup=1)
    y0 = xlstm.mlstm_reference(*card)[0]
    seq_ms = time_ms(lambda: xlstm.mlstm_reference(*card), reps=2, warmup=1)
    y64 = xlstm.mlstm_reference(*(a.double() for a in card))[0].cpu()
    y, y0 = y.cpu(), y0.cpu()
    t0 = time.perf_counter()
    y_cpu = xlstm._mlstm_chunked(*host, MLSTM_CHUNK)[0]
    cpu_chunked_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    y0_cpu = xlstm.mlstm_reference(*(a[:, :MLSTM_CHUNK] for a in host))[0]
    cpu_seq_s = time.perf_counter() - t0
    outs = {"chunked card": y, "recurrence card": y0, "chunked CPU": y_cpu}
    if not all(bool(torch.isfinite(t).all())
               for t in (*outs.values(), y0_cpu, y64)):
        raise AssertionError("mLSTM at full width: a non-finite output")
    gaps = {name: float((t.double() - y64).abs().max())
            for name, t in outs.items()}
    first = dict(outs, **{"recurrence CPU": y0_cpu})
    head = {name: float((t[:, :MLSTM_CHUNK].double()
                         - y64[:, :MLSTM_CHUNK]).abs().max())
            for name, t in first.items()}
    log(f"  mLSTM (B, S, H, dk) = {MLSTM_SHAPE}, chunk {MLSTM_CHUNK} (S "
        f"padded to {-(-s // MLSTM_CHUNK) * MLSTM_CHUNK}), fp32: max |y| "
        f"{float(y64.abs().max()):.3f}; chunked vs recurrence on the card "
        f"{float((y - y0).abs().max()):.3e}; card vs CPU chunked "
        f"{float((y - y_cpu).abs().max()):.3e}; vs float64, all of S: "
        + ", ".join(f"{n} {g:.3e}" for n, g in gaps.items())
        + f"; the first {MLSTM_CHUNK} positions (max |y| "
        f"{float(y64[:, :MLSTM_CHUNK].abs().max()):.3f}): "
        + ", ".join(f"{n} {g:.3e}" for n, g in head.items())
        + f"; on the card chunked {chunked_ms:.3f} ms, recurrence "
        f"{seq_ms:.3f} ms (CUDA events); on the CPU chunked "
        f"{cpu_chunked_s:.2f} s, recurrence over {MLSTM_CHUNK} positions "
        f"{cpu_seq_s:.2f} s (reported, not gated)")


# the replica sync: smollm-135m at its published widths, REPLICAS copies,
# perturbed by REPLICA_NOISE, then REPLICA_ROUNDS EF-int8 rounds of k = 2
REPLICAS, REPLICA_NOISE, REPLICA_ROUNDS = 4, 0.02, 4


def replica_phase() -> dict:
    """``serve.ReplicaGroup`` on the card: REPLICAS replicas of
    smollm-135m at its published widths (random weights from seed 0),
    ``perturb(REPLICA_NOISE)``, then ``sync(rounds=REPLICA_ROUNDS)`` with
    the launch counts set to 0 just before it, each round timed
    (synchronized).  Checks, the JAX test's own bounds: the drift does not
    rise round to round and ends under 0.2 x the drift after the
    perturbation; the wire bytes under half the raw ones; launches exactly
    ``quant_mix`` one per ``leaves.MAX_LEAVES`` leaves a round (the fused
    first hop of the tree) and ``multi_hop_mix_quant`` as many (the one
    int8 tail hop), no other kernel.  Then replica 0 serves 3 requests
    through the paged engine.  Returns the sync's launch counts."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import leaves, ops
    from repro_torch.launch.serve import paged_spec
    from repro_torch.serve import (ContinuousBatchingScheduler, ReplicaGroup,
                                   Request, ServeEngine, serve_requests)
    from repro_torch.tree import tree_leaves

    cfg = configs.get_config("smollm-135m")
    params = _init_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    group = ReplicaGroup(params, REPLICAS, seed=0)
    del params
    d0 = group.perturb(REPLICA_NOISE)
    per_round = -(-len(tree_leaves(group.params)) // leaves.MAX_LEAVES)
    want = {"quant_mix": per_round * REPLICA_ROUNDS,
            "multi_hop_mix_quant": per_round * REPLICA_ROUNDS}
    ops.reset_launch_counts()
    trace, walls = [], []
    for _ in range(REPLICA_ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trace += group.sync(rounds=1)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    counts = ops.launch_counts()
    wire = group.wire_stats()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  ReplicaGroup: {REPLICAS} replicas of {cfg.name} "
        f"({len(tree_leaves(group.params))} leaves), perturb "
        f"{REPLICA_NOISE}: drift {d0:.6f}; sync {REPLICA_ROUNDS} rounds of "
        f"k = {group.gossip.k} (EF-int8, quant_hops='all'): drift "
        + ", ".join(f"{d:.6f}" for d in trace)
        + f"; {statistics.median(walls):.3f} ms a round (median; drift "
        f"reads included; min {min(walls):.3f}, max {max(walls):.3f}); "
        f"wire {wire['wire_bytes']:.0f} of raw {wire['raw_bytes']:.0f} "
        f"bytes ({wire['wire_bytes'] / wire['raw_bytes']:.4f}); peak "
        f"{peak:.2f} GiB; launches {counts}")
    if not (all(b <= a * (1 + 1e-6) for a, b in zip(trace, trace[1:]))
            and trace[-1] < 0.2 * d0
            and wire["wire_bytes"] < 0.5 * wire["raw_bytes"]
            and wire["rounds"] == REPLICA_ROUNDS):
        raise AssertionError(f"replica sync: drift {d0} -> {trace}, wire "
                             f"{wire}")
    got = {k: counts[k] for k in want}
    others = {k: c for k, c in counts.items() if k not in want and c}
    if got != want or others:
        raise AssertionError(f"replica sync launches {counts}, want {want}")
    spec = paged_spec(2, PROMPT_LENGTHS[1] + 8, PAGE_SIZE)
    engine = ServeEngine(cfg, group.replica(0), kv_spec=spec, n_slots=2,
                         temperature=0.0)
    fin = serve_requests(engine, ContinuousBatchingScheduler(2, spec),
                         [Request(prompt=p, max_new_tokens=8)
                          for p in _serve_prompts(cfg)[:3]])
    if len(fin) != 3 or any(len(r.tokens) != 8 for r in fin):
        raise AssertionError(f"replica 0 served {len(fin)} requests")
    log(f"  replica 0 through the paged engine: 3 requests x 8 tokens, "
        f"{engine.steps_run} decode waves; tokens {fin[0].tokens}")
    del group, engine
    torch.cuda.empty_cache()
    return dict(counts)


def contracts_phase() -> None:
    """``analysis.contracts.run`` on the card: every W_t of the channel
    sweep (4 topologies x 3 schedules x 4 fault settings, 20 rounds) and
    of the elastic sweep (3 churn schedules x 2 fault settings, 100
    rounds) symmetric doubly stochastic with departed rows identity, and
    every retraction of every registered geometry (``"polar_fused"``
    through its kernel) on its manifold: no findings."""
    from repro_torch.analysis import contracts

    t0 = time.perf_counter()
    findings = contracts.run(device="cuda")
    log(f"  contracts.run(device='cuda'): {len(findings)} findings in "
        f"{time.perf_counter() - t0:.1f} s")
    if findings:
        raise AssertionError("contracts: " + "; ".join(
            str(f) for f in findings[:5]))


def analysis_phase() -> None:
    """The analysis CLI on the card (``python -m repro_torch.analysis``,
    in process: every pass, the attention tile plans and the Hopper
    budgets included) must exit 0 with no finding, and ``--selftest`` must
    see every fixture fire; then the attention forward's plans by route
    (``kernel_check.attention_plans``), and each
    kernel's resources over the launch configurations of the budget pass
    (``kernel_check.budget_records``): registers a thread, shared memory a
    block and resident blocks (clusters, for a cluster launch) at the
    least and most of its cases."""
    import contextlib
    import io

    from repro_torch.analysis import kernel_check
    from repro_torch.analysis.__main__ import main as analysis_main

    for argv in ([], ["--selftest"]):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            code = analysis_main(argv)
        text = out.getvalue().strip().replace("\n", " | ")
        log(f"  python -m repro_torch.analysis {' '.join(argv)}: exit "
            f"{code} in {time.perf_counter() - t0:.1f} s: {text}")
        if code != 0:
            raise AssertionError(f"analysis CLI {argv}: exit {code}")
    limit = kernel_check.smem_limit()
    plans = kernel_check.attention_plans()
    for route in dict.fromkeys(p["route"] for p in plans):
        ps = [p for p in plans if p["route"] == route]
        log(f"  attention plans, {route}: {len(ps)} cases (ragged S, "
            f"head dims {sorted({p['case'].split()[1] for p in ps})}), "
            f"query rows a block {min(p['rows'] for p in ps)}-"
            f"{max(p['rows'] for p in ps)}, "
            f"{'key rows' if route == 'simt' else 'warps across the keys'} "
            f"{min(p['split'] for p in ps)}-{max(p['split'] for p in ps)}, "
            f"{max(p['bytes'] for p in ps)} bytes at most")
    records = kernel_check.budget_records()
    log(f"  budget pass: {len(records)} launch configurations, shared "
        f"memory limit {limit} bytes a block (the card's opt-in)")
    for kernel in dict.fromkeys(r["kernel"] for r in records):
        rs = [r for r in records if r["kernel"] == kernel]
        smem = [r["static_smem"] + r["dyn_smem"] for r in rs]
        most = max(rs, key=lambda r: r["regs"])
        log(f"    {kernel:20s} {len(rs):3d} cases: registers a thread "
            f"{min(r['regs'] for r in rs)}-{most['regs']} (most at "
            f"{most['case']}, {most['threads']} threads), local bytes a "
            f"thread <= {max(r['local_bytes'] for r in rs)}, shared memory "
            f"{min(smem)}-{max(smem)} bytes, resident "
            f"{min(r['resident'] for r in rs)}-"
            f"{max(r['resident'] for r in rs)} (blocks an SM; clusters the "
            f"card where the cluster > 1: "
            f"{sorted({r['cluster'] for r in rs})})")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    t_start = time.perf_counter()

    def phase(title: str) -> None:
        log(f"{title} (at {time.perf_counter() - t_start:.0f} s)")

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32: torch.backends.cuda.matmul.allow_tf32=False, "
        "torch.backends.cudnn.allow_tf32=False")

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    per = build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s wall "
        f"({', '.join(f'{n} {s:.1f} s' for n, s in per.items())})")

    phase("kernel phase:")
    rows = kernel_phase()
    rows.update(attention_kernel_phase())
    rows.update(attention_backward_phase())
    phase("SSD at zamba2-2.7b's width:")
    ssd_phase()
    phase("mLSTM at xlstm-1.3b's width:")
    mlstm_phase()
    phase("geometries:")
    geometry_phase()
    phase("numerical contracts:")
    contracts_phase()
    phase("analysis CLI and the kernels' Hopper budgets:")
    analysis_phase()
    phase("main path:")
    paths = main_path_phase()
    phase("figures:")
    paths["figures"] = figures_phase()
    phase("robust PCA:")
    paths["robust_pca"] = robust_pca_phase()
    phase("DRO:")
    paths["dro"] = dro_phase()
    phase("elastic:")
    paths["elastic"] = elastic_phase()
    phase("obs:")
    paths["obs"] = obs_phase(rows)
    phase("profile:")
    from repro_torch.launch.fair import COMM_PRESETS
    int8 = COMM_PRESETS["int8_ef"]
    # the main paths at 28x28, then every method of Figs. 1-2 as the
    # figures phase runs it (14x14, "polar")
    profile_phase({
        "full k=1": StepConfig("drgda", True),
        "EF-int8 k=1": StepConfig("drgda", True, int8),
        f"full k={K_THEOREM1}": StepConfig("drgda", True, k=K_THEOREM1),
        f"EF-int8 all k={K_THEOREM1}": StepConfig(
            "drgda", True, dataclasses.replace(int8, quant_hops="all"),
            K_THEOREM1),
        "gt-gda k=1": StepConfig("gt-gda", True),
        "dm-hsgd k=1": StepConfig("dm-hsgd", False),
        **{f"figures {name}": StepConfig(name, name in ("drgda", "gt-gda"),
                                         image_hw=14, retraction="polar")
           for name in ("drgda", "gt-gda", "drsgda", "gnsd-a", "dm-hsgd",
                        "gt-srvr")},
        "robust PCA example": StepConfig("drgda", True,
                                         setup=_robust_pca_setup("example")),
        "robust PCA full width": StepConfig("drgda", True,
                                            setup=_robust_pca_setup("full")),
        "DRO drsgda": StepConfig("drsgda", False, setup=_dro_setup),
        "elastic leave_rejoin k=1": StepConfig("drgda", True,
                                               setup=_elastic_setup)})
    phase("agreement:")
    agreement_phase()
    # after the profile phase: its walls come before any profiler session
    phase("serving path:")
    paths["serving"] = serve_phase()
    phase("served configurations at their published widths:")
    paths.update(serve_models_phase())
    serve_agreement_phase()
    phase("replica sync:")
    paths["replica"] = replica_phase()
    # last: its full-width states take half the card's memory
    phase("LM training:")
    paths["train"], paths["train_polar_fused"] = train_phase()
    phase("LM training, the other configurations:")
    paths.update(train_models_phase())

    # each kernel's launches come from the path it belongs to; every path's
    # counts stand beside them
    home = {name: "full" if name in FULL_PATH else
            "int8" if name in INT8_PATH else
            "train" if name in TRAIN_PATH else "serving"
            for name in KERNEL_META}
    table = []
    # fused_retract has four rows: its cluster routes (r <= 256, the fair
    # main path), its global route (r > 256: smollm-135m's wq / wo under
    # "polar_fused", whose step's launches of that route it reports) and
    # xlstm-1.3b's leaves on that route (the launches of its cut's
    # "polar_fused" step)
    variants = [(name, name, home[name], name, None) for name in KERNEL_META]
    variants[1] = ("fused_retract", "fused_retract", "full", "fused_retract",
                   "cluster routes (r <= 256)")
    xlstm_path = "train xlstm-1.3b polar_fused"
    variants[2:2] = [
        ("fused_retract", "fused_retract_global", "train_polar_fused",
         "fused_retract_global", "global route (r > 256)"),
        *(("fused_retract", f"fused_retract {shape}", xlstm_path,
           "fused_retract_global", f"global route, xlstm-1.3b {shape}")
          for shape in ((TRAIN_MODELS_NODES, 4096, 4096),
                        (TRAIN_MODELS_NODES, 4096, 2048)))]
    for name, key, path, count, variant in variants:
        source, replaces = KERNEL_META[name]
        row = rows[key]
        extra = {"variant": variant} if variant else {}
        table.append({"name": name, **extra, "route": "cuda",
                      "source": source, "replaces": replaces,
                      "launches": paths[path][count],
                      "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                      "plain_ms": row["plain_ms"],
                      "bound_ms": row["bound_ms"],
                      "bound_by": row["bound_by"],
                      "library_ms": row["library_ms"],
                      "device_ms": row["device_ms"],
                      "library_device_ms": row["library_device_ms"],
                      "chain_ms": row["chain_ms"],
                      "chain_device_ms": row["chain_device_ms"],
                      "path_launches": {p: counts.get(count, 0)
                                        for p, counts in paths.items()}})
    phase("kernel table:")
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
