"""Paper Fig. 1 (DRGDA and GT-GDA, full local datasets, 120 steps) on one
card under three cuDNN settings, twice each, every curve point held against
the JAX package's curves; prints the card and one line per run.

    python -m repro_torch.launch.figure_cudnn

The settings: PyTorch's defaults (cuDNN picks its algorithms by heuristics;
its weight-gradient algorithms may sum with atomics, in another order on
every run), ``torch.backends.cudnn.deterministic`` (deterministic
algorithms only), and cuDNN off (PyTorch's own convolutions).  Each line
gives, per quantity, the gap at every curve point (relative, as
:func:`repro_torch.launch.fair.compare_to_reference` counts it), so that a
run-to-run spread under one setting shows beside the spread between
settings.  The runs start from the file's initial weights at its settings
(20-node ring, 14x14 images, seed 0, ``"polar"``).
"""
from __future__ import annotations

import subprocess

import torch

from repro_torch.launch.fair import (REFERENCE, _gap, load_reference,
                                     run_method)

SETTINGS = {"default": {"deterministic": False, "enabled": True},
            "deterministic": {"deterministic": True, "enabled": True},
            "cudnn off": {"deterministic": False, "enabled": False}}
KEYS = ("loss", "M_t", "consensus_x")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("figure_cudnn needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    ref = load_reference(REFERENCE)
    s = ref["settings"]
    want = {r["method"]: r for r in ref["figures"]["figure1_deterministic"]}
    for label, setting in SETTINGS.items():
        torch.backends.cudnn.deterministic = setting["deterministic"]
        torch.backends.cudnn.enabled = setting["enabled"]
        for attempt in (1, 2):
            for name, ref_run in want.items():
                res = run_method(name, s["steps_det"], True, seed=s["seed"],
                                 eval_every=s["eval_every"],
                                 image_hw=s["image_hw"],
                                 n_nodes=s["n_nodes"], retraction="polar",
                                 device="cuda", params=ref["init_params"])
                pairs = list(zip(res["curve"], ref_run["curve"]))
                print(f"{label:13s} run {attempt} {name:6s} " + "  ".join(
                    f"{key}: " + " ".join(
                        f"{b['step']}:{_gap(a, b, key):.1e}"
                        for a, b in pairs) for key in KEYS), flush=True)


if __name__ == "__main__":
    main()
