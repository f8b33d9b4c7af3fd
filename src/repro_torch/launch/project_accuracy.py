"""How tangent the streaming route of ``csrc/stiefel_project.cu`` leaves
its output, under variants of the tensor-core accumulation of
``csrc/tall.cuh``, and what each does to the recorded LM run's Stiefel
residual; prints the card and one JSON line.

    python -m repro_torch.launch.project_accuracy

A tangent direction u at x has sym(x^T u) = 0, and the polar retraction
keeps whatever part of it is not: the error of the projection's Gram
S = sym(x^T g) is what a step adds to ``|| x^T x - I ||``.  Variants (each
a copy of the sources with exact text replaced, compiled with the flags of
``kernels/build.py`` into ``build/kernels/variants/``, all at once, and
called through the port's wrapper with its library handle swapped):

  * ``shipped``: the sources as they are: each k = 8 step's three TF32
    products summed in a partial of their own, added to the running sum
    with fp32 adds (``mma_tile``);
  * ``accumulated in the mma``: every product accumulated by the tensor
    cores over the whole reduction (the design before);
  * ``accumulated in the mma, lo lo``: the same with a fourth TF32
    product, lo x lo, in every step.

For each variant and each streaming leaf of the full-width trainer ((8,
576, 576) and (8, 576, 192)), with x orthonormal to fp64 accuracy and g
the consensus direction x + 1e-3 noise or a random gradient: the largest
``|| sym(x^T P(g)) ||_F`` over the nodes and the error against the fp64
projection relative to its largest entry, both reckoned in fp64, beside
the plain version's on the card (cuBLAS fp32) and on the CPU; the device
time of a call; and the recorded run's residual at its evaluation steps
(``launch/lm_residual.py``'s ``card`` variant).
"""
from __future__ import annotations

import json
import re
import shutil
import subprocess

import torch

from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import stiefel_project as _sp
from repro_torch.launch.kernel_variants import (_configure_project, _load,
                                                device_us)
from repro_torch.launch.lm_residual import run_variant
from repro_torch.launch.train import load_reference

SHAPES = [(8, 576, 576), (8, 576, 192)]

_PASSES = [(f"      tcore::mma_tf32(part[mt][nt], {a}[mt], {b}[nt][0], "
            f"{b}[nt][1]);\n",
            f"      tcore::mma_tf32(acc[mt][nt], {a}[mt], {b}[nt][0], "
            f"{b}[nt][1]);\n")
           for a, b in (("al", "bh"), ("ah", "bl"), ("ah", "bh"))]
# the partial and its adds taken out: every product accumulated in the mma
_IN_MMA = [("  float part[2][4][4] = {};\n", ""), *_PASSES,
           ("#pragma unroll\n  for (int mt = 0; mt < 2; ++mt)\n#pragma unroll\n"
            "    for (int nt = 0; nt < 4; ++nt)\n#pragma unroll\n"
            "      for (int q = 0; q < 4; ++q) acc[mt][nt][q] += "
            "part[mt][nt][q];\n", "")]
# a fourth product, lo x lo, first
_LOLO = ("      tcore::mma_tf32(acc[mt][nt], al[mt], bh[nt][0], bh[nt][1]);\n",
         "      tcore::mma_tf32(acc[mt][nt], al[mt], bl[nt][0], bl[nt][1]);\n"
         "#pragma unroll\n  for (int mt = 0; mt < 2; ++mt)\n#pragma unroll\n"
         "    for (int nt = 0; nt < 4; ++nt)\n"
         "      tcore::mma_tf32(acc[mt][nt], al[mt], bh[nt][0], bh[nt][1]);\n")

VARIANTS = {
    "shipped": [],
    "accumulated in the mma": _IN_MMA,
    "accumulated in the mma, lo lo": _IN_MMA + [_LOLO],
}


def _compile(name: str, edits: list[tuple[str, str]]):
    """Start nvcc on a copy of stiefel_project.cu and its headers with
    ``edits`` made to tall.cuh in turn (each old text must occur once)."""
    out = build.BUILD_DIR / "variants" / ("accuracy_"
                                          + re.sub(r"\W+", "_", name))
    out.mkdir(parents=True, exist_ok=True)
    for header in build.CSRC.glob("*.cuh"):
        shutil.copy(header, out)
    shutil.copy(build.CSRC / "stiefel_project.cu", out)
    text = (out / "tall.cuh").read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} occurs {text.count(old)} "
                               f"times")
        text = text.replace(old, new)
    (out / "tall.cuh").write_text(text)
    lib = out / "lib.so"
    proc = subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
         str(out / "stiefel_project.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, lib


def _measure(out: torch.Tensor, x64: torch.Tensor, want64: torch.Tensor):
    o = out.double().to(x64.device)
    xtu = x64.transpose(-1, -2) @ o
    tang = float(torch.linalg.matrix_norm(0.5 * (xtu + xtu.transpose(-1, -2))
                                          ).max())
    err = float((o - want64).abs().max() / want64.abs().max())
    return {"tangency": tang, "rel_err": err}


def main() -> int:
    procs = {name: _compile(name, edits) for name, edits in VARIANTS.items()}
    libs = {}
    out: dict = {"leaves": {}, "run": {}, "build_errors": {}}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:     # recorded, not hidden
            out["build_errors"][name] = log[-2000:]
            continue
        libs[name] = _load(lib)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = "cuda"
    gen = torch.Generator(device="cpu").manual_seed(0)
    cases = []
    for shape in SHAPES:
        x64 = torch.linalg.qr(torch.randn(shape, generator=gen,
                                          dtype=torch.float64))[0]
        x = x64.float()
        x64 = x.double()          # the fp32 point, exactly
        for kind, g in (("consensus", x + 1e-3 * torch.randn(
                            shape, generator=gen)),
                        ("gradient", torch.randn(shape, generator=gen))):
            want = ref.stiefel_project_ref(x64, g.double())
            cases.append((f"{shape} {kind}", x, g, x64, want))
    for label, x, g, x64, want in cases:
        out["leaves"][label] = {
            "plain card": _measure(ref.stiefel_project_ref(
                x.to(dev), g.to(dev)).cpu(), x64, want),
            "plain cpu": _measure(ref.stiefel_project_ref(x, g), x64, want)}
    reference = load_reference()
    real = _sp._lib
    try:
        for name, lib in libs.items():
            _sp._lib = lambda lib=lib: _configure_project(lib)
            _sp.cluster_size.cache_clear()
            for label, x, g, x64, want in cases:
                xd, gd = x.to(dev), g.to(dev)

                def call(xd=xd, gd=gd):
                    return ops.stiefel_project_leaves([xd], [gd])

                got = _measure(call()[0].cpu(), x64, want)
                got["device_us"] = device_us(call, "")
                out["leaves"][label][name] = got
            run = run_variant(reference, "card", dev)
            out["run"][name] = {
                "evals": {e["step"]: e["stiefel_residual"]
                          for e in run["evals"]},
                "trace_fp64": [t["cpu_fp64"] for t in run["trace"]],
                "final_loss": run["final_loss"]}
    finally:
        _sp._lib = real
        _sp.cluster_size.cache_clear()
    out["reference_evals"] = {e["step"]: e["stiefel_residual"]
                              for e in reference["evals"]}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
