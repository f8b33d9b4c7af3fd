"""Time design alternatives of three kernels on one card: ``csrc/retract.cu``
under other cluster and tile shapes of its (r, r) stage,
``csrc/stiefel_project.cu`` under another cluster size of its on-chip
route and other cluster sizes of the tensor-core Gram (``tall.cuh``) of its
streaming route, and ``csrc/multi_hop_mix_quant.cu`` with every
requantization an IEEE division; prints the card and one JSON line.

    python -m repro_torch.launch.kernel_variants

Each variant is a copy of the source with one line replaced (the ``using
CfgNN = Cfg<...>`` line, the ``kMinCluster`` or ``kGramBlocks`` constant,
or the test that sends a quotient near a half-integer to the division),
compiled with the same ``nvcc`` flags as
``kernels/build.py`` into ``build/kernels/variants/`` (all at once), and
called through the port's own wrappers, whose library handle is swapped
for the variant's.  For each variant and shape: the max abs error against
the plain version (retract; relative for the projection) or bitwise
equality (int8 hops), and the device time of the variant's kernels per
call under ``torch.profiler`` (``self_device_time_total`` of the CUDA
events): the (r, r) stage alone for retract (``finalize``), the whole
call for the projection and the int8 hops.  The
shipped configuration is the variant named ``shipped`` of each group.
Besides (``tail``): the shipped on-chip projection of the step's fc1 leaf
alone, its head leaf alone and both in one launch, in ``ROUNDS`` turns:
what the head's clusters add beside fc1's.  Compare variants only within
one call on one card.
"""
from __future__ import annotations

import ctypes
import json
import re
import shutil
import statistics
import subprocess

import torch

from repro_torch.kernels import build, ops, ref

N_NODES = 20
HOPS = 66        # the EF-int8 k = 67 step's tail
# group -> (source, the line pattern, {variant: replacement line}); the
# first variant of a group is the shipped configuration
RETRACT = {
    "r<=64": (r"using Cfg64 = Cfg<[^>]*>;", {
        "shipped": None,
        "4 CTAs, 1x4": "using Cfg64 = Cfg<4, 16, 1, 4, true>;",
        "4 CTAs, 4x4": "using Cfg64 = Cfg<4, 16, 4, 4, true>;",
        "2 CTAs, 4x4": "using Cfg64 = Cfg<2, 32, 4, 4, true>;",
        "8 CTAs, 2x4": "using Cfg64 = Cfg<8, 8, 2, 4, true>;",
        "8 CTAs, 1x4": "using Cfg64 = Cfg<8, 8, 1, 4, true>;"}),
    "r<=128": (r"using Cfg128 = Cfg<[^>]*>;", {
        "shipped": None,
        "2x4": "using Cfg128 = Cfg<8, 16, 2, 4, false>;"}),
    "r<=256": (r"using Cfg256 = Cfg<[^>]*>;", {
        "shipped": None,
        "4x8": "using Cfg256 = Cfg<8, 32, 4, 8, false>;"}),
}
RETRACT_SHAPES = {"r<=64": [(N_NODES, 784, 64), (N_NODES, 1000, 37)],
                  "r<=128": [(N_NODES, 4096, 99), (N_NODES, 4096, 128)],
                  "r<=256": [(N_NODES, 4096, 256)]}
# stiefel_project: group -> (file the line is in, pattern, variants)
PROJECT = {
    "on chip": ("stiefel_project.cu", r"constexpr int kMinCluster = \d+;", {
        "shipped": None,
        "8 CTAs": "constexpr int kMinCluster = 8;"}),
    "streaming": ("tall.cuh", r"constexpr int kGramBlocks = \d+;", {
        "shipped": None,
        "Gram clusters to 264 blocks": "constexpr int kGramBlocks = 264;",
        "Gram clusters to 132 blocks": "constexpr int kGramBlocks = 132;"}),
}
PROJECT_TREES = {"on chip": [[(N_NODES, 784, 64), (N_NODES, 64, 3)],
                             [(N_NODES, 1000, 37)]],
                 "streaming": [[(N_NODES, 4096, 256)], [(N_NODES, 4096, 99)]]}
# the on-chip projection of the step's leaves alone and in one launch: what
# the head's clusters cost beside fc1's (one CTA an SM at fc1's shared
# memory)
TAIL_TREES = {"fc1": [(N_NODES, 784, 64)], "head": [(N_NODES, 64, 3)],
              "fc1 + head": [(N_NODES, 784, 64), (N_NODES, 64, 3)]}
ROUNDS = 10      # interleaved repeats of the tail readings
QUANT = (r"near = fabsf\(0\.5f - fabsf\(y - k\)\) < 1e-4f;",
         {"shipped": None, "ieee division": "near = true;"})
QUANT_TREES = {"x tree": [72, 1152, 50176, 192], "y": [3]}


def _compile(name: str, source: str, pattern: str, line: str | None,
             patched: str | None = None):
    """Start nvcc on a copy of ``source`` (and its headers) with
    ``pattern`` replaced by ``line`` in ``patched`` (by default the
    source; the files as they are for None); returns (process, library)."""
    out = build.BUILD_DIR / "variants" / re.sub(r"\W+", "_", name)
    out.mkdir(parents=True, exist_ok=True)
    for header in build.CSRC.glob("*.cuh"):
        shutil.copy(header, out)
    shutil.copy(build.CSRC / source, out)
    target = out / (patched or source)
    text = target.read_text()
    if line is not None:
        text, count = re.subn(pattern, line, text)
        if count != 1:
            raise RuntimeError(f"{name}: {pattern!r} matched {count} times")
    target.write_text(text)
    lib = out / "lib.so"
    proc = subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(out / source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, lib


def _load(lib_path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(lib_path))
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def device_us(fn, match: str, calls: int = 10) -> float:
    """Device microseconds per call of ``fn``'s CUDA kernels whose name
    holds ``match``, under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and match in e.key) / calls


def main() -> int:
    from repro_torch.comms.compress import quantize_det
    from repro_torch.kernels import multi_hop_mix as _mh
    from repro_torch.kernels import retract as _rt
    from repro_torch.kernels import stiefel_project as _sp

    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    jobs = {}
    for group, (pattern, variants) in RETRACT.items():
        for v, line in variants.items():
            jobs[("retract", group, v)] = _compile(
                f"retract {group} {v}", "retract.cu", pattern, line)
    for group, (patched, pattern, variants) in PROJECT.items():
        for v, line in variants.items():
            jobs[("project", group, v)] = _compile(
                f"project {group} {v}", "stiefel_project.cu", pattern, line,
                patched)
    for v, line in QUANT[1].items():
        jobs[("quant", "", v)] = _compile(f"quant {v}", "multi_hop_mix_quant.cu",
                                          QUANT[0], line)
    libs = {}
    for key, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log[-3000:]}")
        libs[key] = _load(lib)

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    out: dict = {"retract": {}, "project": {}, "quant": {}}

    def stiefel(shape):
        x = torch.linalg.qr(torch.randn(shape, generator=gen,
                                        device=dev))[0].contiguous()
        return x, 0.5 * x + 0.1 * torch.randn(shape, generator=gen,
                                              device=dev)

    real_rt, real_mh, real_sp = _rt._lib, _mh._quant_lib, _sp._lib
    try:
        for group, trees in PROJECT_TREES.items():
            for shapes in trees:
                xs = [torch.linalg.qr(torch.randn(s, generator=gen,
                                                  device=dev))[0].contiguous()
                      for s in shapes]
                gs = [0.5 * x + 0.1 * torch.randn(x.shape, generator=gen,
                                                  device=dev) for x in xs]
                wants = [ref.stiefel_project_ref(x, g) for x, g in zip(xs, gs)]
                for v in PROJECT[group][2]:
                    lib = libs[("project", group, v)]
                    _sp._lib = lambda lib=lib: _configure_project(lib)
                    _sp.cluster_size.cache_clear()

                    def call():
                        return ops.stiefel_project_leaves(xs, gs)

                    try:
                        err = max(float((a - b).abs().max() / b.abs().max())
                                  for a, b in zip(call(), wants))
                        torch.cuda.synchronize()
                        out["project"][f"{shapes} {v}"] = {
                            "max_rel_err": err,
                            "device_us": device_us(call, "")}
                    except RuntimeError as exc:  # recorded, not hidden
                        out["project"][f"{shapes} {v}"] = {"error": str(exc)}
        _sp._lib = real_sp
        _sp.cluster_size.cache_clear()
        tail = {k: [stiefel(s) for s in v]
                for k, v in TAIL_TREES.items()}
        out["tail"] = {k: [] for k in tail}
        for _ in range(ROUNDS):
            for k, pairs in tail.items():
                out["tail"][k].append(device_us(
                    lambda pairs=pairs: ops.stiefel_project_leaves(
                        [x for x, _ in pairs], [g for _, g in pairs]), ""))
        for key, times in out["tail"].items():
            out["tail"][key] = {"device_us": times,
                                "median_us": statistics.median(times),
                                "min_us": min(times), "max_us": max(times)}
        for group, shapes in RETRACT_SHAPES.items():
            for shape in shapes:
                x = torch.linalg.qr(torch.randn(shape, generator=gen,
                                                device=dev))[0].contiguous()
                g = 0.5 * x + 0.1 * torch.randn(shape, generator=gen,
                                                device=dev)
                want = ref.fused_retract_ref(x, g)
                for v in RETRACT[group][1]:
                    lib = libs[("retract", group, v)]
                    _rt._lib = lambda lib=lib: _rt.configure(lib)
                    err = float((ops.fused_retract(x, g) - want).abs().max())
                    us = device_us(lambda: ops.fused_retract(x, g),
                                   "finalize")
                    out["retract"][f"{shape} {v}"] = {"max_abs_err": err,
                                                      "finalize_us": us}
        for tree, widths in QUANT_TREES.items():
            qs, ss = [], []
            for f in widths:
                q, s = quantize_det(torch.randn((N_NODES, f), generator=gen,
                                                device=dev))
                qs.append(q)
                ss.append(s.reshape(N_NODES, 1))
            wants = [ref.multi_hop_mix_quant_ref(
                ref.ring_panel(q, HOPS), ref.ring_panel(s, HOPS), hops=HOPS,
                w_self=1 / 3, w_side=1 / 3)[HOPS:HOPS + N_NODES]
                for q, s in zip(qs, ss)]
            for v in QUANT[1]:
                lib = libs[("quant", "", v)]
                _mh._quant_lib = lambda lib=lib: _configure_quant(lib)

                def call():
                    return ops.multi_hop_mix_quant_leaves(
                        qs, ss, hops=HOPS, w_self=1 / 3, w_side=1 / 3)

                same = all(torch.equal(a, b) for a, b in zip(call(), wants))
                out["quant"][f"{tree} {v}"] = {
                    "bitwise": same, "device_us": device_us(call, "quant")}
    finally:
        _rt._lib, _mh._quant_lib, _sp._lib = real_rt, real_mh, real_sp
        _sp.cluster_size.cache_clear()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps(out), flush=True)
    return 0


def _configure_project(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_stiefel_project_cluster.argtypes = [i, i]
    lib.repro_stiefel_project_cluster.restype = i
    lib.repro_stiefel_project_leaves.argtypes = [p, p, p, p, p, p, i, p]
    lib.repro_stiefel_project_leaves.restype = i
    lib.repro_stiefel_project_stream.argtypes = [p, p, p, p, i, i, i, p]
    lib.repro_stiefel_project_stream.restype = i
    return lib


def _configure_quant(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_multi_hop_mix_quant.argtypes = [
        p, p, p, p, p, i, p, i, i, ctypes.c_float, ctypes.c_float, i, p]
    lib.repro_multi_hop_mix_quant.restype = ctypes.c_int
    lib.repro_multi_hop_mix_quant_smem.argtypes = [i]
    lib.repro_multi_hop_mix_quant_smem.restype = ctypes.c_longlong
    return lib


if __name__ == "__main__":
    raise SystemExit(main())
