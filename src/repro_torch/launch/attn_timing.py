"""Device time of the attention kernels per call on one card, from
``torch.profiler``, at smollm-135m's serving shapes and at stress shapes;
prints the card and one JSON line.

    python -m repro_torch.launch.attn_timing

Cases (H=9 query heads over Hkv=3 kv heads, hd=64, unless named):
``flash_attention`` at the S=256 prefill, at one block of 16 query rows
(S=16 over T=256, H=1: the latency of one block), at 32 prefills batched
(B=32: the card full), and causal at S=T=4096, each in fp32 and bf16 and
beside one ``scaled_dot_product_attention`` call with the same mask;
``paged_decode_attention`` at the engine's 4-slot decode wave (seq_lens
288, 37, 0, 161 over 16-token pages) and at 64 slots of 2048 tokens.  A
case's ``*_device_us`` is the ``self_device_time_total`` of the CUDA
events under the profiler over its calls, per call; so host work between
calls is not in it.  The script calls only the public wrappers in
``kernels/ops.py``, so it also times an older checkout of the port:

    PYTHONPATH=<checkout>/src python src/repro_torch/launch/attn_timing.py

Compare two versions only within one call on one card, in turns.
"""
from __future__ import annotations

import json
import subprocess

import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels import ops

H, HKV, HD, PS = 9, 3, 64, 16


def device_us(fn, calls: int = 20, warmup: int = 3) -> float:
    """Device microseconds per call of ``fn`` under the profiler."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / calls


def flash_case(gen, dtype, b, s, t, h):
    q = torch.randn((b, s, h, HD), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((b, t, max(1, h // 3), HD), generator=gen,
                        device="cuda").to(dtype) for _ in range(2))
    qpos = torch.arange(t - s, t, dtype=torch.int32,
                        device="cuda").expand(b, s)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    kw = {"is_causal": True} if s == t else {
        "attn_mask": (torch.arange(t, device="cuda")[None, :]
                      <= qpos[0][:, None])[None, None]}
    return (device_us(lambda: ops.flash_attention(q, k, v,
                                                  q_positions=qpos)),
            device_us(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, enable_gqa=True, **kw)))


def paged_case(gen, dtype, seq, m):
    n_pages = len(seq) * m + 1
    q = torch.randn((len(seq), H, HD), generator=gen,
                    device="cuda").to(dtype)
    kp, vp = (torch.randn((n_pages, PS, HKV, HD), generator=gen,
                          device="cuda").to(dtype) for _ in range(2))
    bt = torch.full((len(seq), m), -1, dtype=torch.int32)
    used = 1
    for i, sl in enumerate(seq):
        n = -(-sl // PS)
        bt[i, :n] = torch.arange(used, used + n)
        used += n
    bt = bt.cuda()
    sl = torch.tensor(seq, dtype=torch.int32, device="cuda")
    return device_us(lambda: ops.paged_decode_attention(q, kp, vp, bt, sl))


def main() -> None:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        for name, (b, s, t, h) in (("prefill", (1, 256, 256, H)),
                                   ("one_block", (1, 16, 256, 1)),
                                   ("prefill_b32", (32, 256, 256, H)),
                                   ("causal_4096", (1, 4096, 4096, H))):
            kern, sdpa = flash_case(gen, dtype, b, s, t, h)
            res[f"flash_{name}_{tag}_device_us"] = kern
            res[f"sdpa_{name}_{tag}_device_us"] = sdpa
        res[f"paged_wave_{tag}_device_us"] = paged_case(
            gen, dtype, [288, 37, 0, 161], 18)
        res[f"paged_64x2048_{tag}_device_us"] = paged_case(
            gen, dtype, [2048] * 64, 128)
    print(card)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
