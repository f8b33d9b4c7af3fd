"""Roofline placement of analytical kernel estimates on one GPU.

The port's counterpart of the hardware models and :func:`place` of
``src/repro/launch/roofline.py``: :func:`place` puts any
:class:`~repro_torch.obs.estimates.Estimates` on a hardware model's
roofline, ``min(peak_flops, hbm_bw * intensity)``.  The hardware is
chosen by argument (default ``"h100"``); no environment variable selects
it.

The entries hold the published figures of one H100 SXM (NVIDIA's data
sheet, dense rates, at the full 700 W power limit), the ones
``chip_smoke.py`` bounds its kernels with: 3.35 TB/s of HBM3, and as peak
67 TFLOP/s fp32 on the CUDA cores (``h100``), 165 TFLOP/s for fp32
products as 3xTF32 on the tensor cores (495 / 3, ``h100_tf32x3``) and
989 TFLOP/s dense bf16 (``h100_bf16``).

The JAX module's other half reads XLA artifacts (the compiled module's
``cost_analysis`` and the collectives of its optimized HLO, for a TPU
mesh) and has no counterpart: the port compiles no program, and one card
runs no collective.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Peak numbers of one accelerator for roofline placement."""
    name: str
    peak_flops: float   # FLOP/s of the unit the entry names
    hbm_bw: float       # HBM bytes/s
    ici_bw: float       # interconnect bytes/s per link and direction
    # shared memory per SM (228 KiB on an H100): the on-chip budget a
    # kernel's resident tiles must fit, the counterpart of a TPU core's
    # VMEM in the JAX model
    vmem_bytes: int = 228 * 1024

    @property
    def ridge_intensity(self) -> float:
        """FLOP/byte above which a kernel is compute-bound on this chip."""
        return self.peak_flops / self.hbm_bw


_HBM = 3.35e12
_NVLINK = 25e9      # one NVLink 4 link, one direction (18 links a card)

HARDWARE = {
    "h100": HardwareModel("h100", peak_flops=67e12, hbm_bw=_HBM,
                          ici_bw=_NVLINK),
    "h100_tf32x3": HardwareModel("h100_tf32x3", peak_flops=495e12 / 3,
                                 hbm_bw=_HBM, ici_bw=_NVLINK),
    "h100_bf16": HardwareModel("h100_bf16", peak_flops=989e12, hbm_bw=_HBM,
                               ici_bw=_NVLINK),
}

DEFAULT_HW = "h100"


def get_hardware(name: Optional[str] = None) -> HardwareModel:
    """The hardware model ``name`` (default ``"h100"``)."""
    name = name or DEFAULT_HW
    if name not in HARDWARE:
        raise ValueError(f"unknown hardware model {name!r}; "
                         f"choose from {sorted(HARDWARE)}")
    return HARDWARE[name]


def place(est, hw: Optional[HardwareModel] = None) -> dict:
    """Place an analytical kernel estimate (``Estimates`` or any object
    with ``ops``/``mem``/``intensity``) on ``hw``'s roofline."""
    hw = hw or get_hardware()
    attainable = min(hw.peak_flops, hw.hbm_bw * max(est.intensity, 0.0))
    return {
        "hw": hw.name,
        "intensity": est.intensity,
        "ridge_intensity": hw.ridge_intensity,
        "bound": "compute" if est.intensity >= hw.ridge_intensity else "memory",
        "attainable_flops": attainable,
        "time_s": est.ops / attainable if attainable > 0 else 0.0,
    }
