"""Hardware backend specs for the port's analytic performance layer: a
copy of ``BackendSpec`` from ``repro/core/backend.py``, kept so that the
port never imports the JAX package, with the port's one part, the NVIDIA
H100 SXM, as the only spec and the default.

The spec is the card's datasheet envelope: HBM3 at 3.35 TB/s, dense bf16
at 989 TFLOP/s and dense int8 at 1,979 TOP/s (the same constants
``chip_smoke.py`` prices every kernel's bound with), NVLink 4 at 25 GB/s
a link and direction, and the host link at PCIe 5.0 x16's 64 GB/s a
direction. The reference's TPU constants and its measured readback
asymmetry (a property of the paper's accelerator) do not carry over; the
host link's real rate is measured on the card by ``chip_smoke.py``, which
prints it beside the card's name and power limit.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class BackendSpec:
    """Peak envelope of one accelerator chip.

    All rates are per-chip except ``ici_bw`` (per link).  ``h2d_bw`` is
    the host->device ingest bandwidth; ``d2h_bw`` the device->host
    readback bandwidth (typically much lower — gather contention).
    """
    name: str
    peak_flops_bf16: float        # FLOP/s, dense bf16/fp16
    peak_flops_int8: float        # FLOP/s, dense int8
    hbm_bw: float                 # bytes/s
    ici_bw: float                 # bytes/s per link
    h2d_bw: float                 # bytes/s, host -> device
    d2h_bw: float                 # bytes/s, device -> host

    def peak_flops(self, precision: str = "fp32") -> float:
        """Peak dense FLOP/s for an engine precision string.

        ``w8a8``/``int8`` run on the int8 path; everything else (fp32
        emulation included — the model is relative, the measured
        overhead factor absorbs the absolute scale) gets the bf16 peak.
        """
        if precision in ("w8a8", "int8"):
            return self.peak_flops_int8
        return self.peak_flops_bf16

    def precision_scale(self, precision: str = "fp32") -> float:
        """Predicted step-time multiplier vs the bf16/fp32 baseline
        (1.0 for fp32, 0.5 for w8a8 on a 2x-int8 part)."""
        return self.peak_flops_bf16 / self.peak_flops(precision)


# NVIDIA H100 SXM5 80 GB, dense rates (no sparsity)
H100 = BackendSpec(
    name="h100-sxm",
    peak_flops_bf16=989e12,
    peak_flops_int8=1979e12,
    hbm_bw=3.35e12,
    ici_bw=25e9,
    h2d_bw=64e9,
    d2h_bw=64e9,
)

DEFAULT_BACKEND = H100
