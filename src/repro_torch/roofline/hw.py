"""The card the port targets, for the roofline terms: one NVIDIA H100 SXM
(80 GB HBM3) at its 700 W limit, with the data sheet's dense peaks — the
figures ``chip_smoke.py``'s bounds and PERF.md's table use.  A card set
below 700 W runs slower under load; ``obs.provenance`` records the limit
beside every measurement."""
from __future__ import annotations

from typing import NamedTuple


class HwSpec(NamedTuple):
    name: str                  # torch.cuda.get_device_name / nvidia-smi's name
    power_limit_w: float       # the limit the peaks hold at
    hbm_bw: float              # bytes/s
    peak_flops_f32: float      # FLOP/s, CUDA cores (FMA = 2)
    peak_flops_bf16: float     # FLOP/s, dense tensor cores
    hbm_bytes: float           # device memory


H100 = HwSpec(
    name="NVIDIA H100 80GB HBM3",
    power_limit_w=700.0,
    hbm_bw=3.35e12,
    peak_flops_f32=67e12,
    peak_flops_bf16=989e12,
    hbm_bytes=80e9,
)
