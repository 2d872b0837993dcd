"""Published peaks of the cards the benchmark runs on, by a part of the
name ``torch.cuda.get_device_name()`` gives.  Each rate assumes the card's
full power limit; the run prints the limit beside it."""

from __future__ import annotations

from typing import Optional

# NVIDIA H100 data sheet: HBM3 of the SXM part, HBM2e of the PCIe part
HBM_BYTES_PER_S = {
    "H100 80GB HBM3": 3.35e12,
    "H100 PCIe": 2.0e12,
}


def hbm_bytes_per_s(device_name: str) -> Optional[float]:
    for part, peak in HBM_BYTES_PER_S.items():
        if part in device_name:
            return peak
    return None
