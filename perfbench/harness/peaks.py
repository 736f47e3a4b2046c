"""The table of peaks the utilisation and roofline metrics divide by.

Peaks of one NVIDIA H100 SXM 80 GB, from NVIDIA's data sheet (dense
rates, no sparsity), at its full power limit of 700 W; a card set below
it runs slower, so every share is printed beside the card's limit.
"""

from __future__ import annotations

H100_SXM = {
    "bf16_flops": 989e12,     # tensor cores, dense
    "tf32_flops": 495e12,
    "fp32_flops": 67e12,      # outside the tensor cores
    "hbm_bytes": 3.35e12,     # HBM3 bytes/s
    "power_limit_w": 700.0,
}


def peaks(device_name: str) -> dict:
    """The peak table of a card by its name; only the H100 is known."""
    if "H100" not in device_name:
        raise ValueError(f"no peak table for '{device_name}'")
    return H100_SXM

