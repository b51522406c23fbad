"""The card's published peaks: the denominators of every roofline and MFU.

DATASHEETS and datasheet() are frozen copies of chip_smoke.py's (as of
the benchmark's first version). They lack the bf16 rate, which
BF16_DENSE adds. Every peak is a dense rate from NVIDIA's data sheets,
without sparsity; the rates assume the card's full power limit, so a
reading is written beside the card's power limit.

The rate a configuration is held to is the highest dense rate of the
tensor cores at its precision, which no implementation of that precision
can exceed: TF32 for float32 inputs, bf16 for bfloat16. Bytes move at
the HBM rate.
"""
from __future__ import annotations

# Data-sheet peaks: float32 outside the tensor cores, memory rate, dense
# TF32 on the tensor cores.
DATASHEETS = {
    "H100 PCIe": (51e12, 2.0e12, 378e12),
    "H100 NVL": (60e12, 3.9e12, 417e12),
    "H200": (67e12, 4.8e12, 495e12),
    "H100 SXM": (67e12, 3.35e12, 495e12),
}

# Dense bf16 on the tensor cores (FLOP/s), by the same data-sheet names.
BF16_DENSE = {
    "H100 PCIe": 756e12,
    "H100 NVL": 835e12,
    "H200": 989e12,
    "H100 SXM": 989e12,
}

# Bytes per element and the peak that bounds products, by precision.
ELEMENT_BYTES = {"float32": 4, "bfloat16": 2}


def datasheet(name: str):
    """The data sheet matching a device name; the SXM part's otherwise
    (its name, e.g. "NVIDIA H100 80GB HBM3", does not say SXM)."""
    for key, peaks in DATASHEETS.items():
        if all(word in name for word in key.split()):
            return key, peaks
    return "H100 SXM", DATASHEETS["H100 SXM"]


def peaks_for(device_name: str, precision: str) -> dict:
    """{'sheet', 'flops' (FLOP/s), 'bytes' (B/s), 'element_bytes'} for a
    configuration's precision on the named card."""
    sheet, (_, mem, tf32) = datasheet(device_name)
    if precision == "float32":
        flops = tf32
    elif precision == "bfloat16":
        flops = BF16_DENSE[sheet]
    else:
        raise ValueError(f"no peak for precision {precision!r}")
    return {"sheet": sheet, "flops": flops, "bytes": mem,
            "element_bytes": ELEMENT_BYTES[precision]}
