"""The card's peaks and the least time of a window's work.

One NVIDIA H100 SXM: its SMs x 64 INT32 or 128 FP32 lanes x the
maximum SM clock that nvidia-smi reports (1,980 MHz), and 3.35 TB/s of
HBM3 (NVIDIA's data sheet).  The least time of a window's work is the
largest of its INT32 operations, its FP32 operations and its bytes over
these peaks: the pipes run side by side, so no sum of them can be
claimed as a floor.
"""
from __future__ import annotations

import subprocess

INT32_LANES_PER_SM = 64
FP32_LANES_PER_SM = 128
HBM_BYTES_PER_S = 3.35e12


def smi(query: str) -> str:
    """One nvidia-smi query of card 0, as text."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def card_peaks(sms: int, max_mhz: float) -> dict:
    """Operations or bytes per second of one card."""
    hz = max_mhz * 1e6
    return {"int32_ops": sms * INT32_LANES_PER_SM * hz,
            "fp32_ops": sms * FP32_LANES_PER_SM * hz,
            "bytes": HBM_BYTES_PER_S}


def least_seconds(work: dict, peaks: dict) -> float:
    """The least time of `work` ({"int32_ops", "fp32_ops", "bytes"}) at
    `peaks`."""
    return max(work.get(k, 0.0) / peaks[k] for k in peaks)
