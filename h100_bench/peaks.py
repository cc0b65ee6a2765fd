"""Published peaks of one NVIDIA H100 SXM (data sheet; dense rates, no
sparsity, at the full 700 W power limit).  A card set below 700 W runs
slower under load; ``card()`` reads the limit so that every result carries
it beside the shares stated against these peaks."""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12
FLOP_PER_S = {"float32": 67e12, "bfloat16": 989e12}


def bound_s(flop: float, nbytes: float, dtype: str = "float32") -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the HBM bandwidth."""
    return max(flop / FLOP_PER_S[dtype], nbytes / HBM_BYTES_PER_S)


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reports it, or "unknown"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=False,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.splitlines()[0].strip() if out else "unknown"
