"""The card: the check that there is one (or as many as a cell asks for), and
what the result line says about it."""

from __future__ import annotations

import subprocess


class NoCard(RuntimeError):
    """Fewer CUDA devices than the cell asks for: the run fails, it never
    falls back to the CPU."""


def require(torch, chips: int) -> None:
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is False: this benchmark measures the card")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} CUDA devices; "
                     f"torch.cuda.device_count() is {torch.cuda.device_count()}")


def power_limits() -> list[str]:
    """``nvidia-smi``'s power limit of each card, as it prints it ("700.00 W"),
    or an empty list where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [line.strip() for line in out.splitlines() if line.strip()]


def info(torch, count: int) -> dict:
    """The result line's ``device``: platform, the card's name, the cards
    used, the peak allocation on the fullest of them, and their power
    limits."""
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(count))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(peak), "power_limit": power_limits()[:count]}
