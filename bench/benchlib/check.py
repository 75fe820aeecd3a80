"""What every configuration's check shares: the verdict against the
limits.  What is compared, and over which of the window's requests, is the
configuration's judge's (``bench/judges/<judge>.py``, named by its
``check.judge``)."""

from __future__ import annotations

from typing import Dict


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every compared number is at or under its limit (NaN fails)."""
    return all(numbers[k] <= v for k, v in limits.items())


def limits_of(cfg: dict) -> Dict[str, float]:
    lim = dict(cfg["check"]["limits"])
    lim["failed"] = 0.0
    return lim
