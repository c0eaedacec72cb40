"""The card a measurement ran on."""

from __future__ import annotations

import subprocess


def card_name_and_power_limit() -> str:
    """`nvidia-smi`'s "name, power.limit" line for each visible card: a
    card set below its maximum power runs slower under load, so every
    number is reported beside it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
