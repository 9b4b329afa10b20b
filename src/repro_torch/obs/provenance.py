"""Run provenance — the attribution block every record of the port
carries (the counterpart of :mod:`repro.obs.provenance`).

Numbers are comparable from run to run only when each record says what
produced it: the commit, the torch and CUDA versions, the device — and on
the card its name and power limit as ``nvidia-smi`` reads them, since a
card held below its limit runs slower under load — and when.  Every field
falls back to ``"unknown"`` rather than raising.
"""
from __future__ import annotations

import os
import subprocess
from datetime import datetime, timezone

import torch


def _run(cmd: list[str]) -> str:
    """The command's stripped output, or ``"unknown"``."""
    try:
        out = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                             capture_output=True, text=True, timeout=10)
        text = out.stdout.strip()
        return text if out.returncode == 0 and text else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def card_line() -> str:
    """The first card's ``name, power.limit`` as ``nvidia-smi`` prints them."""
    line = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    return line.splitlines()[0].strip() if line != "unknown" else line


def provenance_meta() -> dict:
    """Commit SHA, ISO timestamp, torch and CUDA versions, the device's
    kind and count, and on a card its name and power limit."""
    meta = {"commit": _run(["git", "rev-parse", "HEAD"]),
            "timestamp": datetime.now(timezone.utc).isoformat(timespec="seconds"),
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda or "unknown"}
    try:
        if torch.cuda.is_available():
            name, _, limit = card_line().partition(",")
            meta.update(backend="cuda", device_kind=torch.cuda.get_device_name(0),
                        n_devices=torch.cuda.device_count(), card_name=name.strip() or "unknown",
                        power_limit=limit.strip() or "unknown")
        else:
            meta.update(backend="cpu", device_kind="cpu", n_devices=0,
                        card_name="unknown", power_limit="unknown")
    except Exception:  # noqa: BLE001 — provenance never fails a run
        meta.update(backend="unknown", device_kind="unknown", n_devices=0,
                    card_name="unknown", power_limit="unknown")
    return meta
