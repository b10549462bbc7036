"""Device selection and a toolchain probe.

``resolve_device`` never carries on on the CPU when the card was asked for:
``"cuda"`` on a host where ``torch.cuda.is_available()`` is False raises.
``probe`` records what a run ran on (torch and CUDA versions, the card's
name and power limit, nvcc), so every measurement can name its hardware.
"""

from __future__ import annotations

import subprocess
from typing import Union

import torch


def resolve_device(name: Union[str, torch.device] = "cuda") -> torch.device:
    """``torch.device`` for ``name``; raises ``RuntimeError`` for a CUDA
    device on a host without one."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            f"False (torch {torch.__version__}); pass device='cpu' to run "
            "the plain PyTorch selection on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}; use 'cuda' or "
                         "'cpu'")
    if dev.type == "cuda" and (dev.index or 0) >= torch.cuda.device_count():
        raise RuntimeError(
            f"device {str(dev)!r} requested but this host has "
            f"{torch.cuda.device_count()} card(s); ranks that share a card "
            "name it explicitly (for example 'cuda:0')")
    return dev


def _run(cmd) -> str:
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({type(e).__name__})"
    out = (proc.stdout or proc.stderr).strip()
    return out if proc.returncode == 0 else f"unavailable ({out[:200]})"


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``."""
    return _run(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"])


def probe() -> dict:
    """Torch and CUDA versions, the GPU's name, nvidia-smi's name and power
    limit line, and ``nvcc --version``'s last line."""
    from ..ops._build import find_nvcc
    cuda = torch.cuda.is_available()
    try:
        nvcc = _run([find_nvcc(), "--version"]).splitlines()[-1]
    except RuntimeError as e:
        nvcc = f"unavailable ({e})"
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cuda_available": cuda,
        "device_count": torch.cuda.device_count() if cuda else 0,
        "gpu": torch.cuda.get_device_name(0) if cuda else None,
        "nvidia_smi": gpu_name_and_power_limit(),
        "nvcc": nvcc,
    }
