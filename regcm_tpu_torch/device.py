"""Where the port's entry points put their tensors.

Every entry point (``Model``, ``HydroCore``, ``MolochCore``,
``PhysicsSuite``, the state helpers) defaults to ``device="cuda"``; on a
host without a CUDA card it raises instead of running on the CPU, which
the caller asks for with ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``, refusing a CUDA device where none exists."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "regcm_tpu_torch runs on the CUDA card by default and this host "
            "has none: pass device=\"cpu\" to run on the CPU")
    return dev
