"""Architecture config registry of the port.

The port has ported the dense llama family only, so it knows one public
``--arch`` id.  Every other id of the reference raises and names the
ROADMAP item that ports its family.
"""
from __future__ import annotations

from typing import List

from repro_torch.configs import tinyllama_1p1b
from repro_torch.configs.base import (  # noqa: F401  (re-exported)
    ArchConfig,
    ArchFamily,
    AttentionKind,
)

_ARCH_MODULES = {"tinyllama-1.1b": tinyllama_1p1b}

ARCH_IDS: List[str] = list(_ARCH_MODULES)


def _module(arch_id: str):
    if arch_id not in _ARCH_MODULES:
        raise KeyError(
            f"arch {arch_id!r} is not ported yet; the port knows "
            f"{', '.join(ARCH_IDS)} (the other families are ROADMAP item "
            f"A.12)")
    return _ARCH_MODULES[arch_id]


def get_config(arch_id: str) -> ArchConfig:
    """Full-scale assigned config for ``--arch <id>``."""
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ArchConfig:
    """Reduced same-family variant (<=2 layers, d_model<=512)."""
    return _module(arch_id).smoke_config()
