"""Architecture config registry of the port.

The port knows the families it has ported: the dense llama
(tinyllama-1.1b), the RWKV6 SSM (rwkv6-1.6b) and the Mamba2 + shared
attention hybrid (zamba2-1.2b).  Every other id of the reference raises
and names the ROADMAP item that ports its family.
"""
from __future__ import annotations

from typing import List

from repro_torch.configs import rwkv6_1p6b, tinyllama_1p1b, zamba2_1p2b
from repro_torch.configs.base import (  # noqa: F401  (re-exported)
    ArchConfig,
    ArchFamily,
    AttentionKind,
)

_ARCH_MODULES = {"tinyllama-1.1b": tinyllama_1p1b,
                 "rwkv6-1.6b": rwkv6_1p6b,
                 "zamba2-1.2b": zamba2_1p2b}

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
