"""Logical model splitting (counterpart of ``repro/core/splitting.py``).

The split unit is a block index into the stacked layer axis.  A client
with propagation length L owns blocks [0, L) of each flow's bottom part.
Parameters that are not per-block are labeled so the FedPairing step knows
which side of the split they live on:

  * ``stack``   — stacked per-block params; the (L-dependent) mask applies.
  * ``bottom``  — always computed by the data owner (embedding, and the
                  hybrid's shared attention block: a permanent overlapping
                  layer its data owner keeps).
  * ``top``     — always computed by the partner (final norm, unembed).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.tree import tree_map


def layer_mask(length: torch.Tensor, num_layers: int) -> torch.Tensor:
    """(..., W) float32 mask: 1.0 for blocks [0, length).  ``length`` may
    carry leading dims (one length per client)."""
    length = torch.as_tensor(length)
    ar = torch.arange(num_layers, device=length.device)
    return (ar < length[..., None]).float()


def overlap_factor(mask_own: torch.Tensor, mask_partner: torch.Tensor,
                   boost: bool = True) -> torch.Tensor:
    """Eq. (7): overlapping blocks (crossed by both flows) get step 2*eta.

    On client i a block l is overlapping iff the own flow computes it
    (l < L_i) AND the partner flow computes it on i (l >= L_p)."""
    if not boost:
        return torch.ones_like(mask_own)
    return 1.0 + mask_own * (1.0 - mask_partner)


def split_plan(cfg: ArchConfig, params: Dict) -> Dict:
    """Same-structure tree of labels {'stack','bottom','top'} per leaf
    (the reference's labels for the ported families' param groups)."""
    labels = {"embed": "bottom", "ln_f": "top", "unembed": "top",
              "blocks": "stack", "mamba": "stack", "shared": "bottom"}
    plan: Dict = {}
    for key, sub in params.items():
        if key not in labels:
            raise KeyError(f"split_plan: unlabeled param group {key!r} "
                           f"for {cfg.name}")
        plan[key] = tree_map(lambda _, lab=labels[key]: lab, sub) \
            if isinstance(sub, dict) else labels[key]
    return plan
