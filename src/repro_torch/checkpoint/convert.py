"""Parameters from the reference into the port.

The reference draws its params with ``jax.random``, which torch cannot
reproduce, so params cross as numpy leaves keyed by the ``a/b/c`` paths
that ``repro/checkpoint/io.py:_flatten`` writes (``blocks/attn/wq``, ...).
The port's tree has the same keys and shapes, leaf for leaf.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.tree import tree_items


def params_from_jax(flat: Mapping[str, np.ndarray], device="cuda") -> Dict:
    """``{path: array}`` -> the port's nested param tree on ``device``."""
    tree: Dict = {}
    for path, leaf in flat.items():
        *parents, name = path.split("/")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[name] = torch.as_tensor(np.array(leaf), device=device)
    return tree


def params_to_flat(params: Dict) -> Dict[str, np.ndarray]:
    """The port's tree -> ``{path: array}`` (the inverse of
    ``params_from_jax``)."""
    return {path: leaf.detach().cpu().numpy()
            for path, leaf in tree_items(params)}
