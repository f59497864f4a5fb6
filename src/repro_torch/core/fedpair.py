"""FedPairing training core (counterpart of ``repro/core/fedpair.py``).

Semantics (pair (i, j), propagation lengths L_i + L_j = W):

* flow_i (client i's data): blocks [0,L_i) + embedding from ω^i, blocks
  [L_i,W) + head from ω^j, built as a parameter *mix*; the gradient with
  respect to the mix routes each flow's gradient to the right owner.
* updates (Eq. 1/2):  ω^i -= η·factor·(a_i·g^i_own + a_j·g^j_incoming).
* overlap (Eq. 7): blocks crossed by both flows get factor 2.

The reference vmaps ``value_and_grad`` over clients.  The port writes the
client axis out instead: params stay stacked ``(N, W, ...)``, the model
runs on ``(N, B, S, D)`` with batched products over N, and attention folds
``(N, B)`` into its batch.  The fused mix is built as a leaf tensor that
requires grad; since the N flows are independent, the gradient of
``sum(losses)`` with respect to it is exactly the reference's stacked
per-flow ``g_mix``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Collection, Dict

import numpy as np
import torch

from repro_torch.core import aggregation, splitting
from repro_torch.tree import tree_items, tree_leaves, tree_map, tree_unflatten

# (params stacked (N, ...), batches stacked (N, ...)) -> (N,) losses
LossFn = Callable[[Dict, Dict], torch.Tensor]


def pair_weights(data_sizes: np.ndarray, partner: np.ndarray) -> np.ndarray:
    """Per-client aggregation weight a_i, normalized WITHIN each pair:
    a_i = |D_i| / (|D_i| + |D_p(i)|)  (see the reference, DESIGN.md §3)."""
    d = np.asarray(data_sizes, np.float64)
    return (d / (d + d[partner])).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class FedPairingConfig:
    lr: float = 0.1
    overlap_boost: bool = True          # Eq. (7) doubled step on overlaps
    aggregation: str = "paper"          # "paper": pre-weighted grads + mean
                                        # "fedavg": plain grads + weighted mean
    donate: bool = True                 # in-place client-param update


# a global model -> N client replicas (leading client axis), the same copy
# the server's broadcast makes
replicate = aggregation.broadcast


def make_fed_step(loss_fn: LossFn, plan: Dict, num_layers: int,
                  fed_cfg: FedPairingConfig, unread: Collection[str] = ()):
    """Build the per-batch FedPairing step.

    Returns ``step(client_params, batches, partner, lengths, agg_w)`` ->
    ``(new_params, {"loss": (N,) losses})`` where
    * client_params — tree stacked over N clients.  With ``fed_cfg.donate``
      (the default) the SGD write happens in place under ``no_grad`` and
      the returned tree is the input tree, updated — the port's form of
      the reference's buffer donation.  With ``donate=False`` the inputs
      are left intact and new tensors are returned.
    * batches       — tree stacked over N clients (one mini-batch each),
    * partner       — (N,) pairing involution,
    * lengths       — (N,) propagation lengths L_i,
    * agg_w         — (N,) aggregation weights a_i.
    ``loss_fn`` takes the stacked trees and returns the (N,) flow losses.
    ``unread`` names the leaves (``a/b/c`` paths) that the loss never reads
    by design, as ``registry.unread_leaves`` gives them: their gradient is
    zero, as under the reference's grad.  Any other leaf without a gradient
    raises.
    """

    def _bmask(masks, a):
        """(N, W) mask broadcast against a stacked (N, W, ...) leaf."""
        return masks.to(a.dtype).reshape(masks.shape + (1,) * (a.dim() - 2))

    def step(client_params, batches, partner, lengths, agg_w):
        device = tree_leaves(client_params)[0].device
        partner = torch.as_tensor(np.asarray(partner), dtype=torch.long,
                                  device=device)
        lengths = torch.as_tensor(np.asarray(lengths), device=device)
        agg_w = torch.as_tensor(np.asarray(agg_w, np.float32),
                                device=device)
        n = partner.shape[0]
        masks = splitting.layer_mask(lengths, num_layers)        # (N, W)
        masks_p = masks[partner]

        # fused gather+mix: bottom/stack[<L] from own, rest from the partner
        def mix(a, label):
            if label == "bottom":
                return a.detach()
            if label == "top":
                return a[partner]
            m = _bmask(masks, a)
            return a * m + a[partner] * (1.0 - m)

        with torch.no_grad():
            mixed = tree_map(mix, client_params, plan)
        items = [(path, t.requires_grad_()) for path, t in tree_items(mixed)]
        losses = loss_fn(mixed, batches)
        grads = torch.autograd.grad(losses.sum(), [t for _, t in items],
                                    allow_unused=True)
        missing = [path for (path, _), g in zip(items, grads)
                   if g is None and path not in unread]
        if missing:
            raise RuntimeError(f"fed step: the loss reads no {missing}")
        g_mix = tree_unflatten(mixed, [torch.zeros_like(t) if g is None else g
                                       for (_, t), g in zip(items, grads)])

        if fed_cfg.aggregation == "paper":
            a_own, a_in = agg_w, agg_w[partner]
        else:  # weighting deferred to the server aggregation
            a_own = a_in = torch.ones_like(agg_w)
        factor = splitting.overlap_factor(masks, masks_p,
                                          fed_cfg.overlap_boost)  # (N, W)

        # fused route + involution return + combine + Eq. (7) factor + SGD:
        # g*m is the flow gradient on own blocks, (g*(1-m))[partner] ==
        # g[partner]*(1-m[partner]) is the partner flow's gradient on them.
        def apply(p, g, label):
            b = (n,) + (1,) * (g.dim() - 1)
            if label == "bottom":
                u = a_own.reshape(b) * g
            elif label == "top":
                u = a_in.reshape(b) * g[partner]
            else:
                m = _bmask(masks, g)
                u = (a_own.reshape(b) * (g * m)
                     + a_in.reshape(b) * (g[partner]
                                          * (1.0 - _bmask(masks_p, g))))
                u = u * _bmask(factor, g).to(u.dtype)
            if fed_cfg.donate:
                return p.sub_(fed_cfg.lr * u)
            return p - fed_cfg.lr * u

        with torch.no_grad():
            new_params = tree_map(apply, client_params, g_mix, plan)
        return new_params, {"loss": losses.detach()}

    return step
