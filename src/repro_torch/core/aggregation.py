"""Server-side model aggregation (counterpart of the ``mean`` policy of
``repro/core/aggregation.py``).

Two weighting modes (see the reference, DESIGN.md §3):
* ``paper``  — gradients were pre-weighted by a_i during local training;
               the server takes the plain mean ``ω_g = (1/N) Σ ω_i``.
* ``fedavg`` — classic McMahan weighting at the server:
               ``ω_g = Σ a_i ω_i`` (local updates unweighted).

Of the aggregation-policy registry the port has ``mean``; ``scaffold`` is
ROADMAP item A.10.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.tree import tree_map

AGG_POLICY_SPECS = ("mean",)


class EmptyCohortError(ValueError):
    """``aggregate()`` was asked to average an empty cohort (all-False
    ``active`` mask or weights summing to zero) — dividing would NaN the
    global params.  Raised with the round index when the caller supplies
    one; a round with no survivors must be skipped, never aggregated."""

    def __init__(self, round_idx: Optional[int] = None):
        self.round = None if round_idx is None else int(round_idx)
        where = "" if self.round is None else f" in round {self.round}"
        super().__init__(
            f"aggregate() called with an empty cohort{where} (aggregation "
            f"weights sum to zero) — dividing would NaN the global params; "
            f"skip the round instead")


def _unnormalized_weights(agg_w: torch.Tensor, mode: str,
                          active: Optional[torch.Tensor],
                          staleness: Optional[torch.Tensor]
                          ) -> Optional[torch.Tensor]:
    """The (N,) pre-normalization weight vector, or ``None`` for the
    plain-mean fast path (mode "paper", no mask, no staleness)."""
    if staleness is not None and not bool(torch.as_tensor(staleness).any()):
        staleness = None        # all fresh: the synchronous path
    if mode == "paper":
        if active is None and staleness is None:
            return None
        if active is None:
            w = torch.ones_like(torch.as_tensor(staleness,
                                                dtype=torch.float32))
        else:
            w = torch.as_tensor(active).float()
    elif mode == "fedavg":
        w = torch.as_tensor(agg_w, dtype=torch.float32)
        if active is not None:
            w = w * torch.as_tensor(active, device=w.device).float()
    else:
        raise ValueError(f"unknown aggregation mode {mode!r}")
    if staleness is not None:
        w = w / (1.0 + torch.as_tensor(staleness, device=w.device).float())
    return w


def _masked_weighted_mean(w: torch.Tensor, tree: Dict) -> Dict:
    """``Σ_i w_i · tree[i]`` over the leading client axis with the
    zero-weight hard-mask: an excluded client's values are never read
    (0 * nan is nan)."""

    def wmean(a):
        wa = w.to(device=a.device, dtype=a.dtype)
        keep = (wa > 0).reshape((-1,) + (1,) * (a.dim() - 1))
        masked = torch.where(keep, a, torch.zeros((), dtype=a.dtype,
                                                  device=a.device))
        return torch.tensordot(wa, masked, dims=([0], [0]))

    return tree_map(wmean, tree)


def aggregate(client_params: Dict, agg_w: torch.Tensor,
              mode: str = "paper",
              active: Optional[torch.Tensor] = None,
              staleness: Optional[torch.Tensor] = None,
              round_idx: Optional[int] = None) -> Dict:
    """client_params stacked (N, ...) -> global params.

    ``active`` (N,) bool restricts the aggregation to the participating
    cohort ("paper": the cohort mean; "fedavg": the cohort-renormalized
    weighted mean).  An empty cohort raises ``EmptyCohortError``.
    ``staleness`` (N,) int discounts client i by 1/(1+staleness[i]) (the
    reference's async rounds; None or all zeros leaves weights as they
    are)."""
    w = _unnormalized_weights(agg_w, mode, active, staleness)
    if w is None:
        return tree_map(lambda a: a.mean(dim=0), client_params)
    total = w.sum()
    if float(total) <= 0.0:
        raise EmptyCohortError(round_idx)
    return _masked_weighted_mean(w / total, client_params)


def aggregation_weights(agg_w: torch.Tensor, n: int, mode: str = "paper",
                        active: Optional[torch.Tensor] = None,
                        staleness: Optional[torch.Tensor] = None,
                        round_idx: Optional[int] = None) -> torch.Tensor:
    """The normalized (N,) per-client weight vector ``aggregate`` reduces
    with.  The plain-mean fast path normalizes to the uniform 1/N."""
    w = _unnormalized_weights(agg_w, mode, active, staleness)
    if w is None:
        return torch.full((n,), 1.0 / n, dtype=torch.float32)
    total = w.sum()
    if float(total) <= 0.0:
        raise EmptyCohortError(round_idx)
    return w / total


def broadcast(global_params: Dict, n: int) -> Dict:
    """Global params -> N stacked client replicas (own storage each, so
    the next round's in-place step may write them)."""
    return tree_map(lambda a: a.unsqueeze(0).repeat((n,) + (1,) * a.dim()),
                    global_params)


class AggregationPolicy:
    """One rule mapping the cohort's trained replicas to the next global
    model.  ``apply`` returns ``(global_params, new_state)``."""

    spec: str = "?"
    stateful: bool = False

    def init_state(self, params_like: Dict, n: int):
        """Fresh policy state for an N-client fleet (None if stateless)."""
        return None

    def apply(self, client_params: Dict, agg_w: torch.Tensor,
              mode: str = "paper", *,
              active: Optional[torch.Tensor] = None,
              staleness: Optional[torch.Tensor] = None,
              state=None, round_idx: Optional[int] = None
              ) -> Tuple[Dict, object]:
        raise NotImplementedError


class MeanAggregation(AggregationPolicy):
    """The cohort-masked weighted mean — delegates to ``aggregate()``."""

    spec = "mean"

    def apply(self, client_params, agg_w, mode="paper", *, active=None,
              staleness=None, state=None, round_idx=None):
        return aggregate(client_params, agg_w, mode, active=active,
                         staleness=staleness, round_idx=round_idx), state


def get_aggregation_policy(spec: str) -> AggregationPolicy:
    if spec == "mean":
        return MeanAggregation()
    if spec == "scaffold":
        raise NotImplementedError(
            "agg_policy 'scaffold' is not ported yet (ROADMAP item A.10)")
    raise ValueError(f"unknown aggregation policy {spec!r}; known: "
                     f"{AGG_POLICY_SPECS}")
