"""Partial client participation (counterpart of the synchronous half of
``repro/core/participation.py``; numpy only).

``sample_cohort`` draws the round's cohort from the driver rng;
``cohort_partner`` pairs within it.  Draw for draw the same as the
reference, so cohorts and pairs match it exactly for one seed.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np

from repro_torch.core import latency, pairing, planning
from repro_torch.core.latency import ChannelModel, ClientFleet

PairFn = Callable[[ClientFleet, ChannelModel], pairing.Pairs]


def sample_cohort(n_clients: int, fraction: float, rng: np.random.Generator
                  ) -> np.ndarray:
    """Sorted indices of the participating cohort.

    A fraction that rounds to >= 1 client is floored at 2 (pairing needs
    two endpoints).  A fraction that rounds to zero yields an empty
    cohort.  The rng is consulted either way, so the driver's draw order
    is cohort-size-invariant."""
    k = int(round(n_clients * fraction))
    if k >= 1:
        k = min(n_clients, max(2, k))
    return np.sort(rng.choice(n_clients, size=k, replace=False))


def cohort_partner(fleet: ClientFleet, chan: ChannelModel,
                   cohort: np.ndarray, pair_fn: Optional[PairFn] = None,
                   ctx: Optional[pairing.PairingContext] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Pair within a cohort; non-participants map to themselves.

    ``pair_fn`` is a bare ``(sub_fleet, chan) -> pairs`` callable (default:
    the paper's greedy ``fedpairing_pairing``) or a
    ``pairing.PairingPolicy`` consulted with ``ctx``.

    Returns (partner (N,), active_mask (N,))."""
    n = fleet.n
    sub = latency.subfleet(fleet, cohort)
    if isinstance(pair_fn, pairing.PairingPolicy):
        ctx = ctx or pairing.PairingContext()
        if pair_fn.cost_driven:
            # price cohort edges with FULL-fleet-normalized dataset weights
            # (and the full fleet's link rates), matching every plan
            # objective's normalization
            idx = np.asarray(cohort)
            if ctx.rel_data is None:
                rel = np.asarray(fleet.data_sizes, np.float64)
                ctx = dataclasses.replace(ctx,
                                          rel_data=(rel / rel.sum())[idx])
            if ctx.rates is None and chan is not None:
                ctx = dataclasses.replace(
                    ctx, rates=fleet.rates(chan)[np.ix_(idx, idx)])
        sub_pairs = pair_fn.pair(sub, chan, ctx)
    else:
        sub_pairs = (pair_fn or pairing.fedpairing_pairing)(sub, chan)
    pairing.validate_matching(sub_pairs, sub.n)   # reject bad pair_fns
    partner = np.arange(n)
    for a, b in sub_pairs:
        ga, gb = int(cohort[a]), int(cohort[b])
        partner[ga], partner[gb] = gb, ga
    active = np.zeros(n, bool)
    active[cohort] = True
    return partner, active


def propagation_lengths(f: np.ndarray, partner: np.ndarray,
                        num_layers: int) -> np.ndarray:
    """Paper rule (numpy): L_i = floor(f_i/(f_i+f_p(i)) W) for the
    lower-indexed member of each pair, L_j = W - L_i for its partner,
    clamped to [1, W-1]; self-paired clients get the full stack."""
    return planning.paper_lengths(np.asarray(f, np.float64),
                                  np.asarray(partner, np.int64), num_layers)


def cohort_pairing(fleet: ClientFleet, chan: ChannelModel,
                   cohort: np.ndarray, num_layers: int,
                   pair_fn: Optional[PairFn] = None
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``cohort_partner`` plus paper-rule lengths.  Returns
    (partner (N,), lengths (N,), active_mask (N,))."""
    partner, active = cohort_partner(fleet, chan, cohort, pair_fn)
    lengths = propagation_lengths(fleet.cpu_hz, partner, num_layers)
    return partner, lengths, active
