# Host-side numpy copy of repro/core/pairing.py, kept in step with it: the
# parity tests hold the port's host traces bit-identical to the reference.
"""Client pairing — the paper's §III greedy algorithm, baselines, and the
cost-driven PairingPolicy registry.

Problem 2: max-weight edge selection on the client graph with
``eps_ij = alpha (f_i - f_j)^2 + beta r_ij`` subject to each vertex covered
at most once (a matching).  Algorithm 1 is the greedy: sort edges by weight
descending, take any edge whose endpoints are both uncovered.

Baselines (paper Table I): random pairing, location-based (max rate only),
computation-resource-based (max (f_i-f_j)^2 only).  We also provide the
*optimal* max-weight matching (NetworkX blossom) as an upper bound the
paper doesn't evaluate — used in tests to bound the greedy's gap.

Beyond the paper's weight heuristic, the **PairingPolicy** registry
(mirroring ``planning``'s SplitPolicy) scores candidate edges by their TRUE
Eq. (3) latency under the policy-optimal cut (``pair_cost_matrix``: each
hypothetical pair is priced at the best cut its split policy would choose),
so Problem 1 can be solved jointly — pairing AND cut together (cf. Wen et
al., *Training Latency Minimization for Model-Splitting Allowed Federated
Edge Learning*; Sun et al., *Split Federated Learning Over Heterogeneous
Edge Devices*).  Two selectors run on the cost matrix: ``greedy-cost``
(ascending min-cost greedy, the Alg.-1 shape on real costs) and
``blossom-cost`` (min-cost maximum matching — exact blossom up to
``_BLOSSOM_EXACT_MAX_N`` clients, the scipy assignment relaxation
beyond).  ``paper-weight`` remains the default policy and is
bit-identical to the historical ``fedpairing_pairing``; see
``planning.build_joint_plan`` for the joint plan the round driver
consumes (DESIGN.md §7).

At fleet scale the cost matrix is the vectorized planning kernel
(``planning.policy_cut_costs`` — batched over candidate pairs, the cut
axis looped), bit-identical to the scalar reference loop kept as
``pair_cost_matrix_reference``, and re-plans of a kept cohort reuse the
cut search through a cross-round ``planning.PlannerCache`` (DESIGN.md
§8; the scaling wall-clocks live in ``BENCH_pairing.json``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core import planning
from repro_torch.core.latency import ChannelModel, ClientFleet

Pairs = List[Tuple[int, int]]


def edge_weights(fleet: ClientFleet, chan: ChannelModel, alpha: float = 1.0,
                 beta: float = 1.0, normalize: bool = True) -> np.ndarray:
    """eps_ij per Eq. (5).  ``normalize`` scales both terms to [0, 1] so the
    alpha/beta trade-off is unit-free (the paper leaves units unspecified)."""
    f = fleet.cpu_hz
    df2 = (f[:, None] - f[None, :]) ** 2
    r = fleet.rates(chan).copy()
    np.fill_diagonal(r, 0.0)
    if normalize:
        df2 = df2 / max(df2.max(), 1e-12)
        r = r / max(r[np.isfinite(r)].max(), 1e-12)
    w = alpha * df2 + beta * r
    np.fill_diagonal(w, -np.inf)
    return w


def greedy_pairing(weights: np.ndarray) -> Pairs:
    """Algorithm 1: descending-weight greedy matching.  O(N^2 log N).

    Sort the candidate edges by weight (stable, so equal weights keep
    upper-triangle order), take any edge whose endpoints are both
    uncovered, stop as soon as the matching is maximum (floor(N/2) pairs)
    — the early exit is what keeps the Alg.-1 scan viable on
    thousand-client fleets where the full edge list has ~N^2/2 entries.
    """
    n = weights.shape[0]
    iu, ju = np.triu_indices(n, k=1)
    order = np.argsort(-weights[iu, ju], kind="stable")
    covered = np.zeros(n, bool)
    pairs: Pairs = []
    for o in order:
        i, j = int(iu[o]), int(ju[o])
        if not covered[i] and not covered[j]:
            pairs.append((i, j))
            covered[i] = covered[j] = True
            if len(pairs) == n // 2:
                break
    return pairs


def random_pairing(n: int, seed: int = 0) -> Pairs:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    return [(int(perm[2 * k]), int(perm[2 * k + 1])) for k in range(n // 2)]


def location_pairing(fleet: ClientFleet, chan: ChannelModel) -> Pairs:
    """Greedy on communication rate alone (paper's location-based baseline)."""
    return greedy_pairing(edge_weights(fleet, chan, alpha=0.0, beta=1.0))


def compute_pairing(fleet: ClientFleet, chan: ChannelModel) -> Pairs:
    """Greedy on compute-difference alone (computation-resource-based)."""
    return greedy_pairing(edge_weights(fleet, chan, alpha=1.0, beta=0.0))


def fedpairing_pairing(fleet: ClientFleet, chan: ChannelModel,
                       alpha: float = 1.0, beta: float = 0.05) -> Pairs:
    """The paper's mechanism: greedy on the combined edge weight.

    The paper leaves alpha/beta unspecified; with both terms normalized to
    [0,1], beta=0.05 was calibrated against the round-time simulator
    (benchmarks/bench_pairing sweeps it): compute balance dominates round
    latency at the paper's constants, so the rate term mostly breaks ties
    between equally-balanced pairs — larger beta sacrifices balance for
    rate and loses to the compute-only baseline."""
    return greedy_pairing(edge_weights(fleet, chan, alpha=alpha, beta=beta))


# ---------------------------------------------------------------------------
# cost-driven pairing — price every candidate edge by its TRUE Eq. (3)
# latency at that hypothetical pair's policy-optimal cut
# ---------------------------------------------------------------------------

def _matrix_inputs(fleet, chan, rates, rel_data):
    """Common (f, rates, rel_data) normalization for the cost matrices."""
    n = fleet.n
    f = np.asarray(fleet.cpu_hz, np.float64)
    if rates is None:
        rates = fleet.rates(chan) if chan is not None \
            else np.full((n, n), np.inf)
    if rel_data is None:
        rel_data = np.asarray(fleet.data_sizes, np.float64)
        rel_data = rel_data / rel_data.sum()
    return f, np.asarray(rates, np.float64), np.asarray(rel_data, np.float64)


def pair_cost_matrix(fleet: ClientFleet, chan: Optional[ChannelModel],
                     num_layers: int, workload, *, split_policy="paper",
                     alpha: float = 1.0, beta: float = 1.0,
                     rates: Optional[np.ndarray] = None,
                     rel_data: Optional[np.ndarray] = None,
                     cache: Optional[planning.PlannerCache] = None,
                     fail: Optional[np.ndarray] = None,
                     cycles: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(N, N) symmetric edge-cost matrix for joint pairing x split search.

    Entry (i, j) is the Eq. (3) cost (``planning.pair_cost``, seconds) of
    the hypothetical pair (i, j) evaluated at the cut the ``split_policy``
    would choose FOR that pair — i.e. each edge is priced at its
    policy-optimal split, so a matching that minimizes the matrix sum
    minimizes the Eq. (4) objective of the resulting ``build_round_plan``
    under the same policy.  Also returns the (N, N) canonical-member cut
    matrix (cuts[i, j] with i < j canonical) so callers can reuse the
    search.  ``rel_data`` overrides the dataset weights (e.g.
    full-fleet-normalized weights when pricing a cohort sub-problem); the
    diagonal is +inf (no self-pairs).

    The search is the vectorized planning kernel
    (``planning.policy_cut_costs``: batched numpy over the candidate-pair
    axis, the cut axis looped 1..W-1) — bit-identical float64 to the
    scalar ``pair_cost_matrix_reference`` loop, which is kept as the
    reference implementation the property tests compare against (and the
    fallback for custom SplitPolicy subclasses with no vectorized form).
    ``cache`` (a ``planning.PlannerCache``) reuses a previous round's cut
    search across rounds: on a hit the cached cuts are re-priced on the
    current rates in O(N^2) instead of re-searched in O(N^2 W)
    (DESIGN.md §8).  ``fail`` ((N,) per-client failure probabilities)
    prices every edge with the expected-latency reliability multiplier
    (``planning.pair_cost``) — cut-independent, so the cut matrix is
    unchanged; part of the cache's problem key.  ``cycles`` overrides the
    workload's per-client ``cycles_per_layer`` vector with a cohort-local
    slice (sub-problems index the subfleet, not the full fleet); default
    is the workload's own vector validated against ``fleet.n`` — either
    way the vector prices each edge's two flows at their own per-layer
    costs and is hashed into the cache key (device-class changes can
    never reuse stale cuts).
    """
    if workload is None:
        raise ValueError("pair_cost_matrix needs a workload model "
                         "(the Eq. (3) cost has no meaning without one)")
    n = fleet.n
    f, rates, rel_data = _matrix_inputs(fleet, chan, rates, rel_data)
    pol = planning.get_policy(split_policy)
    if cycles is None:
        cyc = planning.client_cycles(workload, n)
    else:
        cyc = np.asarray(cycles, np.float64)
        if cyc.shape != (n,):
            raise planning.PerClientShapeError(
                f"cycles override must have one entry per client ({n}), "
                f"got shape {cyc.shape}")
    iu, ju = np.triu_indices(n, k=1)
    f_i, f_j = f[iu], f[ju]
    r = rates[iu, ju]
    d_i, d_j = rel_data[iu], rel_data[ju]
    cy_i = cyc[iu] if cyc is not None else None
    cy_j = cyc[ju] if cyc is not None else None
    if fail is None:
        fl_i = fl_j = 0.0
    else:
        fl = np.asarray(fail, np.float64)
        fl_i, fl_j = fl[iu], fl[ju]

    def search():
        return planning.policy_cut_costs(pol, f_i, f_j, r, d_i, d_j,
                                         workload, num_layers, alpha, beta,
                                         fl_i, fl_j, cy_i, cy_j)

    if cache is not None:
        key = planning.PlannerCache.problem_key(f, rel_data, workload, pol,
                                                num_layers, alpha, beta,
                                                fail=fail, cycles=cyc)
        found = cache.consult(
            key, pol.rate_aware,
            lambda cuts: planning.price_cuts(cuts, f_i, f_j, r, d_i, d_j,
                                             workload, num_layers, alpha,
                                             beta, fl_i, fl_j, cy_i, cy_j))
        if found is None:
            found = search()
            if found is not None:
                cache.store(key, *found, workload=workload)
    else:
        found = search()
    if found is None:          # custom policy without a vectorized form
        return pair_cost_matrix_reference(
            fleet, chan, num_layers, workload, split_policy=pol,
            alpha=alpha, beta=beta, rates=rates, rel_data=rel_data,
            fail=fail, cycles=cyc)
    cvec, costv = found
    cost = np.full((n, n), np.inf)
    cuts = np.zeros((n, n), np.int64)
    cost[iu, ju] = cost[ju, iu] = costv
    cuts[iu, ju] = cuts[ju, iu] = cvec
    return cost, cuts


def pair_cost_matrix_reference(fleet: ClientFleet,
                               chan: Optional[ChannelModel],
                               num_layers: int, workload, *,
                               split_policy="paper", alpha: float = 1.0,
                               beta: float = 1.0,
                               rates: Optional[np.ndarray] = None,
                               rel_data: Optional[np.ndarray] = None,
                               fail: Optional[np.ndarray] = None,
                               cycles: Optional[np.ndarray] = None
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """Scalar reference for ``pair_cost_matrix``: the pure-Python
    O(N^2 W) per-pair loop over ``SplitPolicy.pair_cut_cost``.

    Kept (1) as the ground truth the vectorized kernel is property-tested
    bit-identical against, (2) as the execution path for custom
    SplitPolicy subclasses that only define the scalar ``pair_cut``, and
    (3) as the pure-loop baseline the planner-scaling benchmark times
    (``benchmarks/bench_pairing.py``).
    """
    if workload is None:
        raise ValueError("pair_cost_matrix needs a workload model "
                         "(the Eq. (3) cost has no meaning without one)")
    n = fleet.n
    f, rates, rel_data = _matrix_inputs(fleet, chan, rates, rel_data)
    pol = planning.get_policy(split_policy)
    fl = None if fail is None else np.asarray(fail, np.float64)
    cyc = planning.client_cycles(workload, n) if cycles is None \
        else np.asarray(cycles, np.float64)
    cost = np.full((n, n), np.inf)
    cuts = np.zeros((n, n), np.int64)
    for i in range(n):
        for j in range(i + 1, n):
            ctx = planning.PairContext(
                f_i=float(f[i]), f_j=float(f[j]), num_layers=num_layers,
                rate_bps=float(rates[i, j]), d_i=float(rel_data[i]),
                d_j=float(rel_data[j]), workload=workload,
                alpha=alpha, beta=beta,
                fail_i=float(fl[i]) if fl is not None else 0.0,
                fail_j=float(fl[j]) if fl is not None else 0.0,
                cyc_i=float(cyc[i]) if cyc is not None else None,
                cyc_j=float(cyc[j]) if cyc is not None else None)
            li, c = pol.pair_cut_cost(ctx)
            cost[i, j] = cost[j, i] = c
            cuts[i, j] = cuts[j, i] = int(li)
    return cost, cuts


# above this many pairs the scalar 2-opt scan switches to the batched
# numpy sweep (same only-improving guarantee, different visit order)
_TWO_OPT_BULK_MIN_PAIRS = 32


def two_opt_refine(pairs: Pairs, cost: np.ndarray,
                   max_sweeps: int = 20) -> Pairs:
    """Pairwise-exchange (2-opt) descent on a matching's total cost.

    For every two pairs (i,j),(k,l) the two rewirings (i,k)(j,l) and
    (i,l)(j,k) are tried; the best strictly-improving exchange is applied
    and sweeps repeat to a local optimum.  Each accepted exchange lowers
    the total, so this can only improve the matching it starts from —
    cheap (O(sweeps x P^2)) against the blossom's exact optimum.

    Small matchings keep the historical scalar scan (bit-stable results
    for every existing fleet size); beyond ``_TWO_OPT_BULK_MIN_PAIRS``
    pairs the sweep runs as a batched numpy computation over all (P, P)
    candidate exchanges at once, applying a conflict-free set of the
    best improving exchanges per sweep — same monotone-descent guarantee,
    fleet-scale wall-clock (the scalar scan is O(P^2) Python-loop
    iterations per sweep, minutes at N=2000).
    """
    pairs = [tuple(p) for p in pairs]
    if len(pairs) > _TWO_OPT_BULK_MIN_PAIRS:
        return _two_opt_refine_bulk(pairs, cost, max_sweeps)
    for _ in range(max_sweeps):
        improved = False
        for a in range(len(pairs)):
            for b in range(a + 1, len(pairs)):
                i, j = pairs[a]
                k, l = pairs[b]
                base = cost[i, j] + cost[k, l]
                for p1, p2 in (((i, k), (j, l)), ((i, l), (j, k))):
                    if cost[p1] + cost[p2] < base - 1e-12:
                        pairs[a] = (min(p1), max(p1))
                        pairs[b] = (min(p2), max(p2))
                        base = cost[pairs[a]] + cost[pairs[b]]
                        improved = True
        if not improved:
            break
    return sorted(pairs)


def _two_opt_refine_bulk(pairs: Pairs, cost: np.ndarray,
                         max_sweeps: int) -> Pairs:
    """Batched 2-opt sweep: score all (P, P) pair-of-pair exchanges with
    numpy, apply the improving ones greedily by gain, touching every pair
    at most once per sweep (conflict-free), repeat until no exchange
    improves.  Each applied exchange strictly lowers the total, so the
    only-improving contract of ``two_opt_refine`` is preserved."""
    a = np.array([p[0] for p in pairs], np.int64)
    b = np.array([p[1] for p in pairs], np.int64)
    for _ in range(max_sweeps):
        base = cost[a, b]
        pair_base = base[:, None] + base[None, :]
        # exchange variant 1: (a_x, a_y)(b_x, b_y); variant 2: (a_x, b_y)(b_x, a_y)
        alt1 = cost[a[:, None], a[None, :]] + cost[b[:, None], b[None, :]]
        alt2 = cost[a[:, None], b[None, :]] + cost[b[:, None], a[None, :]]
        gain = pair_base - np.minimum(alt1, alt2)
        gain[np.tril_indices_from(gain)] = -np.inf     # x < y only, no self
        xs, ys = np.nonzero(gain > 1e-12)
        if xs.size == 0:
            break
        order = np.argsort(-gain[xs, ys], kind="stable")
        touched = np.zeros(len(a), bool)
        for o in order:
            x, y = int(xs[o]), int(ys[o])
            if touched[x] or touched[y]:
                continue
            touched[x] = touched[y] = True
            if alt1[x, y] <= alt2[x, y]:
                na = ((a[x], a[y]), (b[x], b[y]))
            else:
                na = ((a[x], b[y]), (b[x], a[y]))
            (a[x], b[x]), (a[y], b[y]) = \
                (min(na[0]), max(na[0])), (min(na[1]), max(na[1]))
    return sorted((int(i), int(j)) for i, j in zip(a, b))


def min_cost_greedy_pairing(cost: np.ndarray) -> Pairs:
    """Min-cost greedy edge selection + 2-opt exchange refinement.

    Ascending-cost greedy (Alg. 1's shape on true edge costs: take the
    cheapest edge whose endpoints are both uncovered) is a poor selector
    for a SUM objective — it burns the cheap edges on already-fast pairs
    and leaves the stragglers matched to each other — so the raw matching
    is refined by ``two_opt_refine`` pairwise exchanges, which is where
    the joint gain over pair-then-cut actually materializes (the blossom
    selector certifies how close the local optimum lands).
    """
    return two_opt_refine(greedy_pairing(-cost), cost)


# beyond this many clients the exact blossom (pure-Python NetworkX,
# O(N^3) with heavy constants) hands over to the scipy assignment solver
_BLOSSOM_EXACT_MAX_N = 64


def min_cost_blossom_pairing(cost: np.ndarray) -> Pairs:
    """Min-cost maximum matching on the cost matrix — the joint bound.

    Up to ``_BLOSSOM_EXACT_MAX_N`` clients this is the EXACT blossom:
    max-weight max-cardinality matching on ``C - cost`` with ``C`` above
    every finite cost, so among maximum matchings the total cost is
    minimized exactly (the greedy selector is tested against this bound).

    Beyond that the pure-Python blossom stops being viable (minutes at
    N=2000) and the selector switches to
    ``scipy.optimize.linear_sum_assignment`` on the symmetric matrix
    (``min_cost_assignment_pairing``): near-optimal rather than exact, but
    fleet-scale — the appropriate bound estimator for the scaling
    benchmark (DESIGN.md §8 discusses when to prefer which).
    """
    n = cost.shape[0]
    if n > _BLOSSOM_EXACT_MAX_N:
        return min_cost_assignment_pairing(cost)
    import networkx as nx

    finite = cost[np.isfinite(cost)]
    hi = float(finite.max()) if finite.size else 1.0
    g = nx.Graph()
    g.add_nodes_from(range(n))
    for i in range(n):
        for j in range(i + 1, n):
            if np.isfinite(cost[i, j]):
                g.add_edge(i, j, weight=hi - float(cost[i, j]) + 1.0)
    mate = nx.max_weight_matching(g, maxcardinality=True)
    return sorted((min(i, j), max(i, j)) for i, j in mate)


def min_cost_assignment_pairing(cost: np.ndarray) -> Pairs:
    """Fleet-scale min-cost matching via the Hungarian relaxation.

    ``scipy.optimize.linear_sum_assignment`` on the symmetric cost (self-
    and non-finite edges priced prohibitively) yields a min-cost
    permutation; by symmetry it decomposes almost entirely into mutual
    2-cycles, which ARE matching pairs.  Vertices left on longer cycles
    are matched among themselves by the ascending-cost greedy, and the
    whole matching is polished by ``two_opt_refine`` — not exact like the
    blossom, but a tight bound at a solver cost of O(N^3) C-speed
    (ms at N=2000) instead of pure-Python blossom minutes.
    """
    from scipy.optimize import linear_sum_assignment

    n = cost.shape[0]
    finite = np.isfinite(cost)
    np.fill_diagonal(finite, False)
    hi = float(cost[finite].max()) if finite.any() else 1.0
    big = hi * n + 1.0
    c = np.where(finite, cost, big)
    _, sigma = linear_sum_assignment(c)
    mutual = (sigma[sigma] == np.arange(n)) & (sigma != np.arange(n))
    pairs = [(int(i), int(sigma[i])) for i in np.flatnonzero(mutual)
             if i < sigma[i]]
    leftover = np.flatnonzero(~mutual)
    if leftover.size >= 2:
        sub = greedy_pairing(-c[np.ix_(leftover, leftover)])
        pairs += [(int(leftover[x]), int(leftover[y])) for x, y in sub]
    return two_opt_refine(sorted(pairs), cost)


# ---------------------------------------------------------------------------
# PairingPolicy registry (mirrors planning's SplitPolicy)
# ---------------------------------------------------------------------------

PAIRING_SPECS = ("paper-weight", "random", "location", "compute",
                 "greedy-cost", "blossom-cost")
# Table-I mechanism names accepted as aliases ("fedpairing" is the paper's
# name for the paper-weight greedy); one resolver serves both vocabularies
# so an unknown mechanism raises at config-validation time, not mid-round.
MECHANISM_ALIASES = {"fedpairing": "paper-weight"}
TABLE1_MECHANISMS = ("fedpairing", "random", "location", "compute")


@dataclasses.dataclass(frozen=True)
class PairingContext:
    """Everything a pairing policy may consult.  Weight-heuristic policies
    only need the fleet/channel they are called with; cost-driven policies
    additionally need the stack depth, the workload model and the split
    policy whose optimal cuts price the edges.  ``rel_data`` optionally
    overrides dataset weights (full-fleet-normalized cohort weights);
    ``seed`` feeds the ``random`` mechanism (drawn from the driver rng);
    ``cache`` (a ``planning.PlannerCache``) lets the cost-matrix cut
    search be reused across rounds (DESIGN.md §8)."""

    num_layers: int = 0
    workload: Optional[object] = None
    split_policy: object = "paper"
    alpha: float = 1.0
    beta: float = 1.0
    rates: Optional[np.ndarray] = None
    rel_data: Optional[np.ndarray] = None
    seed: int = 0
    cache: Optional[planning.PlannerCache] = None
    # per-client failure probabilities (cohort-local, like rates/rel_data)
    # for reliability-aware edge pricing; None -> no reliability term
    fail: Optional[np.ndarray] = None
    # per-client cycles_per_layer (cohort-local, like rates/rel_data) for
    # device-class edge pricing; None -> the workload's own vector (full
    # fleet) or its fleet-global scalar
    cycles: Optional[np.ndarray] = None


class PairingPolicy:
    """A rule mapping (fleet, channel, context) to a matching."""

    spec: str = "?"
    cost_driven: bool = False        # True -> needs workload + num_layers

    def pair(self, fleet: ClientFleet, chan: Optional[ChannelModel],
             ctx: PairingContext) -> Pairs:
        raise NotImplementedError

    def bind(self, ctx: PairingContext):
        """Close over a context -> the historical ``PairFn`` signature
        (``participation.cohort_partner`` consumes either form)."""
        return lambda fleet, chan: self.pair(fleet, chan, ctx)


class PaperWeightPairing(PairingPolicy):
    """The paper's Alg. 1: greedy on the eps_ij weight heuristic — the
    default, bit-identical to the historical ``fedpairing_pairing``."""

    spec = "paper-weight"

    def pair(self, fleet, chan, ctx):
        return fedpairing_pairing(fleet, chan)


class RandomPairing(PairingPolicy):
    """Table-I random baseline; the seed comes from the context (the round
    driver draws it from its rng each round — no placeholder-None)."""

    spec = "random"

    def pair(self, fleet, chan, ctx):
        return random_pairing(fleet.n, seed=ctx.seed)


class LocationPairing(PairingPolicy):
    spec = "location"

    def pair(self, fleet, chan, ctx):
        return location_pairing(fleet, chan)


class ComputePairing(PairingPolicy):
    spec = "compute"

    def pair(self, fleet, chan, ctx):
        return compute_pairing(fleet, chan)


class _CostPairing(PairingPolicy):
    cost_driven = True

    def _select(self, cost: np.ndarray) -> Pairs:
        raise NotImplementedError

    def pair(self, fleet, chan, ctx):
        if ctx.workload is None or ctx.num_layers <= 0:
            raise ValueError(f"{self.spec} pairing needs num_layers and a "
                             f"workload model in the PairingContext")
        cost, _ = pair_cost_matrix(
            fleet, chan, ctx.num_layers, ctx.workload,
            split_policy=ctx.split_policy, alpha=ctx.alpha, beta=ctx.beta,
            rates=ctx.rates, rel_data=ctx.rel_data, cache=ctx.cache,
            fail=ctx.fail, cycles=ctx.cycles)
        return self._select(cost)


class GreedyCostPairing(_CostPairing):
    """Min-cost greedy on the true-latency cost matrix."""

    spec = "greedy-cost"

    def _select(self, cost):
        return min_cost_greedy_pairing(cost)


class BlossomCostPairing(_CostPairing):
    """Exact min-cost blossom matching on the cost matrix — the bound."""

    spec = "blossom-cost"

    def _select(self, cost):
        return min_cost_blossom_pairing(cost)


_POLICY_CLASSES = {cls.spec: cls for cls in
                   (PaperWeightPairing, RandomPairing, LocationPairing,
                    ComputePairing, GreedyCostPairing, BlossomCostPairing)}


def get_pairing_policy(spec) -> PairingPolicy:
    """Resolve a pairing-policy spec (``PAIRING_SPECS`` or a Table-I
    mechanism alias) to a PairingPolicy; instances pass through.  The ONE
    resolver behind ``RoundConfig`` validation, the launchers and the
    benchmarks — unknown specs raise here, at config time."""
    if isinstance(spec, PairingPolicy):
        return spec
    name = MECHANISM_ALIASES.get(spec, spec)
    cls = _POLICY_CLASSES.get(name)
    if cls is None:
        raise ValueError(f"unknown pairing policy {spec!r}; expected one "
                         f"of {PAIRING_SPECS} (or Table-I mechanism names "
                         f"{TABLE1_MECHANISMS})")
    return cls()


# ---------------------------------------------------------------------------
# helpers shared by the training core
# ---------------------------------------------------------------------------

def partner_permutation(pairs: Pairs, n: int) -> np.ndarray:
    """Involution p with p[i]=j for each pair; unpaired clients map to self."""
    p = np.arange(n)
    for i, j in pairs:
        p[i], p[j] = j, i
    return p


def validate_matching(pairs: Pairs, n: int) -> None:
    seen = set()
    for i, j in pairs:
        if i == j:
            raise ValueError(f"self-pair ({i},{j})")
        if i in seen or j in seen:
            raise ValueError(f"vertex reused in pair ({i},{j})")
        seen.update((i, j))
    if n % 2 == 0 and len(seen) != n:
        raise ValueError(f"matching not perfect: covered {len(seen)}/{n}")
