# Host-side numpy copy of repro/core/planning.py, kept in step with it: the
# parity tests hold the port's host traces bit-identical to the reference.
"""Round planning — the single source of truth for one round's split schedule.

Historically the per-pair split computation was scattered across four
layers with subtly different clamping semantics: ``latency.split_lengths``
(scalar), ``splitting.propagation_lengths`` (vectorized),
``rounds._server_cut`` (baseline cuts) and the per-engine ``split_ranges``
in ``fedbucket``/``fedpair_dist``.  This module centralizes all of it:

* the **paper rule** ``L_i = floor(f_i/(f_i+f_j) W)`` (Eq. 6), clamped to
  [1, W-1], in one scalar (`paper_cut`) and one vectorized
  (`paper_lengths`) form — every other module delegates here,
* a pluggable **SplitPolicy** registry (``paper`` | ``fixed:K`` |
  ``latency-opt``): the paper fixes the cut by the compute ratio alone,
  but its own Eq. (3) latency model says the optimal cut also depends on
  the pair's link rate and boundary payloads (cf. Wen et al., *Training
  Latency Minimization for Model-Splitting Allowed Federated Edge
  Learning*; Sun et al., *Split Federated Learning Over Heterogeneous
  Edge Devices*).  ``latency-opt`` searches every cut 1..W-1 per pair
  against the full per-pair latency (`pair_cost`) — never worse than the
  paper rule by construction, since the paper's cut is in the search set,
* the **RoundPlan** object — pairing involution, per-client lengths,
  active mask, server cut and the plan's Eq. (3)/(4) latency objective —
  consumed by the round driver, the fed step and the latency model.

This module is host-side numpy only (no jax) and imports nothing from
``repro_torch.core``, so every layer can depend on it without cycles.  Fleet,
channel and workload objects are duck-typed (``cpu_hz`` / ``data_sizes``
/ ``rates(chan)``; ``cycles_per_layer`` / ``feature_bytes`` / ...), see
``latency.ClientFleet`` / ``latency.WorkloadModel``.

See DESIGN.md §6 (Planning layer) for the contract.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

POLICY_SPECS = ("paper", "latency-opt", "fixed:K")


class PerClientShapeError(ValueError):
    """A per-client vector (``cycles_per_client``, ``cpu_scale``,
    ``extra_s``, ``fail``) does not match the fleet's client axis.

    Raised up front by the consumers that index such vectors by client
    id, so a short vector fails with its producer named instead of an
    opaque IndexError deep inside the batched arithmetic."""


def client_cycles(workload, n: Optional[int] = None
                  ) -> Optional[np.ndarray]:
    """The per-client ``cycles_per_layer`` vector of a workload, or None
    for fleet-global workloads (the scalar ``cycles_per_layer`` applies
    to every client).

    With ``n`` given the vector is validated against the fleet's client
    axis (``PerClientShapeError`` on mismatch) — every consumer that
    gathers cycles by client id calls this first, so a workload built
    for one fleet cannot silently misprice another (or a subfleet, whose
    callers must pass an explicitly subsetted vector)."""
    cyc = getattr(workload, "cycles_per_client", None) \
        if workload is not None else None
    if cyc is None:
        return None
    cyc = np.asarray(cyc, np.float64)
    if cyc.ndim != 1:
        raise PerClientShapeError(
            f"cycles_per_client must be a flat per-client vector, got "
            f"shape {cyc.shape}")
    if n is not None and len(cyc) != int(n):
        raise PerClientShapeError(
            f"cycles_per_client has {len(cyc)} entries but the fleet has "
            f"{int(n)} clients — per-client workloads are indexed by "
            f"client id (subset the vector when pricing a subfleet)")
    return cyc


# ---------------------------------------------------------------------------
# the paper's split rule — the ONE implementation
# ---------------------------------------------------------------------------

def paper_cut(f_i: float, f_j: float, num_layers: int,
              cyc_i: Optional[float] = None,
              cyc_j: Optional[float] = None) -> int:
    """Eq. (6): L_i = floor(f_i/(f_i+f_j) W), clamped to [1, W-1].

    ``f_i`` is the *canonical* (lower-index) member of the pair; its
    partner gets ``W - L_i`` so the pair always sums to W.  This (with
    its batched twin ``paper_cut_batch``) is the single implementation
    of the rule — the vectorized ``participation.propagation_lengths``
    is a thin wrapper.

    ``cyc_i``/``cyc_j`` generalize the rule to per-client per-layer
    costs (device classes): the ratio balances per-layer *throughput*
    ``tau = f / cycles`` instead of raw frequency, so the member that
    finishes a layer faster owns more of the stack.  Equal cycles
    cancel exactly — the historical expression is evaluated verbatim in
    that case, keeping fleet-global workloads bit-identical.
    """
    if cyc_i is not None and cyc_i != cyc_j:
        tau_i, tau_j = f_i / cyc_i, f_j / cyc_j
        li = int(np.floor(tau_i / (tau_i + tau_j) * num_layers))
    else:
        li = int(np.floor(f_i / (f_i + f_j) * num_layers))
    return min(max(li, 1), num_layers - 1)


def paper_cut_batch(f_i, f_j, num_layers: int, cyc_i=None,
                    cyc_j=None) -> np.ndarray:
    """Vectorized ``paper_cut`` over arrays of canonical-member pairs —
    the ONE batched form of the Eq. (6) rule (``paper_lengths``, the
    ``policy_cut_costs`` paper branch and the latency accounting's
    default split all delegate here).  ``cyc_*`` are optional per-member
    ``cycles_per_layer`` arrays (the throughput-balanced generalization;
    pairs with equal cycles take the historical expression exactly)."""
    f_i = np.asarray(f_i, np.float64)
    f_j = np.asarray(f_j, np.float64)
    if cyc_i is None:
        ratio = f_i / (f_i + f_j)
    else:
        cyc_i = np.asarray(cyc_i, np.float64)
        cyc_j = np.asarray(cyc_j, np.float64)
        tau_i, tau_j = f_i / cyc_i, f_j / cyc_j
        # equal-cycles pairs keep the cycle-free expression bit-exactly
        # (the ratio cancels mathematically; np.where makes it literal)
        ratio = np.where(cyc_i == cyc_j, f_i / (f_i + f_j),
                         tau_i / (tau_i + tau_j))
    base = np.floor(ratio * num_layers).astype(np.int64)
    return np.clip(base, 1, num_layers - 1)


def paper_lengths(f: np.ndarray, partner: np.ndarray,
                  num_layers: int,
                  cycles: Optional[np.ndarray] = None) -> np.ndarray:
    """Vectorized paper rule over a partner involution.

    The lower-indexed member of each pair is canonical (`paper_cut`); its
    partner gets the complement, so lengths sum to W exactly.  Self-paired
    clients get the full stack (L_i = W).  ``cycles`` is the optional
    (N,) per-client ``cycles_per_layer`` vector (``client_cycles``).
    """
    f = np.asarray(f, np.float64)
    partner = np.asarray(partner, np.int64)
    idx = np.arange(len(f))
    if cycles is None:
        base = paper_cut_batch(f, f[partner], num_layers)
    else:
        cycles = np.asarray(cycles, np.float64)
        base = paper_cut_batch(f, f[partner], num_layers,
                               cycles, cycles[partner])
    li = np.where(idx <= partner, base, num_layers - base[partner])
    return np.where(partner == idx, num_layers, li)


def partner_from_pairs(pairs: Sequence[Tuple[int, int]], n: int) -> np.ndarray:
    """Pair list -> partner involution; unpaired clients map to self."""
    partner = np.arange(n)
    for i, j in pairs:
        partner[i], partner[j] = j, i
    return partner


def resolve_server_cut(server_cut: int, num_layers: int) -> int:
    """Baseline (sl/splitfed) client-side depth; 0 -> W//2, floored at 1."""
    return server_cut or max(1, num_layers // 2)


# ---------------------------------------------------------------------------
# per-pair latency (Eq. 3) — the cost both the objective and the
# latency-opt policy evaluate
# ---------------------------------------------------------------------------

def boundary_bytes(w, cut: int) -> Tuple[float, float]:
    """Per-sample (feature, gradient) payload in **bytes** at a cut depth.

    Defaults to the workload's flat ``feature_bytes``/``grad_bytes`` (the
    paper models one representative boundary tensor); a workload may carry
    per-cut profiles (``feature_profile``/``grad_profile``, indexed by
    ``cut - 1`` for cuts 1..W-1) so the latency-opt policy can trade
    compute balance against a narrower boundary.
    """
    fp = getattr(w, "feature_profile", None)
    gp = getattr(w, "grad_profile", None)
    feat = w.feature_bytes if fp is None else float(fp[cut - 1])
    grad = w.grad_bytes if gp is None else float(gp[cut - 1])
    return feat, grad


def boundary_bytes_batch(w, cuts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized ``boundary_bytes``: (feature, gradient) **bytes** arrays
    for an int array of cut depths — same profile lookup, elementwise."""
    cuts = np.asarray(cuts, np.int64)
    fp = getattr(w, "feature_profile", None)
    gp = getattr(w, "grad_profile", None)
    feat = (np.full(cuts.shape, float(w.feature_bytes)) if fp is None
            else np.asarray(fp, np.float64)[cuts - 1])
    grad = (np.full(cuts.shape, float(w.grad_bytes)) if gp is None
            else np.asarray(gp, np.float64)[cuts - 1])
    return feat, grad


def pair_cost(f_i: float, f_j: float, rate_bps: float, w, li: int, lj: int,
              d_i: float = 1.0, d_j: float = 1.0, alpha: float = 1.0,
              beta: float = 1.0, fail_i: float = 0.0,
              fail_j: float = 0.0, cyc_i: Optional[float] = None,
              cyc_j: Optional[float] = None) -> float:
    """Eq. (3) wall time (**seconds**) of one pair's round at split
    (li, lj), weighted by the Problem-1 alpha/beta trade-off (Eq. 4's
    per-pair term).  ``f_*`` are CPU frequencies in Hz, ``rate_bps`` the
    link rate in bits/s (here bytes/s — see ``latency.ChannelModel``),
    ``d_*`` the relative dataset weights (unitless, sum to 1 fleet-wide).

    Compute: both flows run in parallel, phases balanced by the split, so
    each of the 2 phases (bottom+top) is bounded by the slower side;
    fwd+bwd doubles it.  Communication: boundary features one way +
    gradients back, per batch, dataset-size weighted (Problem 1's max
    term).  With ``alpha == beta == 1`` this is the Eq. (3) pair wall
    time of the round clock (``latency._pair_times_batch``).

    ``fail_*`` are the members' per-round failure probabilities (dropout /
    exhausted link outage, ``faults.FaultModel.fail_prob``): the cost
    becomes the EXPECTED latency until the pair delivers a round,
    ``cost / ((1 - fail_i)(1 - fail_j))`` — a geometric expected-attempts
    multiplier (cf. *Split Federated Learning Over Heterogeneous Edge
    Devices*, arXiv 2411.13907).  The multiplier is cut-independent, so
    it never changes a pair's optimal cut — only which pairs a joint
    matching builds its critical path through.  At the 0.0 default the
    divisor is exactly 1.0, so fault-free costs stay bit-identical.

    ``cyc_*`` override the workload's fleet-global ``cycles_per_layer``
    with the members' own per-layer costs (device classes, DESIGN.md
    §10); passing the same value as the scalar evaluates the identical
    expression, so all-equal per-client vectors stay bit-identical.
    """
    c_i = w.cycles_per_layer if cyc_i is None else cyc_i
    c_j = w.cycles_per_layer if cyc_j is None else cyc_j
    phase = max(li * c_i / f_i, lj * c_j / f_j)
    compute = 2.0 * 2.0 * phase
    # direction i->j carries flow i's boundary features (cut li) plus flow
    # j's boundary gradients (cut lj), and vice versa — each flow's payload
    # is priced at ITS OWN cut (only visible with per-cut profiles; flat
    # profiles reduce this to the historical symmetric expression)
    feat_i, grad_i = boundary_bytes(w, li)
    feat_j, grad_j = boundary_bytes(w, lj)
    comm = w.batch_size * max(d_i * feat_i + d_j * grad_j,
                              d_j * feat_j + d_i * grad_i) / rate_bps
    return (alpha * compute + beta * comm) \
        * w.batches_per_epoch * w.local_epochs \
        / ((1.0 - fail_i) * (1.0 - fail_j))


def pair_cost_batch(f_i, f_j, rate_bps, w, li, lj, d_i=1.0, d_j=1.0,
                    alpha: float = 1.0, beta: float = 1.0,
                    fail_i=0.0, fail_j=0.0, cyc_i=None,
                    cyc_j=None) -> np.ndarray:
    """Vectorized ``pair_cost``: Eq. (3) **seconds** over arrays of pairs.

    Elementwise over broadcastable arrays (``f_*`` in Hz, ``rate_bps`` in
    bytes/s, ``li``/``lj`` int cut depths, ``d_*`` unitless weights,
    ``fail_*`` per-member failure probabilities — the expected-latency
    reliability multiplier, see ``pair_cost``) — every arithmetic op
    mirrors the scalar ``pair_cost`` in the same order, so the results
    are bit-identical float64 (the property tests assert exact
    equality; at ``fail = 0.0`` the divisor is exactly 1.0).  This is
    the planning kernel behind the fleet-scale cost matrix
    (``pairing.pair_cost_matrix``), the vectorized ``policy_lengths``
    and the batched latency accounting
    (``latency.round_time_from_partner``).
    """
    f_i = np.asarray(f_i, np.float64)
    f_j = np.asarray(f_j, np.float64)
    li = np.asarray(li, np.int64)
    lj = np.asarray(lj, np.int64)
    c_i = w.cycles_per_layer if cyc_i is None else np.asarray(cyc_i, np.float64)
    c_j = w.cycles_per_layer if cyc_j is None else np.asarray(cyc_j, np.float64)
    phase = np.maximum(li * c_i / f_i, lj * c_j / f_j)
    compute = 2.0 * 2.0 * phase
    feat_i, grad_i = boundary_bytes_batch(w, li)
    feat_j, grad_j = boundary_bytes_batch(w, lj)
    comm = w.batch_size * np.maximum(d_i * feat_i + d_j * grad_j,
                                     d_j * feat_j + d_i * grad_i) / rate_bps
    return (alpha * compute + beta * comm) \
        * w.batches_per_epoch * w.local_epochs \
        / ((1.0 - np.asarray(fail_i, np.float64))
           * (1.0 - np.asarray(fail_j, np.float64)))


# ---------------------------------------------------------------------------
# split policies
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PairContext:
    """Everything a policy may consult when cutting one pair.  ``f_i`` is
    the canonical (lower-index) member; ``rate_bps``/``d_*`` feed the
    comm term; ``workload`` may be None for compute-only policies;
    ``fail_*`` are per-member failure probabilities (the expected-latency
    reliability multiplier of ``pair_cost`` — cut-independent, so it
    scales a policy's costs without moving its chosen cut); ``cyc_*``
    are the members' own per-layer cycle costs when the workload is
    per-client (device classes — None falls back to the workload's
    fleet-global scalar)."""

    f_i: float
    f_j: float
    num_layers: int
    rate_bps: float = float("inf")
    d_i: float = 1.0
    d_j: float = 1.0
    workload: Optional[object] = None
    alpha: float = 1.0
    beta: float = 1.0
    fail_i: float = 0.0
    fail_j: float = 0.0
    cyc_i: Optional[float] = None
    cyc_j: Optional[float] = None


class SplitPolicy:
    """A rule mapping one pair's context to the canonical member's cut.

    ``rate_aware`` declares whether the chosen cut depends on the channel
    realization (link rates): rate-independent policies (``paper``,
    ``fixed:K``) cut by compute/constants alone, so their cut search is
    drift-invariant and a ``PlannerCache`` entry never goes stale;
    rate-aware policies (``latency-opt``) must re-search when the channel
    drifts beyond the cache tolerance (DESIGN.md §8).
    """

    spec: str = "?"
    rate_aware: bool = False    # True -> the cut depends on link rates

    def pair_cut(self, ctx: PairContext) -> int:
        raise NotImplementedError

    def pair_cut_cost(self, ctx: PairContext) -> Tuple[int, float]:
        """(cut, Eq. (3) cost at that cut) in one call — what the joint
        cost-matrix pricing consumes; search policies override it so the
        search is not repeated to read off the winning cost."""
        li = self.pair_cut(ctx)
        return li, pair_cost(ctx.f_i, ctx.f_j, ctx.rate_bps, ctx.workload,
                             li, ctx.num_layers - li, ctx.d_i, ctx.d_j,
                             ctx.alpha, ctx.beta, ctx.fail_i, ctx.fail_j,
                             ctx.cyc_i, ctx.cyc_j)


class PaperSplitPolicy(SplitPolicy):
    """The paper's compute-ratio rule (Eq. 6; throughput-balanced under
    per-client cycle costs — see ``paper_cut``)."""

    spec = "paper"

    def pair_cut(self, ctx: PairContext) -> int:
        return paper_cut(ctx.f_i, ctx.f_j, ctx.num_layers,
                         ctx.cyc_i, ctx.cyc_j)


@dataclasses.dataclass(frozen=True)
class FixedSplitPolicy(SplitPolicy):
    """Every pair cuts at depth K (clamped to [1, W-1]) regardless of
    compute — the SplitFed-style uniform cut as a FedPairing policy."""

    k: int

    @property
    def spec(self) -> str:
        return f"fixed:{self.k}"

    def pair_cut(self, ctx: PairContext) -> int:
        return min(max(self.k, 1), ctx.num_layers - 1)


class LatencyOptSplitPolicy(SplitPolicy):
    """Search every cut 1..W-1 against the full Eq. (3) pair cost
    (compute max + link-rate-weighted boundary payloads).  The paper's
    cut is in the search set, so the chosen cut's cost is <= the paper
    rule's by construction; ties resolve to the shallowest cut."""

    spec = "latency-opt"
    rate_aware = True

    def pair_cut(self, ctx: PairContext) -> int:
        return self.pair_cut_cost(ctx)[0]

    def pair_cut_cost(self, ctx: PairContext) -> Tuple[int, float]:
        if ctx.workload is None:
            raise ValueError("latency-opt needs a workload model "
                             "(pass workload= to the plan builder)")
        W = ctx.num_layers
        costs = [pair_cost(ctx.f_i, ctx.f_j, ctx.rate_bps, ctx.workload,
                           cut, W - cut, ctx.d_i, ctx.d_j, ctx.alpha,
                           ctx.beta, ctx.fail_i, ctx.fail_j,
                           ctx.cyc_i, ctx.cyc_j)
                 for cut in range(1, W)]
        k = int(np.argmin(costs))
        return 1 + k, costs[k]


def get_policy(spec) -> SplitPolicy:
    """Resolve a policy spec string (``paper`` | ``latency-opt`` |
    ``fixed:K``) to a SplitPolicy; passes SplitPolicy instances through."""
    if isinstance(spec, SplitPolicy):
        return spec
    if spec == "paper":
        return PaperSplitPolicy()
    if spec == "latency-opt":
        return LatencyOptSplitPolicy()
    if isinstance(spec, str) and spec.startswith("fixed:"):
        try:
            k = int(spec.split(":", 1)[1])
        except ValueError:
            raise ValueError(f"fixed:K needs an integer K, got {spec!r}") \
                from None
        if k < 1:
            raise ValueError(f"fixed:K needs K >= 1, got {spec!r}")
        return FixedSplitPolicy(k)
    raise ValueError(f"unknown split policy {spec!r}; expected one of "
                     f"{POLICY_SPECS}")


def policy_cut_costs(policy, f_i, f_j, rates, d_i, d_j, workload,
                     num_layers: int, alpha: float = 1.0, beta: float = 1.0,
                     fail_i=0.0, fail_j=0.0, cyc_i=None, cyc_j=None
                     ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Vectorized ``SplitPolicy.pair_cut_cost`` over candidate-pair arrays.

    ``f_i`` is the canonical (lower-index) member of every candidate pair;
    all arguments are (P,) arrays (or scalars) over the candidates.
    Returns ``(cuts, costs)`` — the policy-chosen cut and its Eq. (3) cost
    per candidate, bit-identical to the scalar ``pair_cut_cost`` loop —
    or ``None`` for policies without a vectorized form (custom SplitPolicy
    subclasses), in which case callers fall back to the scalar path.
    With ``workload=None`` the rate-independent policies still return
    their cuts, with ``costs=None`` (mirroring the scalar ``pair_cut``,
    which never consults the workload for them).

    The ``latency-opt`` search batches over the candidate axis and loops
    the (small) cut axis 1..W-1 with a strict-improvement update, so ties
    resolve to the shallowest cut exactly like ``np.argmin``'s first-min
    and peak memory stays O(P), not O(P·W).
    """
    policy = get_policy(policy)
    f_i = np.asarray(f_i, np.float64)
    f_j = np.asarray(f_j, np.float64)
    W = int(num_layers)

    def priced(cuts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        if workload is None:
            return cuts, None
        return cuts, pair_cost_batch(f_i, f_j, rates, workload, cuts,
                                     W - cuts, d_i, d_j, alpha, beta,
                                     fail_i, fail_j, cyc_i, cyc_j)

    if isinstance(policy, PaperSplitPolicy):
        return priced(paper_cut_batch(f_i, f_j, W, cyc_i, cyc_j))
    if isinstance(policy, FixedSplitPolicy):
        k = min(max(policy.k, 1), W - 1)
        return priced(np.full(f_i.shape, k, np.int64))
    if isinstance(policy, LatencyOptSplitPolicy):
        if workload is None:
            raise ValueError("latency-opt needs a workload model "
                             "(pass workload= to the plan builder)")
        best_cut = np.full(f_i.shape, 1, np.int64)
        _, best = priced(best_cut)
        for cut in range(2, W):
            _, cost = priced(np.full(f_i.shape, cut, np.int64))
            upd = cost < best
            best = np.where(upd, cost, best)
            best_cut[upd] = cut
        return best_cut, best
    return None


def price_cuts(cuts, f_i, f_j, rates, d_i, d_j, workload, num_layers: int,
               alpha: float = 1.0, beta: float = 1.0,
               fail_i=0.0, fail_j=0.0, cyc_i=None, cyc_j=None) -> np.ndarray:
    """Re-price GIVEN per-candidate cuts on a (possibly drifted) channel:
    the O(P) half of a re-plan, with no O(P·W) cut re-search — what a
    ``PlannerCache`` hit executes (DESIGN.md §8)."""
    cuts = np.asarray(cuts, np.int64)
    return pair_cost_batch(np.asarray(f_i, np.float64),
                           np.asarray(f_j, np.float64), rates, workload,
                           cuts, int(num_layers) - cuts, d_i, d_j,
                           alpha, beta, fail_i, fail_j, cyc_i, cyc_j)


# ---------------------------------------------------------------------------
# cross-round cut-search cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _CacheEntry:
    cuts: np.ndarray        # (P,) policy-optimal cuts at fill time
    cost0: np.ndarray       # (P,) Eq. (3) costs on the FILL-time channel
    workload: object = None  # strong ref: an unhashable workload is keyed
                             # by id(), which is only unique while the
                             # object is alive — pinning it here makes a
                             # recycled-id false hit impossible


class PlannerCache:
    """Cross-round cut-search cache for ``pairing.pair_cost_matrix``.

    Entries are keyed on the **drift-invariant** identity of the planning
    problem — fleet CPU frequencies + dataset weights (positions, hence
    rates, excluded), workload model, split policy, stack depth and the
    alpha/beta trade-off — so a re-plan of a kept cohort finds its
    previous cut search.  On a hit the cached cuts are re-priced on the
    CURRENT rates (``price_cuts``, O(P)) instead of re-searched (O(P·W)):

    * rate-independent policies (``paper``, ``fixed:K``): the cached cuts
      are exact on any channel — the entry never goes stale;
    * rate-aware policies (``latency-opt``): the entry is reused while the
      re-priced costs moved less than ``tolerance`` (max relative Eq. (3)
      movement over candidate edges — the same relative-drift scale
      ``RoundConfig.replan_threshold`` consumes), else it is invalidated
      and the search re-runs on the drifted channel.

    ``last_status`` after each consult is one of ``"hit"`` (cuts reused),
    ``"miss"`` (no entry for the key), ``"invalidated"`` (entry drifted
    beyond tolerance, re-searched); counters accumulate for provenance
    (``RoundRecord.cut_cache``).  Holds at most ``max_entries`` problems
    (FIFO) so cohort-sampling drivers cache their recurring cohorts
    without unbounded growth.  See DESIGN.md §8 for the contract.
    """

    def __init__(self, tolerance: float = 0.0, max_entries: int = 8):
        if tolerance < 0:
            raise ValueError(f"tolerance must be >= 0, got {tolerance}")
        self.tolerance = float(tolerance)
        self.max_entries = int(max_entries)
        self._entries: Dict[Tuple, _CacheEntry] = {}
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self.last_status: str = "n/a"

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        """Drop every entry (the driver's explicit lifetime control)."""
        self._entries.clear()
        self.last_status = "n/a"

    @staticmethod
    def problem_key(fleet_cpu_hz, rel_data, workload, policy,
                    num_layers: int, alpha: float, beta: float,
                    fail=None, cycles=None) -> Tuple:
        """The drift-invariant identity of one cut-search problem.
        ``fail`` (per-client failure probabilities, the reliability
        pricing term) is part of the identity: the same cohort priced
        with and without reliability is a different problem.  So is
        ``cycles`` — the per-client ``cycles_per_layer`` vector actually
        used to price the candidates (cohort-local; defaults to the
        workload's own): hashed by VALUE (raw float64 bytes), so a
        device-class change can never reuse another class mix's cuts
        even for duck-typed workloads keyed by ``id()``, while pure
        channel-rate drift leaves the key (and any rate-independent
        entry) untouched."""
        pol = get_policy(policy)
        try:
            hash(workload)
            wkey = workload               # hashable -> equality-checked key
        except TypeError:                 # unhashable duck-typed workload
            wkey = id(workload)
        fkey = None if fail is None \
            else np.asarray(fail, np.float64).tobytes()
        if cycles is None:
            cycles = client_cycles(workload)
        ckey = None if cycles is None \
            else np.asarray(cycles, np.float64).tobytes()
        return (np.asarray(fleet_cpu_hz, np.float64).tobytes(),
                np.asarray(rel_data, np.float64).tobytes(),
                wkey, pol.spec, int(num_layers), float(alpha), float(beta),
                fkey, ckey)

    def consult(self, key: Tuple, rate_aware: bool,
                reprice: Callable[[np.ndarray], np.ndarray]
                ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Look up ``key``; on a valid entry return ``(cuts, costs)`` with
        costs re-priced on the current channel via ``reprice(cuts)``.
        Returns None (and records miss/invalidation) when the caller must
        run the full search and ``store`` the result."""
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            self.last_status = "miss"
            return None
        cost = reprice(entry.cuts)
        if rate_aware:
            drift = float(np.max(np.abs(cost - entry.cost0) / entry.cost0)) \
                if entry.cost0.size else 0.0
            if drift > self.tolerance:
                del self._entries[key]
                self.invalidations += 1
                self.last_status = "invalidated"
                return None
        self.hits += 1
        self.last_status = "hit"
        return entry.cuts, cost

    def store(self, key: Tuple, cuts: np.ndarray, cost0: np.ndarray,
              workload: object = None) -> None:
        """Record a fresh search (FIFO-evicting beyond ``max_entries``).
        Pass the ``workload`` so id-keyed (unhashable) workloads stay
        alive as long as their entry does (see ``_CacheEntry``)."""
        while len(self._entries) >= self.max_entries:
            del self._entries[next(iter(self._entries))]
        self._entries[key] = _CacheEntry(cuts=np.array(cuts, np.int64),
                                         cost0=np.array(cost0, np.float64),
                                         workload=workload)


def policy_lengths(f: np.ndarray, partner: np.ndarray, num_layers: int,
                   policy="paper", *, rates: Optional[np.ndarray] = None,
                   rel_data: Optional[np.ndarray] = None, workload=None,
                   alpha: float = 1.0, beta: float = 1.0) -> np.ndarray:
    """Per-client propagation lengths under a split policy.

    ``rates`` is the (N, N) link-rate matrix (bytes/s) and ``rel_data``
    the relative dataset weights — consulted by rate-aware policies;
    omitted, the comm term sees an infinite-rate link.  Self-paired
    clients always get the full stack.  Built-in policies take the
    vectorized path (``policy_cut_costs`` over the canonical pairs);
    custom SplitPolicy subclasses fall back to the scalar per-pair loop.
    A per-client workload (``cycles_per_client``, validated against
    ``len(f)``) makes every cut flow-asymmetric: each member's side of
    the search is priced at its own per-layer cost.
    """
    policy = get_policy(policy)
    f = np.asarray(f, np.float64)
    partner = np.asarray(partner, np.int64)
    cyc = client_cycles(workload, len(f))
    if isinstance(policy, PaperSplitPolicy):      # fully closed-form
        return paper_lengths(f, partner, num_layers, cycles=cyc)
    lengths = np.full(len(f), num_layers, np.int64)
    ci = np.flatnonzero(np.arange(len(f)) < partner)   # canonical members
    if ci.size == 0:
        return lengths
    cj = partner[ci]
    batched = policy_cut_costs(
        policy, f[ci], f[cj],
        rates[ci, cj] if rates is not None else float("inf"),
        rel_data[ci] if rel_data is not None else 1.0,
        rel_data[cj] if rel_data is not None else 1.0,
        workload, num_layers, alpha, beta,
        cyc_i=cyc[ci] if cyc is not None else None,
        cyc_j=cyc[cj] if cyc is not None else None)
    if batched is not None:
        cuts, _ = batched
        lengths[ci] = cuts
        lengths[cj] = num_layers - cuts
        return lengths
    for i, j in zip(ci, cj):                      # custom-policy fallback
        ctx = PairContext(
            f_i=float(f[i]), f_j=float(f[j]), num_layers=num_layers,
            rate_bps=(float(rates[i, j]) if rates is not None
                      else float("inf")),
            d_i=float(rel_data[i]) if rel_data is not None else 1.0,
            d_j=float(rel_data[j]) if rel_data is not None else 1.0,
            workload=workload, alpha=alpha, beta=beta,
            cyc_i=float(cyc[i]) if cyc is not None else None,
            cyc_j=float(cyc[j]) if cyc is not None else None)
        li = int(policy.pair_cut(ctx))
        if not 1 <= li <= num_layers - 1:
            raise ValueError(f"policy {policy.spec!r} cut {li} outside "
                             f"[1, {num_layers - 1}] for pair ({i},{j})")
        lengths[i], lengths[j] = li, num_layers - li
    return lengths


# ---------------------------------------------------------------------------
# the RoundPlan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RoundPlan:
    """Single source of truth for one round's split schedule.

    ``kind`` states what the lengths mean:

    * ``paired``       — FedPairing: ``partner`` is the pairing involution,
                         ``lengths[i]`` is client i's own-flow depth
                         (self-paired => full stack),
    * ``server-split`` — sl/splitfed baselines: ``lengths`` is the
                         client-side depth (``server_cut``) for active
                         clients, W for inactive; partner is identity,
    * ``local``        — vanilla FL: everyone runs the full stack.

    ``objective`` is the Eq. (4) weighted sum of per-pair Eq. (3) costs
    (seconds) over the active pairs (None when no workload model was
    supplied).
    The plan is hashable; ``cache_key()`` is what the engines' step caches
    key on (everything that affects a compiled step's shape).
    """

    kind: str
    policy: str
    num_layers: int
    partner: Tuple[int, ...]
    lengths: Tuple[int, ...]
    active: Tuple[bool, ...]
    pairs: Tuple[Tuple[int, int], ...]
    server_cut: int
    granularity: int = 1
    objective: Optional[float] = None
    # provenance of the matching (a PairingPolicy spec; "n/a" for the
    # baseline plans) and, for jointly built plans, the sequential
    # (pair-then-cut) reference objective the joint search is asserted
    # against — neither is part of cache_key (same schedule, same compile).
    pair_policy: str = "paper-weight"
    seq_objective: Optional[float] = None
    # the per-client cycles_per_layer vector the plan was priced under
    # (None for fleet-global workloads).  Part of cache_key: a kept plan
    # must never serve a fleet whose device classes changed, even when
    # the schedule (partner/lengths) happens to coincide.
    cycles: Optional[Tuple[float, ...]] = None

    @property
    def n(self) -> int:
        return len(self.partner)

    def partner_array(self) -> np.ndarray:
        return np.asarray(self.partner, np.int64)

    def lengths_array(self) -> np.ndarray:
        return np.asarray(self.lengths, np.int64)

    def active_array(self) -> np.ndarray:
        return np.asarray(self.active, bool)

    def cache_key(self) -> Tuple:
        """What a pairing-specialized compiled step depends on."""
        return (self.kind, self.partner, self.lengths, self.granularity,
                self.cycles)

    def validate(self) -> "RoundPlan":
        """Check the plan invariants; returns self (chainable)."""
        n, W = self.n, self.num_layers
        partner = self.partner_array()
        lengths = self.lengths_array()
        if not np.array_equal(partner[partner], np.arange(n)):
            raise ValueError(f"partner is not an involution: {self.partner}")
        if np.any(lengths < 1) or np.any(lengths > W):
            raise ValueError(f"lengths outside [1, {W}]: {self.lengths}")
        if self.kind == "paired":
            for i in range(n):
                j = int(partner[i])
                if j == i:
                    if lengths[i] != W:
                        raise ValueError(
                            f"self-paired client {i} must own the full "
                            f"stack, got L={lengths[i]} (W={W})")
                elif lengths[i] + lengths[j] != W:
                    raise ValueError(
                        f"pair ({i},{j}) lengths {lengths[i]}+{lengths[j]} "
                        f"!= W={W}")
            act = self.active_array()
            for i, j in self.pairs:
                if not (act[i] and act[j]):
                    raise ValueError(f"pair ({i},{j}) not inside the "
                                     f"active cohort")
        return self


def _active_pairs(partner: np.ndarray,
                  active: np.ndarray) -> Tuple[Tuple[int, int], ...]:
    return tuple(sorted((int(i), int(partner[i]))
                        for i in range(len(partner))
                        if active[i] and partner[i] > i))


def _pairs_objective(pairs, lengths, cpu_hz, rates, rel, workload,
                     alpha: float, beta: float, fail=None) -> float:
    """Eq. (4): the weighted sum of per-pair Eq. (3) costs (seconds) at
    the GIVEN lengths — the one arithmetic shared by the plan builders and
    the adaptive re-pricing of a kept plan on a drifted channel.
    Vectorized over the pairs (``pair_cost_batch``); ``fail`` is the
    optional (N,) reliability-pricing vector (see ``pair_cost``)."""
    if not pairs:
        return 0.0
    idx = np.asarray(pairs, np.int64)
    i, j = idx[:, 0], idx[:, 1]
    cpu = np.asarray(cpu_hz, np.float64)
    rel = np.asarray(rel, np.float64)
    lengths = np.asarray(lengths, np.int64)
    rate = rates[i, j] if rates is not None else float("inf")
    if fail is None:
        fi = fj = 0.0
    else:
        fail = np.asarray(fail, np.float64)
        fi, fj = fail[i], fail[j]
    cyc = client_cycles(workload, len(cpu))
    return float(np.sum(pair_cost_batch(
        cpu[i], cpu[j], rate, workload, lengths[i], lengths[j],
        rel[i], rel[j], alpha, beta, fi, fj,
        cyc_i=cyc[i] if cyc is not None else None,
        cyc_j=cyc[j] if cyc is not None else None)))


def plan_objective(plan: "RoundPlan", fleet, chan, workload,
                   alpha: float = 1.0, beta: float = 1.0,
                   rates: Optional[np.ndarray] = None,
                   fail: Optional[np.ndarray] = None) -> float:
    """Re-price an existing plan's SCHEDULE (pairs + lengths, unchanged)
    on a fleet/channel realization: the Eq. (4) objective (seconds, the
    alpha/beta-weighted sum of per-pair Eq. (3) costs) at the CURRENT
    rates — what the adaptive round driver compares against
    ``replan_threshold`` to decide whether the channel drift is worth a
    re-matching (and a recompile).  Vectorized over the pairs, so
    re-pricing a kept fleet-scale plan is O(N), not a search."""
    if rates is None and chan is not None:
        rates = fleet.rates(chan)
    rel = np.asarray(fleet.data_sizes, np.float64)
    rel = rel / rel.sum()
    return _pairs_objective(plan.pairs, plan.lengths_array(), fleet.cpu_hz,
                            rates, rel, workload, alpha, beta, fail)


def build_round_plan(fleet, chan, partner, num_layers: int, *,
                     policy="paper", workload=None,
                     active: Optional[np.ndarray] = None,
                     granularity: int = 1, server_cut: int = 0,
                     alpha: float = 1.0, beta: float = 1.0,
                     rates: Optional[np.ndarray] = None,
                     fail: Optional[np.ndarray] = None) -> RoundPlan:
    """Build the FedPairing plan for one round.

    ``fleet``/``chan`` are duck-typed (``latency.ClientFleet`` /
    ``ChannelModel``); ``rates`` overrides ``fleet.rates(chan)``.  The
    Eq. (4) objective is computed over the active pairs with the SAME
    per-pair cost the latency-opt policy minimizes, which is what makes
    ``latency-opt``'s objective <= ``paper``'s by construction.
    ``fail`` (optional (N,) per-client failure probabilities) prices the
    objective with the expected-latency reliability multiplier (see
    ``pair_cost``); the multiplier is cut-independent, so the cut search
    itself is unaffected.
    """
    n = fleet.n
    partner = np.asarray(partner, np.int64)
    act = np.ones(n, bool) if active is None else np.asarray(active, bool)
    if rates is None and chan is not None:
        rates = fleet.rates(chan)
    rel = np.asarray(fleet.data_sizes, np.float64)
    rel = rel / rel.sum()
    pol = get_policy(policy)
    lengths = policy_lengths(fleet.cpu_hz, partner, num_layers, pol,
                             rates=rates, rel_data=rel, workload=workload,
                             alpha=alpha, beta=beta)
    pairs = _active_pairs(partner, act)
    objective = None
    if workload is not None:
        objective = _pairs_objective(pairs, lengths, fleet.cpu_hz, rates,
                                     rel, workload, alpha, beta, fail)
    cyc = client_cycles(workload, n)
    return RoundPlan(
        kind="paired", policy=pol.spec, num_layers=num_layers,
        partner=tuple(int(p) for p in partner),
        lengths=tuple(int(l) for l in lengths),
        active=tuple(bool(a) for a in act), pairs=pairs,
        server_cut=resolve_server_cut(server_cut, num_layers),
        granularity=max(1, int(granularity)),
        objective=objective,
        cycles=None if cyc is None else tuple(float(c) for c in cyc)
        ).validate()


def build_joint_plan(fleet, chan, num_layers: int, *,
                     pair_policy="greedy-cost", split_policy="latency-opt",
                     workload=None, active: Optional[np.ndarray] = None,
                     granularity: int = 1, server_cut: int = 0,
                     alpha: float = 1.0, beta: float = 1.0,
                     rates: Optional[np.ndarray] = None,
                     seed: int = 0,
                     cache: Optional[PlannerCache] = None,
                     fail: Optional[np.ndarray] = None) -> RoundPlan:
    """Solve Problem 1 jointly: pairing AND cuts chosen together.

    The pairing policy sees the true Eq. (3) cost of every candidate edge
    at its ``split_policy``-optimal cut (``pairing.pair_cost_matrix``, the
    vectorized planning kernel); the winning matching is then cut by the
    same policy, so the plan's Eq. (4) objective equals the matrix sum
    over the selected edges.  The returned plan is the BETTER of the joint
    candidate and the sequential (paper-weight Alg.-1 pairing, then cuts)
    reference — hence its objective is <= the sequential
    ``build_round_plan``'s **by construction**, even for selectors without
    an optimality guarantee (the ascending greedy) and even when a
    ``cache`` hit priced the candidate edges at slightly-stale cuts (the
    final comparison always uses freshly-searched true objectives).  The
    reference objective is recorded as ``seq_objective``.

    Cohort sub-problems (``active``) are priced with FULL-fleet-normalized
    dataset weights so the joint objective is exactly comparable to the
    sequential plan built over the same cohort.  ``seed`` feeds the
    ``random`` pairing policy (the driver draws it from its rng);
    ``cache`` is the cross-round ``PlannerCache`` the cost-matrix cut
    search consults (DESIGN.md §8).  ``fail`` ((N,) per-client failure
    probabilities, ``faults.FaultModel.fail_prob``) prices every
    candidate edge with the expected-latency reliability multiplier, so
    the matching avoids building critical paths through flaky clients —
    both the joint candidate and the sequential reference are priced
    with it, keeping the joint <= sequential contract coherent.
    """
    from repro_torch.core import latency as latency_mod
    from repro_torch.core import pairing as pairing_mod

    if workload is None:
        raise ValueError("build_joint_plan needs a workload model (joint "
                         "pairing prices edges by their Eq. (3) cost)")
    n = fleet.n
    act = np.ones(n, bool) if active is None else np.asarray(active, bool)
    cohort = np.flatnonzero(act)
    if rates is None and chan is not None:
        rates = fleet.rates(chan)
    rel = np.asarray(fleet.data_sizes, np.float64)
    rel = rel / rel.sum()
    sub = latency_mod.subfleet(fleet, cohort)
    pol = pairing_mod.get_pairing_policy(pair_policy)
    cyc = client_cycles(workload, n)
    ctx = pairing_mod.PairingContext(
        num_layers=num_layers, workload=workload, split_policy=split_policy,
        alpha=alpha, beta=beta, seed=seed, cache=cache,
        rates=(rates[np.ix_(cohort, cohort)] if rates is not None else None),
        rel_data=rel[cohort],
        fail=(np.asarray(fail, np.float64)[cohort] if fail is not None
              else None),
        cycles=cyc[cohort] if cyc is not None else None)

    def plan_for(sub_pairs):
        partner = np.arange(n)
        for a, b in sub_pairs:
            ga, gb = int(cohort[a]), int(cohort[b])
            partner[ga], partner[gb] = gb, ga
        return build_round_plan(
            fleet, chan, partner, num_layers, policy=split_policy,
            workload=workload, active=act, granularity=granularity,
            server_cut=server_cut, alpha=alpha, beta=beta, rates=rates,
            fail=fail)

    seq_plan = plan_for(pairing_mod.fedpairing_pairing(sub, chan))
    if pol.spec == "paper-weight":
        candidate = seq_plan
    else:
        candidate = plan_for(pol.pair(sub, chan, ctx))
    # pair_policy records the provenance of the matching actually chosen:
    # when the candidate loses to the sequential reference, the executed
    # pairing IS the paper-weight greedy's.
    if candidate.objective <= seq_plan.objective:
        chosen, spec = candidate, pol.spec
    else:
        chosen, spec = seq_plan, "paper-weight"
    return dataclasses.replace(chosen, pair_policy=spec,
                               seq_objective=seq_plan.objective)


