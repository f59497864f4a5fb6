"""Multi-round federated simulation driver (counterpart of
``repro/core/rounds.py``, algorithm ``fedpairing`` on the ``vmapped``
engine).

Each round the driver, in this fixed order (the reference's determinism
contract, DESIGN.md §5):

1. realizes the time-varying channel (``latency.drift_fleet``; no rng draw
   when ``drift_sigma_m <= 0``),
2. samples the participating cohort (``participation.sample_cohort``),
3. draws the pairing seed and plans the round (``planning.RoundPlan``:
   pairing, split lengths, Eq. (4) objective), re-using the previous plan
   under ``replan_threshold`` as the reference does,
4. executes ``batches_per_round`` fed steps (``fedpair.make_fed_step``
   built with ``lr / N``, the reference's engine normalization),
5. aggregates over the cohort and broadcasts,
6. accumulates the Eq. (3) simulated wall-clock.

All host randomness flows from ONE ``np.random.Generator`` seeded with
``RoundConfig.seed`` and consumed in that order, so the port's cohort,
pair, length and simulated-time traces equal the reference's.

Not ported yet (each raises at ``RoundConfig`` construction and names its
ROADMAP item): the baselines fl / sl / splitfed (A.8), the bucketed (A.7)
and dist (A.11) engines, fault injection and checkpoints (A.9), async
rounds and the scaffold policy (A.10).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import aggregation, fedpair, latency, pairing
from repro_torch.core import participation, planning, splitting
from repro_torch.core.latency import ChannelModel, ClientFleet, WorkloadModel
from repro_torch.core.planning import RoundPlan
from repro_torch.tree import tree_items, tree_map

ALGORITHMS = ("fedpairing",)
ENGINES = ("vmapped",)
PAIRINGS: Tuple[str, ...] = pairing.TABLE1_MECHANISMS

_NOT_PORTED = {
    "algorithm": "the fl / sl / splitfed baselines are ROADMAP item A.8",
    "engine": "the bucketed engine is ROADMAP item A.7, the dist engine "
              "A.11",
}


@dataclasses.dataclass(frozen=True)
class RoundConfig:
    """Static knobs of the multi-round loop (see module docstring)."""

    algorithm: str = "fedpairing"
    engine: str = "vmapped"
    rounds: int = 3
    batches_per_round: int = 4
    participation: float = 1.0          # cohort fraction per round
    drift_sigma_m: float = 0.0          # channel realization: position walk
    pair_mechanism: str = "fedpairing"  # Table-I mechanisms (PAIRINGS)
    pair_policy: str = ""               # pairing.PAIRING_SPECS; "" -> the
                                        # Table-I mechanism above
    split_policy: str = "paper"         # paper | fixed:K | latency-opt
    replan_threshold: float = 0.0       # keep the previous plan while its
                                        # re-priced objective moved less
    cut_cache: bool = True              # cross-round cut-search cache
    lr: float = 0.05
    aggregation: str = "paper"          # paper | fedavg (DESIGN.md §3)
    agg_policy: str = "mean"            # mean (scaffold: ROADMAP A.10)
    overlap_boost: bool = True
    bucket_granularity: int = 1
    server_cut: int = 0
    donate: bool = True                 # in-place SGD write in the step
    seed: int = 0
    faults: Optional[object] = None     # fault injection: ROADMAP A.9
    async_rounds: bool = False          # async rounds: ROADMAP A.10

    def __post_init__(self):
        for field, supported in (("algorithm", ALGORITHMS),
                                 ("engine", ENGINES)):
            value = getattr(self, field)
            if value not in supported:
                raise NotImplementedError(
                    f"{field}={value!r} is not ported yet; "
                    f"{_NOT_PORTED[field]}")
        if self.faults is not None:
            raise NotImplementedError(
                "fault injection is not ported yet (ROADMAP item A.9)")
        if self.async_rounds:
            raise NotImplementedError(
                "async rounds are not ported yet (ROADMAP item A.10)")
        if not 0.0 < self.participation <= 1.0:
            raise ValueError(f"participation must lie in (0, 1], got "
                             f"{self.participation} (a cohort fraction)")
        if self.batches_per_round < 1:
            raise ValueError(f"batches_per_round must be >= 1, got "
                             f"{self.batches_per_round}")
        if self.pair_mechanism not in PAIRINGS:
            raise ValueError(f"pair_mechanism must be one of "
                             f"{PAIRINGS}, got {self.pair_mechanism!r}")
        if self.pair_policy and self.pair_mechanism != "fedpairing":
            raise ValueError(
                f"pair_policy={self.pair_policy!r} and pair_mechanism="
                f"{self.pair_mechanism!r} are one knob — set at most one")
        pairing.get_pairing_policy(self.resolved_pair_policy)
        planning.get_policy(self.split_policy)   # raises on unknown spec
        if self.replan_threshold < 0:
            raise ValueError(f"replan_threshold must be >= 0, got "
                             f"{self.replan_threshold}")
        if self.aggregation not in ("paper", "fedavg"):
            raise ValueError(f"aggregation must be 'paper' or 'fedavg', "
                             f"got {self.aggregation!r}")
        aggregation.get_aggregation_policy(self.agg_policy)

    @property
    def resolved_pair_policy(self) -> str:
        return self.pair_policy or self.pair_mechanism


@dataclasses.dataclass(frozen=True)
class RoundRecord:
    """Per-round trace entry (host-side; tuples so traces compare ==)."""

    round: int
    cohort: Tuple[int, ...]
    pairs: Tuple[Tuple[int, int], ...]   # global ids, i < j, sorted
    lengths: Tuple[int, ...]             # (N,) propagation lengths
    mean_loss: float                     # over the active cohort
    sim_round_s: float                   # Eq. (3) straggler-bounded
    sim_total_s: float                   # accumulated simulated wall-clock
    cached_steps: int                    # built fed steps (always 1 here)
    objective: Optional[float] = None    # Eq. (4) of the executed plan
    replanned: bool = True               # False -> adaptive keep
    cut_cache: str = "n/a"               # hit | miss | invalidated | kept |
                                         # n/a (weight policy / no cache)
    status: str = "ok"                   # ok | empty (zero-client cohort)
    wait_s: float = 0.0                  # barrier idle summed over units

    def __eq__(self, other):
        # NaN-aware float compare: empty rounds record mean_loss = nan
        if not isinstance(other, RoundRecord):
            return NotImplemented
        for f in dataclasses.fields(self):
            a, b = getattr(self, f.name), getattr(other, f.name)
            if isinstance(a, float) and isinstance(b, float):
                if a != b and not (a != a and b != b):
                    return False
            elif a != b:
                return False
        return True


@dataclasses.dataclass
class RoundState:
    """Everything that survives from round to round."""

    round: int
    fleet: ClientFleet                   # current channel realization
    client_params: Dict                  # stacked (N, ...)
    rng: np.random.Generator
    sim_time_s: float
    history: List[RoundRecord]
    plan: Optional[RoundPlan] = None     # adaptive anchor plan


class _VmappedEngine:
    """The parameter-mix core with the client axis written out."""

    def __init__(self, cfg, rc: RoundConfig, n: int, gparams: Dict,
                 loss_fn: Callable, unread: Sequence[str] = ()):
        plan = splitting.split_plan(cfg, gparams)
        fed_cfg = fedpair.FedPairingConfig(
            lr=rc.lr / n, overlap_boost=rc.overlap_boost,
            aggregation=rc.aggregation, donate=rc.donate)
        self._step = fedpair.make_fed_step(loss_fn, plan, cfg.num_layers,
                                           fed_cfg, unread=unread)
        self.cached_steps = 1

    def step(self, params, batch, plan: RoundPlan, agg_w):
        new, m = self._step(params, batch, plan.partner_array(),
                            plan.lengths_array(), agg_w)
        return new, m["loss"]


class RoundDriver:
    """Owns the per-round loop for one fleet.

    ``batch_fn`` yields one client-axis-stacked batch tree per call
    (leading dim N); the driver calls it exactly ``batches_per_round``
    times per round.  ``loss_fn`` defaults to the LM registry's loss over
    the stacked trees and returns the (N,) flow losses.  ``params`` are
    the initial global params (e.g. the reference's, converted by
    ``checkpoint.convert.params_from_jax``); by default they are drawn
    from ``registry.init_params(cfg, rc.seed, device)``.
    """

    def __init__(self, cfg, rc: RoundConfig, fleet: ClientFleet,
                 chan: Optional[ChannelModel] = None,
                 workload: Optional[WorkloadModel] = None,
                 batch_fn: Optional[Callable[[], Dict]] = None,
                 loss_fn: Optional[Callable] = None,
                 params: Optional[Dict] = None,
                 device="cuda"):
        from repro_torch.models import registry
        self.cfg = cfg
        self.rc = rc
        self.fleet0 = fleet
        self.n = fleet.n
        self.device = torch.device(device)
        self.chan = chan or ChannelModel()
        self.workload = workload or WorkloadModel(
            num_layers=cfg.num_layers,
            batches_per_epoch=rc.batches_per_round, local_epochs=1)
        planning.client_cycles(self.workload, self.n)   # validate once
        self.loss_fn = loss_fn or (lambda p, b: registry.loss_fn(p, b, cfg)[0])
        self.batch_fn = _validated_batch_fn(
            batch_fn or make_lm_batch_fn(cfg, self.n, seed=rc.seed,
                                         device=self.device), self.n)
        self._gparams = (registry.init_params(cfg, rc.seed, self.device)
                         if params is None else params)
        self._cost_driven = pairing.get_pairing_policy(
            rc.resolved_pair_policy).cost_driven
        self.plan_cache = planning.PlannerCache(
            tolerance=rc.replan_threshold) \
            if (rc.cut_cache and self._cost_driven) else None
        self.agg_policy = aggregation.get_aggregation_policy(rc.agg_policy)
        self._engine = _VmappedEngine(cfg, rc, self.n, self._gparams,
                                      self.loss_fn,
                                      unread=registry.unread_leaves(cfg))

    # -- state ------------------------------------------------------------

    def init_state(self) -> RoundState:
        return RoundState(round=0, fleet=self.fleet0,
                          client_params=fedpair.replicate(self._gparams,
                                                          self.n),
                          rng=np.random.default_rng(self.rc.seed),
                          sim_time_s=0.0, history=[])

    def global_params(self, state: RoundState) -> Dict:
        """The post-broadcast global model: row 0 of the stacked tree."""
        return tree_map(lambda a: a[0], state.client_params)

    def run(self, state: Optional[RoundState] = None,
            rounds: Optional[int] = None) -> RoundState:
        state = state or self.init_state()
        for _ in range(self.rc.rounds if rounds is None else rounds):
            state = self.run_round(state)
        return state

    # -- one round --------------------------------------------------------

    def run_round(self, state: RoundState) -> RoundState:
        """One round.  The input state's rng is deep-copied and its history
        is never mutated; with the default ``donate=True`` the step updates
        the input parameter tensors in place."""
        rc = self.rc
        rng = copy.deepcopy(state.rng)
        fleet = latency.drift_fleet(state.fleet, rng, rc.drift_sigma_m)
        cohort = participation.sample_cohort(self.n, rc.participation, rng)
        # pairing seed: drawn every round, after cohort sampling, so the
        # rng stream matches the reference; only 'random' consumes it
        pair_seed = int(rng.integers(2 ** 31))
        active = np.zeros(self.n, bool)
        active[cohort] = True
        if cohort.size == 0:
            record, client, plan = self._empty_round(state, cohort)
        else:
            record, client, plan = self._fedpairing_round(
                state, fleet, cohort, active, pair_seed)
        return dataclasses.replace(
            state, round=state.round + 1, fleet=fleet, client_params=client,
            rng=rng, sim_time_s=record.sim_total_s,
            history=state.history + [record], plan=plan)

    def _record(self, state, cohort, pairs, lengths, mean_loss, round_s,
                objective=None, replanned=True, cut_cache="n/a",
                status="ok", wait_s=0.0) -> RoundRecord:
        return RoundRecord(
            round=state.round, cohort=tuple(int(c) for c in cohort),
            pairs=pairs, lengths=tuple(int(l) for l in lengths),
            mean_loss=float(mean_loss), sim_round_s=float(round_s),
            sim_total_s=float(state.sim_time_s + round_s),
            cached_steps=self._engine.cached_steps,
            objective=None if objective is None else float(objective),
            replanned=bool(replanned), cut_cache=str(cut_cache),
            status=str(status), wait_s=float(wait_s))

    def _empty_round(self, state, cohort):
        """A participation fraction that rounds to zero clients: params
        untouched, zero simulated seconds, mean_loss = nan; the data stream
        still advances ``batches_per_round`` calls."""
        for _ in range(self.rc.batches_per_round):
            self.batch_fn()
        rec = self._record(state, cohort, (),
                           (self.cfg.num_layers,) * self.n, float("nan"),
                           0.0, replanned=False, status="empty")
        return rec, state.client_params, state.plan

    def round_plan(self, fleet: ClientFleet, partner: np.ndarray,
                   active: np.ndarray, num_layers: Optional[int] = None
                   ) -> RoundPlan:
        """The round's RoundPlan — the single source of truth the engine,
        the latency accounting and the trace record all consume."""
        rc = self.rc
        return planning.build_round_plan(
            fleet, self.chan, partner,
            self.cfg.num_layers if num_layers is None else num_layers,
            policy=rc.split_policy, workload=self.workload, active=active,
            granularity=rc.bucket_granularity, server_cut=rc.server_cut)

    def _latency_plan(self, fleet, partner, active, plan) -> RoundPlan:
        """The plan the Eq. (3) clock is evaluated on: the executed plan,
        re-planned at the workload's depth when that differs."""
        if self.workload.num_layers == plan.num_layers:
            return plan
        return self.round_plan(fleet, partner, active,
                               num_layers=self.workload.num_layers)

    def _build_plan(self, fleet, cohort, active, pair_seed: int) -> RoundPlan:
        """One fresh re-matching under the configured pairing policy."""
        rc = self.rc
        policy = pairing.get_pairing_policy(rc.resolved_pair_policy)
        if policy.cost_driven:
            return planning.build_joint_plan(
                fleet, self.chan, self.cfg.num_layers, pair_policy=policy,
                split_policy=rc.split_policy, workload=self.workload,
                active=active, granularity=rc.bucket_granularity,
                server_cut=rc.server_cut, seed=pair_seed,
                cache=self.plan_cache)
        ctx = pairing.PairingContext(
            num_layers=self.cfg.num_layers, workload=self.workload,
            split_policy=rc.split_policy, seed=pair_seed)
        partner, _ = participation.cohort_partner(fleet, self.chan, cohort,
                                                  policy, ctx=ctx)
        return self.round_plan(fleet, partner, active)

    def _adaptive_plan(self, state: RoundState, fleet, cohort, active,
                       pair_seed: int) -> Tuple[RoundPlan, RoundPlan, bool]:
        """(executed plan, anchor plan, replanned), as in the reference."""
        rc = self.rc
        prev = state.plan
        if (rc.replan_threshold > 0 and prev is not None
                and prev.active == tuple(bool(a) for a in active)):
            new_obj = planning.plan_objective(prev, fleet, self.chan,
                                              self.workload)
            if abs(new_obj - prev.objective) \
                    <= rc.replan_threshold * abs(prev.objective):
                kept = dataclasses.replace(prev, objective=new_obj)
                return kept, prev, False
        plan = self._build_plan(fleet, cohort, active, pair_seed)
        return plan, plan, True

    def _cut_cache_status(self, replanned: bool) -> str:
        if self.plan_cache is None:
            return "n/a"
        if not replanned:
            return "kept"
        return self.plan_cache.last_status

    def _fedpairing_round(self, state, fleet, cohort, active, pair_seed):
        rc = self.rc
        plan, anchor, replanned = self._adaptive_plan(state, fleet, cohort,
                                                      active, pair_seed)
        partner = plan.partner_array()
        agg_w = fedpair.pair_weights(fleet.data_sizes, partner)
        params = state.client_params
        losses = []
        for _ in range(rc.batches_per_round):
            params, l = self._engine.step(params, self.batch_fn(), plan,
                                          agg_w)
            losses.append(l.cpu().numpy())
        mean_loss = _mean_active_loss(losses, active, round_idx=state.round)
        units, times, upload_s = latency.round_clock_plan(
            self._latency_plan(fleet, partner, active, plan), fleet,
            self.chan, self.workload)
        round_s = float(np.max(times)) + upload_s
        wait_s = latency.barrier_wait_s(times)
        g, _ = self.agg_policy.apply(
            params, torch.as_tensor(np.asarray(fleet.data_sizes),
                                    dtype=torch.float32),
            rc.aggregation, active=torch.as_tensor(active),
            round_idx=state.round)
        params = aggregation.broadcast(g, self.n)
        rec = self._record(state, cohort, plan.pairs, plan.lengths,
                           mean_loss, round_s, objective=plan.objective,
                           replanned=replanned,
                           cut_cache=self._cut_cache_status(replanned),
                           wait_s=wait_s)
        return rec, params, anchor


class BatchValidationError(ValueError):
    """``batch_fn`` returned a tree violating the driver's client-axis
    contract (every leaf stacked (N, ...) with a numeric dtype)."""

    def __init__(self, leaf: str, detail: str):
        self.leaf = leaf
        super().__init__(
            f"batch_fn returned an invalid batch: leaf {leaf!r} {detail} — "
            f"every leaf must be an array stacked over the client axis "
            f"(leading dim N) with a numeric dtype")


def _validated_batch_fn(fn: Callable[[], Dict], n: int) -> Callable[[], Dict]:
    """Wrap ``batch_fn`` with the client-axis contract check."""

    def validated() -> Dict:
        batch = fn()
        for path, leaf in tree_items(batch):
            if not isinstance(leaf, (torch.Tensor, np.ndarray)):
                raise BatchValidationError(
                    path, f"is a {type(leaf).__name__}, not an array")
            if leaf.ndim < 1 or int(leaf.shape[0]) != n:
                raise BatchValidationError(
                    path, f"has shape {tuple(leaf.shape)}; expected a "
                          f"leading client dim of {n}")
            if isinstance(leaf, torch.Tensor) and leaf.is_complex():
                raise BatchValidationError(
                    path, f"has non-real dtype {leaf.dtype}")
            if isinstance(leaf, np.ndarray) and not (
                    np.issubdtype(leaf.dtype, np.number)
                    or leaf.dtype == np.bool_):
                raise BatchValidationError(
                    path, f"has non-numeric dtype {leaf.dtype}")
        return batch

    return validated


class NonFiniteLossError(RuntimeError):
    """A training round produced NaN/inf losses — raised with the round
    index and the offending client ids."""

    def __init__(self, round_idx: int, clients: Sequence[int] = ()):
        self.round = int(round_idx)
        self.clients = tuple(int(c) for c in clients)
        who = (f" from clients {list(self.clients)}" if self.clients
               else "")
        super().__init__(
            f"non-finite training loss in round {self.round}{who} — the "
            f"model diverged; lower the learning rate or inspect the "
            f"round's batches")


def _mean_active_loss(losses: Sequence[np.ndarray], active: np.ndarray,
                      round_idx: Optional[int] = None) -> float:
    """Mean per-step loss over the active positions; with ``round_idx``
    given, non-finite active losses raise ``NonFiniteLossError``."""
    arr = np.stack([np.asarray(l, np.float64) for l in losses])
    if round_idx is not None:
        bad = ~np.isfinite(arr[:, active]).all(axis=0)
        if bad.any():
            raise NonFiniteLossError(round_idx,
                                     np.flatnonzero(active)[bad])
    return float(arr[:, active].mean())


def make_lm_batch_fn(cfg, n: int, batch: int = 2, seq: int = 32,
                     seed: int = 0, device="cuda") -> Callable[[], Dict]:
    """Stacked synthetic-LM batches from N disjoint corpus shards, as
    tensors on ``device`` (the same tokens as the reference's)."""
    from repro_torch.data import LMBatcher, SyntheticLM
    corpus = SyntheticLM(vocab_size=cfg.vocab_size, seed=seed).generate()
    shard = len(corpus) // n
    batchers = [LMBatcher(corpus[i * shard:(i + 1) * shard], batch, seq,
                          seed=seed + i) for i in range(n)]

    def next_batches() -> Dict:
        per = [next(b) for b in batchers]
        return {
            "tokens": torch.as_tensor(np.stack([p["tokens"] for p in per]),
                                      device=device),
            "labels": torch.as_tensor(np.stack([p["labels"] for p in per]),
                                      device=device),
        }

    return next_batches
