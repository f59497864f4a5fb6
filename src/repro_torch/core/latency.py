# Host-side numpy copy of repro/core/latency.py, kept in step with it: the
# parity tests hold the port's host traces bit-identical to the reference.
"""Latency model — paper §II (Eq. 3) and Problem 1.

Implements the OFDM link-rate model between clients, the per-pair
computing/communication latency terms, and the synchronous FedPairing
round clock.  These drive the pairing edge weights (core.pairing) and the
simulated round times.  The baseline (FL/SL/SplitFed) round times and the
event-driven clock of the reference are not part of this port yet.

All quantities are scalars/np arrays — this is an analytical model, not a
traced computation (pairing happens on the host before each round).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core import planning

# re-export: the named error every per-client-vector consumer raises on a
# client-axis mismatch (defined in planning to stay import-cycle-free)
PerClientShapeError = planning.PerClientShapeError


@dataclasses.dataclass(frozen=True)
class ChannelModel:
    """Eq. (3): r_ij = B log2(1 + P h_ij / sigma^2), pathloss channel gain.

    Units: ``bandwidth_hz`` in Hz, ``tx_power_w``/``noise_w`` in watts,
    ``ref_gain``/``pathloss_exp`` unitless, ``ref_dist_m`` in meters.
    ``rate_bps`` is the Shannon rate the latency model divides BYTE
    payloads by — i.e. the calibration treats it as bytes/s (the paper
    leaves the bits/bytes factor unspecified; the constant is absorbed
    into the §IV calibration, see ``WorkloadModel``)."""

    bandwidth_hz: float = 64e6          # B, Hz  (paper: 64 MHz)
    tx_power_w: float = 1.0             # P, W  (paper: 1 W)
    noise_w: float = 1e-9               # sigma^2, W (paper: 1e-9 W)
    ref_gain: float = 1e-3              # h0 at ref_dist_m, unitless (assumed; not in paper)
    ref_dist_m: float = 1.0             # zeta_0, m
    pathloss_exp: float = 3.0           # theta, unitless (assumed; typical urban 2.7-3.5)

    def gain(self, dist_m: np.ndarray) -> np.ndarray:
        d = np.maximum(np.asarray(dist_m, np.float64), self.ref_dist_m)
        return self.ref_gain * (self.ref_dist_m / d) ** self.pathloss_exp

    def rate_bps(self, dist_m: np.ndarray) -> np.ndarray:
        snr = self.tx_power_w * self.gain(dist_m) / self.noise_w
        return self.bandwidth_hz * np.log2(1.0 + snr)


@dataclasses.dataclass(frozen=True)
class ClientFleet:
    """N heterogeneous clients: positions (meters), CPU frequencies
    (cycles/s), dataset sizes (samples)."""

    positions: np.ndarray       # (N, 2), m (server at the origin)
    cpu_hz: np.ndarray          # (N,), CPU cycles/s — f_i in Eq. (3)
    data_sizes: np.ndarray      # (N,), samples — |D_i| in Problem 1

    @property
    def n(self) -> int:
        return len(self.cpu_hz)

    def distances(self) -> np.ndarray:
        d = self.positions[:, None, :] - self.positions[None, :, :]
        return np.linalg.norm(d, axis=-1)

    def rates(self, chan: ChannelModel) -> np.ndarray:
        r = chan.rate_bps(self.distances())
        np.fill_diagonal(r, np.inf)  # self-transfer is free
        return r


def make_fleet(n: int = 20, radius_m: float = 50.0, f_min: float = 0.1e9,
               f_max: float = 2.0e9, data_size: int = 2500,
               seed: int = 0) -> ClientFleet:
    """Paper §IV-A setup: 20 clients uniform in a 50 m disc, f ~ U[0.1, 2] GHz."""
    rng = np.random.default_rng(seed)
    rho = radius_m * np.sqrt(rng.uniform(size=n))
    phi = rng.uniform(0, 2 * np.pi, size=n)
    pos = np.stack([rho * np.cos(phi), rho * np.sin(phi)], axis=1)
    return ClientFleet(
        positions=pos,
        cpu_hz=rng.uniform(f_min, f_max, size=n),
        data_sizes=np.full(n, data_size, np.int64),
    )


def subfleet(fleet: ClientFleet, idx: np.ndarray) -> ClientFleet:
    """Restriction of a fleet to the given (sorted) client indices."""
    idx = np.asarray(idx)
    return ClientFleet(positions=fleet.positions[idx],
                       cpu_hz=fleet.cpu_hz[idx],
                       data_sizes=fleet.data_sizes[idx])


def drift_fleet(fleet: ClientFleet, rng: np.random.Generator,
                sigma_m: float) -> ClientFleet:
    """Per-round position random walk — the time-varying channel realization
    (client mobility moves the pathloss, hence the rates the pairing sees).
    CPU frequencies and dataset sizes are round-invariant.  No-op (and no
    rng draw) when ``sigma_m <= 0`` — see DESIGN.md §5 seeding contract."""
    if sigma_m <= 0:
        return fleet
    step = rng.normal(0.0, sigma_m, size=fleet.positions.shape)
    return dataclasses.replace(fleet, positions=fleet.positions + step)


@dataclasses.dataclass(frozen=True)
class WorkloadModel:
    """Model-dependent constants for latency accounting.

    Calibrated to the paper's §IV setup (ResNet18 / CIFAR10, 2500 samples
    per client, 2 local epochs, batch 32): ``cycles_per_layer`` is F in the
    paper (CPU cycles to fwd+bwd+update one layer for one *mini-batch*);
    with F=2e8 and f ~ U[0.1, 2] GHz, vanilla-FL rounds land in the paper's
    ~8700 s regime and FedPairing in the ~1500 s regime (Table II).
    ``feature_bytes``/``grad_bytes`` are PER-SAMPLE boundary tensors
    (ResNet18 mid-network: 128ch x 16 x 16 x fp32 = 131 KB) — Problem 1
    weights the transfer term by dataset size |D_i|, so comm scales with
    samples, which is what makes the rate term of Eq. (5) matter.

    Units on every field: ``cycles_per_layer`` in CPU cycles (divided by
    ``ClientFleet.cpu_hz`` in cycles/s -> seconds), ``feature_bytes`` /
    ``grad_bytes`` / ``model_bytes`` and the per-cut profiles in bytes
    (divided by the channel rate -> seconds), ``batch_size`` in samples,
    ``batches_per_epoch`` / ``local_epochs`` unitless counts.
    """

    num_layers: int                     # W, layers in the full stack
    cycles_per_layer: float = 2e8       # F, CPU cycles / layer / mini-batch
    feature_bytes: float = 128 * 16 * 16 * 4   # bytes / sample, one direction
    grad_bytes: float = 128 * 16 * 16 * 4      # bytes / sample, one direction
    model_bytes: float = 4 * 11e6       # bytes, full model upload (ResNet18-ish)
    batch_size: int = 32                # samples / mini-batch
    batches_per_epoch: int = 78         # 2500 samples / batch 32
    local_epochs: int = 2               # paper: 2 epochs / round
    # optional per-cut boundary payload profiles (index cut-1, cuts
    # 1..W-1); None -> the flat feature/grad_bytes above.  Consulted by
    # planning.pair_cost, which lets the latency-opt split policy trade
    # compute balance against a narrower boundary tensor.
    feature_profile: Optional[Tuple[float, ...]] = None
    grad_profile: Optional[Tuple[float, ...]] = None
    # optional PER-CLIENT cycles_per_layer vector (index = client id,
    # length = fleet.n; DESIGN.md §10): device-class heterogeneity —
    # a phone pays more CPU cycles per layer per mini-batch than an
    # edge server, independently of its clock f_i.  None -> the
    # fleet-global scalar above applies to every client.  Consumers
    # gather it by client id (planning.client_cycles validates the
    # length, PerClientShapeError on mismatch); cohort sub-problems
    # must pass an explicitly subsetted slice.  Kept a tuple so the
    # workload stays hashable (plan/cache keys hash it by value).
    cycles_per_client: Optional[Tuple[float, ...]] = None


def workload_from_arch(cfg, *, seq_len: int = 64, batch_size: int = 32,
                       batches_per_epoch: int = 78, local_epochs: int = 2,
                       cycles_per_layer=2e8) -> WorkloadModel:
    """WorkloadModel calibrated to a REAL architecture config.

    The per-cut ``feature_profile``/``grad_profile`` come from
    ``models.registry.boundary_profile`` (the actual residual-stream
    payload at every split depth — patches, encoder memory and activation
    dtype included) instead of the flat ResNet18 constant, and
    ``model_bytes`` is the architecture's true fp32 parameter footprint —
    so joint pairing x split costs price what the engines would really
    ship.  ``cycles_per_layer`` keeps the paper's §IV CPU calibration by
    default (the fleets are simulated phones, not the training host); a
    SEQUENCE instead of a scalar becomes the per-client
    ``cycles_per_client`` vector (one entry per client, DESIGN.md §10)
    with the scalar field left at the paper default for fleet-global
    consumers.
    """
    from repro_torch.models import registry

    per_client = None
    if np.ndim(cycles_per_layer) > 0:
        per_client = tuple(float(c) for c in cycles_per_layer)
        cycles_per_layer = 2e8
    feat, grad = registry.boundary_profile(cfg, seq_len)
    mid = cfg.num_layers // 2
    return WorkloadModel(
        num_layers=cfg.num_layers,
        cycles_per_layer=float(cycles_per_layer),
        feature_bytes=feat[max(mid - 1, 0)],
        grad_bytes=grad[max(mid - 1, 0)],
        model_bytes=4.0 * registry.count_params_analytical(cfg),
        batch_size=batch_size,
        batches_per_epoch=batches_per_epoch,
        local_epochs=local_epochs,
        feature_profile=feat,
        grad_profile=grad,
        cycles_per_client=per_client)


# ---------------------------------------------------------------------------
# round-time simulation (FedPairing, synchronous)
# ---------------------------------------------------------------------------

def _pair_times_batch(i: np.ndarray, j: np.ndarray, fleet: ClientFleet,
                      rates: np.ndarray, w: WorkloadModel,
                      lengths: Optional[np.ndarray],
                      cycles: Optional[np.ndarray] = None) -> np.ndarray:
    """Eq. (3) wall times (seconds) for an array of pairs at once — the
    batched workload terms behind the round-time simulation (same
    float64 arithmetic as the scalar ``planning.pair_cost``, via
    ``planning.pair_cost_batch``).  ``i`` must be the canonical
    (lower-index) member of every pair; default split is the paper rule.
    ``cycles`` is the validated per-client cycles vector (defaults to
    the workload's own, length-checked against ``fleet.n``); both the
    cut rule and the cost gather it by the raw client ids.
    """
    f = np.asarray(fleet.cpu_hz, np.float64)
    cyc = planning.client_cycles(w, fleet.n) if cycles is None else cycles
    cy_i = cyc[i] if cyc is not None else None
    cy_j = cyc[j] if cyc is not None else None
    if lengths is None:
        li = planning.paper_cut_batch(f[i], f[j], w.num_layers, cy_i, cy_j)
        lj = w.num_layers - li
    else:
        lengths = np.asarray(lengths, np.int64)
        li, lj = lengths[i], lengths[j]
    return planning.pair_cost_batch(f[i], f[j], rates[i, j], w, li, lj,
                                    cyc_i=cy_i, cyc_j=cy_j)


def local_full_stack_time(cpu_hz, w: WorkloadModel, cycles=None):
    """Per-client wall time to train all W layers locally (fwd+bwd) — the
    vanilla-FL cost, also paid by self-paired cohort members.  ``cycles``
    overrides the fleet-global ``w.cycles_per_layer`` with the clients'
    own per-layer costs (already gathered to match ``cpu_hz``)."""
    cyc = w.cycles_per_layer if cycles is None else np.asarray(cycles,
                                                              np.float64)
    return (w.num_layers * cyc / np.asarray(cpu_hz)
            * 2.0 * w.batches_per_epoch * w.local_epochs)


def unit_times_from_partner(partner: np.ndarray, fleet: ClientFleet,
                            chan: ChannelModel, w: WorkloadModel,
                            active: Optional[np.ndarray] = None,
                            lengths: Optional[np.ndarray] = None,
                            cpu_scale: Optional[np.ndarray] = None,
                            extra_s: Optional[np.ndarray] = None
                            ) -> Tuple[Tuple[Tuple[int, ...], ...],
                                       np.ndarray]:
    """Per-unit Eq. (3) training times for a partner involution.

    A *unit* is one independently-scheduled flow of the round: a
    self-paired active client training the full stack solo (``(i,)``), or
    a canonical pair ``(i, j)`` with ``i < j``.  Returns ``(units,
    times)`` — the unit membership tuples and their wall times in seconds
    (no model-upload term; round-level accounting adds it over whichever
    units survive).  This is the decomposition the fault layer needs:
    deadlines, stragglers and exclusions act on units, not on the round
    scalar (``core.faults.faulted_clock``).

    ``cpu_scale`` divides per-client CPU frequency (straggler slowdown
    divisors >= 1); ``extra_s`` adds per-client seconds to the client's
    unit — a pair pays the max over its members, so a shared link's
    retry backoff is not double-counted.  Both default to no-ops with
    bit-exact arithmetic (``round_time_from_partner`` delegates here).
    Both are validated against ``fleet.n`` up front
    (``PerClientShapeError``) — they are indexed by raw client id, so a
    short vector would otherwise fail late with an opaque IndexError (or
    worse, silently misprice).  A per-client workload composes with
    ``cpu_scale`` exactly once each: the slowdown divides ``cpu_hz``
    here (the ONE place it is applied) while ``cycles_per_client`` is
    gathered by raw client id from the unscaled workload — a straggler
    pays ``L * cycles[i] * scale[i] / cpu_hz[i]``, never ``scale**2``.
    """
    n = fleet.n
    act = np.ones(n, bool) if active is None else np.asarray(active, bool)
    partner = np.asarray(partner, np.int64)
    idx = np.arange(n)
    cyc = planning.client_cycles(w, n)
    eff = fleet
    if cpu_scale is not None:
        scale = np.asarray(cpu_scale, np.float64)
        if scale.shape != (n,):
            raise PerClientShapeError(
                f"cpu_scale must have one entry per client ({n}), got "
                f"shape {scale.shape}")
        eff = dataclasses.replace(
            fleet, cpu_hz=np.asarray(fleet.cpu_hz, np.float64) / scale)
    if extra_s is not None:
        ex = np.asarray(extra_s, np.float64)
        if ex.shape != (n,):
            raise PerClientShapeError(
                f"extra_s must have one entry per client ({n}), got "
                f"shape {ex.shape}")
    units: List[Tuple[int, ...]] = []
    times: List[float] = []
    selfp = act & (partner == idx)
    if selfp.any():
        solo = np.atleast_1d(local_full_stack_time(
            eff.cpu_hz[selfp], w,
            cycles=cyc[selfp] if cyc is not None else None))
        for i, t in zip(np.flatnonzero(selfp), solo):
            units.append((int(i),))
            times.append(float(t))
    ci = np.flatnonzero(act & (partner > idx))   # canonical pair members
    if ci.size:
        rates = fleet.rates(chan)
        per_pair = _pair_times_batch(ci, partner[ci], eff, rates, w,
                                     lengths, cycles=cyc)
        for i, t in zip(ci, per_pair):
            units.append((int(i), int(partner[i])))
            times.append(float(t))
    if extra_s is not None:
        times = [t + float(np.max(ex[list(u)]))
                 for u, t in zip(units, times)]
    return tuple(units), np.asarray(times, np.float64)


def round_clock_from_partner(partner: np.ndarray, fleet: ClientFleet,
                             chan: ChannelModel, w: WorkloadModel,
                             active: Optional[np.ndarray] = None,
                             server_rate_bps: Optional[np.ndarray] = None,
                             lengths: Optional[np.ndarray] = None
                             ) -> Tuple[Tuple[Tuple[int, ...], ...],
                                        np.ndarray, float]:
    """The Eq. (3) round-time decomposition ``(units, times, upload_s)``
    behind ``round_time_from_partner``: per-unit training wall times plus
    the round's straggler-upload term (max model upload over the active
    cohort).  Both clocks consume this — the synchronous barrier takes
    ``max(times) + upload_s`` and the event-driven clock (DESIGN.md §12)
    advances per-unit completion events against the same numbers, so the
    two accountings cannot diverge.  An empty active cohort returns
    ``((), zeros(0), 0.0)``."""
    n = fleet.n
    act = np.ones(n, bool) if active is None else np.asarray(active, bool)
    if not act.any():
        return (), np.zeros(0, np.float64), 0.0
    units, times = unit_times_from_partner(partner, fleet, chan, w,
                                           active=act, lengths=lengths)
    if not units:
        # an active cohort with no self-paired member and no canonical
        # pair member means the active set isn't closed under the pairing
        raise ValueError(f"active cohort {np.flatnonzero(act)} contains "
                         f"no trainable flow under partner {partner}")
    srates = _server_rates(fleet, chan, server_rate_bps)
    upload = float(np.max(w.model_bytes / srates[act]))
    return units, times, upload


def round_time_from_partner(partner: np.ndarray, fleet: ClientFleet,
                            chan: ChannelModel, w: WorkloadModel,
                            active: Optional[np.ndarray] = None,
                            server_rate_bps: Optional[np.ndarray] = None,
                            lengths: Optional[np.ndarray] = None) -> float:
    """Eq. (3) round time for a partner involution (the round driver's
    representation): straggler = max over active pairs, self-paired active
    clients pay the full local stack (vanilla-FL-style), inactive clients
    contribute nothing; + model upload over the active cohort only.
    ``lengths`` overrides the per-client split (any policy's plan).
    Batched over the cohort (``unit_times_from_partner``) — at fleet scale
    the per-round accounting must not cost more than the plan itself."""
    units, times, upload = round_clock_from_partner(
        partner, fleet, chan, w, active=active,
        server_rate_bps=server_rate_bps, lengths=lengths)
    if not units:
        return 0.0
    return float(np.max(times)) + upload


def round_clock_plan(plan: "planning.RoundPlan", fleet: ClientFleet,
                     chan: ChannelModel, w: WorkloadModel,
                     server_rate_bps: Optional[np.ndarray] = None
                     ) -> Tuple[Tuple[Tuple[int, ...], ...],
                                np.ndarray, float]:
    """``round_clock_from_partner`` evaluated at a RoundPlan's schedule —
    the decomposition both clocks consume for a planned round."""
    if plan.kind != "paired":
        raise ValueError(f"round_clock_plan wants a paired plan, got "
                         f"{plan.kind!r} (baselines are not ported)")
    return round_clock_from_partner(plan.partner_array(), fleet, chan, w,
                                    active=plan.active_array(),
                                    server_rate_bps=server_rate_bps,
                                    lengths=plan.lengths_array())


def barrier_wait_s(times) -> float:
    """Barrier idle seconds of a synchronous round: sum over units of
    (round straggler max − own finish).  What the synchronous path wastes
    and the event-driven clock recovers (``RoundRecord.wait_s``)."""
    t = np.asarray(times, np.float64)
    if t.size == 0:
        return 0.0
    return float(np.sum(np.max(t) - t))


def _server_rates(fleet: ClientFleet, chan: ChannelModel,
                  server_rate_bps: Optional[np.ndarray]) -> np.ndarray:
    if server_rate_bps is not None:
        return server_rate_bps
    dist = np.linalg.norm(fleet.positions, axis=1)  # server at origin
    return chan.rate_bps(dist)
