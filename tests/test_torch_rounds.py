"""The port's round loop against the reference on the CPU.

Host-side fields (plans, lengths, objectives, simulated times, cohorts,
pairs) come from numpy in both packages and must be bit-identical; the
trained loss goes through two frameworks and agrees within rtol 1e-4.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.io import _flatten
from repro.configs import get_smoke_config as jax_smoke
from repro.core import latency as jlatency
from repro.core import participation as jparticipation
from repro.core import planning as jplanning
from repro.core import rounds as jrounds
from repro.models import registry as jregistry
from repro_torch.checkpoint.convert import params_from_jax
from repro_torch.configs import get_smoke_config
from repro_torch.core import latency, participation, planning, rounds

pytestmark = pytest.mark.torch_port

ARCH = "tinyllama-1.1b"
SMALL = dict(num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
             d_ff=128, vocab_size=128)
JCFG = jax_smoke(ARCH).with_overrides(**SMALL)
TCFG = get_smoke_config(ARCH).with_overrides(**SMALL)
HOST_FIELDS = ("round", "cohort", "pairs", "lengths", "sim_round_s",
               "sim_total_s", "objective", "replanned", "cut_cache",
               "status", "wait_s")


def _workloads(seq=32, jcfg=JCFG, tcfg=TCFG):
    return (jlatency.workload_from_arch(jcfg, seq_len=seq, batch_size=2,
                                        batches_per_epoch=2, local_epochs=1),
            latency.workload_from_arch(tcfg, seq_len=seq, batch_size=2,
                                       batches_per_epoch=2, local_epochs=1))


@pytest.mark.parametrize("split_policy", ["paper", "latency-opt"])
@pytest.mark.parametrize("n", [4, 7])
def test_host_plans_bit_identical(n, split_policy):
    jw, tw = _workloads()
    assert dataclasses.asdict(jw) == dataclasses.asdict(tw)
    chan_j, chan_t = jlatency.ChannelModel(), latency.ChannelModel()
    for seed in range(4):
        jf = jlatency.make_fleet(n=n, seed=seed)
        tf = latency.make_fleet(n=n, seed=seed)
        rng_j, rng_t = (np.random.default_rng(seed) for _ in range(2))
        cohort = jparticipation.sample_cohort(n, 0.75, rng_j)
        np.testing.assert_array_equal(
            participation.sample_cohort(n, 0.75, rng_t), cohort)
        jp, jact = jparticipation.cohort_partner(jf, chan_j, cohort)
        tp, tact = participation.cohort_partner(tf, chan_t, cohort)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tact, jact)
        jplan = jplanning.build_round_plan(jf, chan_j, jp, JCFG.num_layers,
                                           policy=split_policy, workload=jw,
                                           active=jact)
        tplan = planning.build_round_plan(tf, chan_t, tp, TCFG.num_layers,
                                          policy=split_policy, workload=tw,
                                          active=tact)
        np.testing.assert_array_equal(tplan.partner_array(),
                                      jplan.partner_array())
        np.testing.assert_array_equal(tplan.lengths_array(),
                                      jplan.lengths_array())
        assert tplan.objective == jplan.objective
        assert tplan.pairs == jplan.pairs
        ju, jt, jup = jlatency.round_clock_plan(jplan, jf, chan_j, jw)
        tu, tt, tup = latency.round_clock_plan(tplan, tf, chan_t, tw)
        np.testing.assert_array_equal(np.asarray(tt), np.asarray(jt))
        assert tup == jup and tu == ju


@pytest.mark.parametrize("arch,participation_frac,drift", [
    pytest.param(arch, frac, drift,
                 id=f"{frac}-{drift}" if arch == ARCH
                 else f"{arch}-{frac}-{drift}")
    for arch in (ARCH, "rwkv6-1.6b", "zamba2-1.2b")
    for frac, drift in ((1.0, 0.0), (0.75, 5.0))])
def test_driver_trace_matches_reference(arch, participation_frac, drift):
    n = 4
    # tinyllama: its smoke widths at 4 layers; rwkv6-smoke and
    # zamba2-smoke as they are
    jcfg, tcfg = ((JCFG, TCFG) if arch == ARCH
                  else (jax_smoke(arch), get_smoke_config(arch)))
    jw, tw = _workloads(jcfg=jcfg, tcfg=tcfg)
    assert dataclasses.asdict(jw) == dataclasses.asdict(tw)
    kw = dict(rounds=2, batches_per_round=2, participation=participation_frac,
              drift_sigma_m=drift, seed=0)
    jdrv = jrounds.RoundDriver(jcfg, jrounds.RoundConfig(**kw),
                               jlatency.make_fleet(n=n, seed=0), workload=jw)
    gparams = jregistry.init_params(jcfg, jax.random.key(0))
    tdrv = rounds.RoundDriver(tcfg, rounds.RoundConfig(**kw),
                              latency.make_fleet(n=n, seed=0), workload=tw,
                              params=params_from_jax(_flatten(gparams), "cpu"),
                              device="cpu")
    jstate, tstate = jdrv.run(), tdrv.run()
    assert len(tstate.history) == len(jstate.history) == 2
    for jr, tr in zip(jstate.history, tstate.history):
        for field in HOST_FIELDS:
            assert getattr(tr, field) == getattr(jr, field), field
        np.testing.assert_allclose(tr.mean_loss, jr.mean_loss, rtol=1e-4)
    assert tstate.sim_time_s == jstate.sim_time_s
    if participation_frac < 1.0:
        assert any(len(r.cohort) == 3 for r in tstate.history)


def test_unported_branches_raise_and_name_roadmap():
    for kw in (dict(algorithm="fl"), dict(engine="bucketed"),
               dict(agg_policy="scaffold"), dict(async_rounds=True),
               dict(faults=object())):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            rounds.RoundConfig(**kw)


def test_nonfinite_loss_names_round_and_clients():
    losses = [np.array([1.0, np.nan, 2.0, 3.0])]
    active = np.array([True, True, False, True])
    with pytest.raises(rounds.NonFiniteLossError) as err:
        rounds._mean_active_loss(losses, active, round_idx=3)
    assert err.value.round == 3 and err.value.clients == (1,)
    assert rounds._mean_active_loss([np.arange(4.0)], active) == 4.0 / 3


def test_batch_validation_names_the_leaf():
    bad = rounds._validated_batch_fn(
        lambda: {"tokens": np.zeros((3, 2, 8), np.int32)}, 4)
    with pytest.raises(rounds.BatchValidationError, match="tokens"):
        bad()


def test_reference_counterexamples_reproduced():
    """The port reproduces the reference's two known counterexamples
    (ROADMAP §C) value for value, rather than fixing them."""
    from repro.core import pairing as jpairing
    from repro_torch.core import pairing

    # (a) the Alg. 1 greedy collects less weight than location pairing
    got = []
    for lat, pair in ((jlatency, jpairing), (latency, pairing)):
        fleet = lat.make_fleet(n=4, seed=68)
        chan = lat.ChannelModel()
        w = pair.edge_weights(fleet, chan, alpha=1.0, beta=0.05)
        got.append(tuple(sum(w[i, j] for i, j in pairs) for pairs in (
            pair.fedpairing_pairing(fleet, chan),
            pair.location_pairing(fleet, chan))))
    assert got[0] == got[1] and got[1][0] < got[1][1]

    # (b) a faster client lengthens the round under the Eq. (6) floor cut
    times = []
    for lat, pair in ((jlatency, jpairing), (latency, pairing)):
        fleet = lat.make_fleet(n=2, seed=16)
        chan, w = lat.ChannelModel(), lat.WorkloadModel(num_layers=18)
        partner = pair.partner_permutation(
            pair.fedpairing_pairing(fleet, chan), 2)
        f2 = fleet.cpu_hz.copy()
        f2[1] *= 1.25
        fast = dataclasses.replace(fleet, cpu_hz=f2)
        times.append(tuple(lat.round_time_from_partner(partner, f, chan, w)
                           for f in (fleet, fast)))
    assert times[0] == times[1] and times[1][1] > times[1][0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cohort_pairing_lengths_bit_identical(seed):
    jf, tf = (lat.make_fleet(n=9, seed=seed) for lat in (jlatency, latency))
    cohort = jparticipation.sample_cohort(9, 0.6,
                                          np.random.default_rng(seed))
    want = jparticipation.cohort_pairing(jf, jlatency.ChannelModel(), cohort,
                                         12)
    got = participation.cohort_pairing(tf, latency.ChannelModel(), cohort, 12)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode", ["paper", "fedavg"])
@pytest.mark.parametrize("active,staleness", [
    (None, None), ([1, 1, 0, 1], None), ([1, 0, 1, 1], [0, 2, 1, 0])])
def test_aggregate_matches_reference(mode, active, staleness):
    import jax.numpy as jnp

    from repro.core import aggregation as jagg
    from repro_torch.core import aggregation

    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((4, 3, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal((4, 7)).astype(np.float32)}}
    if active is not None:
        tree["a"][np.flatnonzero(np.asarray(active) == 0)] = np.nan
    agg_w = np.array([0.2, 0.4, 0.1, 0.3], np.float32)
    jkw = dict(active=None if active is None else jnp.asarray(active, bool),
               staleness=None if staleness is None else jnp.asarray(staleness))
    tkw = dict(active=None if active is None
               else torch.as_tensor(active, dtype=torch.bool),
               staleness=None if staleness is None
               else torch.as_tensor(staleness))
    want = jagg.aggregate(jax.tree_util.tree_map(jnp.asarray, tree),
                          jnp.asarray(agg_w), mode, **jkw)
    got = aggregation.aggregate(
        {"a": torch.tensor(tree["a"]), "b": {"c": torch.tensor(tree["b"]["c"])}},
        torch.tensor(agg_w), mode, **tkw)
    np.testing.assert_allclose(got["a"].numpy(), np.asarray(want["a"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["b"]["c"].numpy(),
                               np.asarray(want["b"]["c"]), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(
        aggregation.aggregation_weights(torch.tensor(agg_w), 4, mode,
                                        **tkw).numpy(),
        np.asarray(jagg.aggregation_weights(jnp.asarray(agg_w), 4, mode,
                                            **jkw)), rtol=1e-6)


def test_empty_cohort_raises_with_round():
    from repro_torch.core import aggregation

    with pytest.raises(aggregation.EmptyCohortError, match="round 7"):
        aggregation.aggregate({"a": torch.zeros(3, 2)}, torch.ones(3),
                              active=torch.zeros(3, dtype=torch.bool),
                              round_idx=7)
