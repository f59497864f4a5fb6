"""One FedPairing step of the port against the reference's
``make_fed_step(..., FedPairingConfig(donate=False))`` on the CPU.

Same initial params (per-client perturbations of one JAX init), same
batches, same partner / lengths / weights and lr.  Losses and new params
agree within rtol/atol 1e-4 (fp32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import _flatten
from repro.configs import get_smoke_config as jax_smoke
from repro.core import fedpair as jfedpair
from repro.core import splitting as jsplitting
from repro.models import registry as jregistry
from repro_torch.checkpoint.convert import params_from_jax, params_to_flat
from repro_torch.configs import get_smoke_config
from repro_torch.core import fedpair, splitting
from repro_torch.models import registry
from repro_torch.tree import tree_items

pytestmark = pytest.mark.torch_port

ARCH = "tinyllama-1.1b"
SMALL = dict(num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
             d_ff=128, vocab_size=128)
JCFG = jax_smoke(ARCH).with_overrides(**SMALL)
TCFG = get_smoke_config(ARCH).with_overrides(**SMALL)
TOL = dict(rtol=1e-4, atol=1e-4)

# (partner involution, lengths): N = 4 two pairs; N = 5 adds a self-pair
CASES = {
    4: (np.array([2, 3, 0, 1]), np.array([1, 3, 3, 1])),
    5: (np.array([1, 0, 2, 4, 3]), np.array([2, 2, 4, 3, 1])),
}


def _fleet(n, seed=0):
    """Per-client params (a JAX init plus client noise) and batches."""
    g = jregistry.init_params(JCFG, jax.random.key(seed))
    rng = np.random.default_rng(seed)
    stacked = {k: (np.broadcast_to(a, (n,) + a.shape)
                   + 0.02 * rng.standard_normal((n,) + a.shape)
                   ).astype(np.float32)
               for k, a in _flatten(g).items()}
    toks = rng.integers(0, JCFG.vocab_size, size=(n, 2, 16)).astype(np.int32)
    labels = rng.integers(0, JCFG.vocab_size, size=(n, 2, 16))
    return g, stacked, {"tokens": toks, "labels": labels}


@pytest.mark.parametrize("boost", [True, False])
@pytest.mark.parametrize("aggregation", ["paper", "fedavg"])
@pytest.mark.parametrize("n", [4, 5])
def test_step_matches_reference(n, aggregation, boost):
    partner, lengths = CASES[n]
    g, flat, batches = _fleet(n)
    agg_w = jfedpair.pair_weights(np.array([3, 5, 2, 4, 6][:n]), partner)

    tcp = params_from_jax(flat, device="cpu")
    jtree = jax.tree_util.tree_map(jnp.asarray, _unflatten_like(g, flat))
    jstep = jfedpair.make_fed_step(
        lambda p, b: jregistry.loss_fn(p, b, JCFG)[0],
        jsplitting.split_plan(JCFG, g), JCFG.num_layers,
        jfedpair.FedPairingConfig(lr=0.05, overlap_boost=boost,
                                  aggregation=aggregation, donate=False))
    jnew, jm = jstep(jtree, {k: jnp.asarray(v) for k, v in batches.items()},
                     jnp.asarray(partner, jnp.int32),
                     jnp.asarray(lengths, jnp.int32),
                     jnp.asarray(agg_w, jnp.float32))

    tstep = fedpair.make_fed_step(
        lambda p, b: registry.loss_fn(p, b, TCFG)[0],
        splitting.split_plan(TCFG, tcp), TCFG.num_layers,
        fedpair.FedPairingConfig(lr=0.05, overlap_boost=boost,
                                 aggregation=aggregation, donate=False))
    tnew, tm = tstep(tcp, {k: torch.tensor(v) for k, v in batches.items()},
                     partner, lengths, agg_w)

    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               **TOL)
    got, want = params_to_flat(tnew), _flatten(jnew)
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], err_msg=path, **TOL)
    # donate=False leaves the inputs intact
    for path, a in params_to_flat(tcp).items():
        np.testing.assert_array_equal(a, flat[path])


def test_donated_step_updates_in_place():
    partner, lengths = CASES[4]
    g, flat, batches = _fleet(4)
    params = params_from_jax(flat, device="cpu")
    step = fedpair.make_fed_step(
        lambda p, b: registry.loss_fn(p, b, TCFG)[0],
        splitting.split_plan(TCFG, params), TCFG.num_layers,
        fedpair.FedPairingConfig(lr=0.05))
    wq = params["blocks"]["attn"]["wq"]
    new, _ = step(params, {k: torch.tensor(v) for k, v in batches.items()},
                  partner, lengths, np.full(4, 0.5, np.float32))
    assert new["blocks"]["attn"]["wq"] is wq
    assert not np.array_equal(wq.numpy(), flat["blocks/attn/wq"])


def test_self_pair_is_local_sgd():
    """A self-paired client's update is its own full-stack SGD step."""
    partner, lengths = CASES[5]
    g, flat, batches = _fleet(5)
    params = params_from_jax(flat, device="cpu")
    plan = splitting.split_plan(TCFG, params)
    step = fedpair.make_fed_step(
        lambda p, b: registry.loss_fn(p, b, TCFG)[0], plan, TCFG.num_layers,
        fedpair.FedPairingConfig(lr=0.05, overlap_boost=False,
                                 aggregation="fedavg", donate=False))
    tb = {k: torch.tensor(v) for k, v in batches.items()}
    new, _ = step(params, tb, partner, lengths, np.ones(5, np.float32))
    own = params_from_jax({k: a[2] for k, a in flat.items()}, device="cpu")
    leaves = [t.requires_grad_() for _, t in tree_items(own)]
    loss, _ = registry.loss_fn(own, {k: v[2] for k, v in tb.items()}, TCFG)
    grads = torch.autograd.grad(loss, leaves)
    got = params_to_flat(new)
    for (path, p), gr in zip(tree_items(own), grads):
        np.testing.assert_allclose(got[path][2],
                                   (p - 0.05 * gr).detach().numpy(),
                                   err_msg=path, **TOL)


def _unflatten_like(tree, flat):
    paths, treedef = jax.tree_util.tree_flatten_with_path(tree)
    keys = ["/".join(str(p.key) for p in path) for path, _ in paths]
    return jax.tree_util.tree_unflatten(treedef, [flat[k] for k in keys])
