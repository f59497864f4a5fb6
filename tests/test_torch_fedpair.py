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

# (partner involution, lengths) by depth W and N: N = 4 two pairs; N = 5
# adds a self-pair
CASES = {
    (4, 4): (np.array([2, 3, 0, 1]), np.array([1, 3, 3, 1])),
    (4, 5): (np.array([1, 0, 2, 4, 3]), np.array([2, 2, 4, 3, 1])),
    (2, 4): (np.array([2, 3, 0, 1]), np.array([1, 1, 1, 1])),
    (2, 5): (np.array([1, 0, 2, 4, 3]), np.array([1, 1, 2, 1, 1])),
}


def _cfgs(arch):
    """tinyllama: its smoke widths at 4 layers; rwkv6-smoke and
    zamba2-smoke as they are (2 layers)."""
    if arch == ARCH:
        return JCFG, TCFG
    return jax_smoke(arch), get_smoke_config(arch)


def _fleet(n, seed=0, jcfg=JCFG):
    """Per-client params (a JAX init plus client noise) and batches."""
    g = jregistry.init_params(jcfg, jax.random.key(seed))
    rng = np.random.default_rng(seed)
    stacked = {k: (np.broadcast_to(a, (n,) + a.shape)
                   + 0.02 * rng.standard_normal((n,) + a.shape)
                   ).astype(np.float32)
               for k, a in _flatten(g).items()}
    toks = rng.integers(0, jcfg.vocab_size, size=(n, 2, 16)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, size=(n, 2, 16))
    return g, stacked, {"tokens": toks, "labels": labels}


@pytest.mark.parametrize("boost", [True, False])
@pytest.mark.parametrize("aggregation", ["paper", "fedavg"])
@pytest.mark.parametrize("arch,n", [
    pytest.param(ARCH, 4, id="4"), pytest.param(ARCH, 5, id="5"),
    *(pytest.param(arch, n, id=f"{arch}-{n}")
      for arch in ("rwkv6-1.6b", "zamba2-1.2b") for n in (4, 5))])
def test_step_matches_reference(arch, n, aggregation, boost):
    jcfg, tcfg = _cfgs(arch)
    partner, lengths = CASES[(jcfg.num_layers, n)]
    g, flat, batches = _fleet(n, jcfg=jcfg)
    agg_w = jfedpair.pair_weights(np.array([3, 5, 2, 4, 6][:n]), partner)

    tcp = params_from_jax(flat, device="cpu")
    jtree = jax.tree_util.tree_map(jnp.asarray, _unflatten_like(g, flat))
    jstep = jfedpair.make_fed_step(
        lambda p, b: jregistry.loss_fn(p, b, jcfg)[0],
        jsplitting.split_plan(jcfg, g), jcfg.num_layers,
        jfedpair.FedPairingConfig(lr=0.05, overlap_boost=boost,
                                  aggregation=aggregation, donate=False))
    jnew, jm = jstep(jtree, {k: jnp.asarray(v) for k, v in batches.items()},
                     jnp.asarray(partner, jnp.int32),
                     jnp.asarray(lengths, jnp.int32),
                     jnp.asarray(agg_w, jnp.float32))

    tstep = fedpair.make_fed_step(
        lambda p, b: registry.loss_fn(p, b, tcfg)[0],
        splitting.split_plan(tcfg, tcp), tcfg.num_layers,
        fedpair.FedPairingConfig(lr=0.05, overlap_boost=boost,
                                 aggregation=aggregation, donate=False),
        unread=registry.unread_leaves(tcfg))
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
    partner, lengths = CASES[(4, 4)]
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
    partner, lengths = CASES[(4, 5)]
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


def test_unread_leaf_must_be_declared():
    """A leaf the loss does not read raises unless it is declared unread;
    declared, it gets a zero gradient and keeps its value."""
    partner, lengths = CASES[(4, 4)]
    g, flat, batches = _fleet(4)
    params = params_from_jax(flat, device="cpu")
    assert registry.unread_leaves(TCFG) == ()
    assert registry.unread_leaves(get_smoke_config("zamba2-1.2b")) == (
        "shared/attn/wo",)

    def loss(p, b):                     # never reads the final norm
        return registry.loss_fn({**p, "ln_f": p["ln_f"].detach()}, b,
                                TCFG)[0]

    tb = {k: torch.tensor(v) for k, v in batches.items()}
    args = (tb, partner, lengths, np.full(4, 0.5, np.float32))
    cfg = fedpair.FedPairingConfig(lr=0.05, donate=False)
    plan = splitting.split_plan(TCFG, params)
    with pytest.raises(RuntimeError, match="ln_f"):
        fedpair.make_fed_step(loss, plan, TCFG.num_layers, cfg)(params, *args)
    new, _ = fedpair.make_fed_step(loss, plan, TCFG.num_layers, cfg,
                                   unread=("ln_f",))(params, *args)
    np.testing.assert_array_equal(new["ln_f"].numpy(), flat["ln_f"])


def _unflatten_like(tree, flat):
    paths, treedef = jax.tree_util.tree_flatten_with_path(tree)
    keys = ["/".join(str(p.key) for p in path) for path, _ in paths]
    return jax.tree_util.tree_unflatten(treedef, [flat[k] for k in keys])
