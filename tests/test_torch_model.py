"""The port's dense model against the reference on the CPU, at fp32.

Params cross from the reference as the numpy leaves that
``repro.checkpoint.io._flatten`` writes; every other input is made with
numpy from a seed and handed to both packages.  Tolerance: rtol/atol 1e-4
(fp32, the two frameworks sum in different orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import _flatten
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import common as jcommon
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro_torch.checkpoint.convert import params_from_jax, params_to_flat
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import common, registry, transformer
from repro_torch.tree import tree_items, tree_map

pytestmark = pytest.mark.torch_port

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "tinyllama-1.1b"


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    jparams = jregistry.init_params(jcfg, jax.random.key(0))
    flat = _flatten(jparams)
    return jcfg, tcfg, jparams, flat


@pytest.fixture(scope="module")
def batch(models):
    jcfg = models[0]
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, size=(2, 16)).astype(np.int64)
    labels[0, :3] = -1                         # masked positions
    return toks, labels


def test_params_from_jax_round_trips_every_leaf(models):
    flat = models[3]
    params = params_from_jax(flat, device="cpu")
    back = params_to_flat(params)
    assert sorted(back) == sorted(flat)
    for key, arr in flat.items():
        assert back[key].dtype == arr.dtype and back[key].shape == arr.shape
        np.testing.assert_array_equal(back[key], arr)
    # the port's own init builds the same tree: keys, shapes and dtypes
    own = {p: tuple(t.shape) for p, t in
           tree_items(registry.init_params(models[1], 0, "cpu"))}
    assert own == {k: a.shape for k, a in flat.items()}


def test_rms_norm_rope_swiglu():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 4, 32), np.float32)
    gamma = rng.standard_normal((32,), np.float32)
    _close(common.rms_norm(torch.tensor(x), torch.tensor(gamma)),
           jcommon.rms_norm(jnp.asarray(x), jnp.asarray(gamma)))
    pos = np.arange(8)[None, :]
    jc, js = jcommon.rope_cos_sin(jnp.asarray(pos), 32, 10000.0)
    tc, ts = common.rope_cos_sin(torch.tensor(pos), 32, 10000.0)
    _close(tc, jc)
    _close(ts, js)
    _close(common.apply_rope(torch.tensor(x), tc[:, :, None, :],
                             ts[:, :, None, :]),
           jcommon.apply_rope(jnp.asarray(x), jc[:, :, None, :],
                              js[:, :, None, :]))
    w = [rng.standard_normal(s, np.float32) * 0.1
         for s in ((32, 48), (32, 48), (48, 32))]
    _close(common.swiglu(torch.tensor(x), *map(torch.tensor, w)),
           jcommon.swiglu(jnp.asarray(x), *map(jnp.asarray, w)))


def test_block_apply(models):
    jcfg, tcfg, jparams, flat = models
    params = params_from_jax(flat, device="cpu")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, jcfg.d_model), np.float32)
    pos = np.arange(16)[None, :]
    hd = jcfg.resolved_head_dim
    jc, js = jcommon.rope_cos_sin(jnp.asarray(pos), hd, jcfg.rope_theta)
    tc, ts = common.rope_cos_sin(torch.tensor(pos), hd, tcfg.rope_theta)
    for layer, gate in ((0, 1.0), (1, 0.5)):
        jp = jax.tree_util.tree_map(lambda a: a[layer], jparams["blocks"])
        tp = tree_map(lambda a: a[layer], params["blocks"])
        want, _ = jtransformer.block_apply(jp, jnp.asarray(x), jc, js, jcfg,
                                           jnp.float32(gate))
        got = transformer.block_apply(tp, torch.tensor(x), tc, ts, tcfg,
                                      torch.tensor(gate))
        _close(got, want)


def test_forward_logits_loss_and_every_grad_leaf(models, batch):
    jcfg, tcfg, jparams, flat = models
    toks, labels = batch
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.tensor(toks), "labels": torch.tensor(labels)}
    params = params_from_jax(flat, device="cpu")
    jlogits, _ = jregistry.forward_logits(jparams, jb, jcfg)
    _close(registry.forward_logits(params, tb, tcfg), jlogits)

    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jregistry.loss_fn(p, jb, jcfg), has_aux=True)(jparams)
    leaves = [t.requires_grad_() for _, t in tree_items(params)]
    loss, metrics = registry.loss_fn(params, tb, tcfg)
    grads = torch.autograd.grad(loss, leaves)
    _close(loss, jloss)
    assert int(metrics["tokens"]) == int((labels >= 0).sum())
    jflat = _flatten(jgrads)
    paths = [p for p, _ in tree_items(params)]
    assert sorted(paths) == sorted(jflat)
    for path, g in zip(paths, grads):
        np.testing.assert_allclose(g.numpy(), jflat[path], err_msg=path,
                                   **TOL)


def test_client_axis_forward_matches_per_client(models, batch):
    """The leading client axis of the fed step: stacked params and batches
    give each client's own one-model loss."""
    tcfg, flat = models[1], models[3]
    params = params_from_jax(flat, device="cpu")
    toks, labels = batch
    gen = torch.Generator().manual_seed(3)
    other = tree_map(lambda a: a + 0.01 * torch.randn(a.shape, generator=gen),
                     params)
    stacked = tree_map(lambda a, b: torch.stack([a, b]), params, other)
    tb = {"tokens": torch.tensor(np.stack([toks, toks[::-1]])),
          "labels": torch.tensor(np.stack([labels, labels[::-1]]))}
    losses, _ = registry.loss_fn(stacked, tb, tcfg)
    for i, p in enumerate((params, other)):
        one = {k: v[i] for k, v in tb.items()}
        _close(losses[i], registry.loss_fn(p, one, tcfg)[0].detach())


@pytest.mark.parametrize("smoke", [False, True])
def test_count_params_analytical_is_exact(smoke):
    jcfg = jax_smoke(ARCH) if smoke else jax_get_config(ARCH)
    tcfg = get_smoke_config(ARCH) if smoke else get_config(ARCH)
    assert registry.count_params_analytical(tcfg) \
        == jregistry.count_params_analytical(jcfg)
    assert tcfg.param_count() == jcfg.param_count()


def test_unported_arch_names_roadmap():
    with pytest.raises(KeyError, match="ROADMAP"):
        get_smoke_config("deepseek-moe-16b")
