"""The port's rwkv6 (SSM) and zamba2 (hybrid) models against the reference
on the CPU, at fp32, on their smoke configs.

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
from repro.models import hybrid as jhybrid
from repro.models import mamba2 as jmamba2
from repro.models import registry as jregistry
from repro.models import rwkv6 as jrwkv6
from repro_torch.checkpoint.convert import params_from_jax, params_to_flat
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import common, hybrid, mamba2, registry, rwkv6
from repro_torch.tree import tree_items, tree_map

pytestmark = pytest.mark.torch_port

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["rwkv6-1.6b", "zamba2-1.2b"]


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(kw or TOL))


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    arch = request.param
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    jparams = jregistry.init_params(jcfg, jax.random.key(0))
    return jcfg, tcfg, jparams, _flatten(jparams)


def _model(arch):
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    jparams = jregistry.init_params(jcfg, jax.random.key(0))
    flat = _flatten(jparams)
    return jcfg, tcfg, jparams, params_from_jax(flat, device="cpu")


def _batch(vocab, lead=()):
    rng = np.random.default_rng(1)
    toks = rng.integers(0, vocab, size=lead + (2, 16)).astype(np.int32)
    labels = rng.integers(0, vocab, size=lead + (2, 16)).astype(np.int64)
    labels[..., 0, :3] = -1                    # masked positions
    return toks, labels


def _x(cfg, seed=2):
    return np.random.default_rng(seed).standard_normal(
        (2, 16, cfg.d_model), np.float32)


def test_params_from_jax_round_trips_every_leaf(models):
    tcfg, flat = models[1], models[3]
    back = params_to_flat(params_from_jax(flat, device="cpu"))
    assert sorted(back) == sorted(flat)
    for key, arr in flat.items():
        assert back[key].dtype == arr.dtype and back[key].shape == arr.shape
        np.testing.assert_array_equal(back[key], arr)
    # the port's own init builds the same tree: keys, shapes and dtypes
    own = {p: (tuple(t.shape), str(t.dtype)[6:]) for p, t in
           tree_items(registry.init_params(tcfg, 0, "cpu"))}
    assert own == {k: (a.shape, str(a.dtype)) for k, a in flat.items()}


def test_rwkv6_time_mix_channel_mix_group_norm():
    jcfg, tcfg, jparams, params = _model("rwkv6-1.6b")
    x = _x(jcfg)
    d = rwkv6.dims(tcfg)
    for layer in (0, 1):
        jp = jax.tree_util.tree_map(lambda a: a[layer], jparams["blocks"])
        tp = tree_map(lambda a: a[layer], params["blocks"])
        jout, jshift, jstate = jrwkv6.time_mix(jp, jnp.asarray(x), jcfg)
        out, shift, state = rwkv6.time_mix(tp, torch.tensor(x), tcfg)
        _close(out, jout)
        _close(shift, jshift)
        _close(state, jstate)
        jcm, _ = jrwkv6.channel_mix(jp["cm"], jnp.asarray(x))
        cm, _ = rwkv6.channel_mix(tp["cm"], torch.tensor(x))
        _close(cm, jcm)
        gamma = np.random.default_rng(layer).standard_normal(
            tcfg.d_model).astype(np.float32)
        _close(rwkv6._group_norm(torch.tensor(x), torch.tensor(gamma),
                                 d["H"], d["N"], tcfg.norm_eps),
               jrwkv6._group_norm(jnp.asarray(x), jnp.asarray(gamma),
                                  d["H"], d["N"], jcfg.norm_eps))
        for gate in (1.0, 0.5):
            _close(rwkv6.rwkv_block_apply(tp, torch.tensor(x), tcfg,
                                          torch.tensor(gate)),
                   jrwkv6.rwkv_block_apply(jp, jnp.asarray(x), jcfg,
                                           jnp.float32(gate)))


def test_zamba2_mamba_block_and_depthwise_conv():
    jcfg, tcfg, jparams, params = _model("zamba2-1.2b")
    x = _x(jcfg)
    for layer, gate in ((0, 1.0), (1, 0.5)):
        jp = jax.tree_util.tree_map(lambda a: a[layer], jparams["mamba"])
        tp = tree_map(lambda a: a[layer], params["mamba"])
        _close(mamba2.mamba_block_apply(tp, torch.tensor(x), tcfg,
                                        torch.tensor(gate)),
               jmamba2.mamba_block_apply(jp, jnp.asarray(x), jcfg,
                                         jnp.float32(gate)))
        w, b = np.asarray(jp["conv_x"]), np.asarray(jp["conv_bias_x"]) + 0.1
        xs = np.random.default_rng(layer).standard_normal(
            (2, 16, w.shape[-1])).astype(np.float32)
        _close(mamba2._causal_depthwise_conv(torch.tensor(xs),
                                             torch.tensor(w),
                                             torch.tensor(b)),
               jmamba2._causal_depthwise_conv(jnp.asarray(xs),
                                              jnp.asarray(w),
                                              jnp.asarray(b)))


def test_zamba2_shared_block_every_invocation():
    jcfg, tcfg = (c.with_overrides(num_layers=3) for c in
                  (jax_smoke("zamba2-1.2b"), get_smoke_config("zamba2-1.2b")))
    jparams = jregistry.init_params(jcfg, jax.random.key(0))
    params = params_from_jax(_flatten(jparams), device="cpu")
    assert hybrid.num_invocations(tcfg) == jhybrid.num_invocations(jcfg) == 2
    assert hybrid._layer_groups(tcfg) == jhybrid._layer_groups(jcfg)
    x, emb0 = _x(jcfg), _x(jcfg, seed=3)
    pos = np.arange(16)[None, :]
    hd = jcfg.resolved_head_dim
    jc, js = jcommon.rope_cos_sin(jnp.asarray(pos), hd, jcfg.rope_theta)
    tc, ts = common.rope_cos_sin(torch.tensor(pos), hd, tcfg.rope_theta)
    for inv in range(2):
        _close(hybrid.shared_block_apply(params["shared"], torch.tensor(x),
                                         torch.tensor(emb0), inv, tc, ts,
                                         tcfg),
               jhybrid.shared_block_apply(jparams["shared"], jnp.asarray(x),
                                          jnp.asarray(emb0), inv, jc, js,
                                          jcfg))


def test_forward_logits_loss_and_every_grad_leaf(models):
    jcfg, tcfg, jparams, flat = models
    toks, labels = _batch(jcfg.vocab_size)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.tensor(toks), "labels": torch.tensor(labels)}
    params = params_from_jax(flat, device="cpu")
    jlogits, _ = jregistry.forward_logits(jparams, jb, jcfg)
    _close(registry.forward_logits(params, tb, tcfg), jlogits)

    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jregistry.loss_fn(p, jb, jcfg), has_aux=True)(jparams)
    leaves = [t.requires_grad_() for _, t in tree_items(params)]
    loss, metrics = registry.loss_fn(params, tb, tcfg)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    _close(loss, jloss)
    assert int(metrics["tokens"]) == int((labels >= 0).sum())
    jflat = _flatten(jgrads)
    paths = [p for p, _ in tree_items(params)]
    assert sorted(paths) == sorted(jflat)
    for path, g in zip(paths, grads):
        np.testing.assert_allclose(g.numpy(), jflat[path], err_msg=path,
                                   **TOL)


def test_client_axis_forward_matches_per_client(models):
    """The leading client axis of the fed step: stacked params (each client
    with its own u, a_log, shared block, ...) and batches give each
    client's own one-model loss."""
    tcfg, flat = models[1], models[3]
    params = params_from_jax(flat, device="cpu")
    gen = torch.Generator().manual_seed(3)
    others = [tree_map(lambda a: a + 0.05 * torch.randn(a.shape,
                                                        generator=gen),
                       params) for _ in range(2)]
    clients = [params] + others
    stacked = tree_map(lambda *a: torch.stack(a), *clients)
    if tcfg.family.value == "ssm":
        u = stacked["blocks"]["u"]
        assert not torch.equal(u[0], u[1]) and not torch.equal(u[1], u[2])
    toks, labels = _batch(tcfg.vocab_size, lead=(3,))
    tb = {"tokens": torch.tensor(toks), "labels": torch.tensor(labels)}
    losses, _ = registry.loss_fn(stacked, tb, tcfg)
    assert losses.shape == (3,)
    for i, p in enumerate(clients):
        one = {k: v[i] for k, v in tb.items()}
        _close(losses[i], registry.loss_fn(p, one, tcfg)[0].detach())


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_analytical_is_exact(arch, smoke):
    jcfg = jax_smoke(arch) if smoke else jax_get_config(arch)
    tcfg = get_smoke_config(arch) if smoke else get_config(arch)
    assert registry.count_params_analytical(tcfg) \
        == jregistry.count_params_analytical(jcfg)
    assert tcfg.param_count() == jcfg.param_count()
