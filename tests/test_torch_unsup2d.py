"""The port's 2D unsupervised baselines held against hebbax: the networks
``unet_vae`` (UNetVAE2D), ``unet_superpix`` (UNetSuperpix2D) and
``unet_ddpm`` (DDPMUNet, TimeUNet2D), the bridge's Dense <-> Linear map,
``sinusoidal_pos_emb``, ``elbo_metric`` / ``kl_loss``, every function of
``ops/diffusion.py`` (at 8 timesteps), ``ops/superpix.py``, and one step
of each pretrainer.

hebbax's variables go through ``hebbax_torch.bridge.from_flax`` into the
port's model; both run the same numpy-seeded 2x32x32 input at the
networks' own widths with dropout off (see test_torch_unet2d.py).  The
random draws are hebbax's: the VAE's latent eps is recorded where hebbax
draws it (``jax.random.normal`` wrapped with an ordered
``jax.debug.callback``, so it works inside hebbax's jitted step) and
passed to the port; the diffusion draws are recomputed from hebbax's key
splits (the step's three-way split, ``super_forward``'s ``k_t`` / ``k_n``,
``sample_mask``'s per-step splits) and passed in as ``t`` and ``noise``.

Tolerances (float32 rounding that differs between XLA and torch, as
test_torch_deep4.py states them): eval outputs rtol 1e-4 / atol 1e-5,
but atol 2e-5 for TimeUNet2D (23 convs up to 512 wide, 4608-term sums;
seen: 1.3e-5 on 1 of 4096 outputs); training forwards and logits atol
1e-4 (train-mode BN over the 2x2 bottleneck); training losses rtol 1e-4.
One step of each pretrainer (SGD, lr 0.1, momentum 0.9) is held in
float64 for its parameters and BN statistics, rtol 1e-6 / atol 1e-7: in
float32 a step leaves a few percent of some updates to rounding (see
the step section), and in float64 the agreement stops at hebbax's float32
align-corners resize weights (``_linear_interp_matrix``; seen: 5.6e-9).
``sinusoidal_pos_emb``: atol 1.2e-7 * t (exp rounds 3 of the 32
frequencies one ulp apart, and t multiplies that).  The diffusion math
and the losses on given arrays: rtol 1e-5 / 1e-6 (schedules, float64
numpy rounded once to float32, are equal).  Superpixel masks are equal
to the bit.  The Linear init is held to its distribution, not its
values.
"""

import copy
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

import hebbax.models.ddpm as jddpm
import hebbax.models.unet2d as junet
from hebbax.cli import pretrain_unsup_2d as j_cli
from hebbax.config.schedules import make_optimizer as j_make_optimizer
from hebbax.engine.state import TrainState as JState
from hebbax.engine.steps import make_probe_pretrain_step as j_probe_step
from hebbax.ops import diffusion as jdiff
from hebbax.ops import losses as jlosses
from hebbax.ops import superpix as jsp
from hebbax_torch import bridge
from hebbax_torch.config.schedules import make_optimizer
from hebbax_torch.engine.state import TrainState
from hebbax_torch.engine.steps import make_probe_pretrain_step
from hebbax_torch.models import get_network, network_meta, primary_logits
import hebbax_torch.models.ddpm as tddpm
from hebbax_torch.models.ddpm import (DDPMUNet, TimeUNet2D, dense,
                                      sinusoidal_pos_emb)
from hebbax_torch.models.unet2d import UNetSuperpix2D, UNetVAE2D
from hebbax_torch.ops import diffusion as tdiff
from hebbax_torch.ops import losses as tlosses
from hebbax_torch.ops import superpix as tsp
from hebbax_torch.ops.dropout import Dropout
from hebbax_torch.ops.losses import dice_loss

from test_torch_unet2d import no_dropout, to_nchw, to_nhwc  # noqa: F401

torch.set_num_threads(2)

NETS = {"unet_vae": (junet.UNetVAE2D, UNetVAE2D),
        "unet_superpix": (junet.UNetSuperpix2D, UNetSuperpix2D),
        "unet_ddpm": (jddpm.DDPMUNet, DDPMUNet)}
LR = 0.1


def ddpm_variables(jm, key, in_ch=3, n_cls=2, shape=(2, 32, 32)):
    """hebbax's superdiff init: the probe, ``net`` and ``net_seg`` each
    initialised and merged (``hebbax/cli/pretrain_unsup_2d.py::build``)."""
    variables = jm.init(key, jnp.zeros(shape + (n_cls,)), mode="probe",
                        train=False)
    params, stats = dict(variables["params"]), {}
    for mode in ("net", "net_seg"):
        v = jm.init(key, jnp.zeros(shape + (in_ch + n_cls,)),
                    jnp.zeros(shape[:1], jnp.int32), mode=mode, train=False)
        params.update(v["params"])
        stats.update(v["batch_stats"])
    return {"params": params, "batch_stats": stats}


def make_pair(name, seed=0):
    """(hebbax model, numpy variables, port model carrying them, numpy
    NHWC input), dropout off in the port."""
    jcls, _ = NETS[name]
    jm = jcls(in_channels=3, n_cls=2)
    x = np.random.default_rng(seed).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    variables = (ddpm_variables(jm, key) if name == "unet_ddpm"
                 else jm.init(key, jnp.asarray(x), train=False))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    tm = get_network(name, 3, 2, generator=torch.Generator().manual_seed(0))
    tm.load_state_dict(bridge.from_flax(variables["params"],
                                        variables["batch_stats"]))
    for m in tm.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return jm, variables, tm, x


class DrawRecorder:
    """Records hebbax's ``jax.random.normal`` / ``randint`` draws while
    installed, in order, as (kind, array)."""

    def __init__(self, monkeypatch):
        self.records = []
        for kind in ("normal", "randint"):
            orig = getattr(jax.random, kind)

            def draw(*a, _orig=orig, _kind=kind, **k):
                z = _orig(*a, **k)
                jax.debug.callback(
                    lambda v, _k=_kind: self.records.append(
                        (_k, np.asarray(v))), z, ordered=True)
                return z

            monkeypatch.setattr(jax.random, kind, draw)

    def pop(self, kind):
        got, v = self.records.pop(0)
        assert got == kind
        return (to_nchw(v) if kind == "normal"
                else torch.from_numpy(np.array(v)).long())


def _close(got, ref, **tol):
    np.testing.assert_allclose(got, np.asarray(ref), **tol)


# -- registry, parameter trees, bridge -------------------------------------------

@pytest.mark.parametrize("name", sorted(NETS))
def test_registry_entries(name):
    from hebbax.models.registry import network_meta as j_meta
    assert network_meta(name) == j_meta(name)
    tm = get_network(name, 3, 2, generator=torch.Generator().manual_seed(0))
    assert isinstance(tm, NETS[name][1])
    with pytest.raises(KeyError):
        network_meta(name + "_s2d")            # hebbax has none either


def test_primary_logits_per_output_kind():
    a, b = torch.zeros(1), torch.ones(1)
    assert primary_logits("unet_vae", {"output": a, "mu": b}) is a
    assert primary_logits("unet_superpix", (a, b)) is a
    assert primary_logits("unet_ddpm", a) is a


@pytest.mark.parametrize("name", sorted(NETS))
def test_bridge_round_trip(name):
    """The flax tree maps one to one onto the port's state_dict (the
    strict load in make_pair) and back, Dense kernels transposed."""
    _, variables, tm, _ = make_pair(name)
    params, stats = bridge.to_flax(tm.state_dict())
    for tree, ref in ((params, variables["params"]),
                      (stats, variables["batch_stats"])):
        f, r = (traverse_util.flatten_dict(tree),
                traverse_util.flatten_dict(ref))
        assert set(f) == set(r)
        for p in r:
            np.testing.assert_array_equal(f[p], r[p])
    if name == "unet_ddpm":
        k = variables["params"]["net"]["time_fc1"]["kernel"]
        assert k.shape == (64, 256)
        assert tm.net.time_fc1.weight.shape == (256, 64)
        assert torch.equal(tm.net.time_fc1.weight, torch.from_numpy(np.array(k.T)))


def test_dense_init_is_lecun_normal():
    w = dense(256, 64, generator=torch.Generator().manual_seed(0))
    std = math.sqrt(1.0 / 256)
    v = w.weight.detach().numpy()
    assert w.weight.shape == (64, 256) and torch.all(w.bias == 0)
    # truncated at 2 of the pre-truncation std, which is std / 0.8796
    assert np.abs(v).max() <= 2 * std / 0.87962566103423978
    assert abs(v.std() / std - 1) < 0.03 and abs(v.mean()) < 3e-3
    ref = np.asarray(jax.nn.initializers.lecun_normal()(
        jax.random.PRNGKey(0), (256, 64)))
    assert abs(v.std() / ref.std() - 1) < 0.04


# -- forwards ------------------------------------------------------------------

def test_vae_eval_forward_matches_without_latent(no_dropout):
    jm, variables, tm, x = make_pair("unet_vae", seed=1)
    ref = jm.apply(variables, jnp.asarray(x), train=False)   # eps = 0
    tm.eval()
    with torch.no_grad():
        got = tm(to_nchw(x))
    assert set(got) == {"output", "mu", "log_var", "reconstr"}
    for k in got:
        _close(to_nhwc(got[k]), ref[k], rtol=1e-4, atol=1e-5, err_msg=k)


def test_vae_forward_with_hebbax_eps(no_dropout, monkeypatch):
    jm, variables, tm, x = make_pair("unet_vae", seed=2)
    rec = DrawRecorder(monkeypatch)        # after init, which draws too
    ref, _ = jm.apply(variables, jnp.asarray(x), train=True,
                      rngs={"latent": jax.random.PRNGKey(4)},
                      mutable=["batch_stats"])
    jax.effects_barrier()
    assert len(rec.records) == 1 and rec.records[0][1].shape == (2, 2, 2, 256)
    tm.train()
    with torch.no_grad():
        got = tm(to_nchw(x), eps=rec.pop("normal"))
        zero = tm(to_nchw(x), eps=torch.zeros(2, 256, 2, 2))
    for k in got:
        _close(to_nhwc(got[k]), ref[k], rtol=1e-4, atol=1e-4, err_msg=k)
    assert not np.allclose(to_nhwc(zero["output"]), np.asarray(ref["output"]))


def test_vae_draws_eps_from_its_generator():
    tm = get_network("unet_vae", 3, 2,
                     generator=torch.Generator().manual_seed(0),
                     latent_generator=torch.Generator().manual_seed(3))
    std = torch.ones(2, 256, 2, 2)
    a = tm.draw_latent(std)
    tm.latent_generator = torch.Generator().manual_seed(3)
    assert torch.equal(a, tm.draw_latent(std)) and a.abs().sum() > 0
    tm.latent_generator = None
    assert torch.equal(tm.draw_latent(std), torch.zeros_like(std))


def test_superpix_eval_forward_matches(no_dropout):
    jm, variables, tm, x = make_pair("unet_superpix", seed=3)
    ref = jm.apply(variables, jnp.asarray(x), train=False)
    tm.eval()
    with torch.no_grad():
        got = tm(to_nchw(x))
    assert got[1].shape == (2, 2, 32, 32)
    for g, r in zip(got, ref):
        _close(to_nhwc(g), r, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode,ch", [("net", 5), ("net_seg", 5),
                                     ("probe", 2)])
def test_ddpm_eval_forward_matches(no_dropout, mode, ch):
    jm, variables, tm, _ = make_pair("unet_ddpm", seed=4)
    x = np.random.default_rng(5).standard_normal(
        (2, 32, 32, ch)).astype(np.float32)
    t = np.array([0, 999], np.int32)
    jt = jnp.asarray(t) if mode != "probe" else None
    ref = jm.apply(variables, jnp.asarray(x), jt, mode=mode, train=False)
    tm.eval()
    with torch.no_grad():
        got = tm(to_nchw(x), torch.from_numpy(t).long()
                 if mode != "probe" else None, mode=mode)
    assert got.shape[1] == {"net": 3, "net_seg": 2, "probe": 2}[mode]
    _close(to_nhwc(got), ref, rtol=1e-4, atol=2e-5)


def test_ddpm_train_forward_matches(no_dropout):
    jm, variables, tm, _ = make_pair("unet_ddpm", seed=6)
    x = np.random.default_rng(7).standard_normal(
        (2, 32, 32, 5)).astype(np.float32)
    t = np.array([3, 5], np.int32)
    ref, mut = jm.apply(variables, jnp.asarray(x), jnp.asarray(t),
                        mode="net_seg", train=True, mutable=["batch_stats"])
    tm.train()
    with torch.no_grad():
        got = tm(to_nchw(x), torch.from_numpy(t).long(), mode="net_seg")
    _close(to_nhwc(got), ref, rtol=1e-4, atol=1e-4)
    sd = tm.state_dict()
    for path, v in traverse_util.flatten_dict(mut["batch_stats"]).items():
        name = ".".join(path[:-1]) + (".running_mean" if path[-1] == "mean"
                                      else ".running_var")
        np.testing.assert_allclose(sd[name].numpy(), np.asarray(v),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_ddpm_unknown_mode_raises():
    tm = DDPMUNet(3, 2, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError):
        tm(torch.zeros(1, 2, 16, 16), mode="sample")
    assert isinstance(tm.net, TimeUNet2D)


def test_sinusoidal_pos_emb_matches():
    t = np.array([0, 1, 7, 500, 999], np.int32)
    ref = jddpm.sinusoidal_pos_emb(jnp.asarray(t), 64)
    got = sinusoidal_pos_emb(torch.from_numpy(t), 64)
    assert got.shape == (5, 64) and got.dtype == torch.float32
    for row, ti in enumerate(t):
        _close(got[row].numpy(), ref[row], rtol=0,
               atol=1.2e-7 * max(int(ti), 1))


# -- losses ---------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_elbo_metric_matches(weighted):
    rng = np.random.default_rng(8)
    out = {"reconstr": rng.standard_normal((3, 8, 8, 3)),
           "mu": rng.standard_normal((3, 2, 2, 16)),
           "log_var": 0.3 * rng.standard_normal((3, 2, 2, 16))}
    out = {k: v.astype(np.float32) for k, v in out.items()}
    target = rng.standard_normal((3, 8, 8, 3)).astype(np.float32)
    w = np.array([1, 0, 1], np.float32) if weighted else None
    ref = jlosses.elbo_metric({k: jnp.asarray(v) for k, v in out.items()},
                              jnp.asarray(target), beta=0.7,
                              weight=None if w is None else jnp.asarray(w))
    got = tlosses.elbo_metric({k: to_nchw(v) for k, v in out.items()},
                              to_nchw(target), beta=0.7,
                              weight=None if w is None else
                              torch.from_numpy(w))
    _close(float(got), float(ref), rtol=1e-6)
    # the KLD sums over the channel axis: summing over another is finite
    # but different
    wrong = dict(out, mu=out["mu"][..., :2], log_var=out["log_var"][..., :2])
    assert not np.isclose(float(tlosses.elbo_metric(
        {k: to_nchw(v) for k, v in wrong.items()}, to_nchw(target))),
        float(got))


def test_kl_loss_matches():
    rng = np.random.default_rng(9)
    m = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
    s = (0.5 + rng.random((2, 4, 4, 8))).astype(np.float32)
    _close(float(tlosses.kl_loss(to_nchw(m), to_nchw(s))),
           float(jlosses.kl_loss(jnp.asarray(m), jnp.asarray(s))),
           rtol=1e-6)


# -- diffusion ------------------------------------------------------------------

T = 8
OBJECTIVES = ("pred_noise", "pred_x0", "pred_v")


@pytest.mark.parametrize("beta", ["linear", "cosine", "sigmoid"])
@pytest.mark.parametrize("objective", OBJECTIVES)
def test_make_schedule_matches(beta, objective):
    ref = jdiff.make_schedule(T, objective, beta)
    got = tdiff.make_schedule(T, objective, beta)
    assert got.timesteps == T and got.objective == objective
    for f in ("betas", "alphas_cumprod", "alphas_cumprod_prev",
              "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
              "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
              "posterior_variance", "posterior_log_variance_clipped",
              "posterior_mean_coef1", "posterior_mean_coef2",
              "loss_weight"):
        assert getattr(got, f).dtype == torch.float32
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)
    for fn in (jdiff.linear_beta_schedule, jdiff.cosine_beta_schedule,
               jdiff.sigmoid_beta_schedule):
        np.testing.assert_array_equal(
            getattr(tdiff, fn.__name__)(T), fn(T))
    with pytest.raises(ValueError):
        tdiff.make_schedule(T, "pred_eps")


def _arrays(seed, c=3):
    rng = np.random.default_rng(seed)
    a, b = (rng.standard_normal((2, 4, 4, c)).astype(np.float32)
            for _ in range(2))
    t = np.array([0, T - 1], np.int32)
    return a, b, t


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_elementwise_functions_match(objective):
    js, ts = (jdiff.make_schedule(T, objective),
              tdiff.make_schedule(T, objective))
    a, b, t = _arrays(10)
    ja, jb, jt = jnp.asarray(a), jnp.asarray(b), jnp.asarray(t)
    ta, tb, tt = to_nchw(a), to_nchw(b), torch.from_numpy(t).long()
    for name in ("q_sample", "predict_start_from_noise",
                 "predict_noise_from_start", "predict_v",
                 "predict_start_from_v"):
        _close(to_nhwc(getattr(tdiff, name)(ts, ta, tt, tb)),
               getattr(jdiff, name)(js, ja, jt, jb), rtol=1e-6, atol=1e-6,
               err_msg=name)
    for clip in (False, True):
        _close(to_nhwc(tdiff.pred_x_start(ts, ta, tt, 3 * tb, clip=clip)),
               jdiff.pred_x_start(js, ja, jt, 3 * jb, clip=clip),
               rtol=1e-6, atol=1e-6)
    mean, log_var = tdiff.q_posterior(ts, ta, tb, tt)
    jmean, jlog_var = jdiff.q_posterior(js, ja, jb, jt)
    _close(to_nhwc(mean), jmean, rtol=1e-6, atol=1e-6)
    _close(log_var.reshape(-1).numpy(), jnp.reshape(jlog_var, -1),
           rtol=1e-6)
    _close(to_nhwc(tdiff.unnormalize(tdiff.normalize(ta))), a, rtol=1e-6,
           atol=1e-7)


def _toy_models(c_out):
    """The same deterministic 'network' in both layouts: the first c_out
    channels of its input scaled, plus a per-sample term in t."""
    def jmodel(x, t):
        return (0.3 * x[..., :c_out]
                + 0.1 * t.astype(jnp.float32)[:, None, None, None])

    def tmodel(x, t):
        return 0.3 * x[:, :c_out] + 0.1 * t.float()[:, None, None, None]
    return jmodel, tmodel


@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("with_loss_fn", [False, True])
def test_super_p_losses_matches(objective, with_loss_fn):
    js, ts = (jdiff.make_schedule(T, objective),
              tdiff.make_schedule(T, objective))
    a, b, t = _arrays(11, c=2)
    jm, tm = _toy_models(2)
    # hebbax draws the noise from a key: recompute its draw
    key = jax.random.PRNGKey(13)
    jnoise = np.asarray(jax.random.normal(key, a.shape, jnp.float32))
    ref_loss, ref_pred = jdiff.super_p_losses(
        js, jm, jnp.asarray(a), jnp.asarray(b), jnp.asarray(t), key,
        loss_fn=jlosses.dice_loss if with_loss_fn else None)
    got_loss, got_pred = tdiff.super_p_losses(
        ts, tm, to_nchw(a), to_nchw(b), torch.from_numpy(t).long(),
        to_nchw(jnoise), loss_fn=dice_loss if with_loss_fn else None)
    _close(float(got_loss), float(ref_loss), rtol=1e-5)
    _close(to_nhwc(got_pred), ref_pred, rtol=1e-5, atol=1e-6)


def _forward_draws(key, b, diffused_shape, timesteps=T):
    """super_forward's t and noise from hebbax's key split."""
    k_t, k_n = jax.random.split(key)
    t = jax.random.randint(k_t, (b,), 0, timesteps)
    noise = jax.random.normal(k_n, diffused_shape, jnp.float32)
    return torch.from_numpy(np.asarray(t)).long(), to_nchw(np.asarray(noise))


@pytest.mark.parametrize("conditioner,mask_kind", [
    ("img", "int"), ("target", "int"), ("img) #", "int"),
    ("target", "soft")])
def test_super_forward_matches_with_hebbax_draws(conditioner, mask_kind):
    js, ts = (jdiff.make_schedule(T, "pred_noise"),
              tdiff.make_schedule(T, "pred_noise"))
    rng = np.random.default_rng(14)
    img = rng.random((2, 8, 8, 3)).astype(np.float32)
    if mask_kind == "int":
        mask = (rng.random((2, 8, 8)) < 0.5).astype(np.int32)
        tmask = torch.from_numpy(mask).long()
    else:
        mask = rng.random((2, 8, 8, 2)).astype(np.float32)
        tmask = to_nchw(mask)
    diffused = 3 if conditioner == "target" else 2
    jm, tm = _toy_models(diffused)
    key = jax.random.PRNGKey(15)
    t, noise = _forward_draws(key, 2, (2, 8, 8, diffused))
    ref_loss, ref_pred = jdiff.super_forward(
        js, jm, jnp.asarray(img), jnp.asarray(mask), key, 2,
        conditioner=conditioner)
    got_loss, got_pred = tdiff.super_forward(
        ts, tm, to_nchw(img), tmask, 2, conditioner=conditioner, t=t,
        noise=noise)
    _close(float(got_loss), float(ref_loss), rtol=1e-5)
    _close(to_nhwc(got_pred), ref_pred, rtol=1e-5, atol=1e-6)
    # drawn from a generator: t in range, the stream's shape
    g = torch.Generator().manual_seed(0)
    loss, pred = tdiff.super_forward(ts, tm, to_nchw(img), tmask, 2,
                                     conditioner=conditioner, generator=g)
    assert pred.shape[1] == diffused and np.isfinite(float(loss))


def test_draw_timesteps_range():
    ts = tdiff.make_schedule(T)
    t = tdiff.draw_timesteps(ts, 1000,
                             generator=torch.Generator().manual_seed(0))
    assert int(t.min()) == 0 and int(t.max()) == T - 1


@pytest.mark.parametrize("n_cls,conditioner", [(2, "img"), (3, "img"),
                                               (2, "target")])
def test_sample_mask_matches_with_hebbax_draws(n_cls, conditioner):
    js, ts = (jdiff.make_schedule(T, "pred_noise"),
              tdiff.make_schedule(T, "pred_noise"))
    img = np.random.default_rng(16).random((2, 8, 8, 3)).astype(np.float32)
    c_in = 3 if conditioner == "target" else n_cls
    jm, tm = _toy_models(c_in)
    key = jax.random.PRNGKey(17)
    # sample_mask's splits: k0 for the start, then one per reverse step
    k0, k = jax.random.split(key)
    shape = (2, 8, 8, c_in)
    noise = to_nchw(np.asarray(jax.random.normal(k0, shape, jnp.float32)))
    steps = []
    for _ in range(T):
        k, kn = jax.random.split(k)
        steps.append(to_nchw(np.asarray(jax.random.normal(kn, shape,
                                                          jnp.float32))))
    ref = jdiff.sample_mask(js, jm, jnp.asarray(img), key, n_cls,
                            conditioner=conditioner)
    got = tdiff.sample_mask(ts, tm, to_nchw(img), n_cls,
                            conditioner=conditioner, noise=noise,
                            step_noise=torch.stack(steps))
    _close(to_nhwc(got), ref, rtol=1e-5, atol=1e-5)
    drawn = tdiff.sample_mask(ts, tm, to_nchw(img), n_cls,
                              conditioner=conditioner,
                              generator=torch.Generator().manual_seed(0))
    assert drawn.shape == got.shape and torch.isfinite(drawn).all()


# -- superpixels ----------------------------------------------------------------

def _blocky(seed, shape):
    """Images of few levels, so the flood fill grows regions."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 3, shape) / 10.0).astype(np.float32)


@pytest.mark.parametrize("shape,nd", [
    ((4, 16, 16, 3), None),          # 2D channels-last
    ((3, 12, 12), None),             # 2D bare
    ((2, 6, 6, 6, 1), None),         # 3D channels-last
    ((2, 6, 6, 6), 3)])              # 3D bare, nd given
def test_superpix_batch_bit_equal(shape, nd):
    images = _blocky(18, shape)
    ref = jsp.superpix_batch(np.random.default_rng(5), images, nd=nd)
    got = tsp.superpix_batch(np.random.default_rng(5), images, nd=nd)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    assert got.sum() > got.shape[0]          # regions grew past the seed
    for a, b in ((0.05, None), (0.0, None)):
        np.testing.assert_array_equal(
            tsp.superpix_batch(np.random.default_rng(6), images, a, nd),
            jsp.superpix_batch(np.random.default_rng(6), images, a, nd))


def test_superpix_masks_seed_like_hebbax():
    """The CLI's per-batch seed (the run seed and a CRC of the first
    image's 4x4 corner) gives hebbax's masks."""
    import zlib

    from hebbax_torch.cli.pretrain_unsup_2d import superpix_masks
    images = _blocky(19, (3, 16, 16, 3))
    digest = zlib.crc32(images[0, :4, :4].tobytes())
    ref = jsp.superpix_batch(np.random.default_rng(
        np.random.SeedSequence([7, digest])), images)
    np.testing.assert_array_equal(superpix_masks(images, 7), ref)


# -- one pretraining step each ----------------------------------------------------
#
# Each step runs twice per package.  In float32 (the packages' own losses)
# the losses and logits are compared.  In float64 (hebbax under
# ``jax.enable_x64``, the port ``.double()``) every parameter and BN
# statistic is: a step backpropagates through batch norms over the 2x2
# bottleneck of a batch of 2, where float32 leaves a few percent of an
# update to rounding (seen for superdiff's net_seg: the port 1.4% from its
# own float64 step, hebbax 6%, flax's E[x^2]-E[x]^2 variance), so float64
# is where a step can be held to its math.  The float64 runs use a soft
# dice without the packages' float32 cast, and hebbax's loss scalars are
# cast to float32 at the end (it seeds its two pullbacks with float32
# ones), which leaves the gradients float64.

def _batch(seed, with_superpix=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    m = (rng.random((2, 32, 32)) < 0.4).astype(np.int32)
    sp = (rng.random((2, 32, 32)) < 0.2).astype(np.int32)
    jb = {"image": jnp.asarray(x), "mask": jnp.asarray(m)}
    tb = {"image": to_nchw(x), "mask": torch.from_numpy(m).long()}
    if with_superpix:
        jb["mask_superpix"] = jnp.asarray(sp)
        tb["mask_superpix"] = torch.from_numpy(sp).long()
    return jb, tb


def _j_dice64(logits, target):
    probs = jax.nn.softmax(logits, axis=-1)
    onehot = jax.nn.one_hot(target, logits.shape[-1], dtype=logits.dtype)
    num = 2.0 * jnp.sum(probs * onehot, axis=(1, 2)) + 1.0
    den = jnp.sum(probs ** 2 + onehot ** 2, axis=(1, 2)) + 1.0
    return jnp.mean(1.0 - num / den).astype(jnp.float32)


def _t_dice64(logits, target):
    probs = torch.softmax(logits, dim=1)
    onehot = torch.movedim(torch.nn.functional.one_hot(
        target, logits.shape[1]), -1, 1).to(logits.dtype)
    num = 2.0 * torch.sum(probs * onehot, dim=(2, 3)) + 1.0
    den = torch.sum(probs ** 2 + onehot ** 2, dim=(2, 3)) + 1.0
    return torch.mean(1.0 - num / den)


def _emb64(t, dim, theta=10000.0):
    """sinusoidal_pos_emb as hebbax computes it under x64: float64
    frequencies times the float32 t."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float64)
                      * (-math.log(theta) / (half - 1)))
    args = t.to(torch.float32).double()[:, None] * freqs[None]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def _sgd(tm):
    """The port's SGD at LR, momentum 0.9, no decay."""
    return TrainState(model=tm, optimizer=make_optimizer(
        "sgd", tm.parameters(), momentum=0.9), schedule=lambda count: LR)


def _j_sgd():
    return j_make_optimizer("sgd", LR, momentum=0.9)


def _double(batch):
    return {k: (v.double() if v.is_floating_point() else v)
            for k, v in batch.items()}


def _hebbax_step(make_jstep, variables, jb, key, x64=False):
    """One hebbax step from ``variables`` (in float64 under x64); returns
    numpy (params, batch_stats) and outputs."""
    with jax.enable_x64(x64):
        dt = jnp.float64 if x64 else jnp.float32
        cast = lambda a: (jnp.asarray(a, dt)                # noqa: E731
                          if np.issubdtype(np.asarray(a).dtype, np.floating)
                          else jnp.asarray(a))
        v = jax.tree_util.tree_map(cast, variables)
        tx = _j_sgd()
        state = JState(params=v["params"], batch_stats=v["batch_stats"],
                       opt_state=tx.init(v["params"]), step=0)
        state, out = make_jstep(tx)(state, {k: cast(a) for k, a in
                                            jb.items()}, key)
        jax.effects_barrier()
        return (jax.tree_util.tree_map(np.asarray, (state.params,
                                                    state.batch_stats)),
                {k: np.asarray(a) for k, a in out.items()})


def _state64_close(tm64, jstate64):
    ref = bridge.from_flax(*jstate64)
    sd = tm64.state_dict()
    assert set(sd) == set(ref)
    for name, v in ref.items():
        np.testing.assert_allclose(sd[name].numpy(), v.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


def _losses_close(out, jout, keys):
    for k in keys:
        _close(float(out[k]), float(jout[k]), rtol=1e-4, atol=1e-12,
               err_msg=k)
    _close(to_nhwc(out["logits"]), jout["logits"], rtol=1e-4, atol=1e-4)


# the pretext losses: (hebbax float32, port float32, hebbax float64, port
# float64)
UNSUP = {
    "unet_vae": (
        lambda o, b: jlosses.elbo_metric(o, b["image"]),
        lambda o, b: tlosses.elbo_metric(o, b["image"]),
        lambda o, b: jlosses.elbo_metric(o, b["image"]).astype(jnp.float32),
        lambda o, b: tlosses.elbo_metric(o, b["image"])),
    "unet_superpix": (
        lambda o, b: jlosses.dice_loss(o[1], b["mask_superpix"]),
        lambda o, b: dice_loss(o[1], b["mask_superpix"]),
        lambda o, b: _j_dice64(o[1], b["mask_superpix"]),
        lambda o, b: _t_dice64(o[1], b["mask_superpix"])),
    # a pretext loss that reaches no parameter: only the probe trains
    "probe_only": (
        lambda o, b: 0.0 * jnp.sum(o[1]),
        lambda o, b: 0.0 * torch.sum(o[1]),
        lambda o, b: (0.0 * jnp.sum(o[1])).astype(jnp.float32),
        lambda o, b: 0.0 * torch.sum(o[1]))}


@pytest.mark.parametrize("name,unsup", [("unet_vae", "unet_vae"),
                                        ("unet_superpix", "unet_superpix"),
                                        ("unet_superpix", "probe_only")])
def test_probe_pretrain_step_matches(no_dropout, monkeypatch, name, unsup):
    jm, variables, tm, _ = make_pair(name, seed=20)
    tm64 = copy.deepcopy(tm).double()
    rec = DrawRecorder(monkeypatch)
    jb, tb = _batch(21, with_superpix=True)
    key = jax.random.PRNGKey(22)
    j32, t32, j64, t64 = UNSUP[unsup]
    _, jout = _hebbax_step(lambda tx: j_probe_step(
        jm, name, jlosses.dice_loss, tx, j32), variables, jb, key)
    jstate64, _ = _hebbax_step(lambda tx: j_probe_step(
        jm, name, _j_dice64, tx, j64), variables, jb, key, x64=True)
    if name == "unet_vae":            # hebbax's eps, float32 then float64
        eps, eps64 = rec.pop("normal"), rec.pop("normal")
        tm.draw_latent = lambda std: eps
        tm64.draw_latent = lambda std: eps64
    assert rec.records == []

    state, out = make_probe_pretrain_step(tm, name, dice_loss, t32)(
        _sgd(tm), tb)
    assert state.step == 1 and set(out) == {"loss", "loss_unsup", "logits"}
    _losses_close(out, jout, ("loss", "loss_unsup"))
    before = {n: p.detach().clone() for n, p in tm64.named_parameters()}
    make_probe_pretrain_step(tm64, name, _t_dice64, t64)(_sgd(tm64),
                                                         _double(tb))
    _state64_close(tm64, jstate64)
    after = dict(tm64.named_parameters())
    moved = {n for n in after if not torch.equal(after[n], before[n])}
    head = {n for n in after if n.startswith("out_conv.")}
    if unsup == "probe_only":
        assert moved == head               # the probe reaches the head only
    else:                                  # the pretext loss reaches all
        assert {n for n in after if n.endswith(".weight")} <= moved


def test_superdiff_step_matches(no_dropout, monkeypatch):
    from hebbax_torch.cli.pretrain_unsup_2d import make_superdiff_step
    jm, variables, tm, _ = make_pair("unet_ddpm", seed=23)
    tm64 = copy.deepcopy(tm).double()
    jb, tb = _batch(24)
    key = jax.random.PRNGKey(25)
    _, jout = _hebbax_step(lambda tx: j_cli.make_superdiff_step(
        jm, jlosses.dice_loss, tx, 2, T), variables, jb, key)
    # float32: the draws from hebbax's key splits (the step's three-way
    # split, then each super_forward's)
    k1, k2, _ = jax.random.split(key, 3)
    t_seg, noise_seg = _forward_draws(k1, 2, (2, 32, 32, 2))
    t_img, noise_img = _forward_draws(k2, 2, (2, 32, 32, 3))
    state, out = make_superdiff_step(tm, dice_loss, 2, T)(
        _sgd(tm), tb, draws={"t_seg": t_seg, "noise_seg": noise_seg,
                             "t_img": t_img, "noise_img": noise_img})
    assert state.step == 1
    _losses_close(out, jout, ("loss", "loss_unsup", "loss_superdiff"))

    # float64: hebbax's draws recorded as it takes them
    rec = DrawRecorder(monkeypatch)
    sf = jdiff.super_forward
    monkeypatch.setattr(jdiff, "super_forward", lambda *a, **k: (
        lambda r: (r[0].astype(jnp.float32), r[1]))(sf(*a, **k)))
    jstate64, _ = _hebbax_step(lambda tx: j_cli.make_superdiff_step(
        jm, _j_dice64, tx, 2, T), variables, jb, key, x64=True)
    draws = {k: rec.pop(kind) for k, kind in (
        ("t_seg", "randint"), ("noise_seg", "normal"),
        ("t_img", "randint"), ("noise_img", "normal"))}
    assert rec.records == []                # (x64 draws other numbers)
    monkeypatch.setattr(tddpm, "sinusoidal_pos_emb", _emb64)
    before = {n: p.detach().clone() for n, p in tm64.named_parameters()}
    make_superdiff_step(tm64, _t_dice64, 2, T)(_sgd(tm64), _double(tb),
                                               draws=draws)
    _state64_close(tm64, jstate64)
    after = dict(tm64.named_parameters())
    moved = {n.split(".")[0] for n in after
             if not torch.equal(after[n], before[n])}
    # final_conv from the probe, net from the image diffusion, net_seg
    # through the pseudo-mask
    assert moved == {"final_conv", "net", "net_seg"}
