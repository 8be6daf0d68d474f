"""Gaussian diffusion math (``hebbax/ops/diffusion.py``), NCHW.

The reference's SuperDiffusion: the diffused variable is channel-
concatenated with a conditioner (image <-> mask), objectives pred_noise /
pred_x0 / pred_v, SNR loss weighting, and a reverse-process mask sampler.
Schedules follow lucidrains: 'linear' (scaled 1e-4..2e-2), 'cosine',
'sigmoid'; their buffers are computed in float64 numpy and kept as
float32 tensors on the device.

Every random draw (the timesteps ``t``, the ``noise``, the sampler's
per-step noise) comes from an explicit ``torch.Generator`` or is passed
in, so a caller can feed hebbax's ``jax.random`` draws.
"""

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import draw_rows, gmean


def linear_beta_schedule(timesteps):
    scale = 1000 / timesteps
    return np.linspace(scale * 1e-4, scale * 0.02, timesteps,
                       dtype=np.float64)


def cosine_beta_schedule(timesteps, s=0.008):
    steps = timesteps + 1
    t = np.linspace(0, timesteps, steps, dtype=np.float64) / timesteps
    alphas_cumprod = np.cos((t + s) / (1 + s) * math.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


def sigmoid_beta_schedule(timesteps, start=-3, end=3, tau=1):
    steps = timesteps + 1
    t = np.linspace(0, timesteps, steps, dtype=np.float64) / timesteps
    v_start = 1 / (1 + np.exp(-start / tau))
    v_end = 1 / (1 + np.exp(-end / tau))
    alphas_cumprod = (-1 / (1 + np.exp(-((t * (end - start) + start) / tau)))
                      + v_end) / (v_end - v_start)
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


_SCHEDULES = {"linear": linear_beta_schedule,
              "cosine": cosine_beta_schedule,
              "sigmoid": sigmoid_beta_schedule}


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Precomputed buffers, each a (T,) float32 tensor."""

    timesteps: int
    objective: str
    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    loss_weight: torch.Tensor


def make_schedule(timesteps=1000, objective="pred_noise",
                  beta_schedule="sigmoid", device=None) -> DiffusionSchedule:
    betas = _SCHEDULES[beta_schedule](timesteps)
    alphas = 1.0 - betas
    ac = np.cumprod(alphas)
    ac_prev = np.concatenate([[1.0], ac[:-1]])
    posterior_variance = betas * (1.0 - ac_prev) / (1.0 - ac)
    snr = ac / (1 - ac)
    if objective == "pred_noise":
        loss_weight = snr / snr
    elif objective == "pred_x0":
        loss_weight = snr
    elif objective == "pred_v":
        loss_weight = snr / (snr + 1)
    else:
        raise ValueError(objective)

    def f(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(device)

    return DiffusionSchedule(
        timesteps=timesteps, objective=objective,
        betas=f(betas), alphas_cumprod=f(ac),
        alphas_cumprod_prev=f(ac_prev),
        sqrt_alphas_cumprod=f(np.sqrt(ac)),
        sqrt_one_minus_alphas_cumprod=f(np.sqrt(1 - ac)),
        sqrt_recip_alphas_cumprod=f(np.sqrt(1 / ac)),
        sqrt_recipm1_alphas_cumprod=f(np.sqrt(1 / ac - 1)),
        posterior_variance=f(posterior_variance),
        posterior_log_variance_clipped=f(
            np.log(np.maximum(posterior_variance, 1e-20))),
        posterior_mean_coef1=f(betas * np.sqrt(ac_prev) / (1 - ac)),
        posterior_mean_coef2=f((1 - ac_prev) * np.sqrt(alphas) / (1 - ac)),
        loss_weight=f(loss_weight))


def _extract(buf, t, ndim):
    return buf[t].reshape((-1,) + (1,) * (ndim - 1))


def q_sample(sched, x_start, t, noise):
    return (_extract(sched.sqrt_alphas_cumprod, t, x_start.dim()) * x_start
            + _extract(sched.sqrt_one_minus_alphas_cumprod, t,
                       x_start.dim()) * noise)


def predict_start_from_noise(sched, x_t, t, noise):
    return (_extract(sched.sqrt_recip_alphas_cumprod, t, x_t.dim()) * x_t
            - _extract(sched.sqrt_recipm1_alphas_cumprod, t, x_t.dim())
            * noise)


def predict_noise_from_start(sched, x_t, t, x0):
    return ((_extract(sched.sqrt_recip_alphas_cumprod, t, x_t.dim()) * x_t
             - x0)
            / _extract(sched.sqrt_recipm1_alphas_cumprod, t, x_t.dim()))


def predict_v(sched, x_start, t, noise):
    return (_extract(sched.sqrt_alphas_cumprod, t, x_start.dim()) * noise
            - _extract(sched.sqrt_one_minus_alphas_cumprod, t,
                       x_start.dim()) * x_start)


def predict_start_from_v(sched, x_t, t, v):
    return (_extract(sched.sqrt_alphas_cumprod, t, x_t.dim()) * x_t
            - _extract(sched.sqrt_one_minus_alphas_cumprod, t, x_t.dim())
            * v)


def pred_x_start(sched, x_t, t, model_output, clip=False):
    """SuperDiffusion.model_predictions: x0 from the model output under
    the schedule's objective."""
    if sched.objective == "pred_noise":
        x0 = predict_start_from_noise(sched, x_t, t, model_output)
    elif sched.objective == "pred_x0":
        x0 = model_output
    else:
        x0 = predict_start_from_v(sched, x_t, t, model_output)
    if clip:
        x0 = torch.clamp(x0, -1.0, 1.0)
    return x0


def q_posterior(sched, x_start, x_t, t):
    mean = (_extract(sched.posterior_mean_coef1, t, x_t.dim()) * x_start
            + _extract(sched.posterior_mean_coef2, t, x_t.dim()) * x_t)
    log_var = _extract(sched.posterior_log_variance_clipped, t, x_t.dim())
    return mean, log_var


def normalize(x):
    return x * 2.0 - 1.0


def unnormalize(x):
    return (x + 1.0) * 0.5


def super_p_losses(sched, apply_model, x_start, y_start, t, noise,
                   loss_fn=None):
    """SuperDiffusion.p_losses: noise x_start, concatenate the
    conditioner y_start on the channel axis, predict on the concatenation.
    loss_fn=None -> MSE to the objective's target on the x channels;
    loss_fn given -> loss_fn(unnormalized pred_x0, argmax over channels of
    unnormalized x_start), as the reference's live call does.  Either way
    SNR-weighted.  Returns (loss, unnormalized pred_x0)."""
    c_in = x_start.shape[1]
    x = q_sample(sched, x_start, t, noise)
    x = torch.cat([x, y_start], dim=1)
    model_out = apply_model(x, t)
    pred = pred_x_start(sched, x[:, :c_in], t, model_out)
    if loss_fn is None:
        if sched.objective == "pred_noise":
            target = predict_noise_from_start(sched, x[:, :c_in], t, x_start)
        elif sched.objective == "pred_x0":
            target = x_start
        else:
            target = predict_v(sched, x_start, t, noise)
        loss = gmean((model_out - target) ** 2)
    else:
        loss = loss_fn(unnormalize(pred),
                       torch.argmax(unnormalize(x_start), dim=1))
    w = gmean(_extract(sched.loss_weight, t, 1))
    return loss * w, unnormalize(pred)


def draw_timesteps(sched, n, device=None, generator=None):
    """t ~ U{0, ..., T-1}, one per sample."""
    return draw_rows(lambda shape: torch.randint(
        0, sched.timesteps, shape, device=device, generator=generator), (n,))


def super_forward(sched, apply_model, img, target_mask, n_classes,
                  conditioner="img", loss_fn=None, t=None, noise=None,
                  generator=None):
    """SuperDiffusion.forward: one-hot (an integer mask) and normalize both
    streams, draw t, route (x, y) by conditioner.  Any conditioner other
    than 'target' routes like 'img', as the reference's live garbled value
    'img) #' does.  ``t`` and ``noise`` (shaped like the diffused stream)
    are drawn from ``generator``, t first, unless passed in."""
    if target_mask.dim() == img.dim() - 1:
        onehot = torch.movedim(F.one_hot(target_mask.long(), n_classes),
                               -1, 1)
    else:
        onehot = target_mask
    onehot = onehot.to(img.dtype)
    if t is None:
        t = draw_timesteps(sched, img.shape[0], img.device, generator)
    img_n, tgt_n = normalize(img), normalize(onehot)
    x_start, y_start = ((img_n, tgt_n) if conditioner == "target"
                        else (tgt_n, img_n))
    if noise is None:
        noise = draw_rows(lambda shape: torch.randn(
            shape, dtype=x_start.dtype, device=x_start.device,
            generator=generator), x_start.shape)
    return super_p_losses(sched, apply_model, x_start, y_start, t, noise,
                          loss_fn=loss_fn)


def sample_mask(sched, apply_model, img, n_classes, conditioner="img",
                generator=None, noise=None, step_noise=None):
    """Reverse-process sampling of the diffused stream conditioned on the
    other (SuperDiffusion.sample_mask_loop).  ``noise`` (the start) and
    ``step_noise`` ((T, *stream shape), one draw per reverse step) are
    drawn from ``generator`` unless passed in."""
    b, spatial = img.shape[0], tuple(img.shape[2:])
    kw = dict(dtype=img.dtype, device=img.device)
    if n_classes == 2:
        onehot = torch.cat([torch.zeros((b, 1) + spatial, **kw),
                            torch.ones((b, 1) + spatial, **kw)], dim=1)
    else:
        onehot = torch.zeros((b, n_classes) + spatial, **kw)
    img_n, tgt_n = normalize(img), normalize(onehot)
    x_start, y_start = ((img_n, tgt_n) if conditioner == "target"
                        else (tgt_n, img_n))
    c_in = x_start.shape[1]
    if noise is None:
        noise = draw_rows(lambda shape: torch.randn(
            shape, generator=generator, **kw), x_start.shape)
    t_full = torch.full((b,), sched.timesteps - 1, dtype=torch.int64,
                        device=img.device)
    x = q_sample(sched, x_start, t_full, noise)
    for i in range(sched.timesteps):
        t = sched.timesteps - 1 - i
        tb = torch.full((b,), t, dtype=torch.int64, device=img.device)
        model_out = apply_model(torch.cat([x, y_start], dim=1), tb)
        x0 = torch.clamp(pred_x_start(sched, x, tb, model_out), -1.0, 1.0)
        mean, log_var = q_posterior(sched, x0, x, tb)
        z = (step_noise[i] if step_noise is not None
             else draw_rows(lambda shape: torch.randn(
                 shape, generator=generator, **kw), mean.shape))
        x = mean + torch.exp(0.5 * log_var) * z if t > 0 else mean
    return unnormalize(x[:, :c_in])
