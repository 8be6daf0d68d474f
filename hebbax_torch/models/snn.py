"""Spiking VGG9 segmentation network and its non-spiking twin
(``hebbax/models/snn.py`` ``SNNVGG`` and ``ANNVGG``), NCHW.

Architecture 'dl-vgg9':
  features  : conv64, conv64, [avgpool k3 s2 p1], conv128, conv128,
              [avgpool], conv256, atrous256 (pad 2, dil 2), atrous256
  classifier: atrous1024 (pad 12, dil 12), then a 1x1 ``output`` conv
              accumulated WITHOUT leak over the timesteps
All convs are bias-free and xavier-uniform (gain 2).  SNNVGG runs T = 20
timesteps of: Poisson rate-coded input (sign(x) * [U(0,1) <= |x|]), then
per site conv -> per-timestep batch norm (BNTT: scale-only, eps 1e-4,
momentum 0.9, biased variance in the running statistics) -> leaky
integrate-and-fire (leak 0.99, threshold 1, subtract-reset) -> spike with
a surrogate gradient; the accumulated output over T is resized
bilinearly (align_corners) to the input.

hebbax's ``lax.scan`` over the timesteps is a Python loop here.  The BNTT
scales and running statistics keep hebbax's stacked ``(T, C)`` layout and
names (``feat_bn{i}_scale``, ``feat_bn{i}_mean`` / ``_var``, ``cls_bn_*``)
and the conv kernels are root-level parameters named as hebbax's
(``feat{i}``, ``cls_atrous``, ``output``), so one bridge entry covers each
tensor.

The Poisson uniforms come from ``poisson_generator`` on every forward,
eval included (hebbax draws them from its ``poisson`` rng, or from
PRNGKey(0) without one; here a generator seeded 0 stands in), or are
passed in whole as a ``(T, B, C, H, W)`` tensor.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import batch_var_mean, draw_rows
from .common import BatchNorm2d, resize_linear_align_corners

FEATURES = (64, 64, 128, 128, 256, 256, 256)
ATROUS_FROM = 5          # feature layers 5, 6 are atrous (dil 2)
POOL_AFTER = (1, 3)      # avgpool after feature layers 1 and 3 (0-based)
TIMESTEPS = 20
LEAK = 0.99
THRESHOLD = 1.0
BN_EPS = 1e-4


def surrogate_grad(x, grad_type):
    """d spike / dx of the surrogate: Linear 0.3 * relu(1 - |x|),
    FastSigm 1 / (100|x| + 1)^2, Exp exp(-10|x|), PassThru 1."""
    if grad_type == "Linear":
        return 0.3 * torch.clamp(1.0 - torch.abs(x), min=0.0)
    if grad_type == "FastSigm":
        return 1.0 / (100.0 * torch.abs(x) + 1.0) ** 2
    if grad_type == "Exp":
        return torch.exp(-10.0 * torch.abs(x))
    if grad_type == "PassThru":
        return torch.ones_like(x)
    raise ValueError(f"unknown surrogate gradient {grad_type!r}")


class Spike(torch.autograd.Function):
    """Heaviside step (x > 0) forward, the surrogate gradient backward."""

    @staticmethod
    def forward(ctx, x, grad_type="Linear"):
        ctx.save_for_backward(x)
        ctx.grad_type = grad_type
        return (x > 0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * surrogate_grad(x, ctx.grad_type), None


def spike(x, grad_type="Linear"):
    return Spike.apply(x, grad_type)


def poisson_spikes(x, uniforms):
    """Rate-coded input: sign(x) where the uniform draw is <= |x|."""
    return (uniforms <= torch.abs(x)).to(x.dtype) * torch.sign(x)


def avg_pool_3s2p1(x):
    """AvgPool2d(kernel 3, stride 2, padding 1), count_include_pad: the
    output side is ceil(h / 2)."""
    return F.avg_pool2d(x, 3, 2, 1)


def _xavier_gain2(shape, generator=None):
    """xavier_uniform_(gain=2) on a torch (O, I, kh, kw) weight, drawn on
    the CPU from ``generator``."""
    rf = math.prod(shape[2:])
    fan_in, fan_out = shape[1] * rf, shape[0] * rf
    a = 2.0 * math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape).uniform_(-a, a, generator=generator)


def _sites(in_channels):
    """(name, in, out, dilation) of the LIF sites in order: the feature
    convs, then the 1024-wide atrous classifier conv."""
    sites, c_in = [], in_channels
    for i, c in enumerate(FEATURES):
        sites.append((f"feat{i}", c_in, c, 1 if i < ATROUS_FROM else 2))
        c_in = c
    sites.append(("cls_atrous", c_in, 1024, 12))
    return sites


class SNNVGG(nn.Module):
    """Spiking VGG9 (see the module docstring); returns the (B, n_cls, H,
    W) logits."""

    def __init__(self, in_channels: int, n_cls: int,
                 timesteps: int = TIMESTEPS, grad_type: str = "Linear",
                 device=None, generator=None, poisson_generator=None):
        super().__init__()
        self.timesteps = timesteps
        self.grad_type = grad_type
        self.sites = _sites(in_channels)
        for name, c_in, c, _ in self.sites:
            self.register_parameter(name, nn.Parameter(
                _xavier_gain2((c, c_in, 3, 3), generator).to(device)))
        self.output = nn.Parameter(
            _xavier_gain2((n_cls, 1024, 1, 1), generator).to(device))
        self.bn_names = ([f"feat_bn{i}" for i in range(len(FEATURES))]
                         + ["cls_bn"])
        for bn, (_, _, c, _) in zip(self.bn_names, self.sites):
            self.register_parameter(f"{bn}_scale", nn.Parameter(
                torch.ones(timesteps, c, device=device)))
            self.register_buffer(f"{bn}_mean",
                                 torch.zeros(timesteps, c, device=device))
            self.register_buffer(f"{bn}_var",
                                 torch.ones(timesteps, c, device=device))
        self.poisson_generator = poisson_generator

    def draw_uniforms(self, x):
        """One (B, C, H, W) set of U(0, 1) draws per timestep."""
        gen = self.poisson_generator
        if gen is None:
            gen = torch.Generator(device=x.device)
            gen.manual_seed(0)
        # the global batch's draws under data parallelism, this rank's rows
        return draw_rows(lambda shape: torch.rand(
            shape, dtype=x.dtype, device=x.device, generator=gen),
            (self.timesteps,) + tuple(x.shape), axis=1)

    def _bntt(self, pre, s, t):
        """Scale-only batch norm of site ``s`` at timestep ``t``: a training
        forward normalises with the batch statistics and blends them into
        row t of the running ones; eval reads row t."""
        bn = self.bn_names[s]
        means, varis = getattr(self, f"{bn}_mean"), getattr(self, f"{bn}_var")
        if self.training:
            var, mu = batch_var_mean(pre, (0, 2, 3))
            with torch.no_grad():
                means[t] = 0.9 * means[t] + 0.1 * mu
                varis[t] = 0.9 * varis[t] + 0.1 * var
        else:
            mu, var = means[t], varis[t]
        scale = getattr(self, f"{bn}_scale")[t]
        return (scale[:, None, None] * (pre - mu[:, None, None])
                * torch.rsqrt(var + BN_EPS)[:, None, None])

    def forward(self, x, uniforms=None):
        if uniforms is None:
            uniforms = self.draw_uniforms(x)
        h, w = x.shape[2:]
        mems = [0.0] * len(self.sites)
        out_mem = 0.0
        for t in range(self.timesteps):
            out_prev = poisson_spikes(x, uniforms[t])
            for s, (name, _, _, dil) in enumerate(self.sites):
                pre = F.conv2d(out_prev, getattr(self, name), padding=dil,
                               dilation=dil)
                pre = self._bntt(pre, s, t)
                mem = LEAK * mems[s] + pre
                thr = mem / THRESHOLD - 1.0
                out_prev = spike(thr, self.grad_type)
                mems[s] = mem - (thr > 0).to(mem.dtype) * THRESHOLD
                if s in POOL_AFTER:
                    out_prev = avg_pool_3s2p1(out_prev)
            out_mem = out_mem + F.conv2d(out_prev, self.output)
        return resize_linear_align_corners(out_mem / self.timesteps, (h, w))


class ScaleBatchNorm2d(BatchNorm2d):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-4, use_bias=False)``:
    scale-only, initialised to ones."""

    eps = BN_EPS
    gain_init = None
    use_bias = False


class Conv2dNoBias(nn.Module):
    """Bias-free conv, xavier-uniform (gain 2) from ``generator``; with a
    ``compute_dtype`` (flax ``nn.Conv(dtype=)``) input and weight are cast
    to it and the conv runs in it."""

    def __init__(self, in_ch, out_ch, k, dilation=1, padding=0, device=None,
                 generator=None):
        super().__init__()
        self.dilation, self.padding = dilation, padding
        self.compute_dtype = None
        self.weight = nn.Parameter(
            _xavier_gain2((out_ch, in_ch, k, k), generator).to(device))

    def forward(self, x):
        w = self.weight
        if self.compute_dtype is not None:
            x, w = x.to(self.compute_dtype), w.to(self.compute_dtype)
        return F.conv2d(x, w, padding=self.padding, dilation=self.dilation)


class ANNVGG(nn.Module):
    """The non-spiking twin: the same topology with one batch norm per
    conv and ReLU; returns the (B, n_cls, H, W) logits.  ``dtype`` goes to
    the convs only, as in hebbax, whose batch norms take none: they
    return float32, and each conv casts its input again."""

    def __init__(self, in_channels: int, n_cls: int, device=None,
                 generator=None, dtype=None):
        super().__init__()
        self.sites = _sites(in_channels)
        for name, c_in, c, dil in self.sites:
            setattr(self, name, Conv2dNoBias(c_in, c, 3, dil, dil, device,
                                             generator))
        self.output = Conv2dNoBias(1024, n_cls, 1, device=device,
                                   generator=generator)
        for i, (_, _, c, _) in enumerate(self.sites[:-1]):
            setattr(self, f"feat_bn{i}", ScaleBatchNorm2d(c, device=device))
        self.cls_bn = ScaleBatchNorm2d(1024, device=device)
        for m in self.modules():
            if isinstance(m, Conv2dNoBias):
                m.compute_dtype = dtype

    def forward(self, x):
        h, w = x.shape[2:]
        for i, (name, _, _, _) in enumerate(self.sites):
            bn = self.cls_bn if name == "cls_atrous" else getattr(
                self, f"feat_bn{i}")
            x = F.relu(bn(getattr(self, name)(x)))
            if i in POOL_AFTER:
                x = avg_pool_3s2p1(x)
        return resize_linear_align_corners(self.output(x), (h, w))
