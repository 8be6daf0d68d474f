"""The benchmark's FLOP counts against PyTorch's own counter on the plain
reference networks, and the Hebbian delta's against a direct sum over
the convs the forward meets (on the meta device: no arithmetic runs);
a step's count takes every forward FLOP the arch module counts."""

import json
import math
import os
import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import counts
from portbench.reference.nets import Net

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(name):
    with open(os.path.join(PB, "configs", name + ".json")) as f:
        return json.load(f)


def _counted(cfg, batch, spatial):
    net = Net(cfg)
    P = {n: torch.empty(s, device="meta") for n, s in net.params()}
    x = torch.empty((batch, cfg["in_channels"]) + tuple(spatial),
                    device="meta")
    with FlopCounterMode(display=False) as fc:
        net.forward(P, x)
    return fc.get_total_flops()


@pytest.mark.parametrize("batch,spatial,gflop", [
    (1, (96, 96, 80), 1335.07842048),
    (2, (32, 48, 16), None)])
def test_forward_flops_match_the_counter(batch, spatial, gflop):
    cfg = _cfg("unet3d_atrial")
    ours = counts.forward_flops(cfg, batch, spatial)
    assert ours == _counted(cfg, batch, spatial)
    if gflop is not None:
        assert ours == pytest.approx(gflop * 1e9, rel=1e-12)


def test_em_step_count():
    c3 = _cfg("unet3d_atrial")
    with open(os.path.join(PB, "traffic", "em_semi.json")) as f:
        t3 = json.load(f)
    # EM: two passes, each a forward and twice its convs backward but
    # the first conv's input gradient
    first = counts.conv_flops(counts.conv_sites(c3, 1, (96, 96, 80))[0])
    f3 = counts.forward_flops(c3, 1, (96, 96, 80))
    assert counts.step_flops(c3, t3) == 2 * (3 * f3 - first)
    assert counts.step_flops(c3, t3) == pytest.approx(8.005e12, rel=1e-3)


def _traffic(name):
    with open(os.path.join(PB, "traffic", name + ".json")) as f:
        return json.load(f)


def test_hebbian_delta_and_step_counts():
    """The delta's FLOPs and bytes against a direct sum over the Hebbian
    convs the reference's forward meets (their weight, input and output
    shapes, on the meta device)."""
    cfg, mix = _cfg("unet3d_atrial"), _traffic("hebb_pretrain")
    met = []
    net = Net(cfg, hebb_exclude=tuple(mix["flags"]["exclude"]))
    net.record = lambda path, w, x, y, padding, transpose, stride: (
        met.append((w.shape, x.shape, y.shape, transpose)))
    P = {n: torch.empty(s, device="meta") for n, s in net.params()}
    net.forward(P, torch.empty((1, 1, 96, 96, 80), device="meta"))
    assert len(met) == 22 and sum(t for *_, t in met) == 4
    flops = nbytes = 0
    for w, x, y, transpose in met:
        taps = math.prod(w[2:])
        # the contraction runs over the voxels the taps see once each: a
        # conv's output voxels, a transpose conv's input voxels
        voxels = math.prod((x if transpose else y)[2:])
        flops += (2 * w[0] * w[1] * taps * x[0] * voxels
                  + math.prod(y) + (3 if transpose else 2) * math.prod(w))
        nbytes += 4 * (math.prod(x) + math.prod(y) + 2 * math.prod(w))
    sites = counts.hebbian_sites(cfg, mix)
    assert sum(counts.delta_flops(s) for s in sites) == flops
    assert sum(counts.delta_bytes(s) for s in sites) == nbytes
    head = 2 * 64 * 2 * 96 * 96 * 80
    fwd = counts.forward_flops(cfg, 1, (96, 96, 80))
    assert counts.step_flops(cfg, mix) == fwd + flops + head
    assert counts.step_flops(cfg, mix) == pytest.approx(2.6707e12, rel=1e-4)
    roof = counts.delta_roofline_s(cfg, mix)
    assert flops / counts.PEAK_FLOPS < roof < (
        flops / counts.PEAK_FLOPS + nbytes / counts.PEAK_BYTES)
    assert counts.delta_roofline_s(cfg, _traffic("em_semi")) is None


def test_step_counts_take_the_arch_modules_forward(monkeypatch):
    """A network whose forward holds more than its convs (attention's
    matmuls, say) counts all of it in both steps: the EM step's two
    passes differentiate it twice more, the Hebbian step runs it once."""
    cfg = _cfg("unet3d_atrial")
    em, hebb = _traffic("em_semi"), _traffic("hebb_pretrain")
    before = counts.step_flops(cfg, em), counts.step_flops(cfg, hebb)
    unet = counts.nets.arch("unet3d")
    extra = 7e9
    wider = types.SimpleNamespace(
        conv_sites=unet.conv_sites,
        forward_flops=lambda *a: unet.forward_flops(*a) + extra)
    monkeypatch.setattr(counts.nets, "arch", lambda name: wider)
    assert counts.step_flops(cfg, em) == before[0] + 6 * extra
    assert counts.step_flops(cfg, hebb) == before[1] + extra
