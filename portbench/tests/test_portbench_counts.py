"""The benchmark's FLOP counts against PyTorch's own counter on the plain
reference networks (on the meta device: no arithmetic runs)."""

import json
import os

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
