"""Operations of a cell's step, counted from its configuration's shapes,
and the card's peaks they are held against.

FLOPs are those of the unfolded network's mathematics, two per
multiply-add: the forward convolutions and the backward passes the step
needs (a weight gradient per trained kernel, an input gradient per conv
whose input carries a gradient), and a Hebbian step's deltas.  A folded
layout's zero taps and any recomputation are not counted, so a share
reads the same whatever implements the work.  The network's convs come
from its arch module (:func:`portbench.reference.nets.arch`).
"""

import math

from .reference import nets

# NVIDIA H100 SXM data sheet, dense TF32 tensor cores: the card's highest
# rate on float32 inputs (a float32-accurate 3xTF32 kernel stays under it).
PEAK_FLOPS = 495e12
# the same data sheet: HBM3 bandwidth
PEAK_BYTES = 3.35e12
FLOAT32 = 4


def conv_sites(cfg, batch, spatial):
    """Every conv of the configuration's network in forward order:
    {path, cin, cout, k, n, in_sp, out_sp, transpose}."""
    return nets.arch(cfg["arch"]).conv_sites(cfg, batch, spatial)


def conv_flops(s):
    """A conv's forward FLOPs (a transpose conv's over its input)."""
    sp = s["in_sp"] if s["transpose"] else s["out_sp"]
    return 2 * s["n"] * math.prod(sp) * s["cin"] * s["cout"] * math.prod(
        s["k"])


def forward_flops(cfg, batch, spatial):
    return nets.arch(cfg["arch"]).forward_flops(cfg, batch, spatial)


def _step_sites(cfg, traffic):
    return conv_sites(cfg, traffic["flags"]["batch_size"],
                      tuple(cfg["patch_size"]))


def hebbian_sites(cfg, traffic):
    """The convs whose delta a step of the mix computes: every conv
    outside the mix's ``exclude`` under the Hebbian trainer, none under
    another."""
    if traffic["trainer"] != "hebbian":
        return []
    exclude = tuple(traffic["flags"]["exclude"])
    return [s for s in _step_sites(cfg, traffic)
            if not nets.excluded(s["path"], exclude)]


def delta_flops(s):
    """FLOPs of the swta delta of one conv, from the rule's mathematics:
    the contraction of the softmax map with the input (a forward conv's
    (O, I) sum over its output voxels for each tap, a transpose conv's
    over its input voxels for each tap, as many multiply-adds as the
    conv's own), the sums of the map (an add per output value) and the
    decay (a multiply and a subtraction per weight; a transpose conv's
    sums its taps first, a multiply-add more).  The softmax is not
    counted: its bound is the bytes."""
    weights = s["cin"] * s["cout"] * math.prod(s["k"])
    r_values = s["n"] * s["cout"] * math.prod(s["out_sp"])
    return conv_flops(s) + r_values + (3 if s["transpose"] else 2) * weights


def delta_bytes(s):
    """Bytes the delta of one conv must move in float32: the input and
    the output read once, the weight read and the delta written."""
    x = s["n"] * s["cin"] * math.prod(s["in_sp"])
    y = s["n"] * s["cout"] * math.prod(s["out_sp"])
    weights = s["cin"] * s["cout"] * math.prod(s["k"])
    return FLOAT32 * (x + y + 2 * weights)


def delta_roofline_s(cfg, traffic):
    """The least time the card could take for a step's deltas: over the
    sites, the larger of their FLOPs at the peak rate and their bytes at
    the peak bandwidth; None where the step computes none."""
    sites = hebbian_sites(cfg, traffic)
    if not sites:
        return None
    return sum(max(delta_flops(s) / PEAK_FLOPS, delta_bytes(s) / PEAK_BYTES)
               for s in sites)


def step_flops(cfg, traffic):
    """Model FLOPs of one training step of the cell."""
    kind = traffic["trainer"]
    sites = _step_sites(cfg, traffic)
    fwd = forward_flops(cfg, traffic["flags"]["batch_size"],
                        tuple(cfg["patch_size"]))
    if kind == "semi" and traffic["algo"] == "em":
        # a labelled and an unlabelled pass, each differentiated through
        # the whole network: twice the forward's FLOPs (a weight and an
        # input gradient for every product the forward takes, as for a
        # conv or a matmul) but the first conv's input gradient (its
        # input is the image)
        bwd = 2 * fwd - conv_flops(sites[0])
        return 2 * (fwd + bwd)
    if kind == "hebbian":
        # one forward, the deltas, and the weight gradients of the
        # excluded head, which sits at the network's output: nothing
        # below it is differentiated
        exclude = tuple(traffic["flags"]["exclude"])
        head = sum(conv_flops(s) for s in sites
                   if nets.excluded(s["path"], exclude))
        return fwd + sum(delta_flops(s) for s in hebbian_sites(
            cfg, traffic)) + head
    raise ValueError(f"no count of a {kind!r} step")
