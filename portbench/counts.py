"""Operations of a cell's step, counted from its configuration's shapes,
and the card's peak they are held against.

FLOPs are those of the unfolded network's mathematics, two per
multiply-add: the forward convolutions and the backward passes the step
needs (a weight gradient per trained kernel, an input gradient per conv
whose input carries a gradient).  A folded layout's zero taps and any
recomputation are not counted, so a share reads the same whatever
implements the work.
"""

import math

# NVIDIA H100 SXM data sheet, dense TF32 tensor cores: the card's highest
# rate on float32 inputs (a float32-accurate 3xTF32 kernel stays under it).
PEAK_FLOPS = 495e12


def conv_sites(cfg, batch, spatial):
    """Every conv of the configuration's network in forward order:
    {path, cin, cout, k, n, in_sp, out_sp, transpose}."""
    if cfg["arch"] != "unet3d":
        raise ValueError(f"unknown arch {cfg['arch']!r}")
    out = []

    def add(path, cin, cout, k, sp, transpose=False):
        out_sp = tuple(2 * s for s in sp) if transpose else tuple(sp)
        out.append(dict(path=path, cin=cin, cout=cout, k=tuple(k), n=batch,
                        in_sp=tuple(sp), out_sp=out_sp, transpose=transpose))

    def half(sp, times=1):
        return tuple(s // 2 ** times for s in sp)

    f = cfg["init_features"]
    ch = [cfg["in_channels"], f, 2 * f, 4 * f, 8 * f, 16 * f]
    names = ["encoder1", "encoder2", "encoder3", "encoder4", "bottleneck"]
    for i, name in enumerate(names):
        sp = half(spatial, i)
        add(f"encoder.{name}.conv1", ch[i], ch[i + 1], (3, 3, 3), sp)
        add(f"encoder.{name}.conv2", ch[i + 1], ch[i + 1], (3, 3, 3), sp)
    for i in (4, 3, 2, 1):
        c = ch[i]
        add(f"decoder.upconv{i}", 2 * c, c, (2, 2, 2), half(spatial, i),
            transpose=True)
        add(f"decoder.decoder{i}.conv1", 2 * c, c, (3, 3, 3),
            half(spatial, i - 1))
        add(f"decoder.decoder{i}.conv2", c, c, (3, 3, 3),
            half(spatial, i - 1))
    add("conv", f, cfg["num_classes"], (1, 1, 1), spatial)
    return out


def conv_flops(s):
    """A conv's forward FLOPs (a transpose conv's over its input)."""
    sp = s["in_sp"] if s["transpose"] else s["out_sp"]
    return 2 * s["n"] * math.prod(sp) * s["cin"] * s["cout"] * math.prod(
        s["k"])


def forward_flops(cfg, batch, spatial):
    return sum(conv_flops(s) for s in conv_sites(cfg, batch, spatial))


def step_flops(cfg, traffic):
    """Model FLOPs of one training step of the cell."""
    if traffic["trainer"] != "semi" or traffic["algo"] != "em":
        raise ValueError(f"no count of a {traffic['trainer']} step")
    sites = conv_sites(cfg, traffic["flags"]["batch_size"],
                       tuple(cfg["patch_size"]))
    fwd = sum(conv_flops(s) for s in sites)
    # a labelled and an unlabelled pass, each differentiated through every
    # conv: weight gradients for all, input gradients for all but the
    # first conv (its input is the image)
    bwd = 2 * fwd - conv_flops(sites[0])
    return 2 * (fwd + bwd)
