"""The unfolded 3D U-Net as a function of a parameter dict,
channels-first, float32, in training mode (batch statistics): blocks of
two conv3-BN-ReLU at ``init_features`` f, 2f, 4f, 8f and a 16f
bottleneck, 2x2x2 max pools, transpose convs (k 2, s 2) up with
``[up, skip]`` concatenated, and a 1x1x1 head ``conv``.

The layers (a conv with its Hebbian normalisation, batch norm) are the
:class:`~portbench.reference.nets.Net`'s the forward is given.
"""

import torch
import torch.nn.functional as F

from portbench import counts


def plan(cfg):
    """([(path, cin, cout, k, transpose)] of the convs, [(path, ch)] of
    the norms), in forward order."""
    convs, norms = [], []
    f = cfg["init_features"]
    chans = [cfg["in_channels"], f, 2 * f, 4 * f, 8 * f]

    def block(p, cin, cout):
        convs.append((f"{p}.conv1", cin, cout, (3, 3, 3), False))
        norms.append((f"{p}.norm1", cout))
        convs.append((f"{p}.conv2", cout, cout, (3, 3, 3), False))
        norms.append((f"{p}.norm2", cout))

    for i in range(4):
        block(f"encoder.encoder{i + 1}", chans[i], chans[i + 1])
    block("encoder.bottleneck", 8 * f, 16 * f)
    for i, ch in zip((4, 3, 2, 1), (8 * f, 4 * f, 2 * f, f)):
        convs.append((f"decoder.upconv{i}", 2 * ch, ch, (2, 2, 2), True))
        block(f"decoder.decoder{i}", 2 * ch, ch)
    convs.append(("conv", f, cfg["num_classes"], (1, 1, 1), False))
    return convs, norms


def params(cfg):
    """[(name, shape)]: every conv's weight ((O, I, *k), a transpose
    conv's (I, O, *k)) and bias, every norm's weight and bias."""
    convs, norms = plan(cfg)
    out = []
    for path, cin, cout, k, transpose in convs:
        w = (cin, cout) if transpose else (cout, cin)
        out += [(f"{path}.weight", w + tuple(k)),
                (f"{path}.bias", (cout,))]
    for path, ch in norms:
        out += [(f"{path}.weight", (ch,)), (f"{path}.bias", (ch,))]
    return out


def forward(net, P, x):
    def block(p, h):
        h = F.relu(net.norm(P, f"{p}.norm1", net.conv(P, f"{p}.conv1",
                                                      h, 1)))
        return F.relu(net.norm(P, f"{p}.norm2",
                               net.conv(P, f"{p}.conv2", h, 1)))

    feats, h = [], x
    for i in range(1, 5):
        if i > 1:
            h = F.max_pool3d(h, 2)
        h = block(f"encoder.encoder{i}", h)
        feats.append(h)
    h = block("encoder.bottleneck", F.max_pool3d(h, 2))
    for i in (4, 3, 2, 1):
        h = net.conv(P, f"decoder.upconv{i}", h, transpose=True)
        h = block(f"decoder.decoder{i}", torch.cat([h, feats[i - 1]],
                                                   dim=1))
    return net.conv(P, "conv", h)


def conv_sites(cfg, batch, spatial):
    """Every conv of the network in forward order:
    {path, cin, cout, k, n, in_sp, out_sp, transpose}."""
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


def forward_flops(cfg, batch, spatial):
    return sum(counts.conv_flops(s) for s in conv_sites(cfg, batch, spatial))
