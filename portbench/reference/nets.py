"""The unfolded 3D U-Net as a function of a parameter dict,
channels-first, float32, in training mode (batch statistics): blocks of
two conv3-BN-ReLU at ``init_features`` f, 2f, 4f, 8f and a 16f
bottleneck, 2x2x2 max pools, transpose convs (k 2, s 2) up with
``[up, skip]`` concatenated, and a 1x1x1 head ``conv``.

Batch norm normalises by the batch's biased variance (eps from the
configuration).  A Hebbian conv (with ``hebb_exclude`` given, every conv
whose path is not under an excluded module path) convolves with its
weight normalised per output filter (per input channel for a transpose
conv), as a Hebbian snapshot's layers do when fine-tuned with alpha 0.
"""

import torch
import torch.nn.functional as F


def normalize(w):
    """``w`` over the L2 norm of each slice along dim 0 (an output filter
    of a conv, an input channel of a transpose conv), a zero norm left
    at 1."""
    dims = tuple(range(1, w.dim()))
    n = torch.sqrt(torch.sum(w * w, dim=dims, keepdim=True))
    return w / torch.where(n == 0, torch.ones_like(n), n)


class Net:
    """A network of the configuration ``cfg``: ``params()`` lists its
    parameters, ``forward(P, x)`` runs it on the parameter dict ``P``."""

    def __init__(self, cfg, hebb_exclude=None):
        if cfg["arch"] != "unet3d":
            raise ValueError(f"unknown arch {cfg['arch']!r}")
        self.cfg = cfg
        self.hebb_exclude = hebb_exclude
        self.convs = []          # (path, cin, cout, k, transpose)
        self.norms = []
        self._plan_unet3d()

    # -- parameters -------------------------------------------------------

    def _conv(self, path, cin, cout, k, transpose=False):
        self.convs.append((path, cin, cout, k, transpose))

    def _plan_unet3d(self):
        f = self.cfg["init_features"]
        chans = [self.cfg["in_channels"], f, 2 * f, 4 * f, 8 * f]

        def block(p, cin, cout):
            self._conv(f"{p}.conv1", cin, cout, (3, 3, 3))
            self.norms.append((f"{p}.norm1", cout))
            self._conv(f"{p}.conv2", cout, cout, (3, 3, 3))
            self.norms.append((f"{p}.norm2", cout))

        for i in range(4):
            block(f"encoder.encoder{i + 1}", chans[i], chans[i + 1])
        block("encoder.bottleneck", 8 * f, 16 * f)
        for i, ch in zip((4, 3, 2, 1), (8 * f, 4 * f, 2 * f, f)):
            self._conv(f"decoder.upconv{i}", 2 * ch, ch, (2, 2, 2),
                       transpose=True)
            block(f"decoder.decoder{i}", 2 * ch, ch)
        self._conv("conv", f, self.cfg["num_classes"], (1, 1, 1))

    def params(self):
        """[(name, shape)]: every conv's weight ((O, I, *k), a transpose
        conv's (I, O, *k)) and bias, every norm's weight and bias."""
        out = []
        for path, cin, cout, k, transpose in self.convs:
            w = (cin, cout) if transpose else (cout, cin)
            out += [(f"{path}.weight", w + tuple(k)),
                    (f"{path}.bias", (cout,))]
        for path, ch in self.norms:
            out += [(f"{path}.weight", (ch,)), (f"{path}.bias", (ch,))]
        return out

    def hebbian(self, path):
        if self.hebb_exclude is None:
            return False
        parts = path.split(".")
        return not any(".".join(parts[:i]) in self.hebb_exclude
                       for i in range(1, len(parts) + 1))

    # -- layers -----------------------------------------------------------

    def conv(self, P, path, x, padding=0, transpose=False):
        w, b = P[f"{path}.weight"], P[f"{path}.bias"]
        if self.hebbian(path):
            w = normalize(w)
        if transpose:
            return F.conv_transpose3d(x, w, b, stride=2)
        return F.conv3d(x, w, b, padding=padding)

    def norm(self, P, path, x):
        dims = (0,) + tuple(range(2, x.dim()))
        var, mean = torch.var_mean(x, dim=dims, unbiased=False,
                                   keepdim=True)
        view = (1, -1) + (1,) * (x.dim() - 2)
        return ((x - mean) * torch.rsqrt(var + self.cfg["bn_eps"])
                * P[f"{path}.weight"].view(view) + P[f"{path}.bias"].view(view))

    # -- network ----------------------------------------------------------

    def forward(self, P, x):
        def block(p, h):
            h = F.relu(self.norm(P, f"{p}.norm1", self.conv(P, f"{p}.conv1",
                                                            h, 1)))
            return F.relu(self.norm(P, f"{p}.norm2",
                                    self.conv(P, f"{p}.conv2", h, 1)))

        feats, h = [], x
        for i in range(1, 5):
            if i > 1:
                h = F.max_pool3d(h, 2)
            h = block(f"encoder.encoder{i}", h)
            feats.append(h)
        h = block("encoder.bottleneck", F.max_pool3d(h, 2))
        for i in (4, 3, 2, 1):
            h = self.conv(P, f"decoder.upconv{i}", h, transpose=True)
            h = block(f"decoder.decoder{i}", torch.cat([h, feats[i - 1]],
                                                       dim=1))
        return self.conv(P, "conv", h)
