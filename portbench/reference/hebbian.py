"""The Hebbian pretraining step, written from the rule's definition: the
weight-normalised forward, the swta delta of every Hebbian conv, the
excluded head trained by the loss's gradient and every Hebbian kernel by
minus its delta, Adam over those alone (the Hebbian convs' biases and
the norms' affine stay frozen).

swta on a conv of stride 1 (weight (O, I, *k), x the unpadded input, y
the output with its bias, from the normalised weight):

    r = softmax(K y) over the output channels
    dw[o, i, t] = sum_{n, p} r[n, o, p] x_pad[n, i, p + t]
                  - (sum_{n, p} r[n, o, p]) w[o, i, t]

swta_t on a transpose conv whose stride is its kernel (weight (I, O,
*k)), where output voxel s q + t comes from input voxel q through tap t
alone:

    pos[i, o, t] = sum_{n, q} x[n, i, q] r[n, o, s q + t]
    dw[i, o, t]  = pos[i, o, t] - sum_t' (sum_{n, q} r[n, o, s q + t'])
                                         w[i, o, t']

The decay takes the raw weight.  Each tap is one (O, N P) by (N P, I)
product on shifted or strided slices: matmuls, no convolution.
"""

import itertools

import torch
import torch.nn.functional as F

from . import losses, optim
from .nets import Net, excluded


def _taps(k):
    return itertools.product(*(range(t) for t in k))


def swta_delta(w, x, y, k, padding):
    o, i = w.shape[:2]
    if isinstance(padding, int):
        padding = (padding,) * (w.dim() - 2)
    r = torch.softmax(k * y, dim=1)
    rf = r.transpose(0, 1).reshape(o, -1)
    pad = [p for p in reversed(padding) for _ in (0, 1)]
    xp = F.pad(x, pad)
    pos = torch.empty_like(w)
    for t in _taps(w.shape[2:]):
        sl = (slice(None), slice(None)) + tuple(
            slice(a, a + s) for a, s in zip(t, y.shape[2:]))
        xs = xp[sl].transpose(0, 1).reshape(i, -1)
        pos[(slice(None), slice(None)) + t] = rf @ xs.T
    r_sum = rf.sum(1)
    return pos - r_sum.view((o,) + (1,) * (w.dim() - 1)) * w


def swta_t_delta(w, x, y, k):
    i, o = w.shape[:2]
    stride = w.shape[2:]
    r = torch.softmax(k * y, dim=1)
    xf = x.transpose(0, 1).reshape(i, -1)
    pos = torch.empty_like(w)
    dec = torch.zeros((i, o), dtype=w.dtype, device=w.device)
    for t in _taps(stride):
        sl = (slice(None), slice(None)) + tuple(
            slice(a, None, s) for a, s in zip(t, stride))
        rs = r[sl].transpose(0, 1).reshape(o, -1)
        idx = (slice(None), slice(None)) + t
        pos[idx] = xf @ rs.T
        dec += rs.sum(1)[None, :] * w[idx]
    return pos - dec.view((i, o) + (1,) * (w.dim() - 2))


def follow(cfg, traffic, weights, batches, device):
    """Run ``len(batches)`` Hebbian steps of the cell from ``weights`` on
    ``batches`` ([(batch,)], each {'image', 'mask'}), on ``device``, in
    float32 with TF32 off.  Returns the readings of
    :func:`portbench.reference.follow.follow` over the trained
    parameters."""
    flags = traffic["flags"]
    if flags["hebb_mode"] != "swta_t":
        raise ValueError(f"the reference has no {flags['hebb_mode']!r} rule")
    if flags["optimizer"] != "adam" or flags["loss"] != "dice":
        raise ValueError("the reference trains with Adam on the dice loss")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    exclude = tuple(flags["exclude"])
    k = float(flags["hebb_inv_temp"])
    net = Net(cfg, hebb_exclude=exclude)
    convs = {s["path"] for s in net.arch.conv_sites(
        cfg, 1, tuple(cfg["patch_size"]))}
    # every conv kernel and everything under an excluded module
    names = [n for n, _ in net.params()
             if excluded(n.rsplit(".", 1)[0], exclude)
             or (n.endswith(".weight") and n.rsplit(".", 1)[0] in convs)]
    head = [n for n in names if excluded(n.rsplit(".", 1)[0], exclude)]
    P = {n: w.detach().to(device).clone() for n, w in weights.items()}
    P0 = {n: P[n].clone() for n in names}
    opt = optim.Adam()
    lr = optim.epoch_lr(traffic["start_epoch"], flags["lr"],
                        flags["warm_up_duration"], flags["step_size"],
                        flags["gamma"])
    deltas = {}

    def record(path, w, x, y, padding, transpose, stride):
        if not transpose and stride != 1:
            raise ValueError(f"the reference's swta delta takes convs of "
                             f"stride 1, not {path}'s {stride}")
        with torch.no_grad():
            deltas[f"{path}.weight"] = (
                swta_t_delta(w, x, y, k) if transpose
                else swta_delta(w, x, y, k, padding))

    net.record = record
    out = {"losses": {"loss": []}, "state": {}, "grad": {}, "change": {}}
    for step, (batch,) in enumerate(batches):
        deltas.clear()
        leaves = [P[n].requires_grad_(True) for n in head]
        logits = net.forward(P, batch["image"].to(device))
        loss = losses.dice(logits, batch["mask"].to(device))
        grads = dict(zip(head, torch.autograd.grad(loss, leaves)))
        for n in head:
            P[n] = P[n].detach()
        for n in names:
            if n in deltas:
                grads[n] = -deltas[n]
            elif n not in grads:
                grads[n] = torch.zeros_like(P[n])
        out["losses"]["loss"].append(float(loss.detach()))
        opt.step(P, grads, lr)
        if step == 0:
            out["logits"] = logits.detach().cpu()
            out["state"] = {n: float(opt.state(n).norm()) for n in names}
            out["grad"] = {n: float(grads[n].norm()) for n in names}
        del logits, loss, grads
    out["change"] = {n: float((P[n] - P0[n]).norm()) for n in names}
    return out
