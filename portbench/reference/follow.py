"""The reference's first steps of a cell and what the check reads from
them: each step's losses, the first step's logits, the optimizer's state
after the first step and the change of every parameter after the last,
per parameter, with the first gradient's norms (which leaves the change
is compared on).  The mix's ``trainer`` picks the step: ``semi`` (EM,
below) or ``hebbian`` (:mod:`.hebbian`)."""

import torch

from . import hebbian, losses, optim
from .nets import Net


def follow(cfg, traffic, weights, batches, device):
    """The readings of ``len(batches)`` steps of the mix's trainer from
    ``weights`` on ``batches`` (the batches each step takes), on
    ``device``: {'losses': {kind: [per step]}, 'logits', 'state': {name:
    norm}, 'grad': {name: norm}, 'change': {name: norm}}."""
    kind = traffic["trainer"]
    if kind not in STEPS:
        raise ValueError(f"the reference has no {kind!r} trainer")
    return STEPS[kind](cfg, traffic, weights, batches, device)


def follow_em(cfg, traffic, weights, batches, device):
    """Run ``len(batches)`` EM steps of the cell from ``weights`` on the
    ``batches`` ([(sup, unsup)], each {'image', 'mask'}), on ``device``,
    in float32 with TF32 off."""
    flags = traffic["flags"]
    if traffic["algo"] != "em":
        raise ValueError(f"the reference has no {traffic['algo']!r} step")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # a Hebbian snapshot fine-tunes with alpha 0: the normalised forward
    net = Net(cfg, hebb_exclude=tuple(traffic["snapshot"]["exclude"]))
    P = {n: w.detach().to(device).clone() for n, w in weights.items()}
    P0 = {n: v.clone() for n, v in P.items()}
    names = list(P)
    opt = optim.SGD(flags["momentum"], 5 * 10 ** flags["wd"])
    epoch = traffic["start_epoch"]
    lr = optim.epoch_lr(epoch, flags["lr"], flags["warm_up_duration"],
                        flags["step_size"], flags["gamma"])
    weight = flags["unsup_weight"] * (epoch + 1) / flags["num_epochs"]
    out = {"losses": {}, "state": {}, "grad": {}, "change": {}}
    for step, (sup, unsup) in enumerate(batches):
        leaves = [P[n].requires_grad_(True) for n in names]
        out_u = net.forward(P, unsup["image"].to(device))
        out_s = net.forward(P, sup["image"].to(device))
        loss_u = losses.entropy(out_u) * weight
        loss_s = losses.dice(out_s, sup["mask"].to(device))
        loss = loss_s + loss_u
        grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
        for n in names:
            P[n] = P[n].detach()
        for k, v in (("loss", loss), ("loss_sup", loss_s),
                     ("loss_unsup", loss_u)):
            out["losses"].setdefault(k, []).append(float(v.detach()))
        opt.step(P, grads, lr)
        if step == 0:
            out["logits"] = out_s.detach().cpu()
            out["state"] = {n: float(opt.state(n).norm()) for n in names}
            out["grad"] = {n: float(grads[n].norm()) for n in names}
    out["change"] = {n: float((P[n] - P0[n]).norm()) for n in names}
    return out


STEPS = {"semi": follow_em, "hebbian": hebbian.follow}
