"""The plain reference against the port at small sizes on the CPU: the
weight-normalised forward of a fine-tune (the folded 3D network
included), the swta deltas, the losses, the updates and the batches the
patch queue gives; and that the reference imports nothing of the
port."""

import json
import os
import subprocess
import sys
import tempfile

import pytest
import torch

from hebbax_torch.data.volumes3d import PatchQueue
from hebbax_torch.hebb import rules
from hebbax_torch.hebb.spec import HebbSpec
from hebbax_torch.hebb.surgery import pop_deltas
from hebbax_torch.models import get_network
from hebbax_torch.ops import losses as port_losses
from hebbax_torch.config.schedules import make_optimizer
from hebbax_torch.engine.loop import to_device_batch_3d

from portbench import feeds, inputs, weights
from portbench.reference import batches, hebbian, losses, optim
from portbench.reference.nets import Net

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PB)


def _cfg(name, **kw):
    with open(os.path.join(PB, "configs", name + ".json")) as f:
        return dict(json.load(f), **kw)


def _load(model, w):
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(w[n])


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("network,features", [("unet3d_min", 32),
                                              ("unet3d_s2d", 64)])
def test_unet3d_weight_normalised_forward(network, features):
    cfg = _cfg("unet3d_atrial", init_features=features)
    exclude = ("conv", "dsv1")
    spec = HebbSpec(mode="swta_t", k=50.0, alpha=0.0, exclude=exclude)
    model = get_network(network, 1, 2, hebb=spec)
    net = Net(cfg, hebb_exclude=exclude)
    w = weights.make_weights(net.params(), 4, torch.device("cpu"))
    _load(model, w)
    x = torch.randn(1, 1, 16, 16, 16, generator=_gen(2))
    model.train()
    got, want = model(x), net.forward(w, x)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    assert pop_deltas(model) == {}


def test_losses():
    g = _gen(3)
    logits = torch.randn(2, 2, 8, 8, 4, generator=g)
    mask = torch.randint(0, 2, (2, 8, 8, 4), generator=g)
    assert torch.allclose(losses.dice(logits, mask),
                          port_losses.dice_loss(logits, mask), rtol=1e-6)
    assert torch.allclose(
        losses.entropy(logits),
        port_losses.entropy_loss(torch.softmax(logits, 1), 2), rtol=1e-6)


def test_sgd_update():
    g = _gen(4)
    p0 = torch.randn(5, 3, generator=g)
    p = torch.nn.Parameter(p0.clone())
    opt = make_optimizer("sgd", [p], momentum=0.9, weight_decay=5e-5)
    ref = optim.SGD(0.9, 5 * 10 ** -5)
    P = {"p": p0.clone()}
    for lr in (0.1, 0.05, 0.02):
        grad = torch.randn(5, 3, generator=g)
        for group in opt.param_groups:
            group["lr"] = lr
        p.grad = grad.clone()
        opt.step()
        ref.step(P, {"p": grad}, lr)
        assert torch.allclose(p.detach(), P["p"], rtol=1e-6, atol=1e-9)
    assert torch.allclose(opt.state[p]["momentum_buffer"], ref.state("p"),
                          rtol=1e-6)


@pytest.mark.parametrize("transpose", [False, True])
def test_swta_delta_follows_the_rule(transpose):
    """The reference's matmul-per-tap deltas against the port's composed
    rules (its weight-gradient convolutions), in float64."""
    g = _gen(6)
    x = torch.randn(2, 6, 6, 5, 4, generator=g, dtype=torch.float64)
    if transpose:
        w = torch.randn(6, 5, 2, 2, 2, generator=g, dtype=torch.float64)
        y = torch.nn.functional.conv_transpose3d(x, w, stride=2)
    else:
        w = torch.randn(5, 6, 3, 3, 3, generator=g, dtype=torch.float64)
        y = torch.nn.functional.conv3d(x, w, padding=1)
    spec = HebbSpec(mode="swta_t", k=3.0)
    want = rules.compute_delta(spec, w, x, y, (1, 1, 1), transpose,
                               2 if transpose else 1, dtype=torch.float64)
    got = (hebbian.swta_t_delta(w, x, y, 3.0) if transpose
           else hebbian.swta_delta(w, x, y, 3.0, 1))
    assert torch.allclose(got, want, rtol=1e-10, atol=1e-10)


def test_adam_update():
    g = _gen(5)
    p0 = torch.randn(5, 3, generator=g)
    p = torch.nn.Parameter(p0.clone())
    opt = make_optimizer("adam", [p])
    ref = optim.Adam()
    P = {"p": p0.clone()}
    for lr in (1e-3, 1e-3, 5e-4):
        grad = torch.randn(5, 3, generator=g) * 1e-4
        for group in opt.param_groups:
            group["lr"] = lr
        p.grad = grad.clone()
        opt.step()
        ref.step(P, {"p": grad}, lr)
        assert torch.allclose(p.detach(), P["p"], rtol=1e-6, atol=1e-9)
    assert torch.allclose(opt.state[p]["exp_avg"], ref.state("p"),
                          rtol=1e-6)


def test_epoch_lr():
    from hebbax_torch.config.schedules import warmup_step_lr
    for e in (0, 1, 19, 20, 21, 70, 71, 150):
        assert optim.epoch_lr(e, 0.1, 20, 50, 0.5) == warmup_step_lr(
            e, 0.1, 20, 50, 0.5)


@pytest.mark.parametrize("sup", [True, False])
def test_batches_3d_match_the_patch_queue(sup):
    cfg = _cfg("unet3d_atrial", patch_size=[8, 8, 8],
               data={"kind": "volume3d", "train_volumes": 10,
                     "volume_shape": [14, 12, 10]})
    flags = {"regime": 30, "batch_size": 1, "samples_per_volume_train": 2,
             "queue_length": 4}
    seed = 2 ** 31 + 5
    with tempfile.TemporaryDirectory() as tmp:
        names = inputs.item_names("volume3d", 10)
        root = feeds.placeholder_dir(tmp, names)
        ds = feeds.Volumes(root, seed, (14, 12, 10), regime=30, sup=sup)
        q = PatchQueue(ds, (8, 8, 8), batch_size=1, samples_per_volume=2,
                       max_length=4, seed=seed)
        it = iter(q)
        got = [to_device_batch_3d(next(it), "cpu") for _ in range(3)]
        it.close()
        listing = [f for f in os.listdir(os.path.join(root, "image"))]
        want = batches.batches_3d(cfg, flags, seed, listing, 3, sup)
    for g, w in zip(got, want):
        assert torch.equal(g["image"], w["image"])
        if sup:
            assert torch.equal(g["mask"], w["mask"])


def test_reference_imports_nothing_of_the_port():
    code = (
        "import importlib.abc, sys\n"
        "class Refuse(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in ('hebbax_torch', 'hebbax', 'jax'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Refuse())\n"
        "import portbench.reference.follow, portbench.reference.batches\n"
        "import portbench.reference.compare, portbench.inputs\n"
        "import portbench.weights, portbench.counts\n"
        "import portbench.reference.nets as nets\n"
        "nets.arch('unet3d')\n"
        "bad = {m.split('.')[0] for m in sys.modules} & {'hebbax_torch',"
        " 'hebbax', 'jax'}\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
