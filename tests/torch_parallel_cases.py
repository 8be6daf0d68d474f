"""The port's side of tests/test_torch_parallel.py, importable without
JAX: each case builds a port model from carried weights, feeds it the
global batch (padded to a multiple of the ranks, with its 0/1 ``weight``
vector) and returns what one step gave.  Under data parallelism
(:func:`hebbax_torch.parallel.run_ranks`) a rank feeds its own rows of that
batch; in one process the whole of it, so the two runs can be compared
directly.  Injected draws (contrastive permutations, CCT perturbations,
UAMT noise) are the global batch's; a rank keeps its rows of the
batch-shaped ones, as :func:`hebbax_torch.parallel.draw_rows` does.

Each training case also runs as a float64 twin (``double``: the network
and its inputs in float64; the losses still reduce in float32, the
Hebbian deltas are still taken from float32 copies), where the N-rank
and single-process runs differ only by the order of their float64 sums:
in float32, train-mode batch norm over the 2x2 bottleneck of a 32x32
``unet`` turns that reordering into ~1e-4 of the first conv's one-step
update."""

import numpy as np
import torch

from hebbax_torch import parallel
from hebbax_torch.bridge import from_flax
from hebbax_torch.config.schedules import make_optimizer
from hebbax_torch.engine import semi
from hebbax_torch.engine.sliding import slide_window_inference_device
from hebbax_torch.engine.state import TrainState
from hebbax_torch.engine.steps import make_sup_train_step
from hebbax_torch.hebb.layers import HConv, transposed_paths
from hebbax_torch.hebb.spec import HebbSpec
from hebbax_torch.hebb.surgery import pretrain_trainable_names
from hebbax_torch.models import get_network, primary_logits
from hebbax_torch.models.unet3d import UNet3DDTC
from hebbax_torch.ops.dropout import Dropout
from hebbax_torch.ops.losses import segmentation_loss
from hebbax_torch.utils.seeding import make_generator

HEBB_EXCLUDE = ("out_conv",)


def padded(batch, n_ranks):
    """The global host batch padded to a multiple of ``n_ranks``, with its
    0/1 ``weight`` vector (hebbax's dp prep)."""
    n = len(batch["image"])
    total = -(-n // n_ranks) * n_ranks
    out = parallel.pad_batch_to(dict(batch), total)
    w = np.zeros(total, np.float32)
    w[:n] = 1.0
    out["weight"] = w
    return out


def _rows(x, axis=0):
    return parallel.rows(x, axis) if parallel.active() else x


def feed(batch, n_ranks, double=False):
    """What this process's step takes: its rows of the padded global
    batch (all of it in one process), as device tensors (NCHW / NCDHW
    images, int64 masks; float64 images and SDF maps when ``double``)."""
    out = {}
    for k, v in padded(batch, n_ranks).items():
        t = _rows(torch.from_numpy(np.ascontiguousarray(v)))
        if k == "image":
            t = torch.movedim(t, -1, 1).contiguous()
        if k.startswith("mask") and not t.is_floating_point():
            t = t.long()
        elif double and k != "weight":
            t = t.double()
        out[k] = t
    return out


def _model(case, state_key="state", **kw):
    if case["network"] == "unet3d_dtc16":
        model = UNet3DDTC(1, 2, init_features=16, device="cpu")
    else:
        model = get_network(case["network"], case.get("in_channels", 3), 2,
                            device="cpu", **kw)
    params, stats = case[state_key]
    model.load_state_dict(from_flax(params, stats, transposed_paths(model)))
    if case.get("dropout_seed") is None:
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
    return model.double() if case.get("double") else model


def _sgd(params, lr):
    opt = make_optimizer("sgd", params, momentum=0.0, weight_decay=0.0)
    return opt, (lambda count: lr)


def _numpy_state(model):
    return {k: v.detach().numpy().copy()
            for k, v in model.state_dict().items()}


def case_sup(case):
    """One supervised step (SGD at ``lr``); with ``dropout_seed`` the
    network's dropout draws from a generator at that seed."""
    kw = {}
    if case.get("dropout_seed") is not None:
        kw["dropout_generator"] = make_generator(case["dropout_seed"])
    model = _model(case, **kw)
    opt, sched = _sgd(model.parameters(), case["lr"])
    state = TrainState(model=model, optimizer=opt, schedule=sched)
    step = make_sup_train_step(model, case["network"],
                               segmentation_loss(case["loss"]))
    _, out = step(state, feed(case["batch"], case["n_ranks"],
                              case.get("double")))
    return {"loss": float(out["loss"]), "state": _numpy_state(model)}


def _replay_perms(model, perms):
    perms = list(perms)

    def replay(n):
        perm = torch.from_numpy(perms.pop(0))
        assert perm.shape == (n,)
        return perm
    for m in model.modules():
        if isinstance(m, HConv):
            m.draw_permutation = replay
    return perms


def case_hebb(case):
    """One Hebbian pretraining step (alpha 1, ``out_conv`` excluded,
    backprop over the head only, SGD lr 1: the update is the merged
    delta); a contrastive site replays the global permutations given."""
    spec = HebbSpec(mode=case["mode"], k=50.0, w_nrm=True, alpha=1.0,
                    exclude=HEBB_EXCLUDE)
    model = _model(case, hebb=spec)
    left = _replay_perms(model, case.get("perms", ()))
    names = set(pretrain_trainable_names(model, HEBB_EXCLUDE))
    opt, sched = _sgd([p for n, p in model.named_parameters()
                       if n in names], 1.0)
    state = TrainState(model=model, optimizer=opt, schedule=sched)
    step = make_sup_train_step(model, case["network"],
                               segmentation_loss("dice"), hebb_alpha=1.0,
                               backprop_only=HEBB_EXCLUDE)
    _, out = step(state, feed(case["batch"], case["n_ranks"],
                              case.get("double")))
    assert left == [] or not case.get("perms")
    return {"loss": float(out["loss"]), "state": _numpy_state(model)}


def _semi_out(out, models):
    res = {k: float(out[k]) for k in ("loss", "loss_sup", "loss_unsup")}
    for i, m in enumerate(models, 1):
        res[f"state{i}"] = _numpy_state(m)
    return res


def case_cps(case):
    m1, m2 = _model(case, "state"), _model(case, "state2")
    o1, s1 = _sgd(m1.parameters(), case["lr"])
    o2, s2 = _sgd(m2.parameters(), case["lr"])
    state = semi.DualState(model1=m1, optimizer1=o1, schedule1=s1,
                           model2=m2, optimizer2=o2, schedule2=s2)
    step = semi.make_cps_step(m1, m2, case["network"],
                              segmentation_loss("dice"))
    n, double = case["n_ranks"], case.get("double")
    _, out = step(state, feed(case["sup"], n, double),
                  feed(case["unsup"], n, double),
                  case["unsup_weight"])
    return _semi_out(out, (m1, m2))


def case_uamt(case):
    """UAMT with the global batch's teacher and MC noise given
    ((1 + T, B, C, H, W)); a rank keeps its rows (axis 1)."""
    model, teacher = _model(case, "state"), _model(case, "state")
    opt, sched = _sgd(model.parameters(), case["lr"])
    state = semi.DualState(model1=model, optimizer1=opt, schedule1=sched,
                           model2=teacher)
    step = semi.make_uamt_step(model, teacher, case["network"],
                               segmentation_loss("dice"),
                               case["num_epochs"])
    n, double = case["n_ranks"], case.get("double")
    noise = torch.from_numpy(case["noise"])
    if double:
        noise = noise.double()
    _, out = step(state, feed(case["sup"], n, double),
                  feed(case["unsup"], n, double),
                  case["unsup_weight"], case["epoch"],
                  noise=_rows(noise, 1).contiguous())
    return _semi_out(out, (model, teacher))


def _replay_cct(model, records):
    """CCT's recorded global draws per training forward ({kind: [draw per
    level]}); the elementwise dropout masks are batch-shaped, so a rank
    keeps its rows."""
    records = list(records)

    def draw_perturbations(feats):
        out = {}
        for kind, draws in records.pop(0):
            out[kind] = [_rows(d) if kind == "dropout"
                         else d.to(feats[0].dtype) for d in draws]
        return out
    model.draw_perturbations = draw_perturbations


def case_semi(case):
    """One single-model semi step (CCT with replayed draws, DTC)."""
    model = _model(case)
    if case.get("cct_draws") is not None:
        _replay_cct(model, case["cct_draws"])
    opt, sched = _sgd(model.parameters(), case["lr"])
    state = TrainState(model=model, optimizer=opt, schedule=sched)
    dice = segmentation_loss("dice")
    if case["algo"] == "cct":
        fns = (semi.cct_unsup, semi.deep4_sup(dice))
    else:
        fns = (semi.dtc_unsup, semi.dtc_sup(dice))
    network = "unet3d_dtc" if case["algo"] == "dtc" else case["network"]
    step = semi.make_semi_step(model, network, dice, *fns)
    n, double = case["n_ranks"], case.get("double")
    _, out = step(state, feed(case["sup"], n, double),
                  feed(case["unsup"], n, double),
                  case["unsup_weight"])
    return _semi_out(out, (model,))


def case_slider(case):
    """The eval-mode slider's overlap-averaged logits of one volume."""
    model = _model(case)
    model.eval()

    def forward(patches):
        return primary_logits(case["network"], model(patches))

    logits = slide_window_inference_device(
        forward, case["volume"], case["patch"], case["overlap"], 2,
        batch_size=case["batch_size"], device="cpu")
    return {"logits": logits.numpy()}


def case_f64(case):
    """hebbax's float64 check: the eval-mode forward of the global batch
    in float64, the pixel-mean NLL over the global batch."""
    model = _model(case).double()
    model.eval()
    b = feed(case["batch"], case["n_ranks"], case.get("double"))
    with torch.no_grad():
        logits = primary_logits(case["network"],
                                model(b["image"].double())).double()
        logp = torch.log_softmax(logits, dim=1)
        onehot = torch.movedim(torch.nn.functional.one_hot(b["mask"], 2),
                               -1, 1).double()
        loss = -parallel.gmean(torch.sum(onehot * logp, dim=1))
    return {"loss": float(loss)}


CASES = {"sup": case_sup, "hebb": case_hebb, "cps": case_cps,
         "uamt": case_uamt, "semi": case_semi, "slider": case_slider,
         "f64": case_f64}


TRAINING = ("sup", "hebb", "cps", "uamt", "semi")


def run_cases(cases):
    """Every case's result, in order (the function the ranks run); a
    training case's carries its float64 twin's under ``'double'``."""
    torch.manual_seed(0)
    out = []
    for c in cases:
        res = CASES[c["kind"]](c)
        if c["kind"] in TRAINING:
            res["double"] = CASES[c["kind"]](dict(c, double=True))
        out.append(res)
    return out
