"""The run flags the port took over from hebbax in one slice, on the CPU:
``--resume``, ``--profile_dir``, ``--device_augment``, ``--init_weights
xavier|normal|orthogonal``, ``--loss bce|bcebound``, and which CLIs accept
them: every trainer CLI takes them, and runs end to end with ``--device
cpu --dp_devices 2`` (one epoch, batches of 3 padded to 4 over 2 gloo
ranks), while ``--dp_devices`` above the visible cards raises.

* resume: the state round trip (parameters, BN statistics, Adam's
  moments and step, SGD's momentum, both members of a dual state, the
  meta) is exact; a run of 2 epochs then of 3 with ``--resume 1`` trains
  only epoch 3, and its first step's learning rate is the schedule's at
  the restored step (``train_sup_2d``, ``train_semi_2d uamt``,
  ``train_sup_3d`` at ``unet3d_min``);
* profile: ``train_sup_3d --profile_dir`` leaves a trace file there;
* device augmentation: every output is one of the 8 D4 transforms of its
  input, with the mask in step; over 4000 draws the frequency of each
  decision (flip, its direction, transpose, rot90's k) and of each of the
  8 transforms falls within 4 sigma of hebbax's distribution (its
  ``_apply_one`` enumerated over its decision probabilities); the 2D
  trainers turn ``host_augment`` off and finish;
* init: the xavier and normal stds within 5% of hebbax's formulas (gain
  0.02, torch's fans, a transpose conv's fan_in = O * prod(k)); orthogonal
  rows with W W^T = gain^2 I (to 1e-6 relative);
* losses: bce and bcebound equal hebbax's within 1e-6 on random logits and
  targets with -1 ignored.
"""

import csv
import importlib.util
import itertools
import json
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hebbax.hebb.layers import torch_kernel_init
from hebbax.ops import augment_device as jaug
from hebbax.ops import losses as jlosses
from hebbax_torch.cli import common, common3d
from hebbax_torch.cli import train_semi_2d, train_sup_2d, train_sup_3d
from hebbax_torch.config.datasets import dataset_cfg
from hebbax_torch.engine.semi import DualState
from hebbax_torch.engine.state import TrainState
from hebbax_torch.hebb.layers import INIT_GAIN, HConv, HConvTranspose
from hebbax_torch.models import get_network
from hebbax_torch.ops import augment_device as taug
from hebbax_torch.ops import losses as tlosses
from hebbax_torch.utils import trace
from hebbax_torch.utils.checkpoint import load_train_state, save_train_state

torch.set_num_threads(2)

# The port's RAD-DINO trainer and tester ask transformers for
# microsoft/rad-dino.  Set before transformers is imported, here or in
# the ranks a test spawns, this makes the answer offline at once.
os.environ["HF_HUB_OFFLINE"] = "1"

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _synth_module():
    spec = importlib.util.spec_from_file_location(
        "make_synth_data", os.path.join(REPO, "scripts",
                                        "make_synth_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def synth2d(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth") / "GlaS"
    _synth_module().make_2d(str(root), 6, 2, 32, seed=0)
    return str(root)


@pytest.fixture(scope="module")
def synth3d(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth3d") / "Atrial"
    _synth_module().make_3d(str(root), 4, 2, (20, 18, 16), seed=0)
    return str(root)


def _argv2d(synth, root, epochs):
    return ["--device", "cpu", "--path_dataset", synth, "--dataset_name",
            "GlaS", "--path_root_exp", str(root), "-b", "2", "-e",
            str(epochs), "-w", "1", "--validate_iter", "1",
            "--num_workers", "1", "--debug", ""]


def _argv3d(synth, root, epochs):
    return ["--device", "cpu", "--path_dataset", synth,
            "--path_root_exp", str(root), "-n", "unet3d_min", "-b", "2",
            "-e", str(epochs), "-w", "1", "--validate_iter", "1",
            "--patch_size", "(16,16,16)", "--samples_per_volume_train",
            "2", "--samples_per_volume_val", "2", "--num_workers", "1"]


def _at_32(loaders):
    for ld in loaders.values():
        ld.dataset.size = (32, 32)
    return loaders


def _sup_loaders(args):
    return _at_32(common.make_loaders_2d(args, dataset_cfg("GlaS")))


def _semi_loaders(args):
    cfg = dataset_cfg("GlaS")
    sup = common.make_loaders_2d(args, cfg, sup=True)
    unsup = common.make_loaders_2d(args, cfg, sup=False, splits=("train",))
    return _at_32({"train_sup": sup["train"], "val": sup["val"],
                   "train_unsup": unsup["train"]})


def _epochs(run):
    with open(os.path.join(run, "train_log.csv")) as f:
        return [int(float(r["epoch"])) for r in csv.DictReader(f)]


# -- resume 

def _small_model(seed):
    return get_network("unet", 3, 2, device="cpu",
                       generator=torch.Generator().manual_seed(seed))


def _advance(model, optimizer, seed):
    """Two optimizer steps on a training forward, so the moments, the
    momentum and the BN statistics are nontrivial."""
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (2, 3, 32, 32)).astype(np.float32))
    model.train()
    for _ in range(2):
        optimizer.zero_grad()
        model(x).square().mean().backward()
        optimizer.step()


def _states_equal(a, b):
    for x, y in ((a.state_dict(), b.state_dict()),):
        assert set(x) == set(y)
        for k in x:
            assert torch.equal(x[k], y[k]), k


def _optimizers_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert set(sa["state"]) == set(sb["state"]) and sa["state"]
    for k in sa["state"]:
        for name, v in sa["state"][k].items():
            w = sb["state"][k][name]
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(w)), name


def test_resume_roundtrip(tmp_path):
    """Parameters, BN statistics, Adam's moments and step, SGD's
    momentum, both members of a dual state, the step and the meta come
    back equal to the bit."""
    from hebbax_torch.config.schedules import make_optimizer

    m1, m2 = _small_model(1), _small_model(2)
    o1 = make_optimizer("adam", m1.parameters())
    o2 = make_optimizer("sgd", m2.parameters(), momentum=0.9,
                        weight_decay=5e-5)
    _advance(m1, o1, 3)
    _advance(m2, o2, 4)
    state = DualState(model1=m1, optimizer1=o1, schedule1=None, model2=m2,
                      optimizer2=o2, schedule2=None, step=7)
    save_train_state(state, str(tmp_path), epoch=5, best_val=[0.1, 0.5, 0.6])
    assert not os.path.exists(tmp_path / "resume.ckpt.tmp")
    f1, f2 = _small_model(8), _small_model(9)
    fresh = DualState(model1=f1, optimizer1=make_optimizer(
        "adam", f1.parameters()), schedule1=None, model2=f2,
        optimizer2=make_optimizer("sgd", f2.parameters(), momentum=0.9,
                                  weight_decay=5e-5), schedule2=None)
    restored, meta = load_train_state(fresh, str(tmp_path / "resume.ckpt"))
    assert meta == {"epoch": 5, "best_val": [0.1, 0.5, 0.6]}
    assert restored.step == 7
    _states_equal(restored.model1, m1)
    _states_equal(restored.model2, m2)
    _optimizers_equal(restored.optimizer1, o1)
    _optimizers_equal(restored.optimizer2, o2)
    adam = restored.optimizer1.state_dict()["state"][0]
    assert {"exp_avg", "exp_avg_sq", "step"} <= set(adam)
    assert float(adam["step"]) == 2.0
    assert "momentum_buffer" in restored.optimizer2.state_dict()["state"][0]
    # a single-model state, and the teacher's absent optimizer (UAMT)
    single = TrainState(model=m1, optimizer=o1, schedule=None, step=3)
    save_train_state(single, str(tmp_path / "single"), epoch=0)
    back, meta = load_train_state(
        TrainState(model=_small_model(5), optimizer=make_optimizer(
            "adam", _small_model(6).parameters()), schedule=None),
        str(tmp_path / "single" / "resume.ckpt"))
    assert back.step == 3 and meta["best_val"] is None
    _states_equal(back.model, m1)
    teacher = DualState(model1=m1, optimizer1=o1, schedule1=None,
                        model2=m2, step=4)
    save_train_state(teacher, str(tmp_path / "uamt"), epoch=1)
    back, _ = load_train_state(
        DualState(model1=_small_model(5), optimizer1=make_optimizer(
            "adam", _small_model(6).parameters()), schedule1=None,
            model2=_small_model(7)), str(tmp_path / "uamt" / "resume.ckpt"))
    assert back.optimizer2 is None and back.step == 4
    _states_equal(back.model2, m2)


def _lr_recorder(trainer):
    """Record (state.step before, the lr the optimizer stepped at) of
    every train step."""
    seen = []
    step = trainer.train_step

    def wrapped(state, *a):
        before = state.step
        state, out = step(state, *a)
        opt = getattr(state, "optimizer", None) or state.optimizer1
        seen.append((before, opt.param_groups[0]["lr"]))
        return state, out

    trainer.train_step = wrapped
    return seen


def _resume_twice(make):
    """Run 2 epochs, then 3 with --resume 1: the second run trains only
    epoch 3, from the restored step at the schedule's rate."""
    t1 = make(2)
    t1.run()
    assert os.path.exists(os.path.join(t1.paths.checkpoints, "resume.ckpt"))
    steps_done = t1.state.step
    t2 = make(3)
    seen = _lr_recorder(t2)
    t2.run()
    assert t2.paths.run == t1.paths.run
    assert _epochs(t2.paths.run) == [3]
    schedule = getattr(t2.state, "schedule", None) or t2.state.schedule1
    assert seen[0][0] == steps_done
    assert seen[0][1] == schedule(steps_done)
    assert t2.state.step == steps_done + len(seen)


def test_train_sup_2d_resume(synth2d, tmp_path):
    def make(epochs):
        args = train_sup_2d.add_args(common.base_parser_2d()).parse_args(
            _argv2d(synth2d, tmp_path, epochs) + [
                "--regime", "100", "--optimizer", "adam", "-l", "1e-3",
                "-n", "unet", "--resume", "1"])
        return train_sup_2d.build(args, _sup_loaders(args))
    _resume_twice(make)


def test_train_semi_2d_uamt_resume(synth2d, tmp_path):
    def make(epochs):
        args = train_semi_2d.add_args(common.base_parser_2d(),
                                      "uamt").parse_args(
            _argv2d(synth2d, tmp_path, epochs) + [
                "--regime", "50", "-n", "unet", "-l", "1e-2",
                "--resume", "1"])
        return train_semi_2d.build(args, "uamt", _semi_loaders(args))
    _resume_twice(make)


def test_train_sup_3d_resume(synth3d, tmp_path):
    def make(epochs):
        args = train_sup_3d.add_args(common3d.base_parser_3d()).parse_args(
            _argv3d(synth3d, tmp_path, epochs) + ["--regime", "50",
                                                  "--resume", "1"])
        return train_sup_3d.build(args)
    _resume_twice(make)


# -- profile 

def test_profile_dir_writes_a_trace(synth3d, tmp_path):
    prof = tmp_path / "prof"
    args = train_sup_3d.add_args(common3d.base_parser_3d()).parse_args(
        _argv3d(synth3d, tmp_path, 2) + ["--regime", "50", "--profile_dir",
                                         str(prof)])
    train_sup_3d.build(args).run()
    files = os.listdir(prof)
    assert files and all(os.path.getsize(prof / f) > 0 for f in files)
    assert any(f.endswith(".json") for f in files)
    # the traced epoch carries the program's own spans, and tracing is
    # off again after it
    names = set()
    for f in files:
        if f.endswith(".json"):
            with open(prof / f) as fh:
                names |= {e.get("name") for e in json.load(fh)[
                    "traceEvents"]}
    assert {"hx.epoch", "hx.step", "hx.forward", "hx.optimizer"} <= names
    assert not trace.enabled()


# -- device augmentation 

def _d4(x):
    """The 8 D4 transforms of ``x`` (..., H, W), by index."""
    out = []
    for t in (False, True):
        y = x.transpose(-2, -1) if t else x
        for k in range(4):
            out.append(torch.rot90(y, k, (-2, -1)))
    return out


def _d4_index(out, x):
    hits = [i for i, y in enumerate(_d4(x)) if torch.equal(out, y)]
    assert len(hits) == 1
    return hits[0]


def test_device_augment_gives_d4_transforms_in_step():
    g = torch.Generator().manual_seed(0)
    n = 64
    img = torch.randn(n, 3, 16, 16)
    mask = torch.randint(0, 5, (n, 16, 16))
    out_i, out_m = taug.augment_batch(g, img, mask)
    assert out_i.shape == img.shape and out_m.shape == mask.shape
    seen = set()
    for i in range(n):
        k = _d4_index(out_i[i], img[i])
        assert torch.equal(out_m[i], _d4(mask[i])[k])
        seen.add(k)
    assert len(seen) == 8
    with pytest.raises(ValueError, match="square"):
        taug.augment_batch(g, torch.zeros(1, 3, 8, 16))


def _hebbax_d4_probabilities(x):
    """P(each D4 element) under hebbax's decision probabilities, by
    enumerating its ``_apply_one`` on a marker image."""
    probs = np.zeros(8)
    xt = torch.from_numpy(x)
    xj = jnp.asarray(x)[..., None]
    for f, d, t, k in itertools.product((0, 1), range(3), (0, 1),
                                        range(4)):
        if not f and d:
            continue        # without a flip the direction does not matter
        img, _ = jaug._apply_one(xj, jnp.zeros(x.shape, jnp.int32),
                                 jnp.bool_(f), jnp.int32(d), jnp.bool_(t),
                                 jnp.int32(k))
        p = (0.75 / 3 if f else 0.25) * 0.5 * 0.25
        probs[_d4_index(torch.from_numpy(np.array(img)[..., 0]), xt)] += p
    return probs


def test_device_augment_distribution_matches_hebbax():
    n = 4000
    g = torch.Generator().manual_seed(1)
    flip_on, flip_d, transpose_on, rot_k = taug.draw_transforms(g, n)

    def within(freq, p, count):
        sigma = math.sqrt(p * (1 - p) / count)
        assert abs(freq - p) <= 4 * sigma, (freq, p)

    within(float(flip_on.float().mean()), 0.75, n)
    for d in range(3):
        within(float((flip_d[flip_on] == d).float().mean()), 1 / 3,
               int(flip_on.sum()))
    within(float(transpose_on.float().mean()), 0.5, n)
    for k in range(4):
        within(float((rot_k == k).float().mean()), 0.25, n)
    # the 8 transforms' frequencies on a marker image
    marker = np.arange(36, dtype=np.float32).reshape(6, 6)
    expect = _hebbax_d4_probabilities(marker)
    assert math.isclose(expect.sum(), 1.0)
    out, _ = taug.augment_batch(torch.Generator().manual_seed(2),
                                torch.from_numpy(marker).expand(n, 1, 6, 6))
    counts = np.bincount([_d4_index(out[i, 0], torch.from_numpy(marker))
                          for i in range(n)], minlength=8)
    for c, p in zip(counts, expect):
        within(c / n, p, n)


def test_train_sup_2d_device_augment(synth2d, tmp_path):
    args = train_sup_2d.add_args(common.base_parser_2d()).parse_args(
        _argv2d(synth2d, tmp_path, 1) + ["--regime", "100", "-n", "unet",
                                         "--device_augment", "1"])
    trainer = train_sup_2d.build(args, _sup_loaders(args))
    assert trainer.loaders["train"].dataset.host_augment is False
    assert trainer.loaders["val"].dataset.host_augment is True
    trainer.run()
    assert _epochs(trainer.paths.run) == [1]


def test_train_semi_2d_em_device_augment(synth2d, tmp_path):
    args = train_semi_2d.add_args(common.base_parser_2d(), "em").parse_args(
        _argv2d(synth2d, tmp_path, 1) + ["--regime", "50", "-n", "unet",
                                         "--device_augment", "1"])
    trainer = train_semi_2d.build(args, "em", _semi_loaders(args))
    assert trainer.loaders["train_sup"].dataset.host_augment is False
    assert trainer.loaders["train_unsup"].dataset.host_augment is False
    trainer.run()
    assert _epochs(trainer.paths.run) == [1]


def test_host_augment_off_gives_the_eval_item(synth2d):
    args = common.base_parser_2d().parse_args(_argv2d(synth2d, "x", 1))
    ds = _sup_loaders(args)["train"].dataset
    rng = np.random.default_rng(0)
    ds.host_augment = False
    ds.train = True
    a = ds.get(0, rng)
    ds.train = False
    b = ds.get(0, rng)
    np.testing.assert_array_equal(a["image"], b["image"])
    np.testing.assert_array_equal(a["mask"], b["mask"])


# -- init types 

def _hebbax_std(init_type, shape_kio, transpose):
    w = torch_kernel_init(init_type, transpose)(jax.random.PRNGKey(0),
                                                shape_kio)
    return float(np.std(np.asarray(w)))


@pytest.mark.parametrize("init_type", ["xavier", "normal", "kaiming"])
@pytest.mark.parametrize("transpose", [False, True])
def test_init_std_matches_hebbax(init_type, transpose):
    g = torch.Generator().manual_seed(0)
    if transpose:
        m = HConvTranspose(64, 32, (2, 2, 2), stride=2, init_type=init_type,
                           generator=g)
        kio, rf, i, o = (2, 2, 2, 64, 32), 8, 64, 32
        fan_in, fan_out = o * rf, i * rf
    else:
        m = HConv(48, 96, 3, padding=1, init_type=init_type, generator=g)
        kio, rf, i, o = (3, 3, 48, 96), 9, 48, 96
        fan_in, fan_out = i * rf, o * rf
    formula = {"xavier": INIT_GAIN * math.sqrt(2.0 / (fan_in + fan_out)),
               "normal": INIT_GAIN,
               "kaiming": math.sqrt(2.0 / fan_in)}[init_type]
    got = float(m.weight.detach().std())
    assert abs(got / formula - 1) <= 0.05
    assert abs(_hebbax_std(init_type, kio, transpose) / formula - 1) <= 0.05


@pytest.mark.parametrize("transpose", [False, True])
def test_init_orthogonal_rows(transpose):
    g = torch.Generator().manual_seed(0)
    m = (HConvTranspose(16, 8, (2, 2), stride=2, init_type="orthogonal",
                        generator=g) if transpose else
         HConv(16, 32, 3, padding=1, init_type="orthogonal", generator=g))
    rows = m.weight.shape[0]          # O for a conv, I for a transpose
    w = m.weight.detach().double().reshape(rows, -1)
    np.testing.assert_allclose(
        (w @ w.T).numpy(), INIT_GAIN ** 2 * np.eye(rows), rtol=0,
        atol=1e-6 * INIT_GAIN ** 2)


def test_init_type_reaches_every_conv():
    from types import SimpleNamespace
    args = SimpleNamespace(network="unet", init_weights="normal", seed=0,
                           dtype="float32")
    model = common.new_model(args, dataset_cfg("GlaS"), "cpu")
    stds = [float(m.weight.detach().std()) for m in model.modules()
            if isinstance(m, HConv)]
    assert len(stds) == 25 and all(abs(s / INIT_GAIN - 1) < 0.3
                                   for s in stds)
    with pytest.raises(NotImplementedError):
        HConv(3, 4, 3, init_type="uniform")


# -- losses 

def _logits_targets(seed, shape=(2, 16, 12), n_cls=2):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal(shape + (n_cls,)).astype(np.float32) * 2
    target = rng.integers(0, n_cls, shape).astype(np.int32)
    target[rng.random(shape) < 0.2] = -1
    return logits, target


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bce_matches_hebbax(seed):
    logits, target = _logits_targets(seed)
    lg = logits[..., 0]                 # one logit per pixel
    ref = float(jlosses.segmentation_loss("bce")(jnp.asarray(lg),
                                                 jnp.asarray(target)))
    got = float(tlosses.segmentation_loss("bce")(
        torch.from_numpy(lg), torch.from_numpy(target).long()))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("n_cls", [2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_bcebound_matches_hebbax(seed, n_cls):
    logits, target = _logits_targets(seed, n_cls=n_cls)
    ref = float(jlosses.segmentation_loss("bcebound", num_classes=n_cls)(
        jnp.asarray(logits), jnp.asarray(target)))
    got = float(tlosses.segmentation_loss("bcebound", num_classes=n_cls)(
        torch.from_numpy(np.ascontiguousarray(np.moveaxis(logits, -1, 1))),
        torch.from_numpy(target).long()))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("loss", ["dice", "bce", "bcebound"])
def test_aux_weighted_loss_matches_hebbax(loss):
    outs = [_logits_targets(s)[0] for s in (3, 4, 5)]
    target = _logits_targets(3)[1]
    if loss == "bce":
        outs = [o[..., 0] for o in outs]
    ref = float(jlosses.segmentation_loss(loss, aux=True, num_classes=2)(
        [jnp.asarray(o) for o in outs], jnp.asarray(target)))
    t_outs = [torch.from_numpy(np.ascontiguousarray(
        o if loss == "bce" else np.moveaxis(o, -1, 1))) for o in outs]
    got = float(tlosses.segmentation_loss(loss, aux=True, num_classes=2)(
        t_outs, torch.from_numpy(target).long()))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


# -- which CLI accepts which flag 

PORTED = ["--dtype", "bfloat16", "--resume", "1", "--profile_dir", "p",
          "--init_weights", "xavier", "--loss", "bcebound"]

# cli -> (argv, build arguments after ``args``; the 2D loaders go in at
# their place) of its ``--dp_devices 2`` run
DP_RUNS = {
    "pretrain_hebbian_unsup_2d": lambda s, t: (
        _argv2d(s, t, 1) + ["-b", "3", "-n", "unet", "--exclude",
                            "out_conv"], ()),
    "train_sup_2d": lambda s, t: (
        _argv2d(s, t, 1) + ["-b", "3", "-n", "unet", "--regime", "100"], ()),
    "train_snn_sup_2d": lambda s, t: (
        _argv2d(s, t, 1) + ["-b", "3", "--regime", "100"], ()),
    "train_semi_2d": lambda s, t: (
        _argv2d(s, t, 1) + ["-b", "3", "-n", "unet", "--regime", "50"],
        ("em",)),
    "pretrain_unsup_2d": lambda s, t: (
        _argv2d(s, t, 1) + ["-b", "3"], ("vae",)),
    "train_semi_raddino_decoder_2d": lambda s, t: (
        _argv2d(s, t, 1) + ["-b", "3", "--regime", "50"],
        (28, dict(dim=48, depth=2))),
    "pretrain_hebbian_unsup_3d": lambda s, t: (
        _argv3d(s, t, 1) + ["-b", "3", "--exclude", "conv"], ()),
    "train_sup_3d": lambda s, t: (
        _argv3d(s, t, 1) + ["-b", "3", "--regime", "50"], ()),
    "train_semi_3d": lambda s, t: (
        _argv3d(s, t, 1) + ["-b", "3", "--regime", "50"], ("em", None)),
    "pretrain_unsup_3d": lambda s, t: (
        _argv3d(s, t, 1) + ["-b", "3", "-n", "unet_ddpm",
                            "--timestamp_diffusion", "8"],
        ("superdiff", None)),
}


@pytest.mark.parametrize("cli", [
    "pretrain_hebbian_unsup_2d", "train_sup_2d", "train_snn_sup_2d",
    "train_semi_2d", "pretrain_unsup_2d", "train_semi_raddino_decoder_2d",
    "pretrain_hebbian_unsup_3d", "train_sup_3d", "train_semi_3d",
    "pretrain_unsup_3d"])
def test_cli_accepts_the_ported_flags(cli, synth2d, synth3d, tmp_path):
    is3d = cli.endswith("3d")
    parser = (common3d.base_parser_3d() if is3d
              else common.base_parser_2d())
    mod = importlib.import_module(f"hebbax_torch.cli.{cli}")
    if cli in ("train_semi_2d", "train_semi_3d"):
        parser = mod.add_args(parser, "em")
    elif cli in ("pretrain_unsup_2d", "pretrain_unsup_3d"):
        parser = mod.add_args(parser, "vae")
    elif cli != "train_snn_sup_2d":
        parser = mod.add_args(parser)
    extra = [] if is3d else ["--device_augment", "1"]
    args = parser.parse_args(PORTED + extra)
    common.check_ported(args)
    assert common.model_dtype(args) is torch.bfloat16
    over = max(2, torch.cuda.device_count() + 1)
    args = parser.parse_args(["--dp_devices", str(over)])
    visible = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"--dp_devices {over}: only "
                                         f"{visible} CUDA cards"):
        common.check_ported(args)
    # end to end on 2 gloo CPU ranks: one epoch at 32x32 (16^3 in 3D)
    synth = synth3d if is3d else synth2d
    argv, build_args = DP_RUNS[cli](synth, tmp_path)
    parser = (common3d.base_parser_3d() if is3d
              else common.base_parser_2d())
    if cli == "train_snn_sup_2d":
        parser = mod.add_args(common.base_parser_2d({"network": "snn_vgg"}))
    elif cli in ("train_semi_2d", "train_semi_3d", "pretrain_unsup_2d",
                 "pretrain_unsup_3d"):
        parser = mod.add_args(parser, build_args[0])
    else:
        parser = mod.add_args(parser)
    args = parser.parse_args(argv + ["--dp_devices", "2"])
    if not is3d:
        if cli in ("train_semi_2d", "train_semi_raddino_decoder_2d"):
            loaders = _semi_loaders(args)
        else:
            loaders = _sup_loaders(args)
        build_args = (*build_args[:1], loaders, *build_args[1:]) \
            if cli in ("train_semi_2d", "pretrain_unsup_2d") \
            else (loaders, *build_args)
    best = common.train(mod.build, args, *build_args, timeout=60,
                        deadline=300)
    assert len(best) == 3 and all(np.isfinite(best))
    runs = [d for d, _, files in os.walk(str(tmp_path)) if
            "train_log.csv" in files]
    assert len(runs) == 1, runs
    assert os.path.exists(os.path.join(runs[0], "checkpoints", "last.ckpt"))
    assert all(np.isfinite(float(r["loss"])) for r in csv.DictReader(
        open(os.path.join(runs[0], "train_log.csv"))))


def test_model_dtype_names():
    from types import SimpleNamespace
    assert common.model_dtype(SimpleNamespace(dtype="float32")) is None
    assert common.model_dtype(SimpleNamespace(dtype="bf16")) is torch.bfloat16
    with pytest.raises(ValueError):
        common.model_dtype(SimpleNamespace(dtype="float16"))


def test_snn_vgg_ignores_dtype_ann_vgg_takes_it():
    """hebbax's SNNVGG takes a dtype it never uses; ANNVGG casts its
    convs (its batch norms return float32)."""
    x = torch.randn(1, 3, 32, 32)
    snn = get_network("snn_vgg", 3, 2, device="cpu", dtype=torch.bfloat16,
                      poisson_generator=torch.Generator().manual_seed(0))
    snn.timesteps = 2
    assert snn(x).dtype == torch.float32
    ann = get_network("ann_vgg", 3, 2, device="cpu", dtype=torch.bfloat16)
    assert ann(x).dtype == torch.bfloat16


def test_raddino_ignores_dtype(synth2d, tmp_path):
    """hebbax's RAD-DINO trainer builds its encoder and decoder without a
    dtype: with ``--dtype bfloat16`` the port's decoder still computes in
    float32."""
    from hebbax_torch.cli import train_semi_raddino_decoder_2d as rd
    args = rd.add_args(common.base_parser_2d()).parse_args(
        _argv2d(synth2d, tmp_path, 1) + ["--regime", "50", "--dtype",
                                         "bfloat16"])
    trainer = rd.build(args, _semi_loaders(args), image_size=28,
                       encoder_kw=dict(dim=48, depth=2))
    batch = trainer.prep(next(iter(trainer.loaders["val"])))
    assert trainer.eval_step(batch)["logits"].dtype == torch.float32
