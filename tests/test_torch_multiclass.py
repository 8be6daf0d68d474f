"""The port's multi-class metrics against hebbax's: the confusion
accumulator and ``evaluate``, validation and model selection of a
3-class run (``train_sup_2d``, CPS's two members), ``test_2d``'s
multi-class branch with the caller behaviour hebbax has, the RAD-DINO
tester, and the histogram summed over 2 gloo ranks.

The datasets of both packages are binary, so the tests register a
3-class copy of GlaS, ``GlaS3``, in each package's table for the test's
duration, and read its masks as 3 classes (class 2 on the right half of
each disc) through both packages' mask readers.

Tolerances: Jaccard / Dice from histograms of integer counts are exact
(float64 of equal counts) where both packages count the same argmax; on
logits that both packages compute (a forward each), rtol 1e-6 (an argmax
flips only within float32 rounding of a tie); HD95 / ASSD rtol 1e-6 (the
same masks from probabilities thresholded at 0.5, as test_torch_cli.py).
"""

import csv
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hebbax.config.datasets as jdatasets
import hebbax.data.dataset2d as jds
import hebbax.models.raddino as jrd
import hebbax.ops.metrics as jmetrics
from hebbax.cli import test_2d as jtest
from hebbax.models import get_network as j_get_network
from hebbax.utils import checkpoint as jckpt
from hebbax_torch import bridge, parallel
from hebbax_torch.cli import common
from hebbax_torch.cli import test_2d as ttest
from hebbax_torch.cli import test_raddino_decoder_2d as traddino_test
from hebbax_torch.cli import train_semi_2d as semi_cli
from hebbax_torch.cli import train_sup_2d as finetune
from hebbax_torch.config import datasets as tdatasets
from hebbax_torch.data import dataset2d as tds
from hebbax_torch.models import raddino as trd
from hebbax_torch.ops import metrics as tmetrics
from hebbax_torch.utils.checkpoint import load_state_dict

import torch_remat_cases as cases

torch.set_num_threads(2)

# The port's RAD-DINO trainer and tester ask transformers for
# microsoft/rad-dino.  Set before transformers is imported, here or in
# the ranks a test spawns, this makes the answer offline at once.
os.environ["HF_HUB_OFFLINE"] = "1"

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_CLS = 3


def _logits(seed, shape=(3, 8, 8), n_cls=N_CLS, ties=False):
    """(NHWC numpy logits, int targets): integer logits make argmax ties,
    which both packages break to the first maximum."""
    rng = np.random.default_rng(seed)
    if ties:
        x = rng.integers(0, 2, shape + (n_cls,)).astype(np.float32)
    else:
        x = rng.standard_normal(shape + (n_cls,)).astype(np.float32)
    return x, rng.integers(0, n_cls, shape).astype(np.int32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


@pytest.mark.parametrize("n_cls", [3, 4])
@pytest.mark.parametrize("ties", [False, True])
def test_confusion_accumulator_matches_hebbax(n_cls, ties):
    acc, jacc = tmetrics.ConfusionAccumulator(n_cls), \
        jmetrics.ConfusionAccumulator(n_cls)
    for seed in range(3):
        x, t = _logits(seed, n_cls=n_cls, ties=ties)
        acc.update(_nchw(x), torch.from_numpy(t))
        jacc.update(jnp.asarray(x), jnp.asarray(t))
    np.testing.assert_array_equal(acc.hist.numpy(), np.asarray(jacc.hist))
    assert acc.hist.dtype == torch.float32
    got, ref = acc.finalize(), jacc.finalize()
    assert got[0] is None and ref[0] is None
    assert got == ref


def test_absent_class_is_left_out_of_the_means():
    """A class absent from targets and predictions has 0/0 Jaccard; both
    packages leave it out of the nanmean."""
    x, t = _logits(7)
    x[..., 2] = -10.0
    t[t == 2] = 0
    got = tmetrics.eval_multi_class(_nchw(x), torch.from_numpy(t))
    ref = jmetrics.eval_multi_class(x, t)
    assert got == ref and np.isfinite(got[1])


@pytest.mark.parametrize("n_cls", [2, 3])
def test_evaluate_matches_hebbax(n_cls):
    x, t = _logits(11, n_cls=n_cls)
    got = tmetrics.evaluate(n_cls, _nchw(x), torch.from_numpy(t))
    ref = jmetrics.evaluate(n_cls, x, t)
    if n_cls == 2:
        assert got[0] == ref[0]
        np.testing.assert_allclose(got[1:], ref[1:], rtol=1e-6)
    else:
        assert got == ref


def test_make_accumulator_by_class_count():
    assert isinstance(tmetrics.make_accumulator(2),
                      tmetrics.SweepAccumulator)
    acc = tmetrics.make_accumulator(5)
    assert isinstance(acc, tmetrics.ConfusionAccumulator)
    assert acc.num_classes == 5
    # no update: every class is 0/0, a nanmean of nothing (as hebbax's)
    with pytest.warns(RuntimeWarning, match="empty slice"):
        assert np.isnan(acc.finalize()[1])


def test_test_2d_multiclass_branch_reproduces_hebbax():
    """hebbax's caller hands the class-1 probabilities to a branch that
    reads a class map (``hebbax/cli/test_2d.py:118,131`` into ``:58-66``):
    the int64 cast predicts class 1 only where p1 == 1, class 0 elsewhere.
    The port returns hebbax's numbers; the argmax confusion of the same
    logits is another value."""
    x, t = _logits(3, shape=(4, 16, 16))
    x[0, :4, :4] = [0.0, 200.0, 0.0]          # p1 == 1 in float32
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x), axis=-1)[..., 1])
    ref = jtest.evaluate_test(probs, t, None, N_CLS)
    got = ttest.evaluate_test(probs, t, None, N_CLS)
    assert got == ref and got[0] is None
    as_hebbax = tmetrics.eval_multi_class(
        torch.nn.functional.one_hot(torch.from_numpy(
            (probs == 1).astype(np.int64)), N_CLS).permute(0, 3, 1, 2),
        torch.from_numpy(t))
    assert got == as_hebbax
    argmax = tmetrics.eval_multi_class(_nchw(x), torch.from_numpy(t))
    assert abs(argmax[1] - got[1]) > 0.05, (argmax, got)
    # binary: unchanged, at the threshold
    pb, tb = probs, (t > 0).astype(np.int32)
    assert ttest.evaluate_test(pb, tb, 0.4) == jtest.evaluate_test(
        pb, tb, 0.4, 2)


# -- 3-class runs on the CPU ---------------------------------------------------

def _three_class_mask(load):
    def read(path):
        m = load(path).astype(np.uint8)
        m[:, m.shape[1] // 2:] *= 2
        return m
    return read


@pytest.fixture
def glas3(monkeypatch):
    """``GlaS3``: GlaS with 3 classes, in both packages' tables, its
    masks read as 3 classes by both packages' readers."""
    for mod in (tdatasets, jdatasets):
        cfg = dict(mod.dataset_cfg("GlaS"), NUM_CLASSES=N_CLS,
                   PALETTE=[0, 0, 0, 255, 255, 255, 255, 0, 0])
        monkeypatch.setitem(mod._CONFIG, "GlaS3", cfg)
    for mod in (tds, jds):
        monkeypatch.setattr(mod, "_load_mask",
                            _three_class_mask(mod._load_mask))
    return "GlaS3"


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    spec = importlib.util.spec_from_file_location(
        "make_synth_data", os.path.join(REPO, "scripts",
                                        "make_synth_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    root = tmp_path_factory.mktemp("synth3") / "GlaS"
    mod.make_2d(str(root), 6, 2, 32, seed=3)
    return str(root)


def _argv(synth, root):
    return ["--device", "cpu", "--path_dataset", synth, "--dataset_name",
            "GlaS3", "--path_root_exp", str(root), "-b", "2", "-e", "2",
            "-w", "1", "--validate_iter", "1", "--num_workers", "1",
            "-n", "unet", "-l", "0.01"]


def _read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _check_multiclass_run(run, capsys):
    """No threshold anywhere: the snapshots store None, val_log.csv 0.0
    (hebbax's ``ev[0] if ev[0] else 0.0``), train_log.csv an empty field,
    and the box printer no Thr line."""
    for name in ("best_JI", "last"):
        _, meta = load_state_dict(os.path.join(run, "checkpoints",
                                               f"{name}.ckpt"))
        assert meta["threshold"] is None
    val = _read_csv(os.path.join(run, "val_log.csv"))
    assert [r["thresh"] for r in val] == ["0.0", "0.0"]
    assert all(0.0 <= float(r["JI"]) <= 1.0 for r in val)
    train = _read_csv(os.path.join(run, "train_log.csv"))
    assert [r["thresh"] for r in train] == ["", ""]
    out = capsys.readouterr().out
    assert "Jc:" in out and "Thr:" not in out


def test_sup_run_then_test_2d_matches_hebbax(glas3, synth, tmp_path,
                                             capsys):
    """train_sup_2d on 3 classes validates through the confusion
    accumulator; test_2d on its best_JI snapshot then gives hebbax's
    test_2d's metrics.  Without --threshold, hebbax's tester fails on the
    None threshold (a TypeError at HD95) and the port's refuses first."""
    args = finetune.add_args(common.base_parser_2d()).parse_args(
        _argv(synth, tmp_path) + ["--regime", "100"])
    loaders = common.make_loaders_2d(args, tdatasets.dataset_cfg("GlaS3"),
                                     regime=100)
    masks = np.concatenate([b["mask"] for b in loaders["val"]])
    assert set(np.unique(masks)) == {0, 1, 2}
    trainer = finetune.build(args, loaders)
    trainer.run()
    _check_multiclass_run(trainer.paths.run, capsys)

    argv = ["--path_dataset", synth, "--dataset_name", "GlaS3",
            "--path_exp", trainer.paths.run, "-n", "unet", "-b", "2",
            "--num_workers", "1"]
    with pytest.raises(TypeError):
        jtest.main(argv)
    with pytest.raises(ValueError, match="--threshold"):
        ttest.main(["--device", "cpu"] + argv)
    argv += ["--threshold", "0.5"]
    got = ttest.main(["--device", "cpu"] + argv)
    ref = jtest.main(argv)
    assert got["thresh"] is None and ref["thresh"] is None
    for k in ("segm/dice", "segm/jaccard", "segm/asd", "segm/95hd"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, err_msg=k)
    row = _read_csv(os.path.join(trainer.paths.run, "test.csv"))[0]
    assert row["thresh"] == ""


def test_cps_selects_by_mean_jaccard(glas3, synth, tmp_path, capsys):
    """CPS validates both members through two confusion accumulators and
    snapshots the better one with no threshold."""
    args = semi_cli.add_args(common.base_parser_2d(), "cps").parse_args(
        _argv(synth, tmp_path) + ["--regime", "50", "-u", "5"])
    cfg = tdatasets.dataset_cfg("GlaS3")
    sup = common.make_loaders_2d(args, cfg, sup=True)
    unsup = common.make_loaders_2d(args, cfg, sup=False, splits=("train",))
    trainer = semi_cli.build(args, "cps", {
        "train_sup": sup["train"], "train_unsup": unsup["train"],
        "val": sup["val"]})
    accs = []
    orig = tmetrics.make_accumulator

    def spy(n):
        accs.append(orig(n))
        return accs[-1]
    import hebbax_torch.engine.semi as tsemi
    import hebbax_torch.engine.loop as tloop
    for mod in (tsemi, tloop):
        setattr(mod, "make_accumulator", spy)
    try:
        trainer.run()
    finally:
        for mod in (tsemi, tloop):
            setattr(mod, "make_accumulator", orig)
    assert sum(isinstance(a, tmetrics.ConfusionAccumulator)
               for a in accs) >= 4          # 2 members x 2 validations
    assert all(isinstance(a, tmetrics.ConfusionAccumulator) for a in accs)
    _check_multiclass_run(trainer.paths.run, capsys)
    _, meta = load_state_dict(os.path.join(trainer.paths.run,
                                           "checkpoints2", "last.ckpt"))
    assert meta["threshold"] is None


def test_raddino_tester_three_classes_matches_hebbax(glas3, synth,
                                                     tmp_path, monkeypatch):
    """The RAD-DINO tester on a 3-class decoder snapshot, against hebbax's
    root script, both through the same small encoder at 224x224 (the
    script's size): hebbax's PRNGKey(0) init carried into the port."""
    small = dict(dim=48, depth=2)
    vit = jrd.ViTEncoder
    monkeypatch.setattr(jrd, "ViTEncoder", lambda: vit(**small))
    # hebbax's loader asks transformers for microsoft/rad-dino, which may
    # try the network: the offline answer, without asking
    monkeypatch.setattr(jrd, "load_hf_rad_dino_params",
                        lambda params: (params, False))
    enc_params = jax.tree_util.tree_map(np.asarray, vit(**small).init(
        {"params": jax.random.PRNGKey(0)},
        jnp.zeros((1, 224, 224, 3)))["params"])

    def carried(seed, device, image_size, **kw):
        assert seed == 0 and image_size == 224 and kw == small
        enc = trd.ViTEncoder(image_size=224, **small)
        enc.load_state_dict(bridge.from_flax(enc_params))
        return enc
    monkeypatch.setattr(traddino_test, "frozen_encoder", carried)
    decoder = jrd.RadDinoDecoder(N_CLS)
    variables = decoder.init(jax.random.PRNGKey(2),
                             jnp.zeros((1, 16, 16, 48)), train=False)
    run = tmp_path / "run"
    jckpt.save_snapshot(jax.tree_util.tree_map(np.asarray, variables),
                        str(run / "checkpoints"), save_best=True)
    argv = ["--path_dataset", synth, "--dataset_name", "GlaS3",
            "--path_exp", str(run), "-b", "2", "--num_workers", "1",
            "--threshold", "0.5"]
    got = traddino_test.run_test(
        traddino_test.build_parser().parse_args(["--device", "cpu"] + argv),
        image_size=224, encoder_kw=small)
    spec = importlib.util.spec_from_file_location(
        "hebbax_raddino_test", os.path.join(REPO,
                                            "test_raddino_decoder_2d.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(argv)
    ref = _read_csv(os.path.join(run, "test.csv"))[0]
    assert got["thresh"] is None and ref["thresh"] == ""
    for k in ("segm/dice", "segm/jaccard", "segm/asd", "segm/95hd"):
        np.testing.assert_allclose(got[k], float(ref[k]), rtol=1e-6,
                                   err_msg=k)


# -- data parallelism -------------------------------------------------------------

def test_histogram_summed_over_two_ranks_equals_one_process():
    """Each of 2 gloo ranks counts its rows of a padded global batch of 5
    (the single process counts the valid rows); finalize sums the
    histograms first, so every rank returns the single process's
    numbers, and hebbax's."""
    x, t = _logits(13, shape=(5, 8, 8))
    single = cases.confusion_case(x, t, N_CLS)
    ranks = parallel.run_ranks(cases.confusion_case, 2, (x, t, N_CLS),
                               timeout=60, deadline=300, threads=1)
    ref = jmetrics.eval_multi_class(x, t, N_CLS)
    assert single == ref
    assert all(r == single for r in ranks)
