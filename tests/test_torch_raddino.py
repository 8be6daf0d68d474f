"""The port's RAD-DINO path held against hebbax: the ViT encoder (a ViT
at dim 48, depth 2, 12 heads, image 28, so a 2x2 patch grid), the flax
``ConvTranspose`` flip at kernels 3 / 7 and strides 1 / 2 / 3, the
decoder in eval and training mode, one semi step of the trainer on
carried weights, the CLI -> tester with snapshots crossing both ways, and
the tester's encoder seeding.

hebbax's ``ViTBlock`` has no LayerScale (DINOv2's blocks do: a learned
per-channel gain on each residual branch), and neither has the port's:
the block's parameter tree is ``norm1``, ``attn``, ``norm2``, ``fc1``,
``fc2``, one to one.

Tolerances (float32): encoder tokens atol 1e-5 (seen 1.7e-6 at a scale
of 3.3: two blocks of 48-wide attention and a 192-wide MLP, sums taken in
another order); the tanh GELU atol 1e-6 (float32 cancellation in
1 + tanh near x = -4, seen 3.4e-7); transpose convs rtol 1e-5 / atol
1e-6; decoder outputs atol 5e-5 (seen 5.5e-6 at a scale of 4.5;
train-mode BN over batch 2) and BN statistics rtol 1e-4 / atol 1e-5; one
semi step: losses rtol 1e-4, decoder parameters and BN statistics rtol
1e-4 / atol 1e-5 (SGD, lr 0.01).  Snapshot loads and bytes are exact.
"""

import argparse
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn
from flax import traverse_util

import hebbax.cli.common as jcommon
import hebbax.cli.train_semi_raddino_decoder_2d as jcli
import hebbax.models.raddino as jrd
from hebbax.utils import checkpoint as jckpt
from hebbax_torch import bridge
from hebbax_torch.cli import common
from hebbax_torch.cli import test_raddino_decoder_2d as ttest
from hebbax_torch.cli import train_semi_raddino_decoder_2d as tcli
from hebbax_torch.config.datasets import dataset_cfg
from hebbax_torch.models import raddino as trd
from hebbax_torch.utils import checkpoint as tckpt

from test_torch_unet2d import to_nchw, to_nhwc

torch.set_num_threads(2)

# The port's RAD-DINO trainer and tester ask transformers for
# microsoft/rad-dino.  Set before transformers is imported, here or in
# the ranks a test spawns, this makes the answer offline at once.
os.environ["HF_HUB_OFFLINE"] = "1"

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM, DEPTH, SIZE = 48, 2, 28
SMALL = dict(dim=DIM, depth=DEPTH)


def encoder_pair(seed=0):
    """(hebbax encoder, numpy params, port encoder carrying them)."""
    jm = jrd.ViTEncoder(**SMALL)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, SIZE, SIZE, 3)))["params"])
    tm = trd.ViTEncoder(image_size=SIZE, **SMALL)
    tm.load_state_dict(bridge.from_flax(params))
    return jm, params, tm


def decoder_pair(seed=1):
    jm = jrd.RadDinoDecoder(2, out_size=SIZE)
    v = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 2, 2, DIM)), train=False))
    tm = trd.RadDinoDecoder(2, out_size=SIZE, dim=DIM)
    tm.load_state_dict(bridge.from_flax(v["params"], v["batch_stats"],
                                        **bridge.kernel_layout(tm)))
    return jm, v, tm


def _images(seed, n=2, size=SIZE):
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


# -- encoder ---------------------------------------------------------------------

def test_encoder_tokens_match():
    jm, params, tm = encoder_pair()
    x = _images(1)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(to_nchw(x)).numpy()
    assert got.shape == (2, 1 + 4, DIM)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_block_has_hebbax_tree_and_no_layerscale():
    """One to one with hebbax's tree (the strict load in encoder_pair);
    DINOv2's LayerScale gains (``layer_scale1`` / ``ls1``) are absent on
    both sides."""
    _, params, tm = encoder_pair()
    assert sorted(params["block0"]) == ["attn", "fc1", "fc2", "norm1",
                                        "norm2"]
    names = [n for n, _ in tm.block0.named_parameters()]
    assert not [n for n in names if "scale" in n or "ls" in n.split(".")[0]]
    assert tm.block0.attn.query.weight.shape == (12, DIM // 12, DIM)
    assert tm.block0.attn.out.weight.shape == (DIM, 12, DIM // 12)
    assert params["block0"]["attn"]["query"]["kernel"].shape == (
        DIM, 12, DIM // 12)


def test_layernorm_eps_and_tanh_gelu():
    _, _, tm = encoder_pair()
    assert tm.norm.eps == 1e-6 and tm.block0.norm1.eps == 1e-6
    assert fnn.LayerNorm().epsilon == 1e-6
    x = np.linspace(-4, 4, 101).astype(np.float32)
    np.testing.assert_allclose(
        torch.nn.functional.gelu(torch.from_numpy(x),
                                 approximate="tanh").numpy(),
        np.asarray(fnn.gelu(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


def test_reshape_patch_embeddings_matches():
    tokens = np.random.default_rng(2).standard_normal(
        (2, 1 + 16, 5)).astype(np.float32)
    ref = np.asarray(jrd.reshape_patch_embeddings(jnp.asarray(tokens), 56,
                                                  14))
    got = trd.reshape_patch_embeddings(torch.from_numpy(tokens), 56, 14)
    np.testing.assert_array_equal(to_nhwc(got), ref)


# -- the transpose conv and the decoder -------------------------------------------

@pytest.mark.parametrize("k,s", [(3, 1), (3, 2), (3, 3), (7, 1), (7, 2),
                                 (7, 3)])
def test_conv_transpose_flip_matches(k, s):
    """flax ``nn.ConvTranspose(padding='VALID')`` against torch's
    ``conv_transpose2d`` with the bridge's spatially flipped kernel, on an
    asymmetric kernel and an odd-sized input."""
    jm = fnn.ConvTranspose(4, (k, k), strides=(s, s), padding="VALID")
    x = np.random.default_rng(k * 10 + s).standard_normal(
        (2, 5, 6, 3)).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(k + s), jnp.asarray(x))["params"])
    params["bias"] = np.random.default_rng(0).standard_normal(4).astype(
        np.float32)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = trd.FlaxConvTranspose2d(3, 4, k, s)
    sd = bridge.from_flax({"c": params}, **bridge.kernel_layout(
        torch.nn.ModuleDict({"c": tm})))
    tm.load_state_dict({n.split(".", 1)[1]: v for n, v in sd.items()})
    with torch.no_grad():
        got = to_nhwc(tm(to_nchw(x)))
    assert got.shape == ref.shape == (2, (5 - 1) * s + k, (6 - 1) * s + k,
                                      4)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    # without the flip the orientation is wrong
    with torch.no_grad():
        wrong = torch.nn.functional.conv_transpose2d(
            to_nchw(x), torch.from_numpy(np.ascontiguousarray(
                np.transpose(params["kernel"], (2, 3, 0, 1)))),
            torch.from_numpy(params["bias"]), stride=s)
    assert np.abs(to_nhwc(wrong) - ref).max() > 1e-2


@pytest.mark.parametrize("train", [False, True])
def test_decoder_matches(train):
    jm, v, tm = decoder_pair()
    emb = np.random.default_rng(3).standard_normal(
        (2, 2, 2, DIM)).astype(np.float32)
    out = jm.apply(v, jnp.asarray(emb), train=train,
                   mutable=["batch_stats"] if train else False)
    ref, mut = out if train else (out, None)
    tm.train(train)
    with torch.no_grad():
        got = to_nhwc(tm(to_nchw(emb)))
    assert got.shape == (2, SIZE, SIZE, 2)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=5e-5)
    if train:
        sd = tm.state_dict()
        for path, val in traverse_util.flatten_dict(
                mut["batch_stats"]).items():
            name = path[0] + (".running_mean" if path[1] == "mean"
                              else ".running_var")
            np.testing.assert_allclose(sd[name].numpy(), np.asarray(val),
                                       rtol=1e-4, atol=1e-5, err_msg=name)


def test_decoder_full_size_shapes():
    tm = trd.RadDinoDecoder(2)
    with torch.no_grad():
        out = tm.eval()(torch.zeros(1, 768, 16, 16))
    assert out.shape == (1, 2, 224, 224)


@pytest.mark.parametrize("part", ["encoder", "decoder"])
def test_bridge_round_trip(part):
    if part == "encoder":
        _, params, tm = encoder_pair()
        ref = {"params": params}
    else:
        _, ref, tm = decoder_pair()
    p, s = bridge.to_flax(tm.state_dict(), **bridge.kernel_layout(tm))
    got = {"params": p, **({"batch_stats": s} if s else {})}
    f, r = traverse_util.flatten_dict(got), traverse_util.flatten_dict(ref)
    assert set(f) == set(r)
    for k in r:
        np.testing.assert_array_equal(f[k], r[k])


# -- the trainer -----------------------------------------------------------------

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    spec = importlib.util.spec_from_file_location(
        "make_synth_data", os.path.join(REPO, "scripts",
                                        "make_synth_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    root = tmp_path_factory.mktemp("raddino_synth") / "GlaS"
    mod.make_2d(str(root), 4, 2, 32, seed=4)
    return str(root)


def _argv(synth, root, seed=0):
    return ["--path_dataset", synth, "--dataset_name", "GlaS",
            "--path_root_exp", str(root), "-b", "2", "-e", "1", "-w", "1",
            "--regime", "50", "--num_workers", "1", "--optimizer", "sgd",
            "-l", "0.01", "--loss", "dice", "--seed", str(seed)]


def _port_trainer(synth, root, seed=0):
    args = tcli.add_args(common.base_parser_2d()).parse_args(
        ["--device", "cpu"] + _argv(synth, root, seed))
    return args, tcli.build(args, image_size=SIZE, encoder_kw=SMALL)


def test_semi_step_matches_hebbax(synth, tmp_path, monkeypatch):
    """One step of hebbax's jitted decoder step and of the port's on the
    same batches, the encoder and decoder weights carried over: the unsup
    forward then the sup forward, each moving the BN statistics."""
    monkeypatch.setattr(jcli, "ViTEncoder",
                        lambda: jrd.ViTEncoder(**SMALL))
    # hebbax's loader asks transformers for microsoft/rad-dino, which may
    # try the network: the offline answer, without asking
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setattr(jcli, "load_hf_rad_dino_params",
                        lambda params: (params, False))
    jargs = jcli.add_args(jcommon.base_parser_2d()).parse_args(
        _argv(synth, tmp_path / "j"))
    jtrainer = jcli.build(jargs, image_size=SIZE)
    enc_params = jrd.ViTEncoder(**SMALL).init(
        {"params": jax.random.PRNGKey(0)},
        jnp.zeros((1, SIZE, SIZE, 3)))["params"]
    _, trainer = _port_trainer(synth, tmp_path / "t")
    trainer.encoder.load_state_dict(bridge.from_flax(
        jax.tree_util.tree_map(np.asarray, enc_params)))
    dec = trainer.state.model
    js = jtrainer.state
    dec.load_state_dict(bridge.from_flax(
        jax.tree_util.tree_map(np.asarray, js.params),
        jax.tree_util.tree_map(np.asarray, js.batch_stats),
        **bridge.kernel_layout(dec)))

    sup = {"image": _images(5), "mask": (_images(6)[..., 0] > 0).astype(
        np.int32)}
    unsup = {"image": _images(7)}
    js, jout = jtrainer.train_step(
        js, {k: jnp.asarray(v) for k, v in sup.items()},
        {"image": jnp.asarray(unsup["image"])}, 1.0, jax.random.PRNGKey(0))
    trainer.state, out = trainer.train_step(
        trainer.state,
        {"image": to_nchw(sup["image"]),
         "mask": torch.from_numpy(sup["mask"]).long()},
        {"image": to_nchw(unsup["image"])}, 1.0)
    for k in ("loss", "loss_sup", "loss_unsup"):
        np.testing.assert_allclose(float(out[k]), float(jout[k]), rtol=1e-4,
                                   err_msg=k)
    ref = bridge.from_flax(jax.tree_util.tree_map(np.asarray, js.params),
                           jax.tree_util.tree_map(np.asarray,
                                                  js.batch_stats),
                           **bridge.kernel_layout(dec))
    sd = dec.state_dict()
    assert set(ref) == set(sd)
    for k, v in ref.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def port_run(synth, tmp_path_factory):
    root = tmp_path_factory.mktemp("raddino_runs")
    args, trainer = _port_trainer(synth, root, seed=3)
    enc0 = {k: v.clone() for k, v in trainer.encoder.state_dict().items()}
    trainer.run()
    return root, args, trainer, enc0


def test_trainer_run_dir_frozen_encoder_and_decoder_snapshot(port_run,
                                                             capsys):
    root, args, trainer, enc0 = port_run
    rel = os.path.relpath(trainer.paths.run, root)
    assert rel == os.path.join("GlaS", "semi_sup",
                               "raddino_decoder_raddino_decoder",
                               "inv_temp-1", "regime-50", "run-3")
    assert not trainer.encoder_pretrained
    assert not any(p.requires_grad for p in trainer.encoder.parameters())
    for k, v in trainer.encoder.state_dict().items():
        assert torch.equal(v, enc0[k]), k
    rows = trainer.train_log.rows
    assert rows and all(np.isfinite(r["loss"]) for r in rows)
    variables, _ = jckpt.load_snapshot(
        os.path.join(trainer.paths.checkpoints, "last.ckpt"))
    assert sorted(variables["params"]) == ["bn1", "bn2", "bn3", "deconv1",
                                           "deconv2", "deconv3", "out"]


def test_offline_warning_printed(synth, tmp_path, capsys):
    _port_trainer(synth, tmp_path)
    assert trd.OFFLINE_WARNING in capsys.readouterr().out


def test_load_weights_flag_raises(synth, tmp_path):
    args = tcli.add_args(common.base_parser_2d()).parse_args(
        ["--device", "cpu", "--load_weights", "x.ckpt"]
        + _argv(synth, tmp_path))
    with pytest.raises(ValueError):
        tcli.build(args, image_size=SIZE, encoder_kw=SMALL)


def test_port_snapshot_runs_in_hebbax(port_run):
    """hebbax's decoder applied to the port's snapshot gives the port's
    eval logits (the kernels flipped back on the way out)."""
    _, _, trainer, _ = port_run
    variables, _ = jckpt.load_snapshot(
        os.path.join(trainer.paths.checkpoints, "last.ckpt"))
    emb = np.random.default_rng(8).standard_normal(
        (2, 2, 2, DIM)).astype(np.float32)
    ref = jrd.RadDinoDecoder(2, out_size=SIZE).apply(
        variables, jnp.asarray(emb), train=False)
    dec = trainer.state.model.eval()
    with torch.no_grad():
        got = to_nhwc(dec(to_nchw(emb)))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4,
                               atol=1e-5 * max(1.0, np.abs(ref).max()))


def test_hebbax_snapshot_loads_into_port_and_back(tmp_path):
    _, v, tm = decoder_pair(seed=4)
    p1 = jckpt.save_snapshot(v, str(tmp_path / "a"), threshold=0.5)
    sd, _ = tckpt.load_state_dict(p1, **bridge.kernel_layout(tm))
    tm.load_state_dict(sd)
    p2 = tckpt.save_snapshot(sd, str(tmp_path / "b"), threshold=0.5,
                             **bridge.kernel_layout(tm))
    with open(p1, "rb") as f1, open(p2, "rb") as f2:
        assert f1.read() == f2.read()


# -- the tester ------------------------------------------------------------------

def _test_args(synth, run, seed):
    return ttest.build_parser().parse_args(
        ["--device", "cpu", "--path_dataset", synth, "--path_exp", run,
         "--best", "last", "-b", "2", "--num_workers", "1", "--seed",
         str(seed)])


def test_tester_writes_metrics(synth, port_run):
    _, _, trainer, _ = port_run
    metrics = ttest.run_test(_test_args(synth, trainer.paths.run, 3),
                             image_size=SIZE, encoder_kw=SMALL)
    assert all(np.isfinite(v) for v in metrics.values())
    assert 0.0 <= metrics["segm/dice"] <= 1.0
    assert os.path.exists(os.path.join(trainer.paths.run, "test.csv"))


def test_tester_encoder_seed_is_zero_not_the_runs(synth, port_run,
                                                  monkeypatch):
    """hebbax's trainer initialises the encoder from PRNGKey(seed)
    (train_semi_raddino_decoder_2d.py:74-77), its tester from PRNGKey(0)
    (test_raddino_decoder_2d.py:33-34): offline, a run of seed 3 is tested
    through another random encoder than it trained with.  The port keeps
    both seeds: the trainer's encoder from the run's seed, the tester's
    from 0, whatever --seed says."""
    _, args, trainer, _ = port_run
    assert args.seed == 3
    trained = trainer.encoder.state_dict()
    same = tcli.frozen_encoder(3, "cpu", image_size=SIZE, **SMALL)
    for k, v in same.state_dict().items():
        assert torch.equal(v, trained[k]), k
    seen = []
    orig = ttest.frozen_encoder

    def spy(seed, device, **kw):
        seen.append(seed)
        return orig(seed, device, **kw)
    monkeypatch.setattr(ttest, "frozen_encoder", spy)
    ttest.run_test(_test_args(synth, trainer.paths.run, 3),
                   image_size=SIZE, encoder_kw=SMALL)
    assert seen == [0]
    tested = orig(0, "cpu", image_size=SIZE, **SMALL).state_dict()
    assert not torch.equal(tested["pos_embed"], trained["pos_embed"])
    # hebbax's two keys give two encoders likewise
    j0, j3 = [jrd.ViTEncoder(**SMALL).init(
        {"params": jax.random.PRNGKey(s)},
        jnp.zeros((1, SIZE, SIZE, 3)))["params"]["pos_embed"]
        for s in (0, 3)]
    assert not np.array_equal(np.asarray(j0), np.asarray(j3))


def test_tester_argument_surface_is_test_2d():
    assert isinstance(ttest.build_parser(), argparse.ArgumentParser)
    assert ttest.TESTER_ENCODER_SEED == 0
    assert dataset_cfg("GlaS")["IN_CHANNELS"] == 3
