"""RAD-DINO's HF key map and loader in the port against hebbax's.

An HF dinov2 state dict (``microsoft/rad-dino``'s key names and shapes at
224/14: ViT-B, 12 heads of 64, with DINOv2's ``mask_token`` and LayerScale
``lambda1`` keys, which neither map reads) is made with numpy from a
seed by ``chip_smoke.raddino_hf_dict``, the dict phase 16 maps on the
card.  The port's ``apply_hf_state_dict`` maps it onto its
``ViTEncoder`` and hebbax's onto its flax tree; the port's tensors must
equal ``bridge.from_flax`` of hebbax's tree to the bit, at depth 2 and
at the full depth 12.  Tokens at depth 2: within 1e-5 of max(1,
max|tokens|) of hebbax's mapped forward (float32 sums in another order).
Against transformers' own ``Dinov2Model`` (random init, tanh GELU, so
LayerScale is the identity): hebbax's tolerance, rtol 1e-3 / atol 2e-4.

The loader is held to hebbax's semantics with a stand-in ``transformers``
module: no test asks for the real checkpoint, so none reaches the
network.
"""

import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hebbax.models.raddino as jrd
from chip_smoke import raddino_hf_dict as hf_state_dict
from hebbax_torch import bridge
from hebbax_torch.models import raddino as trd

torch.set_num_threads(2)


def hebbax_zeros(depth):
    """hebbax's ViTEncoder tree as numpy zeros (its map overwrites every
    leaf), without running flax's init."""
    shapes = jax.eval_shape(
        lambda x: jrd.ViTEncoder(depth=depth).init(
            {"params": jax.random.PRNGKey(0)}, x)["params"],
        jax.ShapeDtypeStruct((1, 224, 224, 3), jnp.float32))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)


def port_encoder(depth, seed=0):
    return trd.ViTEncoder(depth=depth,
                          generator=torch.Generator().manual_seed(seed))


def snapshot(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


@pytest.mark.parametrize("depth", [2, 12])
def test_map_equals_hebbax_to_the_bit(depth):
    sd = hf_state_dict(depth)
    enc = port_encoder(depth)
    assert trd.apply_hf_state_dict(enc, sd) is enc
    ref = bridge.from_flax(jrd.apply_hf_state_dict(hebbax_zeros(depth), sd))
    got = enc.state_dict()
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert torch.equal(got[k], v), k
    # the reshapes the map applies, against their sources
    b = "encoder.layer.0."
    assert torch.equal(got["block0.attn.query.weight"], torch.from_numpy(
        sd[b + "attention.attention.query.weight"].reshape(12, 64, 768)))
    assert torch.equal(got["block0.attn.out.weight"], torch.from_numpy(
        sd[b + "attention.output.dense.weight"].reshape(768, 12, 64)))
    assert torch.equal(got["patch_embed.weight"], torch.from_numpy(
        sd["embeddings.patch_embeddings.projection.weight"]))
    assert not any(p.requires_grad for p in trd.apply_hf_state_dict(
        port_encoder(depth).requires_grad_(False), sd).parameters())


def test_tokens_match_hebbax_mapped_forward():
    sd = hf_state_dict(2, seed=1)
    enc = trd.apply_hf_state_dict(port_encoder(2), sd).eval()
    params = jrd.apply_hf_state_dict(hebbax_zeros(2), sd)
    x = np.random.default_rng(2).standard_normal(
        (2, 224, 224, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jrd.ViTEncoder(depth=2).apply)(
        {"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = enc(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    assert got.shape == want.shape == (2, 257, 768)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * scale, (err, scale)


def test_tokens_match_hf_dinov2():
    transformers = pytest.importorskip("transformers")
    if not hasattr(transformers, "Dinov2Model"):
        pytest.skip("transformers lacks Dinov2Model")
    cfg = transformers.Dinov2Config(image_size=224, patch_size=14,
                                    num_hidden_layers=2,
                                    hidden_act="gelu_pytorch_tanh")
    torch.manual_seed(0)
    hf = transformers.Dinov2Model(cfg).eval()
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    enc = trd.apply_hf_state_dict(port_encoder(2), sd).eval()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 3, 224, 224)).astype(np.float32))
    with torch.no_grad():
        want = hf(x).last_hidden_state.numpy()
        got = enc(x).numpy()
    assert got.shape == want.shape == (1, 257, 768)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("key,shape", [
    ("embeddings.cls_token", (1, 2, 768)),          # the first key checked
    ("layernorm.bias", (767,)),                     # the last
])
def test_shape_guard_raises_in_both_and_leaves_the_encoder(key, shape):
    sd = hf_state_dict(2)
    sd[key] = np.zeros(shape, np.float32)
    with pytest.raises(AssertionError):
        jrd.apply_hf_state_dict(hebbax_zeros(2), sd)
    enc = port_encoder(2)
    before = snapshot(enc)
    with pytest.raises(AssertionError):
        trd.apply_hf_state_dict(enc, sd)
    for k, v in enc.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_narrower_encoder_fails_where_hebbax_fails():
    """The 12x64 head split is hebbax's, hard-coded: a dim-48 encoder
    fails at the first key in both."""
    sd = hf_state_dict(2)
    small = trd.ViTEncoder(dim=48, depth=2)
    with pytest.raises(AssertionError, match="patch_embed"):
        trd.apply_hf_state_dict(small, sd)
    jsmall = jax.tree_util.tree_map(np.asarray, jrd.ViTEncoder(
        dim=48, depth=2).init({"params": jax.random.PRNGKey(0)},
                              jnp.zeros((1, 224, 224, 3)))["params"])
    with pytest.raises(AssertionError, match="patch_embed"):
        jrd.apply_hf_state_dict(jsmall, sd)


class _FakeModel:
    def __init__(self, sd):
        self.sd = sd

    def state_dict(self):
        return {k: torch.from_numpy(v) for k, v in self.sd.items()}


def fake_transformers(monkeypatch, answer, asked):
    """Install a ``transformers`` whose ``AutoModel.from_pretrained``
    records the repo asked for and returns or raises ``answer``."""
    def from_pretrained(repo):
        asked.append(repo)
        if isinstance(answer, Exception):
            raise answer
        return answer

    mod = types.ModuleType("transformers")
    mod.AutoModel = types.SimpleNamespace(from_pretrained=from_pretrained)
    monkeypatch.setitem(sys.modules, "transformers", mod)


def both_loaders(depth=2):
    """(port's result, hebbax's result, the port encoder's state before)."""
    enc = port_encoder(depth)
    before = snapshot(enc)
    params = hebbax_zeros(depth)
    return (trd.load_hf_rad_dino_params(enc),
            jrd.load_hf_rad_dino_params(params), before, params)


def test_loader_without_transformers(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)   # import fails
    (enc, ok), (params, jok), before, jparams = both_loaders()
    assert (ok, jok) == (False, False) and params is jparams
    for k, v in enc.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_loader_when_from_pretrained_raises(monkeypatch):
    asked = []
    fake_transformers(monkeypatch, OSError("offline"), asked)
    (enc, ok), (params, jok), before, jparams = both_loaders()
    assert asked == ["microsoft/rad-dino"] * 2
    assert (ok, jok) == (False, False) and params is jparams
    for k, v in enc.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_loader_maps_a_checkpoint(monkeypatch):
    sd = hf_state_dict(2, seed=3)
    asked = []
    fake_transformers(monkeypatch, _FakeModel(sd), asked)
    (enc, ok), (params, jok), _, _ = both_loaders()
    assert (ok, jok) == (True, True)
    ref = bridge.from_flax(params)
    for k, v in enc.state_dict().items():
        assert torch.equal(v, ref[k]), k
    got = trd.load_hf_rad_dino_params(port_encoder(2), repo="other/repo")
    assert got[1] and asked[-1] == "other/repo"


def test_loader_incompatible_checkpoint_keeps_random_init(monkeypatch,
                                                          capsys):
    asked = []
    fake_transformers(monkeypatch, _FakeModel(hf_state_dict(2)), asked)
    enc = trd.ViTEncoder(dim=48, depth=2)
    before = snapshot(enc)
    got, ok = trd.load_hf_rad_dino_params(enc)
    port_out = capsys.readouterr().out
    jparams = jax.tree_util.tree_map(np.asarray, jrd.ViTEncoder(
        dim=48, depth=2).init({"params": jax.random.PRNGKey(0)},
                              jnp.zeros((1, 224, 224, 3)))["params"])
    jgot, jok = jrd.load_hf_rad_dino_params(jparams)
    jax_out = capsys.readouterr().out
    assert (ok, jok) == (False, False) and got is enc and jgot is jparams
    for out in (port_out, jax_out):
        assert out.startswith("# rad-dino checkpoint incompatible with this "
                              "encoder config (")
        assert out.rstrip().endswith("; keeping random init")
    for k, v in enc.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_tester_encoder_from_seed_0_through_the_loader(monkeypatch):
    """The tester hands the loader its seed-0 encoder, whatever the run's
    seed, as hebbax's tester (PRNGKey(0))."""
    from hebbax_torch.cli import test_raddino_decoder_2d as ttest
    from hebbax_torch.cli import train_semi_raddino_decoder_2d as tcli

    seen = []

    def loader(encoder):
        seen.append(encoder)
        raise RuntimeError("stop")

    monkeypatch.setattr(ttest, "load_hf_rad_dino_params", loader)
    args = ttest.build_parser().parse_args(["--device", "cpu", "--seed", "5",
                                            "--path_exp", "unused"])
    with pytest.raises(RuntimeError, match="stop"):
        ttest.run_test(args, image_size=28, encoder_kw=dict(dim=48,
                                                             depth=2))
    ref = tcli.frozen_encoder(0, torch.device("cpu"), image_size=28,
                              dim=48, depth=2)
    for k, v in ref.state_dict().items():
        assert torch.equal(seen[0].state_dict()[k], v), k
