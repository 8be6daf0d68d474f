"""hebbax's ``HEBBAX_DELTA_DTYPE`` in the port: the dtype the composed
Hebbian rules compute a delta in, read where hebbax reads it (the
Hebbian conv's forward), float32 unless set.

Each case is one Hebbian conv of each package, on the same weights and
input, with the variable set for both (``monkeypatch``): hebbax's delta
(its composed rule in bfloat16 on bf16 copies of w, x and y) against the
port's (the same rule, in bfloat16 on bf16 copies).  Tolerance 1e-2 of
max|delta|, hebbax's own statement of the bf16 delta error
(``hebbax/hebb/rules.py:41-43``): both round the same operands to bf16,
but each sums in its own order and rounds its partial results apart.  A
site of the CUDA kernel K1 (2D, stride 1, same size) stays float32: on
the CPU its plain version, on float32 copies of the bf16-rounded
operands, equal to the bit, and no farther from the float32 delta than
hebbax's bf16 delta.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hebbax.hebb.layers import HConv as JHConv
from hebbax.hebb.spec import HebbSpec as JSpec
from hebbax_torch.hebb import rules
from hebbax_torch.hebb.layers import HConv
from hebbax_torch.hebb.spec import HebbSpec

torch.set_num_threads(2)

# (mode, input NHWC / NDHWC shape, in, out, kernel)
CASES = {"hpca_2d": ("hpca", (2, 20, 20), 6, 16, 3),
         "swta_3d": ("swta", (2, 10, 10, 10), 4, 8, 3),
         "swta_2d_k1": ("swta", (2, 16, 16), 8, 16, 3)}


def _deltas(case, seed=0):
    """(hebbax's delta, the port's, the port's conv and its input) of one
    training forward, both as torch (O, I, *k) float32."""
    mode, shape, i, o, k = CASES[case]
    nd = len(shape) - 1
    kw = dict(mode=mode, k=20.0, w_nrm=True, alpha=1.0)
    jm = JHConv(o, (k,) * nd, padding=1, hebb=JSpec(**kw))
    x = np.random.default_rng(seed).standard_normal(
        shape + (i,)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    _, mut = jm.apply({"params": params}, jnp.asarray(x), train=True,
                      mutable=["hebb"])
    perm = (nd + 1, nd) + tuple(range(nd))
    ref = torch.from_numpy(np.ascontiguousarray(np.transpose(
        np.asarray(mut["hebb"]["delta"]), perm)))
    conv = HConv(i, o, (k,) * nd, padding=1)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(
            np.transpose(np.asarray(params["kernel"]), perm))))
    conv.spec = HebbSpec(**kw)
    conv.train()
    xt = torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(x, -1, 1)))
    with torch.no_grad():
        conv(xt)
    return ref, conv.delta, conv, xt


@pytest.mark.parametrize("case", ["hpca_2d", "swta_3d"])
def test_bf16_composed_delta_matches_hebbax(case, monkeypatch):
    f32_ref, f32_got, _, _ = _deltas(case)
    monkeypatch.setenv("HEBBAX_DELTA_DTYPE", "bfloat16")
    assert rules.delta_compute_dtype() == torch.bfloat16
    ref, got, _, _ = _deltas(case)
    assert got.dtype == torch.float32
    scale = float(ref.abs().max())
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-2 * scale)
    # the setting took effect in both packages: bf16 moved each delta
    assert float((got - f32_got).abs().max()) > 1e-4 * scale
    assert float((ref - f32_ref).abs().max()) > 1e-4 * scale
    torch.testing.assert_close(f32_got, f32_ref, rtol=0,
                               atol=1e-4 * float(f32_ref.abs().max()))


def test_kernel_site_stays_float32_on_rounded_copies(monkeypatch):
    """At a K1 site the port's only bf16 error is its operands' rounding,
    so it lies no farther from the float32 delta than hebbax's bf16 delta
    (measured: 0.66e-2 against hebbax's 1.34e-2 of max|delta|)."""
    f32_ref, _, _, _ = _deltas("swta_2d_k1")
    monkeypatch.setenv("HEBBAX_DELTA_DTYPE", "bfloat16")
    ref, got, conv, x = _deltas("swta_2d_k1")
    with torch.no_grad():
        y = conv(x)
    conv.delta = None
    bf = [t.detach().to(torch.bfloat16).float()
          for t in (conv.weight, x, y)]
    plain = rules.swta_conv_delta(*bf, 20.0, (1, 1))
    assert torch.equal(got, plain)
    assert (float((got - f32_ref).abs().max())
            <= float((ref - f32_ref).abs().max()))


def test_default_and_unknown_dtypes(monkeypatch):
    monkeypatch.delenv("HEBBAX_DELTA_DTYPE", raising=False)
    assert rules.delta_compute_dtype() == torch.float32
    monkeypatch.setenv("HEBBAX_DELTA_DTYPE", "float16")
    assert rules.delta_compute_dtype() == torch.float16
    monkeypatch.setenv("HEBBAX_DELTA_DTYPE", "int8")
    with pytest.raises(ValueError, match="HEBBAX_DELTA_DTYPE"):
        rules.delta_compute_dtype()
