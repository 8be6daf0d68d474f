"""The port's device slider (``engine/sliding.py``) held against hebbax's
host ``slide_window_inference``.

* The same numpy forward in both: the port's patches go to it through
  numpy and back, so each patch's logits are the same floats and only the
  aggregation differs (the port multiplies by 1/hits as hebbax's device
  slider does, the host divides): rtol 1e-6.  Volumes smaller than the
  patch (padded), grids whose last location is clipped, and last batches
  that are padded are all covered.
* The real networks on carried weights (UNet3D, init_features=4): atol
  1e-4, as the eval-forward test.
* A patch covering the whole volume gives the whole-volume forward.
* The binary finalize is the class-1 softmax of the averaged logits above
  the threshold, on the device; the inputs keep every voxel's probability
  at least 1e-5 from the threshold, so rounding cannot flip one.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hebbax.engine.sliding import slide_window_inference as j_slide
from hebbax_torch.engine.sliding import (slide_window_inference,
                                         slide_window_inference_device)

from test_torch_3d_model import make_pair

torch.set_num_threads(2)

_COEF = np.array([[0.7, -0.3], [0.2, 0.5], [-0.1, 0.05]], np.float32)


def np_forward(patches):
    """(B, *p, 1) -> (B, *p, 2): a fixed voxelwise polynomial."""
    x = patches[..., 0]
    return np.stack([x * _COEF[0, c] + _COEF[1, c] + x * x * _COEF[2, c]
                     for c in range(2)], axis=-1).astype(np.float32)


def t_forward(patches):
    """The same map on the port's (B, 1, *p) tensors, through numpy."""
    out = np_forward(patches.numpy().transpose(0, 2, 3, 4, 1))
    return torch.from_numpy(np.ascontiguousarray(out.transpose(0, 4, 1, 2,
                                                               3)))


@pytest.mark.parametrize("shape,patch,overlap,bs", [
    ((20, 18, 17), (16, 16, 16), (8, 8, 8), 3),
    ((40, 33, 24), (16, 16, 12), (4, 6, 2), 8),
    ((10, 20, 7), (16, 16, 8), (8, 8, 4), 2)])
def test_device_slider_matches_hebbax_host_slider(shape, patch, overlap, bs):
    vol = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    ref = j_slide(np_forward, vol, patch, overlap, 2, batch_size=bs)
    got = slide_window_inference_device(t_forward, vol, patch, overlap, 2,
                                        batch_size=bs, device="cpu")
    assert tuple(got.shape) == (2,) + shape
    np.testing.assert_allclose(got.numpy().transpose(1, 2, 3, 0), ref,
                               rtol=1e-6, atol=1e-7)
    host = slide_window_inference(np_forward, vol, patch, overlap, 2,
                                  batch_size=bs)
    np.testing.assert_array_equal(host, ref)


def test_device_slider_matches_hebbax_on_the_network():
    jm, variables, tm, _ = make_pair(seed=6)
    vol = np.random.default_rng(1).standard_normal((20, 18, 17)).astype(
        np.float32)
    apply = jax.jit(lambda p: jm.apply(variables, p, train=False))
    ref = j_slide(lambda p: apply(jnp.asarray(p)), vol, (16, 16, 16),
                  (8, 8, 8), 2, batch_size=4)
    tm.eval()
    got = slide_window_inference_device(tm, vol, (16, 16, 16), (8, 8, 8), 2,
                                        batch_size=4, device="cpu")
    np.testing.assert_allclose(got.numpy().transpose(1, 2, 3, 0),
                               np.asarray(ref), rtol=0, atol=1e-4)


def test_a_patch_covering_the_volume_is_the_whole_forward():
    _, _, tm, _ = make_pair(seed=7)
    tm.eval()
    vol = np.random.default_rng(2).standard_normal((16, 16, 16)).astype(
        np.float32)
    got = slide_window_inference_device(tm, vol, (16, 16, 16), (8, 8, 8), 2,
                                        batch_size=1, device="cpu")
    with torch.no_grad():
        whole = tm(torch.from_numpy(vol)[None, None])[0]
    torch.testing.assert_close(got, whole, rtol=1e-6, atol=1e-7)


def test_binary_finalize_thresholds_the_class1_softmax():
    shape, patch, overlap = (20, 18, 17), (16, 16, 16), (8, 8, 8)
    vol = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    ref = j_slide(np_forward, vol, patch, overlap, 2, batch_size=3)
    z = ref.astype(np.float64)
    prob = 1.0 / (1.0 + np.exp(z[..., 0] - z[..., 1]))
    thr = 0.37
    assert np.abs(prob - thr).min() > 1e-5
    got = slide_window_inference_device(t_forward, vol, patch, overlap, 2,
                                        batch_size=3, device="cpu",
                                        finalize="binary", threshold=thr)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), (prob > thr).astype(np.uint8))
    arg = slide_window_inference_device(t_forward, vol, patch, overlap, 2,
                                        batch_size=3, device="cpu",
                                        finalize="argmax")
    np.testing.assert_array_equal(arg.numpy(),
                                  np.argmax(ref, -1).astype(np.uint8))
    with pytest.raises(ValueError, match="threshold"):
        slide_window_inference_device(t_forward, vol, patch, overlap, 2,
                                      device="cpu", finalize="binary")
