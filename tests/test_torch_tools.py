"""The port's tools (``hebbax_torch.tools``) against hebbax's ``tools/``
scripts, both run on the same small seeded files.

* NRRD tools (``atrial.preprocess``, ``atrial.postprocess``,
  ``mask2sdf``, ``res_image_mask``): arrays and every header field equal
  to the bit.
* ``wavelet3D``: within 1e-6 of max(1, max|out|) (the trilinear resize in
  float32, another order of sums), the headers equal.
* ``eval``: the 2D and 3D dicts within 1e-12.
* ``wavelet2D`` and ``visualize_weights``: PNG pixels equal (decoded with
  PIL here), ``visualize_weights`` on a hebbax-written and on a
  port-written snapshot.
* ``report_results``: every (group, metric) mean, std and count equal to
  hebbax's pandas summary within 1e-12, NaN where it is NaN, also through
  ``--out``'s CSV.
* The flag sets, tool by tool, and the imports: no new module imports
  jax, flax, optax, hebbax, pandas, transformers or PIL.
"""

import argparse
import csv
import importlib
import importlib.util
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from hebbax_torch.data.nrrd_io import read_nrrd, write_nrrd

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = {"eval": "eval", "mask2sdf": "mask2sdf",
         "report_results": "report_results",
         "res_image_mask": "res_image_mask",
         "visualize_weights": "visualize_weights",
         "wavelet2D": "wavelet2D", "wavelet3D": "wavelet3D",
         "atrial.preprocess": os.path.join("Atrial", "preprocess"),
         "atrial.postprocess": os.path.join("Atrial", "postprocess")}
AFFINE = np.array([[0.0, 1.25, 0.0, -3.5], [0.625, 0.0, 0.0, 7.0],
                   [0.0, 0.0, 2.5, 11.25], [0.0, 0.0, 0.0, 1.0]])


def hebbax_tool(name):
    path = os.path.join(REPO, "tools", TOOLS[name] + ".py")
    spec = importlib.util.spec_from_file_location(
        "hebbax_tool_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_tool(name):
    return importlib.import_module(f"hebbax_torch.tools.{name}")


def ball(shape, centre, r):
    grid = np.mgrid[tuple(slice(0, s) for s in shape)]
    return sum((g - c) ** 2 for g, c in zip(grid, centre)) < r * r


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Seeded inputs: volumes, masks and predictions (NRRD), raw Atrial
    cases, grey and RGB PNGs."""
    root = tmp_path_factory.mktemp("tool_inputs")
    rng = np.random.default_rng(0)
    for sub in ("image", "mask", "pred", "png_grey", "png_rgb"):
        os.makedirs(root / sub)
    for i, shape in enumerate([(20, 18, 12), (17, 22, 10)]):
        vol = rng.normal(100, 20, shape).astype(np.float32)
        mask = ball(shape, [s // 2 for s in shape], 5)
        pred = mask.copy()
        pred[shape[0] // 2, shape[1] // 2, :] = False       # a hole
        pred[1:3, 1:3, 1:3] = True                          # a stray blob
        write_nrrd(root / "image" / f"v{i}.nrrd", vol, affine=AFFINE)
        write_nrrd(root / "mask" / f"v{i}.nrrd",
                   mask.astype(np.uint8) * 255, affine=AFFINE)
        write_nrrd(root / "pred" / f"v{i}.nrrd", pred.astype(np.uint8),
                   affine=AFFINE)
        img = rng.integers(0, 256, (30 + i, 26, 3), dtype=np.uint8)
        Image.fromarray(img).save(root / "png_rgb" / f"{i}.png")
        Image.fromarray(img[..., 0]).save(root / "png_grey" / f"{i}.png")
        Image.fromarray((ball(img.shape[:2], (15, 13), 7 + i) * 255
                         ).astype(np.uint8)).save(root / f"m{i}.png")
    for case, centre in (("case_a", (60, 50, 4)), ("case_b", (20, 70, 3))):
        d = root / "raw" / case
        os.makedirs(d)
        shape = (130, 124, 8)
        write_nrrd(d / "lgemri.nrrd",
                   rng.normal(80, 10, shape).astype(np.float32),
                   affine=AFFINE)
        write_nrrd(d / "laendo.nrrd",
                   ball(shape, centre, 9).astype(np.uint8) * 255,
                   affine=AFFINE)
    (root / "raw" / "notes.txt").write_text("not a case")
    return root


def nrrd_outputs(d):
    return {name: read_nrrd(os.path.join(d, name))
            for name in sorted(os.listdir(d))}


def assert_headers_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if k == "affine":
            assert np.array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


def assert_nrrd_dirs_equal(got_dir, want_dir, atol_of_scale=None):
    got, want = nrrd_outputs(got_dir), nrrd_outputs(want_dir)
    assert sorted(got) == sorted(want) and got
    for name, (arr, hdr) in want.items():
        g, ghdr = got[name]
        assert g.dtype == arr.dtype and g.shape == arr.shape, name
        if atol_of_scale is None:
            assert np.array_equal(g, arr), name
        else:
            scale = max(1.0, float(np.abs(arr).max()))
            assert float(np.abs(g - arr).max()) <= atol_of_scale * scale
        assert_headers_equal(ghdr, hdr)


def run_both(name, argv_of):
    """Run hebbax's and the port's tool: ``argv_of(side)`` gives each its
    argv; returns both results."""
    return (port_tool(name).main(argv_of("port")),
            hebbax_tool(name).main(argv_of("hebbax")))


def test_atrial_preprocess(files, tmp_path):
    run_both("atrial.preprocess", lambda s: [
        "--data_path", str(files / "raw"), "--seed", "3",
        "--save_image_path", str(tmp_path / s / "image"),
        "--save_mask_path", str(tmp_path / s / "mask")])
    for sub in ("image", "mask"):
        assert_nrrd_dirs_equal(tmp_path / "port" / sub,
                               tmp_path / "hebbax" / sub)


def test_atrial_postprocess(files, tmp_path):
    run_both("atrial.postprocess", lambda s: [
        "--pred_path", str(files / "pred"), "--save_path",
        str(tmp_path / s), "--fill_hole_thr", "20"])
    assert_nrrd_dirs_equal(tmp_path / "port", tmp_path / "hebbax")
    out, _ = read_nrrd(tmp_path / "port" / "v0.nrrd")
    assert out[1, 1, 1] == 0          # the stray blob went


@pytest.mark.parametrize("out_path", [False, True])
def test_mask2sdf(files, tmp_path, out_path):
    masks = {}
    for side in ("port", "hebbax"):
        d = tmp_path / side / "mask"
        os.makedirs(d)
        for name in os.listdir(files / "mask"):
            arr, hdr = read_nrrd(files / "mask" / name)
            write_nrrd(d / name, arr, affine=hdr["affine"])
        masks[side] = d
    run_both("mask2sdf", lambda s: ["--mask_path", str(masks[s])] + (
        ["--out_path", str(tmp_path / s / "out")] if out_path else []))
    sub = "out" if out_path else "mask_sdf1"
    assert_nrrd_dirs_equal(tmp_path / "port" / sub, tmp_path / "hebbax" / sub)


def test_res_image_mask(files, tmp_path):
    run_both("res_image_mask", lambda s: [
        "--image_path", str(files / "image"), "--out_path",
        str(tmp_path / s)])
    assert_nrrd_dirs_equal(tmp_path / "port", tmp_path / "hebbax")


@pytest.mark.parametrize("wavelet", ["haar", "db2"])
def test_wavelet3d(files, tmp_path, wavelet):
    run_both("wavelet3D", lambda s: [
        "--image_path", str(files / "image"), "--wavelet_type", wavelet,
        "--L_path", str(tmp_path / s / "L"), "--H_path",
        str(tmp_path / s / "H")])
    for band in ("L", "H"):
        assert_nrrd_dirs_equal(tmp_path / "port" / band,
                               tmp_path / "hebbax" / band,
                               atol_of_scale=1e-6)


def _assert_close_dicts(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12,
                                   err_msg=k)


def test_eval_3d(files):
    _assert_close_dicts(*run_both("eval", lambda s: [
        "--pred_path", str(files / "pred"), "--mask_path",
        str(files / "mask"), "--if_3D", "True"]))


def test_eval_2d(files, tmp_path):
    preds, masks = tmp_path / "pred", tmp_path / "mask"
    os.makedirs(preds)
    os.makedirs(masks)
    for i in range(2):
        m = np.array(Image.open(files / f"m{i}.png"))
        Image.fromarray(m).save(masks / f"{i}.png")
        Image.fromarray(np.roll(m, 2, axis=1) // 255).save(
            preds / f"{i}.png")
    _assert_close_dicts(*run_both("eval", lambda s: [
        "--pred_path", str(preds), "--mask_path", str(masks)]))


def assert_png_dirs_equal(got_dir, want_dir):
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names and names
    for name in names:
        g, w = Image.open(got_dir / name), Image.open(want_dir / name)
        assert g.mode == w.mode, name
        assert np.array_equal(np.array(g), np.array(w)), name


@pytest.mark.parametrize("src,wavelet,rgb", [
    ("png_grey", "db2", None), ("png_rgb", "haar", "1"),
    ("png_rgb", "db2", None)])
def test_wavelet2d(files, tmp_path, src, wavelet, rgb):
    run_both("wavelet2D", lambda s: [
        "--image_path", str(files / src), "--wavelet_type", wavelet,
        "--L_path", str(tmp_path / s / "L"), "--H_path",
        str(tmp_path / s / "H")] + (["--if_RGB", rgb] if rgb else []))
    for band in ("L", "H"):
        assert_png_dirs_equal(tmp_path / "port" / band,
                              tmp_path / "hebbax" / band)


def _hebbax_snapshot(path):
    """A hebbax-written snapshot whose first kernels are 1x1, RGB 3x3 and
    16-channel 3x3."""
    from hebbax.utils.checkpoint import save_snapshot
    rng = np.random.default_rng(4)

    def k(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    params = {"a_proj": {"kernel": k(1, 1, 3, 4), "bias": k(4)},
              "b_conv": {"kernel": k(3, 3, 3, 7), "bias": k(7)},
              "c_conv": {"kernel": k(3, 3, 16, 5)}}
    save_snapshot({"params": params}, str(path), threshold=0.5)
    return str(path / "last.ckpt")


def _port_snapshot(path):
    from hebbax_torch.bridge import kernel_layout
    from hebbax_torch.models import get_network
    from hebbax_torch.utils.checkpoint import save_snapshot
    torch.manual_seed(0)
    model = get_network("unet", 3, 2, device="cpu")
    save_snapshot(model.state_dict(), str(path), **kernel_layout(model))
    return str(path / "last.ckpt")


@pytest.mark.parametrize("writer,layer,scale", [
    ("hebbax", None, "16"), ("hebbax", "c_conv", "3"),
    ("port", None, "16"), ("port", "main_decoder.up1", "2")])
def test_visualize_weights(tmp_path, writer, layer, scale):
    snap = (_hebbax_snapshot if writer == "hebbax" else _port_snapshot)(
        tmp_path)
    for side in ("port", "hebbax"):
        os.makedirs(tmp_path / side)
    run_both("visualize_weights", lambda s: [
        "--snapshot", snap, "--scale", scale, "--out",
        str(tmp_path / s / "filters.png")] + (
        ["--layer", layer] if layer else []))
    assert_png_dirs_equal(tmp_path / "port", tmp_path / "hebbax")


def test_visualize_weights_unknown_layer(tmp_path):
    snap = _hebbax_snapshot(tmp_path)
    for name in ("port", "hebbax"):
        tool = port_tool if name == "port" else hebbax_tool
        with pytest.raises(KeyError, match="nope"):
            tool("visualize_weights").main(["--snapshot", snap, "--layer",
                                            "nope", "--out",
                                            str(tmp_path / "x.png")])


def _write_test_csv(d, row):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "test.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(row))
        w.writeheader()
        w.writerow(row)
        w.writerow({k: 0 for k in row})      # only the first row counts


def _runs_tree(root):
    rng = np.random.default_rng(5)

    def metrics(**over):
        row = {"segm/dice": rng.random(), "segm/jaccard": rng.random(),
               "segm/asd": rng.random() * 10, "segm/95hd": rng.random() * 40,
               "thresh": 0.5}
        row.update(over)
        return row

    base = os.path.join(root, "GlaS", "semi_sup", "h_em_unet_s2d_swta_t")
    for k in ("1", "10", "5"):
        for r in range(3):
            _write_test_csv(os.path.join(base, f"inv_temp-{k}", "regime-5",
                                         f"run-{r}"), metrics())
    _write_test_csv(os.path.join(base, "inv_temp-1", "regime-20", "run-0"),
                    metrics())                                # one run
    _write_test_csv(os.path.join(base, "inv_temp-1", "regime-10", "run-0"),
                    metrics(**{"segm/95hd": "nan"}))
    _write_test_csv(os.path.join(base, "inv_temp-1", "regime-10", "run-1"),
                    metrics(**{"segm/95hd": ""}))            # all NaN
    _write_test_csv(os.path.join(root, "PH2", "fully_sup", "unet",
                                 "inv_temp-1", "regime-100", "run-0"),
                    {"segm/dice": 0.5, "segm/jaccard": 0.25})   # fewer cols
    _write_test_csv(os.path.join(root, "PH2", "fully_sup", "unet",
                                 "inv_temp-1", "regime-100", "run-1"),
                    metrics(**{"segm/extra": 2.0}))
    _write_test_csv(os.path.join(root, "PH2", "shallow"), metrics())


def test_report_results(tmp_path):
    import pandas as pd
    _runs_tree(tmp_path / "runs")
    got, want = run_both("report_results", lambda s: [
        "--exp_root", str(tmp_path / "runs"), "--out",
        str(tmp_path / f"{s}.csv")])
    assert list(got) == list(want.index)
    metrics = list(dict.fromkeys(m for m, _ in want.columns))
    for group, stats in got.items():
        assert list(stats) == metrics
        for m in metrics:
            for value, stat in zip(stats[m], ("mean", "std", "count")):
                ref = float(want.loc[group, (m, stat)])
                if math.isnan(ref):
                    assert math.isnan(value), (group, m, stat)
                else:
                    assert abs(value - ref) <= 1e-12, (group, m, stat)
    assert any(math.isnan(s["segm/dice"][1]) for s in got.values())
    tables = [pd.read_csv(tmp_path / f"{s}.csv", header=[0, 1],
                          index_col=list(range(5)))
              for s in ("port", "hebbax")]
    assert tables[0].index.equals(tables[1].index)
    assert list(tables[0].columns) == list(tables[1].columns)
    np.testing.assert_allclose(tables[0].to_numpy(float),
                               tables[1].to_numpy(float), rtol=0,
                               atol=1e-12)


def test_report_results_empty(tmp_path, capsys):
    assert port_tool("report_results").main(
        ["--exp_root", str(tmp_path)]) == {}
    assert "no test.csv found" in capsys.readouterr().out


class _Parsed(Exception):
    pass


def flag_set(main):
    """{dest: (option strings, default, type, required, nargs)} of the
    parser a tool's ``main`` builds."""
    seen = {}

    def capture(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Parsed

    mp = pytest.MonkeyPatch()
    mp.setattr(argparse.ArgumentParser, "parse_args", capture)
    try:
        with pytest.raises(_Parsed):
            main([])
    finally:
        mp.undo()
    return {a.dest: (tuple(a.option_strings), a.default, a.type,
                     a.required, a.nargs)
            for a in seen["parser"]._actions}


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_flag_sets_equal(name):
    assert flag_set(port_tool(name).main) == flag_set(
        hebbax_tool(name).main)


def test_new_modules_import_without_the_reference_stack():
    code = (
        "import importlib, sys\n"
        "REFUSED = ('jax', 'jaxlib', 'flax', 'optax', 'hebbax', 'pandas',\n"
        "           'transformers', 'PIL')\n"
        "class Refuse:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in REFUSED:\n"
        "            raise ImportError('refused: ' + name)\n"
        "sys.meta_path.insert(0, Refuse())\n"
        "for m in ('entry', 'sweep', 'models.raddino', 'utils.images',\n"
        f"          *{[f'tools.{t}' for t in sorted(TOOLS)]!r}):\n"
        "    importlib.import_module('hebbax_torch.' + m)\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in REFUSED))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip() == "[]"
