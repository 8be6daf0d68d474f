"""Stand-in cells that live only in the tests: the configuration of the
benchmark's cells at a size a CPU test can hold (the 3D UNet at 32
features, unfolded, on 32^3 patches of 40x36x34 volumes) under the EM
mix and the Hebbian pretraining mix, in a copy of ``portbench/`` beside a
``BENCHMARK.json`` that names only them."""

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
PORTBENCH = os.path.dirname(HERE)
REPO = os.path.dirname(PORTBENCH)
CELL = "tiny3d.tiny_em"
HEBB_CELL = "tiny3d.tiny_hebb"
# float32 rounding at this size reads up to 1.1e-3 (state) and 3.6e-3
# (change), the reference against itself in float64 as much as the port
# against the reference; each planted fault reads over ten times a
# limit (bf16's logits 0.019, half_batch's change 0.116, altered's state
# 0.1, unchanged's 1)
LIMITS = {"loss": 1e-4, "logits": 1e-4, "state": 5e-3, "change": 1e-2}
# the Hebbian stand-in reads up to 6e-8 (loss), 1.3e-6 (logits), 4.0e-6
# (state) and 5.1e-6 (change); each planted fault reads over ten times a
# limit (bf16's logits 0.016, altered's state 0.1, drop_site's change 1,
# half_k's state 0.021, unchanged's 1)
HEBB_LIMITS = {"loss": 1e-4, "logits": 1e-4, "state": 1e-3, "change": 1e-3}


def _load(rel):
    with open(os.path.join(PORTBENCH, rel)) as f:
        return json.load(f)


def _dump(obj, path):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make_root(tmp):
    """A checkout root under ``tmp`` with a copy of ``portbench/`` and a
    ``BENCHMARK.json`` of the stand-in cell; returns its path."""
    root = os.path.join(str(tmp), "root")
    pb = os.path.join(root, "portbench")
    shutil.copytree(PORTBENCH, pb, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    c3 = _load("configs/unet3d_atrial.json")
    c3.update(name="tiny3d", network="unet3d_min", init_features=32,
              patch_size=[32, 32, 32],
              data={"kind": "volume3d", "train_volumes": 10,
                    "volume_shape": [40, 36, 34]})
    t3 = _load("traffic/em_semi.json")
    t3["flags"].update(regime=20, queue_length=8,
                       samples_per_volume_train=2)
    th = _load("traffic/hebb_pretrain.json")
    th["flags"].update(queue_length=8, samples_per_volume_train=2)
    _dump(c3, os.path.join(pb, "configs", "tiny3d.json"))
    _dump(t3, os.path.join(pb, "traffic", "tiny_em.json"))
    _dump(th, os.path.join(pb, "traffic", "tiny_hebb.json"))
    _dump({"limits": LIMITS}, os.path.join(pb, "limits", CELL + ".json"))
    _dump({"limits": HEBB_LIMITS},
          os.path.join(pb, "limits", HEBB_CELL + ".json"))
    bench = _load("../BENCHMARK.json")
    bench["configs"] = [dict(name="tiny3d",
                             source="https://example.org/stand-in",
                             file="portbench/configs/tiny3d.json",
                             reduced=[], why="test")]
    bench["workloads"] = [dict(name=CELL, config="tiny3d",
                               traffic="tiny_em", chips=1, why="test"),
                          dict(name=HEBB_CELL, config="tiny3d",
                               traffic="tiny_hebb", chips=1, why="test")]
    _dump(bench, os.path.join(root, "BENCHMARK.json"))
    return root


def env():
    """The environment of a run in a stand-in root: the repository on the
    path for ``hebbax_torch``."""
    e = dict(os.environ)
    e["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, e.get("PYTHONPATH")) if p)
    return e
