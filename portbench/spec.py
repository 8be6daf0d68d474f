"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root,
``configs/<config>.json``, ``traffic/<traffic>.json``,
``limits/<workload>.json``, a reader ``metrics/<metric>.py`` per
per-layer metric and a plain network ``reference/arch_<arch>.py`` per
configuration's ``arch`` (:mod:`portbench.reference.nets`).  A cell
brings its files; nothing here names one."""

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic
    mix, limits and metrics."""

    def __init__(self, root, workload, here=HERE):
        self.root = root
        self.bench = load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                           f"one of {sorted(cells)}")
        self.workload = cells[workload]
        self.name = workload
        configs = {c["name"]: c for c in self.bench["configs"]}
        entry = configs[self.workload["config"]]
        self.config = load_json(os.path.join(root, entry["file"]))
        self.traffic = load_json(os.path.join(
            here, "traffic", self.workload["traffic"] + ".json"))
        self.limits = load_json(os.path.join(here, "limits",
                                             workload + ".json"))
        self.here = here

    def metrics(self, group):
        """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
        return [m for m in self.bench[group]
                if self.name in m.get("workloads", [self.name])]

    def reader(self, name):
        """The module of ``metrics/<name>.py``."""
        path = os.path.join(self.here, "metrics", name + ".py")
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
