"""Mean, std and count of every run's test metrics (hebbax's
``tools/report_results.py``): walks a runs tree
``<dataset>/<phase>/<tag>/inv_temp-K/regime-R/run-S``, takes the first
row of each ``test.csv`` and groups the ``segm/*`` columns by (dataset,
phase, tag, inv_temp, regime), as hebbax's pandas ``groupby(...).agg(
["mean", "std", "count"])`` does: NaN skipped, std with ddof 1 (NaN for
fewer than two values), groups sorted, a row lacking a key dropped.

    python -m hebbax_torch.tools.report_results --exp_root ./runs \
        [--out summary.csv]

Reads the CSVs with :mod:`csv`; needs no pandas.
"""

import argparse
import csv
import math
import os

import numpy as np

KEYS = ("dataset", "phase", "tag", "inv_temp", "regime", "run")
GROUP_KEYS = KEYS[:-1]
STATS = ("mean", "std", "count")


def _number(text):
    try:
        return float(text)
    except (TypeError, ValueError):
        return math.nan


def collect(exp_root):
    """One dict per ``test.csv``: its first row (numbers as float) and the
    run's keys from its path."""
    rows = []
    for dirpath, _, files in os.walk(exp_root):
        if "test.csv" not in files:
            continue
        with open(os.path.join(dirpath, "test.csv"), newline="") as f:
            first = next(csv.DictReader(f), None)
        if first is None:
            continue
        row = {k: _number(v) for k, v in first.items()}
        parts = os.path.relpath(dirpath, exp_root).split(os.sep)
        for k, v in zip(KEYS, parts):
            row[k] = v.split("-", 1)[-1] if "-" in v and k in (
                "inv_temp", "regime", "run") else v
        rows.append(row)
    return rows


def _stats(values):
    v = np.asarray([x for x in values if not math.isnan(x)], np.float64)
    n = len(v)
    if n == 0:
        return math.nan, math.nan, 0
    mean = v.sum() / n
    std = (math.sqrt(((v - mean) ** 2).sum() / (n - 1)) if n > 1
           else math.nan)
    return float(mean), std, n


def summarize(rows):
    """(group keys, metrics, {group tuple: {metric: (mean, std,
    count)}}), groups in sorted order."""
    columns = list(dict.fromkeys(k for row in rows for k in row))
    metrics = [c for c in columns if c.startswith("segm/")]
    keys = [k for k in GROUP_KEYS if k in columns]
    groups = {}
    for row in rows:
        if all(k in row for k in keys):
            groups.setdefault(tuple(row[k] for k in keys), []).append(row)
    table = {g: {m: _stats([r.get(m, math.nan) for r in groups[g]])
                 for m in metrics} for g in sorted(groups)}
    return keys, metrics, table


def write_csv(path, keys, metrics, table):
    """The summary in pandas's ``to_csv`` layout of a two-level column
    index: metric and statistic header rows, then the group keys'."""
    blank = [""] * len(keys)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(blank + [m for m in metrics for _ in STATS])
        w.writerow(blank + [s for _ in metrics for s in STATS])
        w.writerow(keys + [""] * (len(metrics) * len(STATS)))
        for group, stats in table.items():
            w.writerow(list(group) + [repr(x) for m in metrics
                                      for x in stats[m]])


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--exp_root", default="./runs")
    parser.add_argument("--out", default=None, help="optional summary csv")
    args = parser.parse_args(argv)
    rows = collect(args.exp_root)
    if not rows:
        print("no test.csv found under", args.exp_root)
        return {}
    keys, metrics, table = summarize(rows)
    print("  ".join(keys + [f"{m} mean/std/count" for m in metrics]))
    for group, stats in table.items():
        print("  ".join(list(group) + [
            f"{mean:.4f}/{std:.4f}/{n}" for mean, std, n in
            (stats[m] for m in metrics)]))
    if args.out:
        write_csv(args.out, keys, metrics, table)
    return table


if __name__ == "__main__":
    main()
