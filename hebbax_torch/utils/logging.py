"""Observability sinks (``hebbax/utils/logging.py``): the fixed-width
console box, CSV metric logs written with :mod:`csv`, and a TensorBoard
writer that is a no-op where tensorboard is not installed."""

import csv
import os


class BoxPrinter:
    """The reference's fixed-width console report."""

    def __init__(self, num_classes):
        self.print_num = 42 + (num_classes - 3) * 7
        self.print_num_minus = self.print_num - 2
        self.print_num_half = int(self.print_num / 2 - 1)

    def rule(self, ch="-"):
        print(ch * self.print_num)

    def line(self, text):
        print(f"| {text}".ljust(self.print_num_minus, " "), "|")

    def epoch_header(self, epoch, num_epochs):
        self.rule("=")
        self.line(f"Epoch {epoch + 1}/{num_epochs}")

    def epoch_loss(self, loss, train=True):
        self.rule()
        self.line(f"{'Train' if train else 'Val'} Loss: {loss:.4f}")
        self.rule()

    def eval_list(self, num_classes, eval_list, train=True):
        text = "Train" if train else "Val"
        if num_classes == 2:
            self.line(f"{text} Thr: {eval_list[0]:.4f}")
        self.line(f"{text}  Jc: {eval_list[1]:.4f}")
        self.line(f"{text}  Dc: {eval_list[2]:.4f}")

    def best_val(self, num_classes, best):
        if num_classes == 2:
            self.line(f"Best Val Thr: {best[0]:.4f}")
        self.line(f"Best Val  Jc: {best[1]:.4f}")
        self.line(f"Best Val  Dc: {best[2]:.4f}")


def write_csv(path, rows):
    """Write dict rows with the union of their keys as the header, in
    first-seen order (the layout ``pandas.DataFrame(rows).to_csv`` gives);
    a missing value is an empty field."""
    fields = []
    for row in rows:
        for k in row:
            if k not in fields:
                fields.append(k)
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fields, restval="")
        writer.writeheader()
        writer.writerows(
            {k: ("" if v is None else v) for k, v in row.items()}
            for row in rows)


class MetricsLog:
    """Row-append metric log flushed to CSV (train_log.csv / val_log.csv)."""

    def __init__(self, path, filename):
        self.path = os.path.join(path, filename)
        self.rows = []

    def append(self, **row):
        self.rows.append(row)

    def flush(self):
        write_csv(self.path, self.rows)


class SilentPrinter(BoxPrinter):
    """A :class:`BoxPrinter` that prints nothing (the data-parallel ranks
    other than rank 0)."""

    def rule(self, ch="-"):
        pass

    def line(self, text):
        pass


class NullWriter:
    def add_scalar(self, *a, **k):
        pass

    def close(self):
        pass


def make_tb_writer(logdir):
    """TensorBoard writer if the tensorboard package is present, else a
    no-op stub."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return NullWriter()
    return SummaryWriter(log_dir=logdir)
