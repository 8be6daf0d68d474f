"""Epoch harness for single-model training (``hebbax/engine/loop.py``
``SupTrainer``): per-epoch training with streaming metric accumulation,
display-interval console/TensorBoard/CSV reporting, validation-interval
evaluation with best-val-Jaccard snapshotting, and final last.ckpt +
train_log.csv/val_log.csv artifacts (kernel layouts in the snapshot
follow the model's module types).  Every scalar ``loss*`` entry a step
returns besides ``loss`` is averaged over the epoch and logged as its own
``train_log.csv`` column and ``train/<name>`` scalar.  Data parallelism is
not ported yet.
"""

import time

import numpy as np
import torch

from ..hebb.layers import transposed_paths
from ..ops.metrics import make_accumulator
from ..utils import images as image_utils
from ..utils.checkpoint import save_snapshot
from ..utils.logging import BoxPrinter, MetricsLog, make_tb_writer


def to_device_batch(batch, device):
    """Host batch (NHWC float32 images, int masks) -> device tensors
    (NCHW float32 images, int64 masks); other entries pass through."""
    out = dict(batch)
    out["image"] = torch.from_numpy(np.ascontiguousarray(
        batch["image"])).permute(0, 3, 1, 2).contiguous().to(device)
    if "mask" in batch:
        out["mask"] = torch.from_numpy(np.asarray(batch["mask"])).to(
            device=device, dtype=torch.int64)
    return out


def to_device_batch_3d(batch, device):
    """Host patch batch ((B, X, Y, Z) images, int masks) -> device tensors
    ((B, 1, X, Y, Z) float32 images, int64 masks); the patch ids and
    locations stay on the host."""
    out = {"image": torch.from_numpy(np.ascontiguousarray(
        batch["image"], dtype=np.float32))[:, None].to(device)}
    if "mask" in batch:
        out["mask"] = torch.from_numpy(np.asarray(batch["mask"])).to(
            device=device, dtype=torch.int64)
    return out


class SupTrainer:
    """Single-model trainer.

    train_step : (state, batch) -> (state, {'loss', 'logits'})
    eval_step : batch -> {'logits', 'loss'}
    train_key : the loader an epoch runs over (the semi trainers run over
        'train_sup' and draw from 'train_unsup' beside it)
    """

    train_key = "train"

    def __init__(self, *, state, train_step, eval_step, loaders,
                 num_classes, paths, args, device, hebb_meta=None,
                 palette=None, printer=None):
        self.state = state
        self.train_step = train_step
        self.eval_step = eval_step
        self.loaders = loaders
        self.num_classes = num_classes
        self.paths = paths
        self.args = args
        self.device = device
        self.hebb_meta = hebb_meta or {}
        self.palette = palette
        self.printer = printer or BoxPrinter(num_classes)
        self.writer = make_tb_writer(paths.tensorboard)
        self.train_log = MetricsLog(paths.run, "train_log.csv")
        self.val_log = MetricsLog(paths.run, "val_log.csv")
        self.best_val = [0.0, 0.0, 0.0]
        self._epoch_losses = None
        self._aux_losses = {}

    def prep(self, batch):
        out = to_device_batch(batch, self.device)
        out.pop("id", None)
        return out

    def _save_best(self, threshold, epoch):
        save_snapshot(self.state.state_dict(), self.paths.checkpoints,
                      threshold=threshold, save_best=True,
                      transposed=transposed_paths(self.state.model),
                      **self.hebb_meta)

    def _save_last(self, threshold):
        save_snapshot(self.state.state_dict(), self.paths.checkpoints,
                      threshold=threshold, save_best=False,
                      transposed=transposed_paths(self.state.model),
                      **self.hebb_meta)

    def train_epoch(self, epoch, collect_metrics):
        acc = make_accumulator(self.num_classes) if collect_metrics else None
        # the losses accumulate on the device; one read at epoch end
        total_loss, n_batches = 0.0, 0
        aux_totals = {}
        for batch in self.loaders[self.train_key]:
            batch = self.prep(batch)
            self.state, out = self.train_step(self.state, batch)
            total_loss = total_loss + out["loss"]
            # the pretrainers' scalar loss_unsup / loss_superdiff
            for k, v in out.items():
                if k != "loss" and k.startswith("loss") and v.dim() == 0:
                    aux_totals[k] = aux_totals.get(k, 0.0) + v
            n_batches += 1
            if acc is not None:
                acc.update(out["logits"], batch["mask"])
        n = max(n_batches, 1)
        self._aux_losses = {k: float(v) / n for k, v in aux_totals.items()}
        return float(total_loss) / n, acc

    def validate(self, epoch):
        acc = make_accumulator(self.num_classes)
        total_loss, n_batches = 0.0, 0
        preds, names = [], []
        for batch in self.loaders["val"]:
            ids = batch.get("id")
            batch = self.prep(batch)
            out = self.eval_step(batch)
            if "loss" in out:
                total_loss = total_loss + out["loss"]
            n_batches += 1
            acc.update(out["logits"], batch["mask"])
            if self.args.debug and self.palette is not None:
                probs = torch.softmax(out["logits"], dim=1)[:, 1]
                preds.append(probs.cpu().numpy())
                names.extend(ids or [])
        thr, ji, dc = acc.finalize()
        val_loss = float(total_loss) / max(n_batches, 1)
        return val_loss, (thr, ji, dc), preds, names

    def run(self):
        args = self.args
        since = time.time()
        for epoch in range(args.num_epochs):
            display = (epoch + 1) % args.display_iter == 0
            validate = ((epoch + 1) % args.validate_iter == 0
                        or epoch + 1 == args.num_epochs)
            epoch_t0 = time.time()
            train_loss, acc = self.train_epoch(epoch, display)
            epoch_seconds = time.time() - epoch_t0

            if display:
                p = self.printer
                p.epoch_header(epoch, args.num_epochs)
                p.epoch_loss(train_loss, train=True)
                ev = acc.finalize()
                p.eval_list(self.num_classes, ev, train=True)
                losses = self._epoch_losses
                if losses:  # semi trainers: sup/unsup/total sinks
                    self.writer.add_scalar("train/segm_loss",
                                           losses["loss_sup"], epoch + 1)
                    self.writer.add_scalar("train/unsup_loss",
                                           losses["loss_unsup"], epoch + 1)
                    self.writer.add_scalar("train/total_loss",
                                           losses["loss"], epoch + 1)
                else:
                    self.writer.add_scalar("train/segm_loss", train_loss,
                                           epoch + 1)
                self.writer.add_scalar("train/JI", ev[1], epoch + 1)
                self.writer.add_scalar("train/DC", ev[2], epoch + 1)
                for k, v in self._aux_losses.items():
                    self.writer.add_scalar(f"train/{k}", v, epoch + 1)
                self.train_log.append(epoch=epoch + 1, loss=train_loss,
                                      thresh=ev[0], JI=ev[1], DC=ev[2],
                                      seconds=round(epoch_seconds, 3),
                                      **self._aux_losses)

            if validate:
                val_loss, ev, preds, names = self.validate(epoch)
                p = self.printer
                p.epoch_loss(val_loss, train=False)
                p.eval_list(self.num_classes, ev, train=False)
                self.writer.add_scalar("val/segm_loss", val_loss, epoch + 1)
                self.writer.add_scalar("val/JI", ev[1], epoch + 1)
                self.writer.add_scalar("val/DC", ev[2], epoch + 1)
                self.val_log.append(epoch=epoch + 1, loss=val_loss,
                                    thresh=ev[0] if ev[0] else 0.0,
                                    JI=ev[1], DC=ev[2])
                if ev[1] > self.best_val[1]:
                    self.best_val = list(ev)
                    self._save_best(ev[0], epoch)
                    if args.debug and preds and self.palette is not None:
                        image_utils.save_preds(
                            np.concatenate(preds), ev[0], names,
                            self.paths.val_seg_preds, self.palette)

        self._save_last(self.best_val[0])
        self.train_log.flush()
        self.val_log.flush()
        self.printer.rule("=")
        self.printer.best_val(self.num_classes, self.best_val)
        elapsed = time.time() - since
        self.printer.line(
            f"Training done in {elapsed // 60:.0f}m {elapsed % 60:.0f}s")
        self.printer.rule("=")
        self.writer.close()
        return self.best_val
