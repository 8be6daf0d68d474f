"""Epoch harness for single-model training (``hebbax/engine/loop.py``
``SupTrainer``): per-epoch training with streaming metric accumulation,
display-interval console/TensorBoard/CSV reporting, validation-interval
evaluation with best-val-Jaccard snapshotting, and final last.ckpt +
train_log.csv/val_log.csv artifacts (kernel layouts in the snapshot
follow the model's module types).  Every scalar ``loss*`` entry a step
returns besides ``loss`` is averaged over the epoch and logged as its own
``train_log.csv`` column and ``train/<name>`` scalar.  ``--resume`` and
``--profile_dir`` are hebbax's (:meth:`SupTrainer.run`).

A batch goes through :meth:`SupTrainer.prep`: the trainer's ``host_prep``
(numpy, on the whole host batch), then under data parallelism
(:mod:`hebbax_torch.parallel`) the padding to a multiple of the ranks, the
0/1 ``weight`` vector and the rank's rows, then ``to_device``.  Train and
validation metrics are those of the global ``logits[:n_valid]``: each rank
counts its valid rows and the counters are summed at ``finalize``.  Only
rank 0 prints and writes logs, TensorBoard, snapshots and ``resume.ckpt``;
``--resume`` restores every rank.
"""

import functools
import os
import time

import numpy as np
import torch

from ..bridge import kernel_layout
from ..ops.metrics import make_accumulator
from ..parallel import active, gather_rows, is_main, shard_global_batch
from ..utils import images as image_utils
from ..utils import trace
from ..utils.checkpoint import (load_train_state, save_snapshot,
                                save_train_state)
from ..utils.logging import (BoxPrinter, MetricsLog, NullWriter,
                             SilentPrinter, make_tb_writer)


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
    """Host patch batch ((B, X, Y, Z) images, int masks, float SDF maps) ->
    device tensors ((B, 1, X, Y, Z) float32 images, int64 masks, (B, X, Y,
    Z) float32 ``mask_sdf`` / ``mask_sdf2``); the patch ids and locations
    stay on the host."""
    out = {"image": torch.from_numpy(np.ascontiguousarray(
        batch["image"], dtype=np.float32))[:, None].to(device)}
    if "mask" in batch:
        out["mask"] = torch.from_numpy(np.asarray(batch["mask"])).to(
            device=device, dtype=torch.int64)
    for k in ("mask_sdf", "mask_sdf2"):
        if k in batch:
            out[k] = torch.from_numpy(np.ascontiguousarray(
                batch[k], dtype=np.float32)).to(device)
    return out


class SupTrainer:
    """Single-model trainer.

    train_step : (state, batch) -> (state, {'loss', 'logits'})
    eval_step : batch -> {'logits', 'loss'}
    train_key : the loader an epoch runs over (the semi trainers run over
        'train_sup' and draw from 'train_unsup' beside it)
    host_prep : None or host batch -> host batch (numpy), run on the whole
        batch before it is sharded (e.g. superpixel pseudo-masks)
    to_device : host batch -> device batch (default
        :func:`to_device_batch`; the 3D trainers set
        :func:`to_device_batch_3d`)
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
        main = is_main()
        self.printer = printer or (BoxPrinter if main else SilentPrinter)(
            num_classes)
        self.writer = (make_tb_writer(paths.tensorboard) if main
                       else NullWriter())
        self.train_log = MetricsLog(paths.run, "train_log.csv")
        self.val_log = MetricsLog(paths.run, "val_log.csv")
        self.best_val = [0.0, 0.0, 0.0]
        self._epoch_losses = None
        self._aux_losses = {}
        self.host_prep = None
        self.to_device = functools.partial(to_device_batch, device=device)
        self._n_valid = None        # this rank's valid rows (dp)
        self._n_valid_global = None

    def prep(self, batch):
        """Host batch -> this rank's device batch (module docstring);
        under data parallelism it carries the ``weight`` vector and
        records the valid rows of the global and of this rank's batch."""
        with trace.span("hx.prep"):
            batch = dict(batch)
            batch.pop("id", None)
            if self.host_prep is not None:
                batch = self.host_prep(batch)
            if not active():
                return self.to_device(batch)
            batch, self._n_valid_global, self._n_valid = shard_global_batch(
                batch)
            weight = batch.pop("weight")
            out = self.to_device(batch)
            out["weight"] = torch.from_numpy(weight).to(self.device)
            return out

    def _valid(self, x):
        """The rows of ``x`` (this rank's batch) that are not padding."""
        return x if self._n_valid is None else x[:self._n_valid]

    def _save_best(self, threshold, epoch):
        save_snapshot(self.state.state_dict(), self.paths.checkpoints,
                      threshold=threshold, save_best=True,
                      **kernel_layout(self.state.model),
                      **self.hebb_meta)

    def _save_last(self, threshold):
        save_snapshot(self.state.state_dict(), self.paths.checkpoints,
                      threshold=threshold, save_best=False,
                      **kernel_layout(self.state.model),
                      **self.hebb_meta)

    def train_epoch(self, epoch, collect_metrics):
        with trace.span("hx.epoch"):
            acc = (make_accumulator(self.num_classes) if collect_metrics
                   else None)
            # the losses accumulate on the device; one read at epoch end
            total_loss, n_batches = 0.0, 0
            aux_totals = {}
            for batch in trace.iterate(self.loaders[self.train_key],
                                       "hx.data.next"):
                batch = self.prep(batch)
                with trace.span("hx.step"):
                    self.state, out = self.train_step(self.state, batch)
                total_loss = total_loss + out["loss"]
                # the pretrainers' scalar loss_unsup / loss_superdiff
                for k, v in out.items():
                    if k != "loss" and k.startswith("loss") and v.dim() == 0:
                        aux_totals[k] = aux_totals.get(k, 0.0) + v
                n_batches += 1
                if acc is not None:
                    with trace.span("hx.metrics"):
                        acc.update(self._valid(out["logits"]),
                                   self._valid(batch["mask"]))
            n = max(n_batches, 1)
            with trace.span("hx.epoch.read"):
                self._aux_losses = {k: float(v) / n
                                    for k, v in aux_totals.items()}
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
            acc.update(self._valid(out["logits"]), self._valid(batch["mask"]))
            if self.args.debug and self.palette is not None:
                # softmax in the logits' dtype, as hebbax's
                probs = torch.softmax(out["logits"], dim=1)[:, 1]
                if active():
                    probs = gather_rows(probs)[:self._n_valid_global]
                preds.append(probs.float().cpu().numpy())
                names.extend(ids or [])
        thr, ji, dc = acc.finalize()
        val_loss = float(total_loss) / max(n_batches, 1)
        return val_loss, (thr, ji, dc), preds, names

    def _resume(self):
        """With ``--resume``, restore ``<checkpoints>/resume.ckpt`` when it
        exists; returns the epoch to start from."""
        if not getattr(self.args, "resume", None):
            return 0
        path = os.path.join(self.paths.checkpoints, "resume.ckpt")
        if not os.path.exists(path):
            return 0
        self.state, meta = load_train_state(self.state, path)
        if meta.get("best_val"):
            self.best_val = meta["best_val"]
        self.printer.line(f"Resumed from epoch {meta['epoch'] + 1}")
        return meta["epoch"] + 1

    def _profiled_epoch(self, epoch, display):
        """One train epoch under ``torch.profiler`` (CUDA activity when the
        run is on the card) with the program's spans on
        (:mod:`..utils.trace`), its trace exported into
        ``--profile_dir``."""
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.device(self.device).type == "cuda"
        activities = [ProfilerActivity.CPU]
        if cuda:
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            trace.enable(cuda)
            try:
                out = self.train_epoch(epoch, display)
                if cuda:
                    torch.cuda.synchronize(self.device)
            finally:
                trace.disable()
        if is_main():
            os.makedirs(self.args.profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                self.args.profile_dir, f"epoch{epoch}.pt.trace.json"))
        return out

    def run(self):
        """Train ``num_epochs`` epochs.  ``--resume`` restarts after the
        epoch of ``resume.ckpt`` and rewrites it after every validated
        epoch; a resumed run's loaders start at their epoch 0 shuffle, as
        hebbax's do.  ``--profile_dir`` traces epoch 1 (past the first
        epoch's warm-up) into that directory.  Under data parallelism
        every rank decides alike (its metrics are global) and rank 0
        alone writes."""
        main = is_main()
        args = self.args
        since = time.time()
        for epoch in range(self._resume(), args.num_epochs):
            display = (epoch + 1) % args.display_iter == 0
            validate = ((epoch + 1) % args.validate_iter == 0
                        or epoch + 1 == args.num_epochs)
            epoch_t0 = time.time()
            if getattr(args, "profile_dir", None) and epoch == 1:
                train_loss, acc = self._profiled_epoch(epoch, display)
            else:
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
                    if main:
                        self._save_best(ev[0], epoch)
                    if (main and args.debug and preds
                            and self.palette is not None):
                        image_utils.save_preds(
                            np.concatenate(preds), ev[0], names,
                            self.paths.val_seg_preds, self.palette)
                if main and getattr(args, "resume", None):
                    save_train_state(self.state, self.paths.checkpoints,
                                     epoch, self.best_val)

        if main:
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
