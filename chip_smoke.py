#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``hebbax_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. build every CUDA kernel of the port from ``hebbax_torch/csrc`` (nvcc,
   one process per library, all started together);
2. at each of the 22 Hebbian sites of UNet2D at batch 32 and 128x128 —
   the tensors a real training forward gives the site — hold the SWTA
   delta kernel against its plain PyTorch version (max abs error <=
   1e-4 * max|plain|: float32 sums over up to 5e5 pixels taken in another
   order, products in 3xTF32), require two launches on the same tensors
   to be equal to the bit, and time, with CUDA events after warm-up, the
   kernel, the plain version and one cuDNN composition of the same
   function (softmax + ``torch.nn.grad.conv2d_weight`` + epilogue, timed
   only), beside three bounds: bytes over 3.35 TB/s, the FLOPs over the
   float32 SIMT peak (67 TFLOP/s), and three times the FLOPs over the
   TF32 tensor-core peak (495 TFLOP/s).  The kernel's bound is the larger
   of bytes and tensor-core time: the arithmetic it really does;
3. on a small input (batch 2, 32x32), a training forward on the card
   (kernel) against the same weights on the CPU (plain version): logits
   and all 22 deltas;
4. the main path through the port's CLIs on in-memory synthetic 128x128
   data (``scripts/make_synth_data.py::make_2d``'s generator, 64 train /
   16 val): (a) ``pretrain_hebbian_unsup_2d`` (swta_t, K=50, out_conv
   excluded, Adam, lr 1e-6, batch 32, 2 epochs, warmup 1), (b)
   ``train_sup_2d --load_hebbian_weights`` (a)'s last.ckpt at regime 50,
   (c) ``test_2d --hebbian_pretrain 1`` on (b)'s best_JI.ckpt.  The kernel
   launch count is zeroed just before each and read just after; (a) must
   launch it 22 times per step.  After each of (a) and (b) has run and
   its count was read, 10 more steps on one batch give the steady step
   time, and 3 steps under ``torch.profiler`` the device time by kernel
   class;
   before 4, at batch 2, 32x32, a training forward of ``unet_urpc`` and
   ``unet_cct`` on the card against the CPU, as in 3 (CCT with the same
   perturbation draws on both; 22 and 58 launches);
5. the semi-supervised family on the same data, each path with its
   launch count zeroed just before and read just after, and then timed
   like (a) and (b): (d) ``pretrain_hebbian_unsup_2d`` of ``unet_urpc``
   (its four heads excluded) and ``unet_cct`` (``out_conv`` excluded),
   flags as (a), which must launch the kernel 22 and 58 times per step
   (CCT's shared decoder runs four times per forward), leave the Hebbian
   kernels unchanged in epoch 0 and change them in epoch 1; (e)
   ``train_semi_2d`` em / uamt / cps on ``unet`` from (a)'s last.ckpt and
   urpc / cct from (d)'s, regime 50, with the sweep's flags (SGD, lr 0.5,
   dice, unsup weight 5, validation every epoch), 2 epochs, warmup 1:
   no kernel launch (alpha 0), finite losses, best_JI.ckpt written, and
   for uamt / cps checkpoints2/last.ckpt, both models moved and model 2
   unlike model 1; (f) ``test_2d --hebbian_pretrain 1`` on each (e) run's
   best_JI.ckpt: finite metrics in range;
6. the unsupervised baselines, none of which has a Hebbian conv (K1
   launches 0 in each): (g) at batch 2, 32x32, a training forward of
   ``unet_vae`` (same eps), ``unet_superpix`` and ``unet_ddpm``'s net /
   net_seg (same t) on the card against the CPU, every output within
   1e-4 (``unet_ddpm``'s: 1e-4 of max(1, its largest |value|)); (h)
   ``pretrain_unsup_2d`` vae / superpix / superdiff on the same data (Adam, lr 1e-4, superdiff at 1000 timesteps, batch 32, 2 epochs,
   warmup 1): finite ``loss`` / ``loss_unsup`` (/ ``loss_superdiff``)
   columns, last.ckpt written, every non-head parameter moved, then 10
   steady and 3 profiled steps, and the superpixel pseudo-mask prep (host
   numpy) timed apart over 10 batches; (i) ``train_semi_2d em -n
   unet_s2d --load_weights`` on (h)'s vae and superpix last.ckpt with the
   sweep's flags (the loaded trunk equal to the snapshot before the first
   step), timed like (e), then ``test_2d --best JI`` on each; one
   ``unsup_baseline_path`` line carries their numbers;
7. the 3D Hebbian bootstrap on full-width ``unet3d`` (64 initial
   features, a 1024-channel bottleneck) over synthetic NRRD volumes
   (``scripts/make_synth_data.py::make_3d``'s generator, copied; 4 train
   and 2 val volumes of 128x128x96, written by the port under
   ``build/chip_smoke/``), none of which reaches K1 (every 3D delta is the
   composed rule; K1 launches 0 on each path): (j) at batch 2, 32^3, a
   training forward (swta_t, K=50, ``conv`` excluded) on the card against
   the same weights on the CPU (logits within 1e-4, the 22 deltas within
   1e-3 of their site's max|delta|), then at each of the 22 sites, on the
   tensors of a real training forward at batch 1, 96x96x80, the composed
   delta timed with CUDA events beside its bounds (FLOPs over the float32
   SIMT peak, bytes over HBM); (k) ``pretrain_hebbian_unsup_3d -n unet3d``
   (swta_t, K=50, the sweep's exclude list, Adam, lr 1e-6, batch 1, patch
   96x96x80, 2 epochs, warmup 1): finite losses, the Hebbian kernels
   ``encoder.encoder1.conv1`` and ``decoder.upconv1`` unchanged in epoch
   0 and changed in epoch 1, the head trained, ``last.ckpt`` written; (l)
   ``train_sup_3d -n unet3d --load_hebbian_weights`` (k)'s snapshot at
   regime 50 (SGD, lr 0.1): the trunk equal to the snapshot before the
   first step, ``conv`` re-initialised, finite losses, ``best_JI.ckpt``;
   (k) and (l) then time 10 steady and 3 profiled steps; (m) ``test_3d
   --hebbian_pretrain 1 --postprocessing True`` with 96x96x80 patches
   overlapping by 48x48x40 on (l)'s snapshot: Dice and Jaccard in [0, 1],
   HD95 and ASSD finite unless no volume had a non-empty prediction, and
   the seconds per volume of the slider and, apart, of post-processing +
   distances; one ``hebbian_3d_path`` line carries (j)–(m);
8. print the ``{"kernels": [...]}`` line (with ``launches_by_path``: a,
   urpc_pretrain, cct_pretrain and the paths of 6 and 7), the card's name
   and power limit, and last ``{"ok": true, "device": {...}}``.

It needs one card, imports nothing of JAX or of the ``hebbax`` package,
and writes only under ``build/`` beside this file.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
RUN_DIR = os.path.join(ROOT, "build", "chip_smoke")
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_F32_FLOP_PER_S = 67e12     # H100 SXM float32, no tensor cores
PEAK_TF32_FLOP_PER_S = 495e12   # H100 SXM TF32 tensor cores, dense
TF32_PASSES = 3                 # 3xTF32: hi*hi + hi*lo + lo*hi
BATCH, SIZE, N_TRAIN, N_VAL = 32, 128, 64, 16
NET_3D, VOLUME, PATCH, OVERLAP = ("unet3d", (128, 128, 96), (96, 96, 80),
                                  (48, 48, 40))
N_TRAIN_3D, N_VAL_3D = 4, 2
K_TEMP = 50.0
TOL = 1e-4                      # max abs error / max |plain|


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def synth_items(n_train, n_val, size, seed=0):
    """``scripts/make_synth_data.py::make_2d`` in memory: one generator
    for both splits, a disc per image, RGB uint8 images, 0/1 masks."""
    rng = np.random.default_rng(seed)
    out = {}
    for split, n in (("train", n_train), ("val", n_val)):
        items = []
        for i in range(n):
            yy, xx = np.mgrid[:size, :size]
            cy, cx = rng.integers(size // 4, 3 * size // 4, 2)
            r = rng.integers(size // 8, size // 4)
            mask = ((yy - cy) ** 2 + (xx - cx) ** 2 < r * r).astype(
                np.uint8)
            img = np.stack([mask * 150 + 50, mask * 100 + 70,
                            np.full_like(mask, 90)], -1).astype(np.uint8)
            img = np.clip(img + rng.integers(0, 30, img.shape), 0,
                          255).astype(np.uint8)
            items.append((f"{i}.png", img, mask))
        out[split] = items
    return out


def array_dataset_class():
    from hebbax_torch.data import SegDataset2D, regime_split

    class ArrayDataset(SegDataset2D):
        """SegDataset2D over in-memory (name, image, mask) items."""

        def __init__(self, items, mean, std, split, sup=True, regime=100,
                     seed=0, size=(SIZE, SIZE)):
            names = regime_split([n for n, _, _ in items], regime, seed,
                                 sup)
            by_name = {n: (img, m) for n, img, m in items}
            self.items = [by_name[n] for n in names]
            self.image_paths = list(names)
            self.mask_paths = None
            self.sup = sup
            self.train = split == "train"
            self.mean, self.std = mean, std
            self.size = size
            self.seed = seed
            self.cache_decoded = False
            self._cache = {}

        def _decoded(self, index):
            img, mask = self.items[index]
            return img, (mask if self.sup else None)

    return ArrayDataset


def make_loaders(items, args, regime):
    from hebbax_torch.config.datasets import dataset_cfg, input_stats
    from hebbax_torch.data import Loader

    ds_cls = array_dataset_class()
    mean, std = input_stats(dataset_cfg(args.dataset_name), args.input1)
    train = ds_cls(items["train"], mean, std, "train", regime=regime,
                   seed=args.seed)
    val = ds_cls(items["val"], mean, std, "val", seed=args.seed)
    return {"train": Loader(train, args.batch_size, shuffle=True,
                            seed=args.seed, num_workers=args.num_workers),
            "val": Loader(val, args.batch_size, shuffle=False,
                          num_workers=args.num_workers)}


def make_semi_loaders(items, args, regime):
    """{'train_sup', 'train_unsup', 'val'}: the labelled files of
    ``regime``, their unlabelled complement (no masks), the val split."""
    from hebbax_torch.config.datasets import dataset_cfg, input_stats
    from hebbax_torch.data import Loader

    ds_cls = array_dataset_class()
    mean, std = input_stats(dataset_cfg(args.dataset_name), args.input1)
    kw = dict(shuffle=True, seed=args.seed, num_workers=args.num_workers)
    return {
        "train_sup": Loader(ds_cls(items["train"], mean, std, "train",
                                   regime=regime, seed=args.seed),
                            args.batch_size, **kw),
        "train_unsup": Loader(ds_cls(items["train"], mean, std, "train",
                                     sup=False, regime=regime,
                                     seed=args.seed),
                              args.batch_size, **kw),
        "val": Loader(ds_cls(items["val"], mean, std, "val", seed=args.seed),
                      args.batch_size, shuffle=False,
                      num_workers=args.num_workers)}


def cuda_time_ms(fn, warmup=2, iters=10):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bounds(n, i, h, w, o, k):
    """Bounds (ms) of one SWTA delta: ``bytes`` (each input read once,
    the output written once), ``f32`` (2*P*M*O operations on the float32
    SIMT units), ``tc`` (the same operations three times on the TF32
    tensor cores); ``ms`` and ``by`` for the kernel's own arithmetic,
    3xTF32: the larger of bytes and tc."""
    p, m = n * h * w, i * k * k
    ops = 2.0 * p * m * o
    t_bytes = 4.0 * (p * (i + o) + 2 * m * o) / PEAK_BYTES_PER_S * 1e3
    t_f32 = ops / PEAK_F32_FLOP_PER_S * 1e3
    t_tc = TF32_PASSES * ops / PEAK_TF32_FLOP_PER_S * 1e3
    return {"bytes": t_bytes, "f32": t_f32, "tc": t_tc,
            "ms": max(t_bytes, t_tc),
            "by": "bytes" if t_bytes > t_tc else "operations"}


def library_delta(w, x, y, k, pad):
    """One cuDNN composition of the same function (timed only)."""
    import torch
    r = torch.softmax(k * y, dim=1)
    pos = torch.nn.grad.conv2d_weight(x, w.shape, r, padding=pad)
    return pos - r.sum(dim=(0, 2, 3))[:, None, None, None] * w


def hebbian_model(device, seed=0):
    from hebbax_torch.hebb.spec import HebbSpec
    from hebbax_torch.models import get_network
    from hebbax_torch.utils.seeding import make_generator

    spec = HebbSpec(mode="swta_t", k=K_TEMP, exclude=("out_conv",))
    return get_network("unet", 3, 2, hebb=spec, device=device,
                       generator=make_generator(seed),
                       dropout_generator=make_generator(seed + 1, device))


def capture_sites(model, images):
    """(name, w, x, y, padding) of every Hebbian conv in one training
    forward."""
    import torch
    from hebbax_torch.hebb.layers import HConv
    from hebbax_torch.hebb.surgery import pop_deltas

    sites, hooks = [], []
    for name, m in model.named_modules():
        if isinstance(m, HConv) and m.spec is not None:
            def hook(mod, inp, out, name=name):
                sites.append((name, mod.weight.detach().clone(),
                              inp[0].detach(), out.detach(), mod.padding))
            hooks.append(m.register_forward_hook(hook))
    model.train()
    with torch.no_grad():
        model(images)
    for h in hooks:
        h.remove()
    pop_deltas(model)
    return sites


def phase_sites(device, images):
    import torch
    from hebbax_torch.hebb import kernels, rules

    model = hebbian_model(device)
    sites = capture_sites(model, images)
    check(len(sites) == 22, f"expected 22 Hebbian sites, got {len(sites)}")
    rows = []
    log(f"{'site':36s} {'N,I,H,W,O,k':>22s} {'err/max':>9s} "
        f"{'kernel_ms':>9s} {'plain_ms':>9s} {'library_ms':>10s} "
        f"{'tc_ms':>7s} {'f32_ms':>7s} {'byte_ms':>7s} {'share':>6s}")
    for name, w, x, y, pad in sites:
        n, i, h, wd = x.shape
        o, k = w.shape[0], w.shape[2]
        plain = rules.swta_conv_delta(w, x, y, K_TEMP, pad)
        got = kernels.SWTA_DELTA(w, x, y, K_TEMP, pad)
        torch.cuda.synchronize()
        err = float((got - plain).abs().max())
        scale = float(plain.abs().max())
        check(np.isfinite(err) and err <= TOL * scale,
              f"{name}: kernel vs plain max abs error {err} > "
              f"{TOL} * {scale}")
        again = kernels.SWTA_DELTA(w, x, y, K_TEMP, pad)
        torch.cuda.synchronize()
        check(torch.equal(got, again),
              f"{name}: two launches on the same tensors differ")
        k_ms = cuda_time_ms(lambda: kernels.SWTA_DELTA(w, x, y, K_TEMP, pad))
        p_ms = cuda_time_ms(lambda: rules.swta_conv_delta(w, x, y, K_TEMP,
                                                          pad))
        l_ms = cuda_time_ms(lambda: library_delta(w, x, y, K_TEMP, pad))
        b = bounds(n, i, h, wd, o, k)
        rows.append(dict(site=name, shape=[n, i, h, wd, o, k],
                         max_abs_err=err, rel_err=err / scale, ms=k_ms,
                         plain_ms=p_ms, library_ms=l_ms, bound_ms=b["ms"],
                         bound_by=b["by"], bound_tc_ms=b["tc"],
                         bound_f32_ms=b["f32"], bound_bytes_ms=b["bytes"]))
        log(f"{name:36s} {str((n, i, h, wd, o, k)):>22s} "
            f"{err / scale:9.2e} {k_ms:9.4f} {p_ms:9.4f} {l_ms:10.4f} "
            f"{b['tc']:7.4f} {b['f32']:7.4f} {b['bytes']:7.4f} "
            f"{b['ms'] / k_ms:6.1%}")
    log("sites " + json.dumps(rows))
    return rows


def phase_small_reference(device):
    """Training forward on the card (kernel) vs the CPU (plain version),
    same weights and input."""
    import torch
    from hebbax_torch.hebb import kernels
    from hebbax_torch.hebb.surgery import pop_deltas
    from hebbax_torch.ops.dropout import Dropout

    gpu = hebbian_model(device, seed=3)
    cpu = hebbian_model("cpu", seed=3)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    for m in (gpu, cpu):
        for mod in m.modules():
            if isinstance(mod, Dropout):
                mod.p = 0.0             # dropout off: the streams differ
        m.train()
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 3, 32, 32)).astype(np.float32))
    before = kernels.SWTA_DELTA.launches
    with torch.no_grad():
        out_g = gpu(x.to(device)).cpu()
        out_c = cpu(x)
    check(kernels.SWTA_DELTA.launches == before + 22,
          "the card's training forward did not launch the kernel 22 times")
    dg, dc = pop_deltas(gpu), pop_deltas(cpu)
    check(set(dg) == set(dc) and len(dg) == 22, "delta sites differ")
    logit_err = float((out_g - out_c).abs().max())
    check(logit_err <= 1e-4, f"logits card vs CPU differ by {logit_err}")
    worst = max(float((dg[n].cpu() - dc[n]).abs().max())
                / float(dc[n].abs().max()) for n in dc)
    # BN over the 2x2x2 bottleneck and K=50 amplify conv rounding (cuDNN
    # vs oneDNN) in the deltas; the CPU parity tests hold 1e-3 likewise
    check(worst <= 1e-3, f"deltas card vs CPU differ by {worst} of scale")
    log(f"small-input reference: logits max abs diff {logit_err:.3e}, "
        f"deltas max diff / scale {worst:.3e}")


def timed_step(step, times, watch=None, snapshots=None):
    import torch

    def wrapped(state, *batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, out = step(state, *batches)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if watch is not None:
            snapshots.append(
                state.model.state_dict()[watch].detach().clone())
        return state, out
    return wrapped


def step_runner(trainer, step):
    """A closure running one more train step of ``trainer`` through the
    unwrapped ``step`` on fixed batches: its first train batch, and for a
    semi trainer the next unlabelled batch, at the last epoch's weight."""
    sup = trainer.prep(next(iter(trainer.loaders[trainer.train_key])))
    if not hasattr(trainer, "next_unsup"):
        def run():
            trainer.state, _ = step(trainer.state, sup)
        return run
    unsup = trainer.prep(trainer.next_unsup())
    epoch = trainer.args.num_epochs - 1
    w = trainer.epoch_weight(epoch)

    def run():
        trainer.train_step = step
        trainer.state, _ = trainer.call_step(sup, unsup, w, epoch)
    return run


def steady_step_ms(trainer, step, n=10):
    """Host times (ms) of n more train steps on fixed batches, each ended
    by a synchronize, after the run's own steps warmed up cuDNN and the
    allocator.  Made after the path's launch count was read."""
    import torch

    run = step_runner(trainer, step)
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def kernel_group(name):
    """Coarse class of a CUDA kernel by its name."""
    low = name.lower()
    if "swta_" in low:
        return "swta_delta"
    if any(s in low for s in ("conv", "cudnn", "xmma", "implicit", "grad")):
        return "convolution"
    if "gemm" in low or "cutlass" in low:
        return "matmul"
    return "other"


def profile_steps(trainer, step, steady_ms, n=3):
    """torch.profiler over n train steps on fixed batches: device time per
    step by kernel class, its share of the unprofiled step's median host
    time ``steady_ms``, and the heaviest kernels.  Made after the path's
    launch count was read."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run = step_runner(trainer, step)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    kernels = {}
    for evt in prof.key_averages():
        if str(evt.device_type).endswith("CUDA"):
            us = getattr(evt, "device_time_total", None)
            if us is None:
                us = evt.cuda_time_total
            kernels[evt.key] = us / 1e3 / n
    groups = {}
    for name, ms in kernels.items():
        g = kernel_group(name)
        groups[g] = groups.get(g, 0.0) + ms
    device_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {"device_ms": device_ms, "step_ms": steady_ms,
            "busy_share": device_ms / steady_ms, "groups_ms": groups,
            "top_ms": [[name[:80], ms] for name, ms in top]}


def all_on(model, device_type):
    return all(t.device.type == device_type for t in
               list(model.parameters()) + list(model.buffers()))


def phase_main_path(items, device="0"):
    import torch
    from hebbax_torch.cli import common
    from hebbax_torch.cli import pretrain_hebbian_unsup_2d as pretrain
    from hebbax_torch.cli import test_2d
    from hebbax_torch.cli import train_sup_2d
    from hebbax_torch.hebb import kernels

    shutil.rmtree(RUN_DIR, ignore_errors=True)
    on = "cpu" if device == "cpu" else "cuda"
    base = cli_base(device)
    launches = {}

    # (a) Hebbian pretraining
    args = pretrain.add_args(common.base_parser_2d()).parse_args(base + [
        "-n", "unet", "--exclude", "out_conv", "--hebb_mode", "swta_t",
        "--hebb_inv_temp", str(int(K_TEMP)), "--optimizer", "adam",
        "-l", "1e-6", "--debug", ""])
    trainer = pretrain.build(args, make_loaders(items, args, 100))
    watch = "encoder.in_conv.conv2.weight"
    w0 = trainer.state.model.state_dict()[watch].detach().clone()
    times_a, snaps = [], []
    raw_step = trainer.train_step
    trainer.train_step = timed_step(raw_step, times_a, watch, snaps)
    kernels.SWTA_DELTA.launches = 0
    trainer.run()
    launches["a"] = kernels.SWTA_DELTA.launches
    steps_a = len(times_a)
    per_epoch = len(trainer.loaders["train"])
    check(steps_a == 2 * per_epoch, f"pretrain ran {steps_a} steps")
    check(launches["a"] == 22 * steps_a,
          f"pretrain launched the kernel {launches['a']} times, expected "
          f"22 x {steps_a}")
    check(all(torch.equal(s, w0) for s in snaps[:per_epoch]),
          "a Hebbian kernel changed in epoch 0 (lr 0)")
    check(not torch.equal(snaps[-1], w0),
          "the Hebbian kernels did not change in epoch 1")
    check(all_on(trainer.state.model, on), f"a model tensor is off {on}")
    losses, ok = finite_losses(trainer)
    check(ok, f"pretrain losses {losses}")
    run_a = trainer.paths.run
    log(f"(a) pretrain: {steps_a} steps, kernel launches {launches['a']}, "
        f"step ms {[round(t, 3) for t in times_a]}, losses {losses}")
    steady = {"a": steady_step_ms(trainer, raw_step)}
    profiled = {"a": profile_steps(trainer, raw_step,
                                   float(np.median(steady["a"])))}
    log("(a) profile " + json.dumps(profiled["a"]))

    # (b) fine-tuning from (a)'s snapshot
    args = train_sup_2d.add_args(common.base_parser_2d()).parse_args(
        base + ["--load_hebbian_weights",
                os.path.join(run_a, "checkpoints", "last.ckpt"),
                "--regime", "50", "--debug", ""])
    trainer = train_sup_2d.build(args, make_loaders(items, args, 50))
    times_b = []
    raw_step = trainer.train_step
    trainer.train_step = timed_step(raw_step, times_b)
    kernels.SWTA_DELTA.launches = 0
    trainer.run()
    launches["b"] = kernels.SWTA_DELTA.launches
    check(all_on(trainer.state.model, on), f"a model tensor is off {on}")
    losses, ok = finite_losses(trainer)
    check(ok, f"fine-tune losses {losses}")
    run_b = trainer.paths.run
    check(os.path.exists(os.path.join(run_b, "checkpoints", "best_JI.ckpt")),
          "fine-tuning wrote no best_JI.ckpt")
    log(f"(b) fine-tune: {len(times_b)} steps, step ms "
        f"{[round(t, 3) for t in times_b]}, losses {losses}")
    steady["b"] = steady_step_ms(trainer, raw_step)
    profiled["b"] = profile_steps(trainer, raw_step,
                                  float(np.median(steady["b"])))
    log("(b) profile " + json.dumps(profiled["b"]))

    # (c) test on (b)'s best snapshot
    args = test_2d.build_parser().parse_args(
        ["--device", device, "--path_exp", run_b, "--hebbian_pretrain", "1",
         "-b", str(BATCH), "--num_workers", "4"])
    from hebbax_torch.config.datasets import dataset_cfg, input_stats
    from hebbax_torch.data import Loader
    mean, std = input_stats(dataset_cfg("GlaS"), "image")
    test_ds = array_dataset_class()(items["val"], mean, std, "test")
    kernels.SWTA_DELTA.launches = 0
    metrics = test_2d.run_test(args, Loader(test_ds, BATCH,
                                            num_workers=4))
    launches["c"] = kernels.SWTA_DELTA.launches
    check(metrics is not None and all(np.isfinite(v)
                                      for v in metrics.values()),
          f"test metrics {metrics}")
    check(0.0 <= metrics["segm/dice"] <= 1.0
          and 0.0 <= metrics["segm/jaccard"] <= 1.0,
          f"test metrics out of range: {metrics}")
    log(f"(c) test: Dice {metrics['segm/dice']:.4f} Jaccard "
        f"{metrics['segm/jaccard']:.4f} HD95 {metrics['segm/95hd']:.3f} "
        f"ASSD {metrics['segm/asd']:.3f} at threshold {metrics['thresh']}")
    log("main_path " + json.dumps({
        "launches": launches, "steps": {"a": steps_a, "b": len(times_b)},
        "step_ms": {"a": times_a, "b": times_b},
        "steady_step_ms": summary(steady),
        "test": metrics}))
    return launches, run_a


DEEP4 = {"unet_urpc": (("out_conv_dp1", "out_conv_dp2", "out_conv_dp3",
                        "out_conv"), 22),
         "unet_cct": (("out_conv",), 58)}
SEMI = (("em", "unet"), ("uamt", "unet"), ("cps", "unet"),
        ("urpc", "unet_urpc"), ("cct", "unet_cct"))


def cli_base(device):
    return ["--device", device, "--path_dataset", "synthetic/GlaS",
            "--dataset_name", "GlaS", "--path_root_exp", RUN_DIR,
            "-b", str(BATCH), "-e", "2", "-w", "1", "--num_workers", "4"]


def finite_losses(trainer):
    losses = ([r["loss"] for r in trainer.train_log.rows]
              + [r["loss"] for r in trainer.val_log.rows])
    return losses, all(np.isfinite(v) for v in losses)


def phase_deep4_reference(device):
    """Training forward of unet_urpc and unet_cct at batch 2, 32x32 on the
    card (kernel) against the same weights on the CPU (plain version);
    CCT's perturbations take the same draws on both (drawn on the CPU)."""
    import torch
    from hebbax_torch.hebb import kernels
    from hebbax_torch.hebb.spec import HebbSpec
    from hebbax_torch.hebb.surgery import pop_deltas
    from hebbax_torch.models import get_network
    from hebbax_torch.models.common import (CCT_PERTURB_KINDS,
                                            draw_perturbation)
    from hebbax_torch.ops.dropout import Dropout
    from hebbax_torch.utils.seeding import make_generator

    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 3, 32, 32)).astype(np.float32))
    for net, (exclude, per_step) in DEEP4.items():
        spec = HebbSpec(mode="swta_t", k=K_TEMP, exclude=exclude)
        gpu, cpu = [get_network(net, 3, 2, hebb=spec, device=dev,
                                generator=make_generator(3))
                    for dev in (device, "cpu")]
        cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
        for m in (gpu, cpu):
            for mod in m.modules():
                if isinstance(mod, Dropout):
                    mod.p = 0.0         # dropout off: the streams differ
            m.train()
        if net == "unet_cct":
            gen, draws = make_generator(9), {}

            def draw_on_cpu(feats, gen=gen, draws=draws):
                for kind in CCT_PERTURB_KINDS:
                    draws[kind] = [draw_perturbation(kind, f, gen)
                                   for f in feats]
                return draws

            cpu.draw_perturbations = draw_on_cpu
            gpu.draw_perturbations = lambda feats, draws=draws: {
                k: [d.to(device) for d in v] for k, v in draws.items()}
        with torch.no_grad():
            out_c = cpu(x)
            before = kernels.SWTA_DELTA.launches
            out_g = [o.cpu() for o in gpu(x.to(device))]
        check(kernels.SWTA_DELTA.launches == before + per_step,
              f"{net}: the card's training forward did not launch the "
              f"kernel {per_step} times")
        dg, dc = pop_deltas(gpu), pop_deltas(cpu)
        check(set(dg) == set(dc) and len(dg) == 22,
              f"{net}: delta sites differ")
        logit_err = max(float((g - c).abs().max())
                        for g, c in zip(out_g, out_c))
        check(logit_err <= 1e-4,
              f"{net}: logits card vs CPU differ by {logit_err}")
        worst = max(float((dg[n].cpu() - dc[n]).abs().max())
                    / float(dc[n].abs().max()) for n in dc)
        check(worst <= 1e-3,
              f"{net}: deltas card vs CPU differ by {worst} of scale")
        log(f"small-input reference {net}: 4 outputs max abs diff "
            f"{logit_err:.3e}, deltas max diff / scale {worst:.3e}, "
            f"{per_step} launches")


def phase_deep4_pretrain(items, device="0"):
    """(d) Hebbian pretraining of unet_urpc (its four heads excluded) and
    unet_cct (out_conv excluded), as (a): 22 and 58 launches per step."""
    import torch
    from hebbax_torch.cli import common
    from hebbax_torch.cli import pretrain_hebbian_unsup_2d as pretrain
    from hebbax_torch.hebb import kernels

    on = "cpu" if device == "cpu" else "cuda"
    launches, snaps, steady, profiled, steps = {}, {}, {}, {}, {}
    for net, (exclude, per_step) in DEEP4.items():
        key = net[len("unet_"):] + "_pretrain"
        args = pretrain.add_args(common.base_parser_2d()).parse_args(
            cli_base(device) + [
                "-n", net, "--exclude", *exclude, "--hebb_mode", "swta_t",
                "--hebb_inv_temp", str(int(K_TEMP)), "--optimizer", "adam",
                "-l", "1e-6", "--debug", ""])
        trainer = pretrain.build(args, make_loaders(items, args, 100))
        watch = "encoder.in_conv.conv2.weight"
        w0 = trainer.state.model.state_dict()[watch].detach().clone()
        times, snapshots = [], []
        raw_step = trainer.train_step
        trainer.train_step = timed_step(raw_step, times, watch, snapshots)
        kernels.SWTA_DELTA.launches = 0
        trainer.run()
        launches[key] = kernels.SWTA_DELTA.launches
        steps[key] = len(times)
        per_epoch = len(trainer.loaders["train"])
        check(steps[key] == 2 * per_epoch, f"{key} ran {steps[key]} steps")
        check(launches[key] == per_step * steps[key],
              f"{key} launched the kernel {launches[key]} times, expected "
              f"{per_step} x {steps[key]}")
        check(all(torch.equal(w, w0) for w in snapshots[:per_epoch]),
              f"{key}: a Hebbian kernel changed in epoch 0 (lr 0)")
        check(not torch.equal(snapshots[-1], w0),
              f"{key}: the Hebbian kernels did not change in epoch 1")
        check(all_on(trainer.state.model, on), f"a model tensor is off {on}")
        losses, ok = finite_losses(trainer)
        check(ok, f"{key} losses {losses}")
        snaps[net] = os.path.join(trainer.paths.checkpoints, "last.ckpt")
        log(f"(d) {key}: {steps[key]} steps, kernel launches "
            f"{launches[key]}, step ms {[round(t, 3) for t in times]}, "
            f"losses {losses}")
        steady[key] = steady_step_ms(trainer, raw_step)
        profiled[key] = profile_steps(trainer, raw_step,
                                      float(np.median(steady[key])))
        log(f"(d) {key} profile " + json.dumps(profiled[key]))
    return launches, snaps, steady, steps


def phase_semi(items, snaps, device="0"):
    """(e) train_semi_2d with the sweep's flags, each algorithm from its
    network's Hebbian snapshot; no kernel launch (alpha 0).  (f) test_2d
    on each run's best_JI.ckpt."""
    import torch
    from hebbax_torch.cli import common
    from hebbax_torch.cli import test_2d
    from hebbax_torch.cli import train_semi_2d
    from hebbax_torch.config.datasets import dataset_cfg, input_stats
    from hebbax_torch.data import Loader
    from hebbax_torch.hebb import kernels

    on = "cpu" if device == "cpu" else "cuda"
    watch = "encoder.in_conv.conv1.weight"
    launches, steady, steps, tests = {}, {}, {}, {}
    for algo, net in SEMI:
        args = train_semi_2d.add_args(common.base_parser_2d(), algo)\
            .parse_args(cli_base(device) + [
                "-n", net, "--load_hebbian_weights", snaps[net],
                "--hebb_inv_temp", str(int(K_TEMP)), "--regime", "50",
                "--optimizer", "sgd", "-l", "0.5", "--loss", "dice",
                "--unsup_weight", "5", "--validate_iter", "1",
                "--debug", ""])
        trainer = train_semi_2d.build(args, algo,
                                      make_semi_loaders(items, args, 50))
        dual = algo in ("uamt", "cps")
        models = ([trainer.state.model1, trainer.state.model2] if dual
                  else [trainer.state.model])
        w0 = [m.state_dict()[watch].detach().clone() for m in models]
        times = []
        raw_step = trainer.train_step
        trainer.train_step = timed_step(raw_step, times)
        kernels.SWTA_DELTA.launches = 0
        trainer.run()
        launches[algo] = kernels.SWTA_DELTA.launches
        steps[algo] = len(times)
        check(launches[algo] == 0,
              f"{algo} launched the kernel {launches[algo]} times (alpha 0)")
        check(all(all_on(m, on) for m in models),
              f"{algo}: a model tensor is off {on}")
        losses, ok = finite_losses(trainer)
        check(ok, f"{algo} losses {losses}")
        ckpts = trainer.paths.checkpoints
        check(os.path.exists(os.path.join(ckpts, "best_JI.ckpt")),
              f"{algo} wrote no best_JI.ckpt")
        w1 = [m.state_dict()[watch] for m in models]
        check(not torch.equal(w1[0], w0[0]), f"{algo}: model 1 unchanged")
        if dual:
            check(os.path.exists(os.path.join(ckpts + "2", "last.ckpt")),
                  f"{algo} wrote no checkpoints2/last.ckpt")
            check(not torch.equal(w1[1], w0[1]),
                  f"{algo}: model 2 unchanged")
            check(not torch.equal(w1[1], w1[0]),
                  f"{algo}: model 2 equals model 1")
        log(f"(e) {algo} on {net}: {steps[algo]} steps, kernel launches "
            f"{launches[algo]}, step ms {[round(t, 3) for t in times]}, "
            f"losses {losses}")
        steady[algo] = steady_step_ms(trainer, raw_step)
        profiled = profile_steps(trainer, raw_step,
                                 float(np.median(steady[algo])))
        log(f"(e) {algo} profile " + json.dumps(profiled))

        # (f) test on the run's best snapshot
        targs = test_2d.build_parser().parse_args(
            ["--device", device, "--path_exp", trainer.paths.run,
             "--hebbian_pretrain", "1", "-n", net, "-b", str(BATCH),
             "--num_workers", "4"])
        mean, std = input_stats(dataset_cfg("GlaS"), "image")
        test_ds = array_dataset_class()(items["val"], mean, std, "test")
        kernels.SWTA_DELTA.launches = 0
        metrics = test_2d.run_test(targs, Loader(test_ds, BATCH,
                                                 num_workers=4))
        check(kernels.SWTA_DELTA.launches == 0, f"(f) {algo} launched K1")
        check(metrics is not None and all(np.isfinite(v)
                                          for v in metrics.values()),
              f"(f) {algo} test metrics {metrics}")
        check(0.0 <= metrics["segm/dice"] <= 1.0
              and 0.0 <= metrics["segm/jaccard"] <= 1.0,
              f"(f) {algo} test metrics out of range: {metrics}")
        tests[algo] = metrics
        log(f"(f) test {algo}: Dice {metrics['segm/dice']:.4f} Jaccard "
            f"{metrics['segm/jaccard']:.4f} HD95 {metrics['segm/95hd']:.3f}"
            f" ASSD {metrics['segm/asd']:.3f}")
    return launches, steady, steps, tests


UNSUP_KINDS = ("vae", "superpix", "superdiff")


def phase_unsup_reference(device):
    """(g) Training forward of unet_vae (same eps), unet_superpix and
    unet_ddpm's net / net_seg (same t) at batch 2, 32x32 on the card
    against the same weights on the CPU; every output within 1e-4 (the
    logits gate of 3), ``unet_ddpm``'s within 1e-4 of max(1, its largest
    |value|): its outputs reach ~4 and carry the rounding of 23 convs up
    to 512 wide with train-mode BN over a 2x2 bottleneck; and no K1
    launch (no Hebbian conv)."""
    import torch
    from hebbax_torch.hebb import kernels
    from hebbax_torch.models import get_network
    from hebbax_torch.ops.dropout import Dropout
    from hebbax_torch.utils.seeding import make_generator

    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.standard_normal((2, 3, 32, 32)).astype(
        np.float32))
    x5 = torch.from_numpy(rng.standard_normal((2, 5, 32, 32)).astype(
        np.float32))
    eps = torch.from_numpy(rng.standard_normal((2, 256, 2, 2)).astype(
        np.float32))
    t = torch.tensor([17, 903])
    errs = {}
    for net in ("unet_vae", "unet_superpix", "unet_ddpm"):
        gpu, cpu = [get_network(net, 3, 2, device=dev,
                                generator=make_generator(4))
                    for dev in (device, "cpu")]
        for m in (gpu, cpu):
            for mod in m.modules():
                if isinstance(mod, Dropout):
                    mod.p = 0.0         # dropout off: the streams differ
            m.train()
        before = kernels.SWTA_DELTA.launches
        with torch.no_grad():
            if net == "unet_vae":
                out_c = cpu(x, eps=eps)
                out_g = gpu(x.to(device), eps=eps.to(device))
                pairs = {k: (out_g[k], out_c[k]) for k in out_c}
            elif net == "unet_superpix":
                pairs = dict(zip(("seg", "superpix"), zip(
                    gpu(x.to(device)), cpu(x))))
            else:
                pairs = {m: (gpu(x5.to(device), t.to(device), mode=m),
                             cpu(x5, t, mode=m))
                         for m in ("net", "net_seg")}
        check(kernels.SWTA_DELTA.launches == before,
              f"{net}: the card's forward launched K1")
        for k, (g, c) in pairs.items():
            err = float((g.cpu() - c).abs().max())
            scale = max(1.0, float(c.abs().max()))
            check(err <= 1e-4 * (scale if net == "unet_ddpm" else 1.0),
                  f"{net} {k}: card vs CPU differ by {err} (scale {scale})")
            errs[f"{net}.{k}"] = {"max_abs": err, "scale": scale}
        log(f"small-input reference {net}: " + ", ".join(
            f"{k} {errs[f'{net}.{k}']['max_abs']:.3e} of "
            f"{errs[f'{net}.{k}']['scale']:.3g}" for k in pairs)
            + " max abs diff of scale, 0 launches")
    return errs


def superpix_prep_ms(trainer, n=10):
    """Host time (ms) of the superpixel pseudo-masks of n train batches."""
    from hebbax_torch.cli.pretrain_unsup_2d import superpix_masks

    times, batches = [], []
    while len(batches) < n:
        batches.extend(trainer.loaders["train"])
    for batch in batches[:n]:
        t0 = time.perf_counter()
        superpix_masks(batch["image"], trainer.args.seed)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def phase_unsup_pretrain(items, device="0"):
    """(h) pretrain_unsup_2d vae / superpix / superdiff with the sweep's
    Adam at lr 1e-4 (superdiff at its 1000 timesteps): no K1 launch,
    finite loss columns, last.ckpt, every non-head parameter moved; then
    steady and profiled steps on prepared batches, and the superpixel
    prep timed apart."""
    import torch
    from hebbax_torch.cli import common
    from hebbax_torch.cli import pretrain_unsup_2d as unsup
    from hebbax_torch.hebb import kernels

    on = "cpu" if device == "cpu" else "cuda"
    launches, snaps, steady, profiled, steps = {}, {}, {}, {}, {}
    prep = None
    for kind in UNSUP_KINDS:
        key = f"{kind}_pretrain"
        args = unsup.add_args(common.base_parser_2d(), kind).parse_args(
            cli_base(device) + ["--optimizer", "adam", "-l", "1e-4",
                                "--debug", ""])
        trainer = unsup.build(args, kind, make_loaders(items, args, 100))
        model = trainer.state.model
        heads = tuple(h + "." for h in unsup.HEADS[kind])
        p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        times = []
        raw_step = trainer.train_step
        trainer.train_step = timed_step(raw_step, times)
        kernels.SWTA_DELTA.launches = 0
        trainer.run()
        launches[key] = kernels.SWTA_DELTA.launches
        steps[key] = len(times)
        check(launches[key] == 0, f"{key} launched K1 {launches[key]} times")
        check(steps[key] == 2 * len(trainer.loaders["train"]),
              f"{key} ran {steps[key]} steps")
        check(all_on(model, on), f"a model tensor is off {on}")
        cols = ["loss", "loss_unsup"] + (["loss_superdiff"]
                                         if kind == "superdiff" else [])
        rows = trainer.train_log.rows
        losses = {c: [r[c] for r in rows] for c in cols}
        check(len(rows) == 2 and all(np.isfinite(v) for c in cols
                                     for v in losses[c]),
              f"{key} train_log losses {losses}")
        val = [r["loss"] for r in trainer.val_log.rows]
        check(all(np.isfinite(v) for v in val), f"{key} val losses {val}")
        snaps[kind] = os.path.join(trainer.paths.checkpoints, "last.ckpt")
        check(os.path.exists(snaps[kind]), f"{key} wrote no last.ckpt")
        still = [n for n, p in model.named_parameters()
                 if not n.startswith(heads) and torch.equal(p, p0[n])]
        check(not still, f"{key}: non-head parameters did not move: "
                         f"{still[:5]} ({len(still)})")
        log(f"(h) {key}: {steps[key]} steps, K1 launches {launches[key]}, "
            f"step ms {[round(t, 3) for t in times]}, losses {losses}, "
            f"val {val}")
        steady[key] = steady_step_ms(trainer, raw_step)
        profiled[key] = profile_steps(trainer, raw_step,
                                      float(np.median(steady[key])))
        log(f"(h) {key} profile " + json.dumps(profiled[key]))
        if kind == "superpix":
            prep = superpix_prep_ms(trainer)
            log(f"(h) superpix prep ms (10 batches of {BATCH}) "
                f"{[round(t, 3) for t in prep]}")
    return launches, snaps, steady, profiled, steps, prep


def phase_unsup_em(items, snaps, device="0"):
    """(i) train_semi_2d em -n unet_s2d --load_weights on (h)'s vae and
    superpix last.ckpt with the sweep's flags (SGD, lr 0.5, dice, unsup
    weight 5, regime 50): the loaded trunk equals the snapshot before the
    first step, no K1 launch, finite losses; then test_2d --best JI on
    each run: finite metrics in range, no K1 launch."""
    import torch
    from hebbax_torch.cli import common
    from hebbax_torch.cli import test_2d
    from hebbax_torch.cli import train_semi_2d
    from hebbax_torch.config.datasets import dataset_cfg, input_stats
    from hebbax_torch.data import Loader
    from hebbax_torch.hebb import kernels
    from hebbax_torch.utils.checkpoint import load_state_dict

    on = "cpu" if device == "cpu" else "cuda"
    launches, steady, profiled, steps, tests = {}, {}, {}, {}, {}
    for kind in ("vae", "superpix"):
        key = f"em_{kind}"
        args = train_semi_2d.add_args(common.base_parser_2d(), "em")\
            .parse_args(cli_base(device) + [
                "-n", "unet_s2d", "--load_weights", snaps[kind],
                "--regime", "50", "--optimizer", "sgd", "-l", "0.5",
                "--loss", "dice", "--unsup_weight", "5",
                "--validate_iter", "1", "--debug", ""])
        trainer = train_semi_2d.build(args, "em",
                                      make_semi_loaders(items, args, 50))
        model = trainer.state.model
        loaded, _ = load_state_dict(snaps[kind])
        differ = [n for n, t in model.state_dict().items()
                  if not n.startswith("out_conv.")
                  and not torch.equal(t.cpu(), loaded[n])]
        check(not differ, f"{key}: the trunk differs from the snapshot: "
                          f"{differ[:5]}")
        times = []
        raw_step = trainer.train_step
        trainer.train_step = timed_step(raw_step, times)
        kernels.SWTA_DELTA.launches = 0
        trainer.run()
        launches[key] = kernels.SWTA_DELTA.launches
        steps[key] = len(times)
        check(launches[key] == 0, f"{key} launched K1 {launches[key]} times")
        check(all_on(model, on), f"{key}: a model tensor is off {on}")
        losses, ok = finite_losses(trainer)
        check(ok, f"{key} losses {losses}")
        check(os.path.exists(os.path.join(trainer.paths.checkpoints,
                                          "best_JI.ckpt")),
              f"{key} wrote no best_JI.ckpt")
        log(f"(i) {key}: {steps[key]} steps, K1 launches {launches[key]}, "
            f"step ms {[round(t, 3) for t in times]}, losses {losses}")
        steady[key] = steady_step_ms(trainer, raw_step)
        profiled[key] = profile_steps(trainer, raw_step,
                                      float(np.median(steady[key])))
        log(f"(i) {key} profile " + json.dumps(profiled[key]))

        targs = test_2d.build_parser().parse_args(
            ["--device", device, "--path_exp", trainer.paths.run,
             "--best", "JI", "-n", "unet_s2d", "-b", str(BATCH),
             "--num_workers", "4"])
        mean, std = input_stats(dataset_cfg("GlaS"), "image")
        test_ds = array_dataset_class()(items["val"], mean, std, "test")
        kernels.SWTA_DELTA.launches = 0
        metrics = test_2d.run_test(targs, Loader(test_ds, BATCH,
                                                 num_workers=4))
        launches[f"test_{key}"] = kernels.SWTA_DELTA.launches
        check(launches[f"test_{key}"] == 0, f"(i) test {key} launched K1")
        check(metrics is not None and all(np.isfinite(v)
                                          for v in metrics.values()),
              f"(i) test {key} metrics {metrics}")
        check(0.0 <= metrics["segm/dice"] <= 1.0
              and 0.0 <= metrics["segm/jaccard"] <= 1.0,
              f"(i) test {key} metrics out of range: {metrics}")
        tests[key] = metrics
        log(f"(i) test {key}: Dice {metrics['segm/dice']:.4f} Jaccard "
            f"{metrics['segm/jaccard']:.4f} HD95 {metrics['segm/95hd']:.3f}"
            f" ASSD {metrics['segm/asd']:.3f}")
    return launches, steady, profiled, steps, tests


# -- 7: the 3D Hebbian bootstrap on unet3d -----------------------------------

EXCLUDE_3D = ("conv", "dsv1", "dsv2", "dsv3", "dsv4", "out_conv",
              "out_sdf", "out_seg")


def synth_volumes(root, n_train, n_val, shape, seed=0):
    """``scripts/make_synth_data.py::make_3d``'s generator (image and mask,
    no SDF maps), written by the port's NRRD writer."""
    from hebbax_torch.data.nrrd_io import write_nrrd

    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        for sub in ("image", "mask"):
            os.makedirs(os.path.join(root, split, sub), exist_ok=True)
        for i in range(n):
            vol = rng.normal(100, 20, shape).astype(np.float32)
            xx, yy, zz = np.mgrid[: shape[0], : shape[1], : shape[2]]
            c = [s // 2 for s in shape]
            r = min(shape) // 4
            mask = (((xx - c[0]) ** 2 + (yy - c[1]) ** 2
                     + (zz - c[2]) ** 2) < r * r).astype(np.uint8) * 255
            vol[mask > 0] += 60
            name = f"v{i}.nrrd"
            write_nrrd(os.path.join(root, split, "image", name), vol)
            write_nrrd(os.path.join(root, split, "mask", name), mask)
    return root


def hebbian_unet3d(device, seed=0):
    from hebbax_torch.hebb.spec import HebbSpec
    from hebbax_torch.models import get_network
    from hebbax_torch.utils.seeding import make_generator

    spec = HebbSpec(mode="swta_t", k=K_TEMP, exclude=("conv",))
    return get_network(NET_3D, 1, 2, hebb=spec, device=device,
                       generator=make_generator(seed))


def bounds_3d(mod, w, x, y):
    """Bounds (ms) of one composed 3D delta: its FLOPs (2 per
    multiply-add of the unfold correlation) over the float32 SIMT peak,
    and its bytes (x, y and w read once, the delta written once) over
    HBM."""
    n, i = x.shape[:2]
    o = y.shape[1]
    taps = int(np.prod(w.shape[2:]))
    # a forward conv correlates every output voxel with I*taps inputs; a
    # transpose conv every input voxel with O*taps outputs
    voxels = n * int(np.prod((x if mod.transpose else y).shape[2:]))
    ops = 2.0 * voxels * i * o * taps
    nbytes = 4.0 * (x.numel() + y.numel() + 2 * w.numel())
    t_f32 = ops / PEAK_F32_FLOP_PER_S * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"f32": t_f32, "bytes": t_bytes, "ms": max(t_f32, t_bytes),
            "by": "operations" if t_f32 >= t_bytes else "bytes"}


def phase_3d_reference(device):
    """(j) Training forward of full-width unet3d at batch 2, 32^3 on the
    card against the same weights on the CPU: no K1 launch (every 3D
    delta is the composed rule), logits within 1e-4, deltas within 1e-3
    of each site's max|delta| (as in 3); then the composed delta at each
    of the 22 sites at batch 1 and the full patch, timed beside its
    bounds."""
    import torch
    from hebbax_torch.hebb import kernels, rules
    from hebbax_torch.hebb.surgery import pop_deltas

    gpu, cpu = hebbian_unet3d(device, seed=3), hebbian_unet3d("cpu", seed=3)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (2, 1, 32, 32, 32)).astype(np.float32))
    for m in (gpu, cpu):
        m.train()
    before = kernels.SWTA_DELTA.launches
    with torch.no_grad():
        out_g = gpu(x.to(device)).cpu()
        out_c = cpu(x)
    check(kernels.SWTA_DELTA.launches == before,
          "the card's 3D training forward launched K1")
    dg, dc = pop_deltas(gpu), pop_deltas(cpu)
    check(set(dg) == set(dc) and len(dg) == 22,
          f"3D delta sites differ: {len(dg)} vs {len(dc)}")
    logit_err = float((out_g - out_c).abs().max())
    check(logit_err <= 1e-4, f"unet3d logits card vs CPU differ by "
                             f"{logit_err}")
    worst = max(float((dg[n].cpu() - dc[n]).abs().max())
                / float(dc[n].abs().max()) for n in dc)
    check(worst <= 1e-3, f"unet3d deltas card vs CPU differ by {worst} of "
                         f"scale")
    log(f"(j) small-input reference unet3d: logits max abs diff "
        f"{logit_err:.3e}, deltas max diff / scale {worst:.3e}, 0 launches")
    del cpu, out_c, dc

    images = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (1, 1) + PATCH).astype(np.float32)).to(device)
    sites = capture_sites(gpu, images)
    check(len(sites) == 22, f"expected 22 unet3d sites, got {len(sites)}")
    rows = []
    log(f"{'site':30s} {'x shape':>24s} {'O':>5s} {'ms':>9s} "
        f"{'f32_ms':>8s} {'byte_ms':>8s} {'share':>6s}")
    for name, w, xs, ys, _ in sites:
        mod = gpu.get_submodule(name)

        def delta(mod=mod, w=w, xs=xs, ys=ys):
            return rules.compute_delta(mod.spec, w, xs, ys, mod.padding,
                                       mod.transpose, mod.stride)

        before = kernels.SWTA_DELTA.launches
        d = delta()
        torch.cuda.synchronize()
        check(kernels.SWTA_DELTA.launches == before,
              f"{name}: a 3D delta launched K1")
        check(bool(torch.isfinite(d).all()), f"{name}: non-finite delta")
        ms = cuda_time_ms(delta, warmup=1, iters=5)
        b = bounds_3d(mod, w, xs, ys)
        rows.append(dict(site=name, transpose=mod.transpose,
                         x=list(xs.shape), o=ys.shape[1], ms=ms,
                         bound_ms=b["ms"], bound_by=b["by"],
                         bound_f32_ms=b["f32"], bound_bytes_ms=b["bytes"]))
        log(f"{name:30s} {str(tuple(xs.shape)):>24s} {ys.shape[1]:5d} "
            f"{ms:9.3f} {b['f32']:8.3f} {b['bytes']:8.3f} "
            f"{b['ms'] / ms:6.1%}")
    del sites, gpu
    torch.cuda.empty_cache()
    return {"logits_max_abs": logit_err, "delta_max_rel": worst,
            "sites": rows}


def cli_base_3d(device, data_root):
    return ["--device", device, "--path_dataset", data_root,
            "--dataset_name", "Atrial", "--path_root_exp", RUN_DIR,
            "-n", NET_3D, "-b", "1", "-e", "2", "-w", "1",
            "--patch_size", ",".join(str(p) for p in PATCH),
            "--num_workers", "4"]


def phase_3d_pretrain(data_root, device="0"):
    """(k) pretrain_hebbian_unsup_3d on unet3d with the sweep's flags:
    no K1 launch, finite losses, the Hebbian kernels unchanged in epoch 0
    (lr 0) and changed in epoch 1, the head trained, last.ckpt; then
    steady and profiled steps."""
    import torch
    from hebbax_torch.cli import common3d
    from hebbax_torch.cli import pretrain_hebbian_unsup_3d as pretrain
    from hebbax_torch.hebb import kernels

    on = "cpu" if device == "cpu" else "cuda"
    args = pretrain.add_args(common3d.base_parser_3d()).parse_args(
        cli_base_3d(device, data_root) + [
            "--hebb_mode", "swta_t", "--hebb_inv_temp", str(int(K_TEMP)),
            "--exclude", *EXCLUDE_3D, "--optimizer", "adam", "-l", "1e-6"])
    trainer = pretrain.build(args)
    model = trainer.state.model
    watch = ("encoder.encoder1.conv1.weight", "decoder.upconv1.weight")
    w0 = {n: model.state_dict()[n].detach().clone() for n in watch}
    head0 = model.conv.weight.detach().clone()
    times, snaps = [], []
    raw_step = trainer.train_step

    def watched(state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, out = raw_step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        sd = state.model.state_dict()
        snaps.append({n: sd[n].detach().clone() for n in watch})
        return state, out

    trainer.train_step = watched
    kernels.SWTA_DELTA.launches = 0
    trainer.run()
    launches = kernels.SWTA_DELTA.launches
    per_epoch = len(trainer.loaders["train"])
    check(len(times) == 2 * per_epoch, f"(k) ran {len(times)} steps")
    check(launches == 0, f"(k) launched K1 {launches} times")
    for n in watch:
        check(all(torch.equal(s[n], w0[n]) for s in snaps[:per_epoch]),
              f"(k) {n} changed in epoch 0 (lr 0)")
        check(not torch.equal(snaps[-1][n], w0[n]),
              f"(k) {n} did not change in epoch 1")
    check(not torch.equal(model.conv.weight, head0),
          "(k) the head did not train")
    check(all_on(model, on), f"(k) a model tensor is off {on}")
    losses, ok = finite_losses(trainer)
    check(ok, f"(k) losses {losses}")
    snap = os.path.join(trainer.paths.checkpoints, "last.ckpt")
    check(os.path.exists(snap), "(k) wrote no last.ckpt")
    log(f"(k) pretrain_3d: {len(times)} steps, K1 launches {launches}, "
        f"step ms {[round(t, 3) for t in times]}, losses {losses}")
    steady = steady_step_ms(trainer, raw_step)
    profiled = profile_steps(trainer, raw_step, float(np.median(steady)))
    log("(k) profile " + json.dumps(profiled))
    return launches, snap, len(times), times, steady, profiled


def phase_3d_finetune(data_root, snap, device="0"):
    """(l) train_sup_3d --load_hebbian_weights at regime 50 with the base
    parser's SGD lr 0.1: the trunk equal to the snapshot before the first
    step, conv re-initialised, no K1 launch, finite losses, best_JI.ckpt;
    then steady and profiled steps."""
    import torch
    from hebbax_torch.cli import common3d
    from hebbax_torch.cli import train_sup_3d
    from hebbax_torch.hebb import kernels
    from hebbax_torch.hebb.layers import transposed_paths
    from hebbax_torch.utils.checkpoint import load_state_dict

    on = "cpu" if device == "cpu" else "cuda"
    args = train_sup_3d.add_args(common3d.base_parser_3d()).parse_args(
        cli_base_3d(device, data_root) + [
            "--load_hebbian_weights", snap, "--hebb_inv_temp",
            str(int(K_TEMP)), "--regime", "50"])
    trainer = train_sup_3d.build(args)
    model = trainer.state.model
    loaded, _ = load_state_dict(snap, transposed_paths(model))
    sd = model.state_dict()
    differ = [n for n, t in sd.items() if not n.startswith("conv.")
              and not torch.equal(t.cpu(), loaded[n])]
    check(not differ, f"(l) the trunk differs from the snapshot: "
                      f"{differ[:5]}")
    check(not torch.equal(sd["conv.weight"].cpu(), loaded["conv.weight"]),
          "(l) conv was not re-initialised")
    times = []
    raw_step = trainer.train_step
    trainer.train_step = timed_step(raw_step, times)
    kernels.SWTA_DELTA.launches = 0
    trainer.run()
    launches = kernels.SWTA_DELTA.launches
    check(launches == 0, f"(l) launched K1 {launches} times")
    check(all_on(model, on), f"(l) a model tensor is off {on}")
    losses, ok = finite_losses(trainer)
    check(ok, f"(l) losses {losses}")
    check(os.path.exists(os.path.join(trainer.paths.checkpoints,
                                      "best_JI.ckpt")),
          "(l) wrote no best_JI.ckpt")
    log(f"(l) sup_3d: {len(times)} steps, K1 launches {launches}, step ms "
        f"{[round(t, 3) for t in times]}, losses {losses}")
    steady = steady_step_ms(trainer, raw_step)
    profiled = profile_steps(trainer, raw_step, float(np.median(steady)))
    log("(l) profile " + json.dumps(profiled))
    return launches, trainer.paths.run, len(times), times, steady, profiled


def phase_3d_test(data_root, run, device="0"):
    """(m) test_3d on (l)'s best snapshot, post-processed: no K1 launch,
    Dice / Jaccard in [0, 1], HD95 / ASSD finite unless no volume had a
    non-empty prediction (then NaN, and said so)."""
    from hebbax_torch.cli import test_3d
    from hebbax_torch.data.nrrd_io import read_nrrd
    from hebbax_torch.hebb import kernels

    args = test_3d.build_parser().parse_args(
        ["--device", device, "--path_exp", run, "--path_dataset", data_root,
         "-n", NET_3D, "--hebbian_pretrain", "1", "--postprocessing",
         "True", "--patch_size", ",".join(str(p) for p in PATCH),
         "--patch_overlap", ",".join(str(p) for p in OVERLAP)])
    kernels.SWTA_DELTA.launches = 0
    res = test_3d.run_test(args)
    launches = kernels.SWTA_DELTA.launches
    check(launches == 0, f"(m) launched K1 {launches} times")
    check(0.0 <= res["dice"] <= 1.0 and 0.0 <= res["jaccard"] <= 1.0,
          f"(m) metrics out of range: {res}")
    pp = os.path.join(run, "test_seg_preds_postprocessed")
    nonempty = [n for n in sorted(os.listdir(pp))
                if read_nrrd(os.path.join(pp, n))[0].any()]
    if nonempty:
        check(np.isfinite(res["hd"]) and np.isfinite(res["sd"]),
              f"(m) HD95/ASSD not finite with non-empty predictions "
              f"{nonempty}: {res}")
    else:
        check(np.isnan(res["hd"]) and np.isnan(res["sd"]),
              f"(m) distances of empty predictions: {res}")
    log(f"(m) test_3d: Dice {res['dice']:.4f} Jaccard {res['jaccard']:.4f} "
        f"HD95 {res['hd']:.3f} ASSD {res['sd']:.3f} (non-empty predictions "
        f"{nonempty}; NaN distances mean none); seconds per volume: slider "
        f"{res['seconds']['slider']:.3f}, post-processing + distances "
        f"{res['seconds']['postprocess_eval']:.3f}")
    return launches, dict(res, nonempty=nonempty)


def phase_3d(card, device="0"):
    """Phase 7: (j)-(m) (``card``: the torch device of (j), ``device``
    the CLIs' flag); returns the launches by path and the
    ``hebbian_3d_path`` record."""
    data_root = synth_volumes(os.path.join(RUN_DIR, "data3d", "Atrial"),
                              N_TRAIN_3D, N_VAL_3D, VOLUME)
    ref = phase_3d_reference(card)
    l_k, snap, steps_k, times_k, steady_k, prof_k = phase_3d_pretrain(
        data_root, device)
    l_l, run, steps_l, times_l, steady_l, prof_l = phase_3d_finetune(
        data_root, snap, device)
    l_m, test = phase_3d_test(data_root, run, device)
    launches = {"pretrain_3d": l_k, "sup_3d": l_l, "test_3d": l_m}
    record = {
        "launches": launches, "steps": {"k": steps_k, "l": steps_l},
        "step_ms": {"k": times_k, "l": times_l},
        "steady_step_ms": summary({"k": steady_k, "l": steady_l}),
        "profile": profile_summary({"k": prof_k, "l": prof_l}),
        "card_vs_cpu": {k: ref[k] for k in ("logits_max_abs",
                                            "delta_max_rel")},
        "delta_sites": ref["sites"],
        "delta_sites_ms": sum(r["ms"] for r in ref["sites"]),
        "delta_sites_bound_ms": sum(r["bound_ms"] for r in ref["sites"]),
        "test": test, "patch": list(PATCH), "volume": list(VOLUME)}
    return launches, record


def profile_summary(profiled):
    return {k: {"device_ms": v["device_ms"], "busy_share": v["busy_share"],
                "groups_ms": v["groups_ms"], "top_ms": v["top_ms"][:3]}
            for k, v in profiled.items()}


def summary(steady):
    return {k: {"median": float(np.median(v)), "min": min(v), "max": max(v)}
            for k, v in steady.items()}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 2
    from hebbax_torch import build
    from hebbax_torch.cli.common import resolve_device

    device = resolve_device("0")          # TF32 off for cuDNN and matmul
    torch.manual_seed(0)

    t0 = time.perf_counter()
    built = build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s for "
        f"{sorted(build.LIBRARIES)} (compiled now: {sorted(built)})")
    for name, info in built.items():
        log(f"--- nvcc {name} ({info['seconds']:.2f} s)\n{info['log']}")

    items = synth_items(N_TRAIN, N_VAL, SIZE)
    from hebbax_torch.config.datasets import dataset_cfg, input_stats
    from hebbax_torch.data.augment2d import normalize
    mean, std = input_stats(dataset_cfg("GlaS"), "image")
    images = torch.from_numpy(np.stack(
        [normalize(img, mean, std) for _, img, _ in
         items["train"][:BATCH]])).permute(0, 3, 1, 2).contiguous().to(
        device)

    rows = phase_sites(device, images)
    phase_small_reference(device)
    phase_deep4_reference(device)
    launches, run_a = phase_main_path(items)
    l_d, snaps, steady_d, steps_d = phase_deep4_pretrain(items)
    launches.update(l_d)
    snaps["unet"] = os.path.join(run_a, "checkpoints", "last.ckpt")
    l_e, steady_e, steps_e, tests = phase_semi(items, snaps)
    log("deep4_semi_path " + json.dumps({
        "launches": {**l_d, **l_e}, "steps": {**steps_d, **steps_e},
        "steady_step_ms": summary({**steady_d, **steady_e}),
        "test": tests}))

    errs_g = phase_unsup_reference(device)
    l_h, unsup_snaps, steady_h, prof_h, steps_h, prep = \
        phase_unsup_pretrain(items)
    l_i, steady_i, prof_i, steps_i, tests_i = phase_unsup_em(items,
                                                             unsup_snaps)
    launches.update(l_h)
    launches.update(l_i)
    log("unsup_baseline_path " + json.dumps({
        "launches": {**l_h, **l_i}, "steps": {**steps_h, **steps_i},
        "steady_step_ms": summary({**steady_h, **steady_i}),
        "profile": profile_summary({**prof_h, **prof_i}),
        "superpix_prep_ms": {"median": float(np.median(prep)),
                             "min": min(prep), "max": max(prep),
                             "batch": BATCH},
        "card_vs_cpu_max_abs": errs_g, "test": tests_i}))

    l_3d, record_3d = phase_3d(device)
    launches.update(l_3d)
    log("hebbian_3d_path " + json.dumps(record_3d))

    from hebbax_torch.hebb.kernels import SwtaDeltaKernel
    total = {key: sum(r[key] for r in rows)
             for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                         "bound_tc_ms", "bound_f32_ms", "bound_bytes_ms")}
    ops_ms = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
    kernels_line = {"kernels": [{
        "name": SwtaDeltaKernel.name,
        "route": "cuda",
        "source": SwtaDeltaKernel.source,
        "replaces": "hebbax/hebb/pallas_kernels.py:93",
        "launches": launches["a"],
        "launches_by_path": {k: launches[k] for k in (
            "a", "urpc_pretrain", "cct_pretrain", "vae_pretrain",
            "superpix_pretrain", "superdiff_pretrain", "em_vae",
            "em_superpix", "test_em_vae", "test_em_superpix",
            "pretrain_3d", "sup_3d", "test_3d")},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": ("operations" if ops_ms >= total["bound_ms"] / 2
                     else "bytes"),
        "library_ms": total["library_ms"],
        "arith": "3xtf32",
        "bound_tc_ms": total["bound_tc_ms"],
        "bound_f32_ms": total["bound_f32_ms"],
        "bound_bytes_ms": total["bound_bytes_ms"],
        "sites": len(rows),
        "shapes": [r["shape"] for r in rows],
    }]}
    print(json.dumps(kernels_line), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index or 0}"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
