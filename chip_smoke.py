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
8. the 3D semi-supervised family over phase 7's volumes (which carry
   ``mask_sdf1`` maps from the port's ``mask_to_sdf``), with the sweep's
   network names, none reaching K1: (n) at batch 2, 32^3, a training
   forward of full-width ``unet3d_dtc``, ``unet3d_cct`` (the same
   perturbation draws on both) and a Hebbian ``unet3d_urpc`` (swta_t,
   K=50, heads excluded, channel dropout off) on the card against the
   CPU: every output within 1e-4 of max(1, max|output|), URPC's 18 deltas
   within 1e-3 of their site's max|delta|; (o)
   ``pretrain_hebbian_unsup_3d -n unet3d_urpc`` with (k)'s flags and 2
   patches per volume: ``conv1.conv1`` and ``up_concat1.conv.conv1``
   unchanged in epoch 0 and changed in epoch 1, the four ``dsv`` heads
   trained, ``last.ckpt``; (p) ``train_semi_3d`` at regime 50 with the
   sweep's flags (SGD, lr 0.1, dice, unsup weight 5, validation every
   epoch), batch 1, 96x96x80 patches, 2 patches per train and val volume,
   2 epochs, warmup 1: em / uamt / cps on ``unet3d_s2d`` from (k)'s
   snapshot, urpc on ``unet3d_urpc_s2d`` from (o)'s, cct on
   ``unet3d_cct_s2d_rc`` and dtc on ``unet3d_dtc_s2d`` from kaiming;
   gates as (e) plus the trunk equal to the Hebbian snapshot before the
   first step; then 10 steady and 3 profiled steps each and the peak
   ``torch.cuda.max_memory_allocated``; (q) ``test_3d --postprocessing
   True`` on each run's best_JI.ckpt, gates as (m); one ``semi_3d_path``
   line carries (n)–(q);
9. the rest of the paper's sweeps, none reaching K1 (0 launches on each
   path): (r) training forwards on the card against the CPU, full width:
   ``unet3d_vae`` (same eps) and ``unet3d_superpix`` at batch 2, 32^3;
   ``snn_vgg`` at batch 2, 128x128, T=20 in float64 with the same
   Poisson uniforms on both, its spike counts per site required equal
   and outputs and BNTT statistics within 1e-9 of max(1, max|value|);
   ``ann_vgg`` at batch 2, 128x128; the RAD-DINO ViT-B encoder at batch
   2, 224x224 and the decoder on the CPU's patch grid; the float32
   outputs within 1e-4 of max(1, max|output|); (s) ``pretrain_unsup_3d``
   vae / superpix / superdiff over phase 7's volumes with the 3D
   pretraining sweep's flags (Adam, lr 1e-4, batch 2, 96x96x80 patches,
   superdiff on their central 96x96 slice at 1000 timesteps), 2 patches
   per volume, 2 epochs: finite loss columns, last.ckpt, every non-head
   parameter moved, steady and profiled steps, peak memory, and the 3D
   superpixel prep timed apart; (t) ``train_semi_3d em -n unet3d_s2d
   --load_weights`` from (s)'s vae and superpix snapshots (batch 2, SGD
   lr 0.1, regime 50; the model equal to the snapshot before the first
   step), timed likewise, then ``test_3d --postprocessing True`` on
   each; (u) ``train_snn_sup_2d`` of ``snn_vgg`` at regime 20 and
   ``ann_vgg`` at regime 100 (batch 2, 128x128, Adam lr 1e-3), then
   ``test_snn_2d`` on each; (v) ``train_semi_raddino_decoder_2d`` at
   224x224, batch 2, regime 20 (the encoder frozen and unchanged), then
   ``test_raddino_decoder_2d``; one ``sweeps_tail_path`` line carries
   (r)-(v);
10. ``--dtype bfloat16`` and the run flags: (w) the bf16 2D main path:
   at batch 2, 32x32 an eval forward of bf16 ``unet`` on the card
   against the CPU (within 3e-2 of max(1, max|output|): cuDNN and oneDNN
   round bf16 convolutions apart) and against the card's float32 forward
   (must differ by > 1e-4); ``pretrain_hebbian_unsup_2d --dtype
   bfloat16`` with (a)'s flags (4 steps, K1 22 launches per step, every
   HConv's output bf16, parameters and statistics float32), then K1 at
   the 22 sites of a bf16 training forward on its float32 copies of the
   bf16 x and y against its plain version (TOL of max|delta|, two
   launches equal to the bit); ``train_sup_2d --dtype bfloat16`` from
   its snapshot and ``test_2d``; steady and profiled steps and peak
   memory; (x) the bf16 3D bootstrap: the same card-vs-CPU check on
   full-width ``unet3d`` at batch 1, 32^3, then (k) and (l) at ``--dtype
   bfloat16`` (no K1 launch, every HConv's output bf16), timed, profiled,
   peak memory; (y)
   ``train_sup_2d --resume 1 --device_augment 1`` for 1 epoch, then for 2
   with ``--profile_dir``: the second run trains epoch 2 alone, the trace
   is written, every augmented batch lies on the card; one
   ``bf16_flags_path`` line carries (w)-(y);
11. every Hebbian rule and the VNet family, none reaching K1 (0 launches
   on each path): at each site of a training forward of full-width
   ``unet`` (batch 2, 64x64), ``unet3d`` (batch 2, 32^3) and ``vnet``
   (its 4 strided down convs and 4 transpose up convs, batch 2, 32^3),
   each rule's delta on the card against the same rule on the CPU from
   the same tensors (hpca and contrastive on ``unet``; hpca_t, swta and
   contrastive on ``unet3d``; swta, hpca, hpca_t and contrastive on
   ``vnet``; contrastive with the batch reversed), within 1e-3 of
   max|delta|; a strided 2D CUDA call through the dispatcher equals the
   composed rule and leaves K1's count unchanged; card-vs-CPU training
   forwards of ``vnet``, ``vnet_dtc`` and ``vnet_cct`` (same draws) at
   batch 2, 32^3, within 1e-4 of max(1, max|output|); (z)
   ``pretrain_hebbian_unsup_2d -n unet --hebb_mode hpca`` and
   ``contrastive`` with (a)'s flags (4 steps each), then ``train_sup_2d
   --load_hebbian_weights`` and ``test_2d`` from the hpca snapshot; (aa)
   ``pretrain_hebbian_unsup_3d -n unet3d --exclude conv`` under hpca_t,
   swta (4 steps each, batch 1) and contrastive (2 steps at batch 2: at
   batch 1 its permutation is the identity and its delta 0) over phase
   7's volumes, the regime-50 half, one patch per volume; (ab) ``-n vnet
   --hebb_mode swta_t --exclude out_tr.conv2`` likewise, ``train_sup_3d
   -n vnet --load_hebbian_weights`` and ``test_3d``; (ac) ``train_semi_3d
   cct -n vnet_cct`` and ``dtc -n vnet_dtc`` from kaiming (4 steps each)
   and ``test_3d`` on each; every run's Hebbian kernels unchanged at lr 0
   and changed after (under contrastive, unless every permutation drawn
   was the identity), steady and profiled steps and peak memory; one
   ``rules_vnet_path`` line carries them;
12. print the ``{"kernels": [...]}`` line (with ``launches_by_path``: a,
   urpc_pretrain, cct_pretrain and the paths of 6 to 11), the card's
   name and power limit, and last ``{"ok": true, "device": {...}}``.

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
    reset_peak(on)
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
    peaks = {"a": peak_gib(on)}

    # (b) fine-tuning from (a)'s snapshot
    args = train_sup_2d.add_args(common.base_parser_2d()).parse_args(
        base + ["--load_hebbian_weights",
                os.path.join(run_a, "checkpoints", "last.ckpt"),
                "--regime", "50", "--debug", ""])
    reset_peak(on)
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
    peaks["b"] = peak_gib(on)

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
        "steady_step_ms": summary(steady), "peak_gib": peaks,
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


def share_cct_draws(cpu, gpu, device, seed=9):
    """CCT's perturbations take the same draws on both models: drawn on
    the CPU by ``cpu``'s forward (which must run first), then copied to
    ``device`` for ``gpu``'s."""
    from hebbax_torch.models.common import (CCT_PERTURB_KINDS,
                                            draw_perturbation)
    from hebbax_torch.utils.seeding import make_generator

    gen, draws = make_generator(seed), {}

    def draw_on_cpu(feats):
        for kind in CCT_PERTURB_KINDS:
            draws[kind] = [draw_perturbation(kind, f, gen) for f in feats]
        return draws

    cpu.draw_perturbations = draw_on_cpu
    gpu.draw_perturbations = lambda feats: {
        k: [d.to(device) for d in v] for k, v in draws.items()}


def phase_deep4_reference(device):
    """Training forward of unet_urpc and unet_cct at batch 2, 32x32 on the
    card (kernel) against the same weights on the CPU (plain version);
    CCT's perturbations take the same draws on both (drawn on the CPU)."""
    import torch
    from hebbax_torch.hebb import kernels
    from hebbax_torch.hebb.spec import HebbSpec
    from hebbax_torch.hebb.surgery import pop_deltas
    from hebbax_torch.models import get_network
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
            share_cct_draws(cpu, gpu, device)
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
    """``scripts/make_synth_data.py::make_3d``'s generator (image, mask and
    the ``mask_sdf1`` map DTC trains against, from the port's
    ``mask_to_sdf``), written by the port's NRRD writer."""
    from hebbax_torch.data.nrrd_io import write_nrrd
    from hebbax_torch.ops.distance import mask_to_sdf

    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        for sub in ("image", "mask", "mask_sdf1"):
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
            write_nrrd(os.path.join(root, split, "mask_sdf1", name),
                       mask_to_sdf(mask > 0).astype(np.float32))
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


def cli_base_3d(device, data_root, net=None):
    return ["--device", device, "--path_dataset", data_root,
            "--dataset_name", "Atrial", "--path_root_exp", RUN_DIR,
            "-n", net or NET_3D, "-b", "1", "-e", "2", "-w", "1",
            "--patch_size", ",".join(str(p) for p in PATCH),
            "--num_workers", "4"]


def record_permutations(model, watch):
    """{weight name: [the permutations its contrastive site drew]} for the
    ``watch`` kernels, filled as the model runs."""
    perms = {n: [] for n in watch}
    for n in watch:
        conv = model.get_submodule(n.rsplit(".", 1)[0])

        def recording(size, draw=conv.draw_permutation, seen=perms[n]):
            seen.append(draw(size))
            return seen[-1]
        conv.draw_permutation = recording
    return perms


def pretrain_3d(data_root, device, net, watch, heads, tag, extra=(),
                mode="swta_t", exclude=EXCLUDE_3D):
    """pretrain_hebbian_unsup_3d of ``net`` with the sweep's flags (rule
    ``mode``, the ``exclude`` list): no K1 launch, every HConv's output in
    the run's ``--dtype``, finite losses, the ``watch`` Hebbian kernels
    unchanged in epoch 0 (lr 0) and changed in epoch 1 (under contrastive
    unless every permutation the site drew was the identity: its two
    terms then cancel exactly), every ``heads`` weight trained,
    last.ckpt; then steady and profiled steps and the peak memory."""
    import torch
    from hebbax_torch.cli import common, common3d
    from hebbax_torch.cli import pretrain_hebbian_unsup_3d as pretrain
    from hebbax_torch.hebb import kernels

    on = "cpu" if device == "cpu" else "cuda"
    args = pretrain.add_args(common3d.base_parser_3d()).parse_args(
        cli_base_3d(device, data_root, net) + list(extra) + [
            "--hebb_mode", mode, "--hebb_inv_temp", str(int(K_TEMP)),
            "--exclude", *exclude, "--optimizer", "adam", "-l", "1e-6"])
    reset_peak(on)
    trainer = pretrain.build(args)
    model = trainer.state.model
    dtypes, hooks = conv_dtypes(model)
    perms = record_permutations(model, watch)
    sd0 = model.state_dict()
    w0 = {n: sd0[n].detach().clone() for n in watch}
    heads0 = {n: sd0[n].detach().clone() for n in heads}
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
    for h in hooks:
        h.remove()
    want = common.model_dtype(args) or torch.float32
    check(dtypes and set(dtypes) == {want},
          f"{tag} HConv outputs {set(dtypes)}, not {want}")
    per_epoch = len(trainer.loaders["train"])
    check(len(times) == 2 * per_epoch, f"{tag} ran {len(times)} steps")
    check(launches == 0, f"{tag} launched K1 {launches} times")
    for n in watch:
        check(all(torch.equal(s[n], w0[n]) for s in snaps[:per_epoch]),
              f"{tag} {n} changed in epoch 0 (lr 0)")
        moves = not all(torch.equal(p, torch.arange(len(p)))
                        for p in perms[n]) if mode == "contrastive" else True
        check(torch.equal(snaps[-1][n], w0[n]) != moves,
              f"{tag} {n}: changed in epoch 1 is "
              f"{not torch.equal(snaps[-1][n], w0[n])}, expected {moves}")
    sd = model.state_dict()
    for n in heads:
        check(not torch.equal(sd[n], heads0[n]),
              f"{tag} the head {n} did not train")
    check(all_on(model, on), f"{tag} a model tensor is off {on}")
    losses, ok = finite_losses(trainer)
    check(ok, f"{tag} losses {losses}")
    snap = os.path.join(trainer.paths.checkpoints, "last.ckpt")
    check(os.path.exists(snap), f"{tag} wrote no last.ckpt")
    log(f"{tag} pretrain {args.network}: {len(times)} steps, K1 launches "
        f"{launches}, step ms {[round(t, 3) for t in times]}, losses "
        f"{losses}")
    steady = steady_step_ms(trainer, raw_step)
    profiled = profile_steps(trainer, raw_step, float(np.median(steady)))
    log(f"{tag} profile " + json.dumps(profiled))
    log(f"{tag} peak memory {peak_gib(on)} GiB (torch.cuda."
        f"max_memory_allocated, the run and its timed steps)")
    return launches, snap, len(times), times, steady, profiled


def phase_3d_pretrain(data_root, device="0"):
    """(k) pretrain_hebbian_unsup_3d on unet3d (:func:`pretrain_3d`),
    watching ``encoder.encoder1.conv1`` and ``decoder.upconv1``."""
    return pretrain_3d(data_root, device, NET_3D,
                       ("encoder.encoder1.conv1.weight",
                        "decoder.upconv1.weight"), ("conv.weight",), "(k)")


def phase_3d_finetune(data_root, snap, device="0", extra=(), tag="(l)",
                      net=None, head="conv"):
    """(l) train_sup_3d --load_hebbian_weights at regime 50 with the base
    parser's SGD lr 0.1 (and the ``extra`` flags) on ``net`` (NET_3D): the
    trunk equal to the snapshot before the first step, the excluded
    ``head`` re-initialised, no K1 launch,
    every HConv's output in the run's ``--dtype``, finite losses,
    best_JI.ckpt; then steady and profiled steps and the peak memory."""
    import torch
    from hebbax_torch.cli import common, common3d
    from hebbax_torch.cli import train_sup_3d
    from hebbax_torch.hebb import kernels
    from hebbax_torch.hebb.layers import transposed_paths
    from hebbax_torch.utils.checkpoint import load_state_dict

    on = "cpu" if device == "cpu" else "cuda"
    args = train_sup_3d.add_args(common3d.base_parser_3d()).parse_args(
        cli_base_3d(device, data_root, net) + list(extra) + [
            "--load_hebbian_weights", snap, "--hebb_inv_temp",
            str(int(K_TEMP)), "--regime", "50"])
    reset_peak(on)
    trainer = train_sup_3d.build(args)
    model = trainer.state.model
    dtypes, hooks = conv_dtypes(model)
    loaded, _ = load_state_dict(snap, transposed_paths(model))
    sd = model.state_dict()
    differ = [n for n, t in sd.items() if not n.startswith(head + ".")
              and not torch.equal(t.cpu(), loaded[n])]
    check(not differ, f"{tag} the trunk differs from the snapshot: "
                      f"{differ[:5]}")
    check(not torch.equal(sd[head + ".weight"].cpu(),
                          loaded[head + ".weight"]),
          f"{tag} {head} was not re-initialised")
    times = []
    raw_step = trainer.train_step
    trainer.train_step = timed_step(raw_step, times)
    kernels.SWTA_DELTA.launches = 0
    trainer.run()
    launches = kernels.SWTA_DELTA.launches
    for h in hooks:
        h.remove()
    want = common.model_dtype(args) or torch.float32
    check(dtypes and set(dtypes) == {want},
          f"{tag} HConv outputs {set(dtypes)}, not {want}")
    check(launches == 0, f"{tag} launched K1 {launches} times")
    check(all_on(model, on), f"{tag} a model tensor is off {on}")
    losses, ok = finite_losses(trainer)
    check(ok, f"{tag} losses {losses}")
    check(os.path.exists(os.path.join(trainer.paths.checkpoints,
                                      "best_JI.ckpt")),
          f"{tag} wrote no best_JI.ckpt")
    log(f"{tag} sup_3d: {len(times)} steps, K1 launches {launches}, step ms "
        f"{[round(t, 3) for t in times]}, losses {losses}")
    steady = steady_step_ms(trainer, raw_step)
    profiled = profile_steps(trainer, raw_step, float(np.median(steady)))
    log(f"{tag} profile " + json.dumps(profiled))
    log(f"{tag} peak memory {peak_gib(on)} GiB (torch.cuda."
        f"max_memory_allocated, the run and its timed steps)")
    return launches, trainer.paths.run, len(times), times, steady, profiled


def phase_3d_test(data_root, run, device="0", net=None, hebbian=True,
                  tag="(m)"):
    """(m) test_3d on (l)'s best snapshot (or another run's, of ``net``),
    post-processed: no K1 launch, Dice / Jaccard in [0, 1], HD95 / ASSD
    finite unless no volume had a non-empty prediction (then NaN, and said
    so)."""
    from hebbax_torch.cli import test_3d
    from hebbax_torch.data.nrrd_io import read_nrrd
    from hebbax_torch.hebb import kernels

    args = test_3d.build_parser().parse_args(
        ["--device", device, "--path_exp", run, "--path_dataset", data_root,
         "-n", net or NET_3D, "--postprocessing", "True",
         "--patch_size", ",".join(str(p) for p in PATCH),
         "--patch_overlap", ",".join(str(p) for p in OVERLAP)]
        + (["--hebbian_pretrain", "1"] if hebbian else []))
    kernels.SWTA_DELTA.launches = 0
    res = test_3d.run_test(args)
    launches = kernels.SWTA_DELTA.launches
    check(launches == 0, f"{tag} launched K1 {launches} times")
    check(0.0 <= res["dice"] <= 1.0 and 0.0 <= res["jaccard"] <= 1.0,
          f"{tag} metrics out of range: {res}")
    pp = os.path.join(run, "test_seg_preds_postprocessed")
    nonempty = [n for n in sorted(os.listdir(pp))
                if read_nrrd(os.path.join(pp, n))[0].any()]
    if nonempty:
        check(np.isfinite(res["hd"]) and np.isfinite(res["sd"]),
              f"{tag} HD95/ASSD not finite with non-empty predictions "
              f"{nonempty}: {res}")
    else:
        check(np.isnan(res["hd"]) and np.isnan(res["sd"]),
              f"{tag} distances of empty predictions: {res}")
    log(f"{tag} test_3d {args.network}: Dice {res['dice']:.4f} Jaccard "
        f"{res['jaccard']:.4f} "
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
    return launches, record, data_root, snap


URPC_3D = "unet3d_urpc"
# (algo, network, the Hebbian snapshot it starts from: phase 7's (k), (o)
# or none) as reproduce_{hebbian_,}semi_supervised_3d.sh run them
SEMI_3D = (("em", "unet3d_s2d", "k"), ("uamt", "unet3d_s2d", "k"),
           ("cps", "unet3d_s2d", "k"), ("urpc", "unet3d_urpc_s2d", "o"),
           ("cct", "unet3d_cct_s2d_rc", None),
           ("dtc", "unet3d_dtc_s2d", None))
# phase 8 cuts steps, not width: 2 patches per train volume, 2 per val
SPV_3D_SEMI = ["--samples_per_volume_train", "2",
               "--samples_per_volume_val", "2"]


def phase_semi_3d_reference(device):
    """(n) Training forwards at batch 2, 32^3 on the card against the same
    weights on the CPU: full-width unet3d_dtc, unet3d_cct (the same
    perturbation draws on both) and a Hebbian unet3d_urpc (swta_t, K=50,
    its heads excluded; channel dropout off on both): every output within
    1e-4 of max(1, max|output|), URPC's 18 deltas within 1e-3 of each
    site's max|delta|, no K1 launch."""
    import torch
    from hebbax_torch.hebb import kernels
    from hebbax_torch.hebb.spec import HebbSpec
    from hebbax_torch.hebb.surgery import pop_deltas
    from hebbax_torch.models import get_network
    from hebbax_torch.ops.dropout import Dropout
    from hebbax_torch.utils.seeding import make_generator

    x = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (2, 1, 32, 32, 32)).astype(np.float32))
    out = {}
    for net in ("unet3d_dtc", "unet3d_cct", URPC_3D):
        spec = (HebbSpec(mode="swta_t", k=K_TEMP, exclude=EXCLUDE_3D)
                if net == URPC_3D else None)
        gpu, cpu = [get_network(net, 1, 2, hebb=spec, device=dev,
                                generator=make_generator(3))
                    for dev in (device, "cpu")]
        cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
        for m in (gpu, cpu):
            for mod in m.modules():
                if isinstance(mod, Dropout):
                    mod.p = 0.0         # dropout off: the streams differ
            m.train()
        if net == "unet3d_cct":
            share_cct_draws(cpu, gpu, device)
        with torch.no_grad():
            out_c = cpu(x)
            before = kernels.SWTA_DELTA.launches
            out_g = [o.cpu() for o in gpu(x.to(device))]
        check(kernels.SWTA_DELTA.launches == before,
              f"(n) {net}: the card's forward launched K1")
        rel = max(float((g - c).abs().max()) / max(1.0, float(c.abs().max()))
                  for g, c in zip(out_g, out_c))
        check(rel <= 1e-4, f"(n) {net}: outputs card vs CPU differ by {rel} "
                           f"of max(1, max|output|)")
        rec = {"outputs_max_rel": rel}
        if spec is not None:
            dg, dc = pop_deltas(gpu), pop_deltas(cpu)
            check(set(dg) == set(dc) and len(dg) == 18,
                  f"(n) {net}: delta sites differ: {len(dg)} vs {len(dc)}")
            rec["delta_max_rel"] = max(
                float((dg[n].cpu() - dc[n]).abs().max())
                / float(dc[n].abs().max()) for n in dc)
            check(rec["delta_max_rel"] <= 1e-3,
                  f"(n) {net}: deltas card vs CPU differ by "
                  f"{rec['delta_max_rel']} of scale")
        out[net] = rec
        log(f"(n) small-input reference {net}: " + json.dumps(rec)
            + ", 0 launches")
        del gpu, cpu, out_c, out_g
    torch.cuda.empty_cache()
    return out


def trunk_equal_to_snapshot(model, snap, exclude):
    """The entries of ``model`` outside ``exclude`` that differ from the
    snapshot ``snap``."""
    import torch
    from hebbax_torch.hebb.layers import transposed_paths
    from hebbax_torch.hebb.spec import is_excluded
    from hebbax_torch.utils.checkpoint import load_state_dict

    loaded, _ = load_state_dict(snap, transposed_paths(model))
    return [n for n, t in model.state_dict().items()
            if not is_excluded(tuple(n.split(".")[:-1]), tuple(exclude))
            and not torch.equal(t.cpu(), loaded[n])]


def phase_semi_3d_train(data_root, snaps, device="0", runs=SEMI_3D,
                        spv=SPV_3D_SEMI, tag="p", test_tag="q",
                        suffix="_3d"):
    """(p) train_semi_3d at regime 50 with the sweep's flags (SGD, lr 0.1,
    dice, unsup weight 5, validation every epoch), batch 1, 96x96x80
    patches, 2 epochs, warmup 1, each algorithm from its snapshot or from
    kaiming: no K1 launch, finite losses, best_JI.ckpt, the trunk equal
    to the Hebbian snapshot before the first step, for uamt / cps
    checkpoints2/last.ckpt, both models moved and model 2 unlike model 1;
    then steady and profiled steps and the peak memory; (q) test_3d on
    each run's best_JI.ckpt, as (m).  ``runs``, ``spv``, the tags and the
    launch keys' ``suffix`` serve phase 11's VNet runs too."""
    import gc

    import torch
    from hebbax_torch.cli import common3d, train_semi_3d
    from hebbax_torch.hebb import kernels

    on = "cpu" if device == "cpu" else "cuda"
    out = {k: {} for k in ("launches", "steps", "step_ms", "steady",
                           "profile", "peak_gib", "test")}
    for algo, net, src in runs:
        argv = cli_base_3d(device, data_root, net) + spv + [
            "--regime", "50", "--optimizer", "sgd", "-l", "0.1", "--loss",
            "dice", "--unsup_weight", "5", "--validate_iter", "1"]
        if src:
            argv += ["--load_hebbian_weights", snaps[src],
                     "--hebb_inv_temp", str(int(K_TEMP))]
        args = train_semi_3d.add_args(common3d.base_parser_3d(), algo)\
            .parse_args(argv)
        if on == "cuda":
            torch.cuda.reset_peak_memory_stats()
        trainer = train_semi_3d.build(args, algo)
        dual = algo in ("uamt", "cps")
        models = ([trainer.state.model1, trainer.state.model2] if dual
                  else [trainer.state.model])
        if src:
            differ = trunk_equal_to_snapshot(models[0], snaps[src],
                                             EXCLUDE_3D)
            check(not differ, f"({tag}) {algo}: the trunk differs from the "
                              f"snapshot: {differ[:5]}")
        watch = next(n for n, _ in models[0].named_parameters()
                     if n.endswith("conv1.weight"))
        w0 = [m.state_dict()[watch].detach().clone() for m in models]
        times = []
        raw_step = trainer.train_step
        trainer.train_step = timed_step(raw_step, times)
        kernels.SWTA_DELTA.launches = 0
        trainer.run()
        launches = kernels.SWTA_DELTA.launches
        out["launches"][f"{algo}{suffix}"] = launches
        check(launches == 0, f"({tag}) {algo} launched K1 {launches} times")
        check(all(all_on(m, on) for m in models),
              f"({tag}) {algo}: a model tensor is off {on}")
        losses, ok = finite_losses(trainer)
        check(ok, f"({tag}) {algo} losses {losses}")
        ckpts = trainer.paths.checkpoints
        check(os.path.exists(os.path.join(ckpts, "best_JI.ckpt")),
              f"({tag}) {algo} wrote no best_JI.ckpt")
        w1 = [m.state_dict()[watch] for m in models]
        check(not torch.equal(w1[0], w0[0]), f"({tag}) {algo}: model 1 "
                                             f"unchanged")
        if dual:
            check(os.path.exists(os.path.join(ckpts + "2", "last.ckpt")),
                  f"({tag}) {algo} wrote no checkpoints2/last.ckpt")
            check(not torch.equal(w1[1], w0[1]),
                  f"({tag}) {algo}: model 2 unchanged")
            check(not torch.equal(w1[1], w1[0]),
                  f"({tag}) {algo}: model 2 equals model 1")
        out["steps"][algo], out["step_ms"][algo] = len(times), times
        log(f"({tag}) {algo} on {net}: {len(times)} steps, K1 launches "
            f"{launches}, step ms {[round(t, 3) for t in times]}, losses "
            f"{losses}")
        out["steady"][algo] = steady_step_ms(trainer, raw_step)
        out["profile"][algo] = profile_steps(
            trainer, raw_step, float(np.median(out["steady"][algo])))
        log(f"({tag}) {algo} profile " + json.dumps(out["profile"][algo]))
        if on == "cuda":
            out["peak_gib"][algo] = torch.cuda.max_memory_allocated() / 2**30
            log(f"({tag}) {algo} peak memory {out['peak_gib'][algo]:.3f} "
                f"GiB (torch.cuda.max_memory_allocated, the run and its "
                f"timed steps)")
        run = trainer.paths.run
        del trainer, models, raw_step
        gc.collect()
        if on == "cuda":
            torch.cuda.empty_cache()
        l_q, out["test"][algo] = phase_3d_test(
            data_root, run, device, net=net, hebbian=bool(src),
            tag=f"({test_tag}) {algo}")
        out["launches"][f"test_{algo}{suffix}"] = l_q
    return out


def phase_semi_3d(card, data_root, snap_k, device="0"):
    """Phase 8: (n)-(q) over phase 7's volumes and (k)'s snapshot;
    returns the launches by path and the ``semi_3d_path`` record."""
    ref = phase_semi_3d_reference(card)
    l_o, snap_o, steps_o, times_o, steady_o, prof_o = pretrain_3d(
        data_root, device, URPC_3D,
        ("conv1.conv1.weight", "up_concat1.conv.conv1.weight"),
        tuple(f"dsv{i}.weight" for i in range(1, 5)), "(o)", SPV_3D_SEMI)
    semi = phase_semi_3d_train(data_root, {"k": snap_k, "o": snap_o},
                               device)
    launches = {"pretrain_3d_urpc": l_o, **semi["launches"]}
    record = {
        "launches": launches,
        "steps": {"o": steps_o, **semi["steps"]},
        "step_ms": {"o": times_o, **semi["step_ms"]},
        "steady_step_ms": summary({"o": steady_o, **semi["steady"]}),
        "profile": profile_summary({"o": prof_o, **semi["profile"]}),
        "peak_gib": semi["peak_gib"], "card_vs_cpu": ref,
        "test": semi["test"], "networks": {a: n for a, n, _ in SEMI_3D},
        "patch": list(PATCH), "spv": SPV_3D_SEMI}
    return launches, record


# -- 9: the rest of the sweeps ----------------------------------------------

# phase 9 cuts steps, not width: 2 patches per train and val volume
SPV_3D_TAIL = SPV_3D_SEMI
SNN_SIZE, RADDINO_SIZE = SIZE, 224
TAIL_REGIME = 20                # the SNN and RAD-DINO semi sweeps' largest


def max_rel(got, ref):
    """Largest |got - ref| over max(1, max|ref|)."""
    ref = ref.detach().cpu()
    return (float((got.detach().cpu() - ref).abs().max())
            / max(1.0, float(ref.abs().max())))


class SpikeCounter:
    """Counts the spikes of each LIF site while installed over
    ``hebbax_torch.models.snn.spike`` (called site by site, timestep by
    timestep)."""

    def __init__(self, n_sites):
        from hebbax_torch.models import snn
        self.snn, self.n_sites = snn, n_sites
        self.counts, self.calls = [0] * n_sites, 0

    def __enter__(self):
        self.orig = self.snn.spike

        def counted(x, grad_type="Linear"):
            out = self.orig(x, grad_type)
            self.counts[self.calls % self.n_sites] += int(out.sum())
            self.calls += 1
            return out
        self.snn.spike = counted
        return self

    def __exit__(self, *exc):
        self.snn.spike = self.orig


def phase_tail_reference(device):
    """(r) Training forwards at full width on the card against the same
    weights on the CPU, no K1 launch: unet3d_vae (the same eps) and
    unet3d_superpix at batch 2, 32^3; snn_vgg at batch 2, SNN_SIZE^2, T=20
    in float64 with the same Poisson uniforms (spike counts per site
    equal, outputs within 1e-9 of max(1, max|output|)); ann_vgg at batch
    2, SNN_SIZE^2; the RAD-DINO ViT-B encoder at batch 2, 224^2 and the
    decoder on the CPU's patch grid.  Outputs within 1e-4 of max(1,
    max|output|) unless said."""
    import torch
    from hebbax_torch.hebb import kernels
    from hebbax_torch.models import get_network, raddino, snn
    from hebbax_torch.utils.seeding import make_generator

    rng = np.random.default_rng(14)
    out = {}

    def pair(net, seed, in_ch=1):
        return [get_network(net, in_ch, 2, device=dev,
                            generator=make_generator(seed)).train()
                for dev in (device, "cpu")]

    def gate(name, pairs, tol=1e-4):
        errs = {k: max_rel(g, c) for k, (g, c) in pairs.items()}
        for k, e in errs.items():
            check(e <= tol, f"(r) {name} {k}: card vs CPU differ by {e} of "
                            f"max(1, max|output|)")
        out[name] = errs
        log(f"(r) small-input reference {name}: " + json.dumps(errs)
            + ", 0 launches")

    before = kernels.SWTA_DELTA.launches
    x3 = torch.from_numpy(rng.standard_normal((2, 1, 32, 32, 32)).astype(
        np.float32))
    eps = torch.from_numpy(rng.standard_normal((2, 1024, 2, 2, 2)).astype(
        np.float32))
    for net in ("unet3d_vae", "unet3d_superpix"):
        gpu, cpu = pair(net, 5)
        with torch.no_grad():
            if net == "unet3d_vae":
                oc = cpu(x3, eps=eps)
                og = gpu(x3.to(device), eps=eps.to(device))
                pairs = {k: (og[k], oc[k]) for k in oc}
            else:
                pairs = dict(zip(("seg", "superpix"),
                                 zip(gpu(x3.to(device)), cpu(x3))))
        gate(net, pairs)
        del gpu, cpu, pairs

    gpu, cpu = [m.double() for m in pair("snn_vgg", 6, in_ch=3)]
    x2 = torch.from_numpy(rng.uniform(-1, 1, (2, 3, SNN_SIZE, SNN_SIZE)))
    uni = torch.from_numpy(rng.uniform(0, 1, (cpu.timesteps,) + x2.shape))
    counts, ys = [], []
    with torch.no_grad():
        for m, dev in ((cpu, "cpu"), (gpu, device)):
            with SpikeCounter(len(snn.FEATURES) + 1) as sc:
                ys.append(m(x2.to(dev), uniforms=uni.to(dev)))
            counts.append(sc.counts)
    yc, yg = ys
    check(counts[0] == counts[1], f"(r) snn_vgg spike counts per site "
                                  f"differ: CPU {counts[0]}, card "
                                  f"{counts[1]}")
    check(sum(counts[0]) > 0, "(r) snn_vgg: no spike")
    stats = {k: (v, cpu.state_dict()[k]) for k, v in gpu.state_dict().items()
             if k.endswith(("_mean", "_var"))}
    gate("snn_vgg", {"output": (yg, yc), **stats}, tol=1e-9)
    out["snn_vgg"]["spikes_per_site"] = counts[0]
    log(f"(r) snn_vgg spikes per site over T={cpu.timesteps}, batch 2: "
        f"{counts[0]} (equal on both)")
    del gpu, cpu, ys, yg, yc, stats

    xa = torch.from_numpy(rng.standard_normal((2, 3, SNN_SIZE, SNN_SIZE))
                          .astype(np.float32))
    gpu, cpu = pair("ann_vgg", 7, in_ch=3)
    with torch.no_grad():
        gate("ann_vgg", {"output": (gpu(xa.to(device)), cpu(xa))})
    del gpu, cpu

    xr = torch.from_numpy(rng.standard_normal(
        (2, 3, RADDINO_SIZE, RADDINO_SIZE)).astype(np.float32))
    enc = [raddino.ViTEncoder(image_size=RADDINO_SIZE, device=dev,
                              generator=make_generator(8)).eval()
           for dev in (device, "cpu")]
    dec = [raddino.RadDinoDecoder(2, out_size=RADDINO_SIZE, device=dev,
                                  generator=make_generator(9)).train()
           for dev in (device, "cpu")]
    with torch.no_grad():
        tok_g, tok_c = enc[0](xr.to(device)), enc[1](xr)
        grid = raddino.reshape_patch_embeddings(tok_c, RADDINO_SIZE)
        pairs = {"tokens": (tok_g, tok_c),
                 "decoder": (dec[0](grid.to(device)), dec[1](grid))}
    gate("raddino", pairs)
    check(kernels.SWTA_DELTA.launches == before, "(r) a forward launched K1")
    del enc, dec, pairs
    release()
    return out


def run_path(trainer, tag, on, watch=()):
    """Run ``trainer`` with its K1 launch count zeroed just before and read
    just after: no launch, finite losses, best_JI.ckpt and last.ckpt, the
    ``watch`` parameters moved; then 10 steady and 3 profiled steps, and
    the peak memory of the run and its timed steps."""
    import torch
    from hebbax_torch.hebb import kernels

    model = trainer.state.model
    sd0 = model.state_dict()
    w0 = {n: sd0[n].detach().clone() for n in watch}
    times = []
    raw_step = trainer.train_step
    trainer.train_step = timed_step(raw_step, times)
    kernels.SWTA_DELTA.launches = 0
    trainer.run()
    launches = kernels.SWTA_DELTA.launches
    check(launches == 0, f"{tag} launched K1 {launches} times")
    check(all_on(model, on), f"{tag}: a model tensor is off {on}")
    losses, ok = finite_losses(trainer)
    check(ok, f"{tag} losses {losses}")
    for name in ("best_JI.ckpt", "last.ckpt"):
        check(os.path.exists(os.path.join(trainer.paths.checkpoints, name)),
              f"{tag} wrote no {name}")
    sd = model.state_dict()
    still = [n for n in watch if torch.equal(sd[n], w0[n])]
    check(not still, f"{tag}: {still[:5]} ({len(still)}) did not move")
    log(f"{tag}: {len(times)} steps, K1 launches {launches}, step ms "
        f"{[round(t, 3) for t in times]}, losses {losses}")
    steady = steady_step_ms(trainer, raw_step)
    profiled = profile_steps(trainer, raw_step, float(np.median(steady)))
    log(f"{tag} profile " + json.dumps(profiled))
    peak = (torch.cuda.max_memory_allocated() / 2**30 if on == "cuda"
            else None)
    if peak is not None:
        log(f"{tag} peak memory {peak:.3f} GiB (torch.cuda."
            f"max_memory_allocated, the run and its timed steps)")
    return {"launches": launches, "steps": len(times), "step_ms": times,
            "steady": steady, "profile": profiled, "peak_gib": peak,
            "run": trainer.paths.run}


def release():
    """Free what the caller dropped before the next path allocates."""
    import gc

    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reset_peak(on):
    import torch
    if on == "cuda":
        torch.cuda.reset_peak_memory_stats()


def phase_unsup_3d(data_root, device="0"):
    """(s) pretrain_unsup_3d vae / superpix / superdiff with the 3D
    pretraining sweep's flags (Adam, lr 1e-4, dice, batch 2, 96x96x80
    patches, validation every epoch; superdiff on the patches' central
    96x96 z-slice at 1000 timesteps), 2 patches per volume, 2 epochs,
    warmup 1: no K1 launch, finite loss columns, last.ckpt, every
    non-head parameter moved; steady and profiled steps, peak memory, and
    the 3D superpixel prep timed apart over 10 batches."""
    import torch
    from hebbax_torch.cli import common3d
    from hebbax_torch.cli import pretrain_unsup_3d as unsup3d

    on = "cpu" if device == "cpu" else "cuda"
    out, snaps, prep = {}, {}, None
    for kind in unsup3d.KINDS:
        key = f"{kind}3d_pretrain"
        args = unsup3d.add_args(common3d.base_parser_3d(), kind).parse_args(
            cli_base_3d(device, data_root, unsup3d.NETWORK_DEFAULT[kind])
            + SPV_3D_TAIL + ["-b", "2", "--optimizer", "adam", "-l", "1e-4",
                             "--loss", "dice", "--validate_iter", "1"])
        reset_peak(on)
        trainer = unsup3d.build(args, kind)
        model = trainer.state.model
        heads = tuple(h + "." for h in unsup3d.HEADS_3D[kind])
        p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        tag = f"(s) {key}"
        rec = run_path(trainer, tag, on)
        cols = ["loss", "loss_unsup"] + (["loss_superdiff"]
                                         if kind == "superdiff" else [])
        rows = trainer.train_log.rows
        check(len(rows) == 2 and all(np.isfinite(r[c]) for r in rows
                                     for c in cols),
              f"{tag} train_log {[{c: r[c] for c in cols} for r in rows]}")
        still = [n for n, p in model.named_parameters()
                 if not n.startswith(heads) and torch.equal(p, p0[n])]
        check(not still, f"{tag}: non-head parameters did not move: "
                         f"{still[:5]} ({len(still)})")
        snaps[kind] = os.path.join(trainer.paths.checkpoints, "last.ckpt")
        if kind == "superpix":
            batches = []
            while len(batches) < 10:
                batches.extend(trainer.loaders["train"])
            prep = []
            for batch in batches[:10]:
                t0 = time.perf_counter()
                unsup3d.superpix_masks_3d(batch["image"], args.seed)
                prep.append((time.perf_counter() - t0) * 1e3)
            log(f"(s) 3D superpix prep ms (10 batches of 2 patches "
                f"{list(args.patch_size)}) {[round(t, 3) for t in prep]}")
        out[key] = rec
        del trainer, model, p0
        release()
    return out, snaps, prep


def phase_em_3d(data_root, snaps, device="0"):
    """(t) train_semi_3d em -n unet3d_s2d --load_weights on (s)'s vae and
    superpix last.ckpt with the 3D semi sweep's flags (SGD, lr 0.1, dice,
    unsup weight 5, batch 2, regime 50, validation every epoch), 2
    patches per volume, 2 epochs: the model equal to the snapshot before
    the first step (every entry it has, the head ``conv`` included; the
    baseline's extras dropped), then run_path's gates; then test_3d
    --postprocessing True on each run's best_JI.ckpt."""
    from hebbax_torch.cli import common3d, train_semi_3d

    on = "cpu" if device == "cpu" else "cuda"
    out, tests = {}, {}
    for kind in ("vae", "superpix"):
        key = f"em3d_{kind}"
        args = train_semi_3d.add_args(common3d.base_parser_3d(), "em")\
            .parse_args(cli_base_3d(device, data_root, "unet3d_s2d")
                        + SPV_3D_TAIL + [
                            "-b", "2", "--regime", "50", "--optimizer",
                            "sgd", "-l", "0.1", "--loss", "dice",
                            "--unsup_weight", "5", "--validate_iter", "1",
                            "--load_weights", snaps[kind]])
        reset_peak(on)
        trainer = train_semi_3d.build(args, "em")
        differ = trunk_equal_to_snapshot(trainer.state.model, snaps[kind], ())
        check(not differ, f"(t) {key}: the model differs from the "
                          f"snapshot: {differ[:5]}")
        out[key] = run_path(trainer, f"(t) {key}", on,
                            watch=("encoder.encoder1.conv1.weight",))
        del trainer
        release()
        out[f"test_{key}"], tests[key] = phase_3d_test(
            data_root, out[key]["run"], device, net="unet3d_s2d",
            hebbian=False, tag=f"(t) test {key}")
    return out, tests


def phase_snn(items, device="0"):
    """(u) train_snn_sup_2d at batch 2, SNN_SIZE^2 with the SNN sweeps'
    flags (Adam, lr 1e-3, dice, validation every 2 epochs): snn_vgg at
    regime TAIL_REGIME (``semi_sup/kaiming_snn_vgg``) and ann_vgg at 100
    (``fully_sup/ann_vgg``), 2 epochs, warmup 1, run_path's gates; then
    test_snn_2d --best JI on each."""
    from hebbax_torch.cli import common, test_snn_2d, train_snn_sup_2d
    from hebbax_torch.config.datasets import dataset_cfg, input_stats
    from hebbax_torch.data import Loader
    from hebbax_torch.hebb import kernels

    on = "cpu" if device == "cpu" else "cuda"
    out, tests = {}, {}
    mean, std = input_stats(dataset_cfg("GlaS"), "image")
    for net, regime in (("snn_vgg", TAIL_REGIME), ("ann_vgg", 100)):
        key = f"{net}_sup"
        args = train_snn_sup_2d.add_args(common.base_parser_2d(
            {"network": "snn_vgg"})).parse_args(cli_base(device) + [
                "-n", net, "-b", "2", "--regime", str(regime),
                "--optimizer", "adam", "-l", "1e-3", "--loss", "dice",
                "--validate_iter", "2", "--debug", ""])
        reset_peak(on)
        trainer = train_snn_sup_2d.build(args, make_loaders(items, args,
                                                            regime))
        phase = "semi_sup" if regime < 100 else "fully_sup"
        tag = f"kaiming_{net}" if regime < 100 else net
        check(os.path.relpath(trainer.paths.run, RUN_DIR) == os.path.join(
            "GlaS", phase, tag, "inv_temp-1", f"regime-{regime}", "run-0"),
            f"(u) {key} run dir {trainer.paths.run}")
        watch = ("feat0", "cls_atrous") if net == "snn_vgg" else (
            "feat0.weight", "cls_atrous.weight")
        out[key] = run_path(trainer, f"(u) {key}", on, watch=watch)
        del trainer
        release()
        test_ds = array_dataset_class()(items["val"], mean, std, "test")
        kernels.SWTA_DELTA.launches = 0
        argv = ["--device", device, "--path_exp", out[key]["run"],
                "--best", "JI", "-b", "2", "--num_workers", "4"]
        metrics = test_snn_2d.main(
            argv + ([] if net == "snn_vgg" else ["-n", net]),
            Loader(test_ds, 2, num_workers=4))
        out[f"test_{net}"] = kernels.SWTA_DELTA.launches
        check(out[f"test_{net}"] == 0, f"(u) test {net} launched K1")
        check(metrics is not None and all(np.isfinite(v)
                                          for v in metrics.values())
              and 0.0 <= metrics["segm/dice"] <= 1.0,
              f"(u) test {net} metrics {metrics}")
        tests[net] = metrics
        log(f"(u) test {net}: Dice {metrics['segm/dice']:.4f} Jaccard "
            f"{metrics['segm/jaccard']:.4f}")
    return out, tests


def phase_raddino(items, device="0"):
    """(v) train_semi_raddino_decoder_2d with the sweep's flags (Adam, lr
    1e-3, dice, unsup weight 5, batch 2, regime TAIL_REGIME, validation
    every 2 epochs) at 224^2, 2 epochs, warmup 1: run_path's gates, the
    ViT-B encoder frozen and unchanged, the decoder moved; then
    test_raddino_decoder_2d --best JI (its encoder from seed 0, as
    hebbax's tester)."""
    import torch
    from hebbax_torch.cli import common
    from hebbax_torch.cli import test_raddino_decoder_2d as rtest
    from hebbax_torch.cli import train_semi_raddino_decoder_2d as rtrain
    from hebbax_torch.config.datasets import dataset_cfg, input_stats
    from hebbax_torch.data import Loader
    from hebbax_torch.hebb import kernels

    on = "cpu" if device == "cpu" else "cuda"
    args = rtrain.add_args(common.base_parser_2d()).parse_args(
        cli_base(device) + ["-b", "2", "--regime", str(TAIL_REGIME),
                            "--optimizer", "adam", "-l", "1e-3", "--loss",
                            "dice", "--unsup_weight", "5",
                            "--validate_iter", "2", "--debug", ""])
    reset_peak(on)
    trainer = rtrain.build(args, make_semi_loaders(items, args, TAIL_REGIME),
                           image_size=RADDINO_SIZE)
    check(not trainer.encoder_pretrained, "(v) the encoder is not random")
    enc0 = {k: v.clone() for k, v in trainer.encoder.state_dict().items()}
    check(not any(p.requires_grad for p in trainer.encoder.parameters()),
          "(v) an encoder parameter takes grad")
    out = {"raddino_semi": run_path(
        trainer, "(v) raddino_semi", on,
        watch=("deconv1.weight", "out.weight", "bn1.weight"))}
    check(all(torch.equal(v, enc0[k])
              for k, v in trainer.encoder.state_dict().items()),
          "(v) the frozen encoder moved")
    del trainer, enc0
    release()
    mean, std = input_stats(dataset_cfg("GlaS"), "image")
    test_ds = array_dataset_class()(items["val"], mean, std, "test",
                                    size=(RADDINO_SIZE, RADDINO_SIZE))
    kernels.SWTA_DELTA.launches = 0
    metrics = rtest.run_test(rtest.build_parser().parse_args(
        ["--device", device, "--path_exp", out["raddino_semi"]["run"],
         "--best", "JI", "-b", "2", "--num_workers", "4"]),
        Loader(test_ds, 2, num_workers=4), image_size=RADDINO_SIZE)
    out["test_raddino"] = kernels.SWTA_DELTA.launches
    check(out["test_raddino"] == 0, "(v) the tester launched K1")
    check(all(np.isfinite(v) for v in metrics.values())
          and 0.0 <= metrics["segm/dice"] <= 1.0,
          f"(v) test metrics {metrics}")
    log(f"(v) test raddino: Dice {metrics['segm/dice']:.4f} Jaccard "
        f"{metrics['segm/jaccard']:.4f}")
    return out, metrics


def phase_sweeps_tail(card, items, data_root, device="0"):
    """Phase 9: (r)-(v) over phase 4's images and phase 7's volumes;
    returns the launches by path and the ``sweeps_tail_path`` record."""
    ref = phase_tail_reference(card)
    rec_s, snaps, prep = phase_unsup_3d(data_root, device)
    rec_t, tests_t = phase_em_3d(data_root, snaps, device)
    rec_u, tests_u = phase_snn(items, device)
    rec_v, test_v = phase_raddino(items, device)
    paths = {**rec_s, **rec_t, **rec_u, **rec_v}
    launches = {k: (v["launches"] if isinstance(v, dict) else v)
                for k, v in paths.items()}
    runs = {k: v for k, v in paths.items() if isinstance(v, dict)}
    record = {
        "launches": launches,
        "steps": {k: v["steps"] for k, v in runs.items()},
        "step_ms": {k: v["step_ms"] for k, v in runs.items()},
        "steady_step_ms": summary({k: v["steady"] for k, v in runs.items()}),
        "profile": profile_summary({k: v["profile"]
                                    for k, v in runs.items()}),
        "peak_gib": {k: v["peak_gib"] for k, v in runs.items()},
        "superpix3d_prep_ms": {"median": float(np.median(prep)),
                               "min": min(prep), "max": max(prep),
                               "batch": 2},
        "card_vs_cpu": ref,
        "test": {**tests_t, **tests_u, "raddino": test_v},
        "patch": list(PATCH), "snn_size": SNN_SIZE,
        "raddino_size": RADDINO_SIZE}
    return launches, record


BF16_ROOT = os.path.join(RUN_DIR, "bf16")
BF16_TOL = 3e-2     # card vs CPU at bf16, of max(1, max|output|)


def peak_gib(on):
    """Peak ``torch.cuda.max_memory_allocated`` since the last
    :func:`reset_peak`, in GiB (None on the CPU)."""
    import torch
    return torch.cuda.max_memory_allocated() / 2**30 if on == "cuda" \
        else None


def bf16_argv(argv):
    """A CLI argv at ``--dtype bfloat16`` whose runs land under
    ``build/chip_smoke/bf16`` (apart from the float32 paths' runs)."""
    out = list(argv)
    out[out.index("--path_root_exp") + 1] = BF16_ROOT
    return out + ["--dtype", "bfloat16"]


def bf16_reference(name, make, x, device):
    """An eval forward of the bf16 network ``make(dtype, device)`` on the
    card against the same weights at bf16 on the CPU (within BF16_TOL of
    max(1, max|output|): cuDNN and oneDNN round bf16 convolutions apart)
    and against the card's own float32 forward (must differ by > 1e-4)."""
    import torch
    gpu, cpu = make(torch.bfloat16, device), make(torch.bfloat16, "cpu")
    f32 = make(None, device)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    f32.load_state_dict(gpu.state_dict())
    outs = []
    for m, dev in ((gpu, device), (cpu, "cpu"), (f32, device)):
        m.eval()
        with torch.no_grad():
            outs.append(m(x.to(dev)).float().cpu())
    scale = max(1.0, float(outs[1].abs().max()))
    err = float((outs[0] - outs[1]).abs().max()) / scale
    cast = float((outs[0] - outs[2]).abs().max())
    check(np.isfinite(err) and err <= BF16_TOL,
          f"{name} bf16 card vs CPU differ by {err} of scale")
    check(cast > 1e-4, f"{name} bf16 forward equals the float32 one "
                       f"({cast})")
    log(f"bf16 small-input reference {name}: card vs CPU {err:.3e} of "
        f"scale, bf16 vs float32 on the card {cast:.3e}")
    del gpu, cpu, f32
    release()
    return {"card_vs_cpu": err, "bf16_vs_f32": cast}


def conv_dtypes(model):
    """Forward hooks recording the output dtype of every HConv; returns
    (the list they fill, their handles)."""
    from hebbax_torch.hebb.layers import HConv
    seen, hooks = [], []
    for m in model.modules():
        if isinstance(m, HConv):
            hooks.append(m.register_forward_hook(
                lambda mod, i, o: seen.append(o.dtype)))
    return seen, hooks


def bf16_sites(model, images):
    """The float32 copies K1 takes at each Hebbian site of a bf16
    training forward: the raw weight, the bf16-cast input, the bf16
    output."""
    import torch
    sites = []
    for name, w, x, y, pad in capture_sites(model, images):
        sites.append((name, w, x.to(torch.bfloat16).float().contiguous(),
                      y.float().contiguous(), pad, y.dtype))
    return sites


def phase_bf16_2d(items, device="0"):
    """(w) The bf16 2D main path: card-vs-CPU bf16 forward of ``unet``;
    ``pretrain_hebbian_unsup_2d --dtype bfloat16`` as (a) (22 launches
    per step, every HConv computing in bf16), K1 against its plain version
    on a training forward's float32 copies of the bf16 x and y (TOL of
    max|delta|, two launches equal to the bit); then ``train_sup_2d
    --dtype bfloat16`` from its snapshot and ``test_2d``, each timed and
    profiled like (a) and (b), with its peak memory."""
    import torch
    from hebbax_torch.cli import common
    from hebbax_torch.cli import pretrain_hebbian_unsup_2d as pretrain
    from hebbax_torch.cli import test_2d
    from hebbax_torch.cli import train_sup_2d
    from hebbax_torch.hebb import kernels, rules
    from hebbax_torch.hebb.spec import HebbSpec
    from hebbax_torch.models import get_network
    from hebbax_torch.utils.seeding import make_generator

    on = "cpu" if device == "cpu" else "cuda"
    card = torch.device("cuda", 0) if on == "cuda" else torch.device("cpu")

    def make(dtype, dev):
        return get_network("unet", 3, 2, device=dev, dtype=dtype,
                           generator=make_generator(3))

    ref = bf16_reference("unet", make, torch.from_numpy(
        np.random.default_rng(7).standard_normal(
            (2, 3, 32, 32)).astype(np.float32)), card)
    launches, record = {}, {"reference": ref}

    # (w) pretraining
    args = pretrain.add_args(common.base_parser_2d()).parse_args(bf16_argv(
        cli_base(device) + [
            "-n", "unet", "--exclude", "out_conv", "--hebb_mode", "swta_t",
            "--hebb_inv_temp", str(int(K_TEMP)), "--optimizer", "adam",
            "-l", "1e-6", "--debug", ""]))
    reset_peak(on)
    trainer = pretrain.build(args, make_loaders(items, args, 100))
    model = trainer.state.model
    dtypes, hooks = conv_dtypes(model)
    times = []
    raw_step = trainer.train_step
    trainer.train_step = timed_step(raw_step, times)
    kernels.SWTA_DELTA.launches = 0
    trainer.run()
    launches["bf16_pretrain"] = kernels.SWTA_DELTA.launches
    for h in hooks:
        h.remove()
    check(len(times) == 4, f"(w) pretrain ran {len(times)} steps")
    check(launches["bf16_pretrain"] == 22 * len(times),
          f"(w) launched K1 {launches['bf16_pretrain']} times, expected "
          f"22 x {len(times)}")
    check(dtypes and all(d == torch.bfloat16 for d in dtypes),
          f"(w) an HConv ran in {set(dtypes)}")
    check(all(t.dtype == torch.float32 for t in
              list(model.parameters()) + list(model.buffers())),
          "(w) a parameter or statistic left float32")
    check(all_on(model, on), f"(w) a model tensor is off {on}")
    losses, ok = finite_losses(trainer)
    check(ok, f"(w) pretrain losses {losses}")
    snap = os.path.join(trainer.paths.checkpoints, "last.ckpt")
    log(f"(w) bf16 pretrain: {len(times)} steps, K1 launches "
        f"{launches['bf16_pretrain']}, {len(dtypes)} HConv outputs all "
        f"bfloat16, step ms {[round(t, 3) for t in times]}, losses "
        f"{losses}")
    steady = {"w_pretrain": steady_step_ms(trainer, raw_step)}
    profiled = {"w_pretrain": profile_steps(
        trainer, raw_step, float(np.median(steady["w_pretrain"])))}
    peaks = {"w_pretrain": peak_gib(on)}
    log("(w) pretrain profile " + json.dumps(profiled["w_pretrain"]))

    # K1 on the bf16 path's float32 copies
    batch = trainer.prep(next(iter(trainer.loaders["train"])))
    rows = []
    for name, w, x, y, pad, ydt in bf16_sites(model, batch["image"]):
        check(ydt == torch.bfloat16, f"(w) {name} output is {ydt}")
        plain = rules.swta_conv_delta(w, x, y, K_TEMP, pad)
        got = kernels.SWTA_DELTA(w, x, y, K_TEMP, pad)
        again = kernels.SWTA_DELTA(w, x, y, K_TEMP, pad)
        if on == "cuda":
            torch.cuda.synchronize()
        err = float((got - plain).abs().max())
        scale = float(plain.abs().max())
        check(np.isfinite(err) and err <= TOL * scale,
              f"(w) {name}: K1 vs plain {err} > {TOL} * {scale}")
        check(torch.equal(got, again),
              f"(w) {name}: two launches on the same tensors differ")
        rows.append({"site": name, "rel_err": err / scale})
    check(len(rows) == 22, f"(w) {len(rows)} bf16 sites")
    worst = max(r["rel_err"] for r in rows)
    log(f"(w) K1 on the bf16 copies: 22 sites, worst error {worst:.3e} of "
        f"max|delta|, repeats equal to the bit")
    record["k1_bf16_worst_rel"] = worst
    del trainer, model
    release()

    # (w) fine-tuning and test
    args = train_sup_2d.add_args(common.base_parser_2d()).parse_args(
        bf16_argv(cli_base(device) + [
            "--load_hebbian_weights", snap, "--regime", "50",
            "--debug", ""]))
    reset_peak(on)
    trainer = train_sup_2d.build(args, make_loaders(items, args, 50))
    times_b = []
    raw_step = trainer.train_step
    trainer.train_step = timed_step(raw_step, times_b)
    kernels.SWTA_DELTA.launches = 0
    trainer.run()
    launches["bf16_sup"] = kernels.SWTA_DELTA.launches
    check(launches["bf16_sup"] == 0, "(w) fine-tuning launched K1")
    losses, ok = finite_losses(trainer)
    check(ok, f"(w) fine-tune losses {losses}")
    run_b = trainer.paths.run
    check(os.path.exists(os.path.join(run_b, "checkpoints", "best_JI.ckpt")),
          "(w) fine-tuning wrote no best_JI.ckpt")
    log(f"(w) bf16 fine-tune: {len(times_b)} steps, step ms "
        f"{[round(t, 3) for t in times_b]}, losses {losses}")
    steady["w_sup"] = steady_step_ms(trainer, raw_step)
    profiled["w_sup"] = profile_steps(trainer, raw_step,
                                      float(np.median(steady["w_sup"])))
    peaks["w_sup"] = peak_gib(on)
    log("(w) fine-tune profile " + json.dumps(profiled["w_sup"]))
    del trainer
    release()

    from hebbax_torch.config.datasets import dataset_cfg, input_stats
    from hebbax_torch.data import Loader
    targs = test_2d.build_parser().parse_args(
        ["--device", device, "--path_exp", run_b, "--hebbian_pretrain", "1",
         "-b", str(BATCH), "--num_workers", "4"])
    mean, std = input_stats(dataset_cfg("GlaS"), "image")
    test_ds = array_dataset_class()(items["val"], mean, std, "test")
    kernels.SWTA_DELTA.launches = 0
    metrics = test_2d.run_test(targs, Loader(test_ds, BATCH, num_workers=4))
    launches["bf16_test"] = kernels.SWTA_DELTA.launches
    check(metrics is not None and all(np.isfinite(v)
                                      for v in metrics.values())
          and 0.0 <= metrics["segm/dice"] <= 1.0,
          f"(w) test metrics {metrics}")
    log(f"(w) test of the bf16 run: Dice {metrics['segm/dice']:.4f} "
        f"Jaccard {metrics['segm/jaccard']:.4f}")
    record.update(launches=dict(launches), steady_step_ms=summary(steady),
                  profile=profile_summary(profiled), peak_gib=peaks,
                  test=metrics)
    return launches, record


def phase_bf16_3d(data_root, device="0"):
    """(x) The bf16 3D bootstrap: card-vs-CPU bf16 eval forward of
    full-width ``unet3d`` at batch 1, 32^3; (k) and (l) at ``--dtype
    bfloat16`` (the steps are (k)'s and (l)'s), no K1 launch, every HConv
    in bf16, steady and profiled steps and peak memory."""
    import torch
    from hebbax_torch.models import get_network
    from hebbax_torch.utils.seeding import make_generator

    on = "cpu" if device == "cpu" else "cuda"
    card = torch.device("cuda", 0) if on == "cuda" else torch.device("cpu")

    def make(dtype, dev):
        return get_network(NET_3D, 1, 2, device=dev, dtype=dtype,
                           generator=make_generator(3))

    ref = bf16_reference(NET_3D, make, torch.from_numpy(
        np.random.default_rng(11).standard_normal(
            (1, 1, 32, 32, 32)).astype(np.float32)), card)
    root_args = ["--dtype", "bfloat16"]
    reset_peak(on)
    l_k, snap, steps_k, times_k, steady_k, prof_k = pretrain_3d(
        data_root, device, NET_3D, ("encoder.encoder1.conv1.weight",
                                    "decoder.upconv1.weight"),
        ("conv.weight",), "(x)", extra=root_args
        + ["--path_root_exp", BF16_ROOT])
    peak_k = peak_gib(on)
    reset_peak(on)
    l_l, run, steps_l, times_l, steady_l, prof_l = phase_3d_finetune(
        data_root, snap, device, extra=root_args
        + ["--path_root_exp", BF16_ROOT], tag="(x) fine-tune")
    peak_l = peak_gib(on)
    launches = {"bf16_pretrain_3d": l_k, "bf16_sup_3d": l_l}
    log(f"(x) peak memory: pretrain {peak_k} GiB, fine-tune {peak_l} GiB")
    return launches, {
        "reference": ref, "launches": launches,
        "steps": {"x_pretrain": steps_k, "x_sup": steps_l},
        "steady_step_ms": summary({"x_pretrain": steady_k,
                                   "x_sup": steady_l}),
        "profile": profile_summary({"x_pretrain": prof_k,
                                    "x_sup": prof_l}),
        "peak_gib": {"x_pretrain": peak_k, "x_sup": peak_l}}


def phase_flags(items, device="0"):
    """(y) The run flags on the card: ``train_sup_2d --resume 1
    --device_augment 1`` for 1 epoch, then for 2 with ``--profile_dir``:
    the second run trains only epoch 2 (its log holds epoch 2 alone), the
    profile of that epoch is written, and every augmented batch lay on
    the card."""
    import torch
    from hebbax_torch.cli import common
    from hebbax_torch.cli import train_sup_2d
    from hebbax_torch.hebb import kernels
    from hebbax_torch.ops import augment_device

    on = "cpu" if device == "cpu" else "cuda"
    prof_dir = os.path.join(RUN_DIR, "flags_profile")
    shutil.rmtree(prof_dir, ignore_errors=True)
    devices = []
    orig = augment_device.augment_batch

    def watched(generator, images, masks=None):
        devices.append(images.device.type)
        return orig(generator, images, masks)

    augment_device.augment_batch = watched
    kernels.SWTA_DELTA.launches = 0
    try:
        runs = []
        for epochs, extra in ((1, []), (2, ["--profile_dir", prof_dir])):
            argv = cli_base(device) + ["-n", "unet", "--regime", "100",
                                       "--resume", "1", "--device_augment",
                                       "1", "--debug", ""] + extra
            argv[argv.index("-e") + 1] = str(epochs)
            argv[argv.index("--path_root_exp") + 1] = os.path.join(
                RUN_DIR, "flags")
            args = train_sup_2d.add_args(
                common.base_parser_2d()).parse_args(argv)
            trainer = train_sup_2d.build(args, make_loaders(items, args,
                                                            100))
            check(trainer.loaders["train"].dataset.host_augment is False,
                  "(y) --device_augment left host augmentation on")
            trainer.run()
            runs.append([r["epoch"] for r in trainer.train_log.rows])
    finally:
        augment_device.augment_batch = orig
    launches = kernels.SWTA_DELTA.launches
    check(launches == 0, f"(y) launched K1 {launches} times")
    check(runs == [[1], [2]], f"(y) the resumed run trained epochs {runs}")
    traces = [f for f in os.listdir(prof_dir)
              if os.path.getsize(os.path.join(prof_dir, f)) > 0]
    check(bool(traces), "(y) --profile_dir wrote no trace")
    check(devices and set(devices) == {on},
          f"(y) augmented batches lay on {set(devices)}")
    log(f"(y) flags: resume trained epochs {runs}, profile {traces}, "
        f"{len(devices)} batches augmented on {on}")
    return {"flags": launches}, {"epochs": runs, "traces": traces,
                                 "augmented_batches": len(devices)}


# -- 11: every Hebbian rule, and the VNet family -----------------------------

RULES_2D = ("hpca", "contrastive")
RULES_3D = ("hpca_t", "swta", "contrastive")
RULES_VNET = ("swta", "hpca", "hpca_t", "contrastive")
VNET_EXCLUDE = ("out_tr.conv2",)
# phase 11 cuts steps, not width: the regime-50 half of the 4 train
# volumes, one patch from each, one patch per val volume
SPV_RULES = ["--samples_per_volume_train", "1", "--samples_per_volume_val",
             "1", "--regime", "50"]
VNET_SEMI = (("cct", "vnet_cct", None), ("dtc", "vnet_dtc", None))


def rule_deltas_card_vs_cpu(tag, sites, modes, device):
    """Card against CPU, per delta: each rule of ``modes`` at each site,
    from the same tensors (the raw weight, the bias, the layer's input and
    output, its stride and padding; contrastive with the batch reversed),
    within 1e-3 of the CPU delta's max|delta|; no K1 launch.  Returns the
    worst error of each mode."""
    import torch
    from hebbax_torch.hebb import kernels, rules
    from hebbax_torch.hebb.spec import HebbSpec

    worst = {}
    for mode in modes:
        spec = HebbSpec(mode=mode, k=K_TEMP)
        errs = []
        for name, mod, x, y in sites:
            perm = torch.arange(x.shape[0] - 1, -1, -1)

            def delta(dev, mod=mod, x=x, y=y, perm=perm):
                return rules.compute_delta(
                    spec, mod.weight.detach().to(dev), x.to(dev), y.to(dev),
                    mod.padding, mod.transpose, mod.stride,
                    bias=mod.bias.detach().to(dev), perm=perm.to(dev))

            before = kernels.SWTA_DELTA.launches
            dg = delta(device).cpu()
            check(kernels.SWTA_DELTA.launches == before,
                  f"{tag} {mode} at {name} launched K1")
            dc = delta("cpu")
            scale = float(dc.abs().max())
            check(bool(torch.isfinite(dc).all()) and scale > 0,
                  f"{tag} {mode} at {name}: CPU delta scale {scale}")
            err = float((dg - dc).abs().max()) / scale
            check(err <= 1e-3, f"{tag} {mode} at {name}: card vs CPU "
                               f"{err} of max|delta|")
            errs.append(err)
        worst[mode] = max(errs)
        log(f"{tag} {mode}: {len(sites)} sites card vs CPU, worst "
            f"{worst[mode]:.3e} of max|delta|, 0 launches")
    return worst


def strided_2d_site(device, images):
    """A strided 2D CUDA call through the dispatcher (a k = s = 2 conv of
    32 filters over the batch of 2D images) equals the composed rule and
    leaves K1's launch count unchanged."""
    import torch
    import torch.nn.functional as F
    from hebbax_torch.hebb import kernels, rules

    x = images[:, :, :64, :64].contiguous()
    w = torch.from_numpy(np.random.default_rng(21).standard_normal(
        (32, x.shape[1], 2, 2)).astype(np.float32)).to(device)
    y = F.conv2d(x, w, stride=2)
    before = kernels.SWTA_DELTA.launches
    got = kernels.swta_delta(w, x, y, K_TEMP, (0, 0), (2, 2))
    torch.cuda.synchronize()
    check(kernels.SWTA_DELTA.launches == before,
          "a strided 2D site launched K1")
    ref = rules.swta_wgrad_delta(w, x, y, K_TEMP, 0, 2)
    err = float((got - ref).abs().max()) / float(ref.abs().max())
    check(err <= TOL, f"the strided 2D site differs from the composed rule "
                      f"by {err} of max|delta|")
    log(f"(z) strided 2D site {tuple(x.shape)} k=s=2: K1 launches "
        f"unchanged, {err:.3e} of max|delta| from the composed rule")
    return err


def pretrain_2d_rule(items, device, mode):
    """``pretrain_hebbian_unsup_2d -n unet --hebb_mode <mode>`` with (a)'s
    flags: no K1 launch, finite losses, the watched Hebbian kernels
    unchanged in epoch 0 (lr 0) and changed in epoch 1; then steady and
    profiled steps and the peak memory.  Returns (launches, last.ckpt,
    record)."""
    import torch
    from hebbax_torch.cli import common
    from hebbax_torch.cli import pretrain_hebbian_unsup_2d as pretrain
    from hebbax_torch.hebb import kernels

    on = "cpu" if device == "cpu" else "cuda"
    tag = f"(z) {mode}"
    args = pretrain.add_args(common.base_parser_2d()).parse_args(
        cli_base(device) + [
            "-n", "unet", "--exclude", "out_conv", "--hebb_mode", mode,
            "--hebb_inv_temp", str(int(K_TEMP)), "--optimizer", "adam",
            "-l", "1e-6", "--debug", ""])
    reset_peak(on)
    trainer = pretrain.build(args, make_loaders(items, args, 100))
    model = trainer.state.model
    watch = ("encoder.in_conv.conv2.weight",
             "main_decoder.up4.conv.conv1.weight")
    perms = record_permutations(model, watch)
    sd0 = model.state_dict()
    w0 = {n: sd0[n].detach().clone() for n in watch}
    times, snaps = [], []
    raw_step = trainer.train_step

    def watched(state, batch):
        out = timed_step(raw_step, times)(state, batch)
        sd = state.model.state_dict()
        snaps.append({n: sd[n].detach().clone() for n in watch})
        return out

    trainer.train_step = watched
    kernels.SWTA_DELTA.launches = 0
    trainer.run()
    launches = kernels.SWTA_DELTA.launches
    per_epoch = len(trainer.loaders["train"])
    check(len(times) == 2 * per_epoch, f"{tag} ran {len(times)} steps")
    check(launches == 0, f"{tag} launched K1 {launches} times")
    for n in watch:
        check(all(torch.equal(s[n], w0[n]) for s in snaps[:per_epoch]),
              f"{tag} {n} changed in epoch 0 (lr 0)")
        moves = not all(torch.equal(p, torch.arange(len(p)))
                        for p in perms[n]) if mode == "contrastive" else True
        check(torch.equal(snaps[-1][n], w0[n]) != moves,
              f"{tag} {n}: changed in epoch 1 is "
              f"{not torch.equal(snaps[-1][n], w0[n])}, expected {moves}")
    check(all_on(model, on), f"{tag}: a model tensor is off {on}")
    losses, ok = finite_losses(trainer)
    check(ok, f"{tag} losses {losses}")
    log(f"{tag} pretrain: {len(times)} steps, K1 launches {launches}, "
        f"step ms {[round(t, 3) for t in times]}, losses {losses}")
    steady = steady_step_ms(trainer, raw_step)
    profiled = profile_steps(trainer, raw_step, float(np.median(steady)))
    log(f"{tag} profile " + json.dumps(profiled))
    peak = peak_gib(on)
    log(f"{tag} peak memory {peak} GiB (torch.cuda.max_memory_allocated, "
        f"the run and its timed steps)")
    snap = os.path.join(trainer.paths.checkpoints, "last.ckpt")
    return launches, snap, {"steps": len(times), "step_ms": times,
                            "steady": steady, "profile": profiled,
                            "peak_gib": peak}


def finetune_test_2d(items, snap, device, tag):
    """``train_sup_2d --load_hebbian_weights`` from ``snap`` at regime 50
    and ``test_2d --hebbian_pretrain 1`` on its best snapshot, each with
    its K1 count zeroed before and read after (0 launches), timed like
    (b).  Returns (launches by path, record)."""
    from hebbax_torch.cli import common
    from hebbax_torch.cli import test_2d
    from hebbax_torch.cli import train_sup_2d
    from hebbax_torch.config.datasets import dataset_cfg, input_stats
    from hebbax_torch.data import Loader
    from hebbax_torch.hebb import kernels

    on = "cpu" if device == "cpu" else "cuda"
    args = train_sup_2d.add_args(common.base_parser_2d()).parse_args(
        cli_base(device) + ["--load_hebbian_weights", snap, "--regime",
                            "50", "--debug", ""])
    reset_peak(on)
    trainer = train_sup_2d.build(args, make_loaders(items, args, 50))
    rec = run_path(trainer, f"{tag} fine-tune", on,
                   watch=("encoder.in_conv.conv1.weight",))
    targs = test_2d.build_parser().parse_args(
        ["--device", device, "--path_exp", rec["run"], "--hebbian_pretrain",
         "1", "-b", str(BATCH), "--num_workers", "4"])
    mean, std = input_stats(dataset_cfg("GlaS"), "image")
    test_ds = array_dataset_class()(items["val"], mean, std, "test")
    kernels.SWTA_DELTA.launches = 0
    metrics = test_2d.run_test(targs, Loader(test_ds, BATCH, num_workers=4))
    l_test = kernels.SWTA_DELTA.launches
    check(l_test == 0, f"{tag} test launched K1 {l_test} times")
    check(metrics is not None and all(np.isfinite(v)
                                      for v in metrics.values())
          and 0.0 <= metrics["segm/dice"] <= 1.0,
          f"{tag} test metrics {metrics}")
    log(f"{tag} test: Dice {metrics['segm/dice']:.4f} Jaccard "
        f"{metrics['segm/jaccard']:.4f}")
    del trainer
    release()
    return rec["launches"], l_test, dict(rec, test=metrics)


def vnet_reference(device):
    """VNet's card-vs-CPU training forwards at batch 2, 32^3 (skip dropout
    off on both, VNetCCT with the same perturbation draws): every output
    within 1e-4 of max(1, max|output|)."""
    import torch
    from hebbax_torch.models import get_network
    from hebbax_torch.ops.dropout import Dropout
    from hebbax_torch.utils.seeding import make_generator

    x = torch.from_numpy(np.random.default_rng(17).standard_normal(
        (2, 1, 32, 32, 32)).astype(np.float32))
    out = {}
    for net in ("vnet", "vnet_dtc", "vnet_cct"):
        gpu, cpu = [get_network(net, 1, 2, device=dev,
                                generator=make_generator(3))
                    for dev in (device, "cpu")]
        cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
        for m in (gpu, cpu):
            for mod in m.modules():
                if isinstance(mod, Dropout):
                    mod.p = 0.0         # dropout off: the streams differ
            m.train()
        if net == "vnet_cct":
            share_cct_draws(cpu, gpu, device)
        with torch.no_grad():
            out_c = cpu(x)
            out_g = gpu(x.to(device))
        if net == "vnet":
            out_c, out_g = (out_c,), (out_g,)
        rel = max(float((g.cpu() - c).abs().max())
                  / max(1.0, float(c.abs().max()))
                  for g, c in zip(out_g, out_c))
        check(rel <= 1e-4, f"(ab) {net}: outputs card vs CPU differ by "
                           f"{rel} of max(1, max|output|)")
        out[net] = rel
        log(f"(ab) small-input reference {net}: outputs {rel:.3e} of "
            f"max(1, max|output|)")
        del gpu, cpu
    release()
    return out


def phase_rules(items, images, data_root, device="0"):
    """Phase 11: (z) the 2D rules on ``unet``, (aa) the 3D rules on
    ``unet3d``, (ab) the VNet chain, (ac) VNet's semi runs; returns the
    launches by path and the ``rules_vnet_path`` record."""
    import torch
    from hebbax_torch.hebb.spec import HebbSpec
    from hebbax_torch.models import get_network
    from hebbax_torch.utils.seeding import make_generator

    on = "cpu" if device == "cpu" else "cuda"
    card = torch.device("cuda", 0) if on == "cuda" else torch.device("cpu")
    launches, record = {}, {"card_vs_cpu": {}}

    # card against CPU, per delta, at each network's sites
    def sites_of(net, spec, x, keep=None):
        """(name, module, input, output) of the Hebbian sites of one
        training forward of ``net`` at ``x``."""
        model = get_network(net, x.shape[1], 2, hebb=spec, device=card,
                            generator=make_generator(3))
        sites = [(name, model.get_submodule(name), xi, yo)
                 for name, _, xi, yo, _ in capture_sites(model, x.to(card))]
        return [s for s in sites if keep is None or keep(s[1])]

    x2 = images[:2, :, :64, :64].contiguous()
    record["card_vs_cpu"]["unet"] = rule_deltas_card_vs_cpu(
        "(z)", sites_of("unet", HebbSpec(exclude=("out_conv",)), x2),
        RULES_2D, card)
    x3 = torch.from_numpy(np.random.default_rng(19).standard_normal(
        (2, 1, 32, 32, 32)).astype(np.float32))
    record["card_vs_cpu"]["unet3d"] = rule_deltas_card_vs_cpu(
        "(aa)", sites_of(NET_3D, HebbSpec(exclude=("conv",)), x3), RULES_3D,
        card)
    record["card_vs_cpu"]["vnet"] = rule_deltas_card_vs_cpu(
        "(ab)", sites_of("vnet", HebbSpec(exclude=VNET_EXCLUDE), x3,
                         lambda m: m.transpose or m.stride != (1, 1, 1)),
        RULES_VNET, card)
    release()
    record["strided_2d_site_rel"] = strided_2d_site(card, images)
    record["vnet_forward"] = vnet_reference(card)

    # (z) pretraining under hpca and contrastive; fine-tune + test from hpca
    paths, tests = {}, {}
    for mode in RULES_2D:
        key = f"{mode}_pretrain_2d"
        launches[key], snap, paths[key] = pretrain_2d_rule(items, device,
                                                           mode)
        if mode == "hpca":
            snap_hpca = snap
        release()
    l_sup, l_test, rec = finetune_test_2d(items, snap_hpca, device,
                                          "(z) hpca")
    launches.update(hpca_sup_2d=l_sup, hpca_test_2d=l_test)
    tests["hpca_test_2d"] = rec.pop("test")
    paths["hpca_sup_2d"] = rec

    def path_3d(key, out):
        launches[key], steps, times, steady, prof = out
        paths[key] = {"steps": steps, "step_ms": times, "steady": steady,
                      "profile": prof, "peak_gib": peak_gib(on)}
        release()

    # (aa) the 3D rules on unet3d, conv excluded; contrastive at batch 2
    # (at batch 1 its permutation is the identity and its delta 0)
    for mode in RULES_3D:
        extra = SPV_RULES + (["-b", "2"] if mode == "contrastive" else [])
        reset_peak(on)
        l_aa, _, *rest = pretrain_3d(
            data_root, device, NET_3D, ("encoder.encoder1.conv1.weight",
                                        "decoder.upconv1.weight"),
            ("conv.weight",), f"(aa) {mode}", extra, mode=mode,
            exclude=("conv",))
        path_3d(f"{mode}_pretrain_3d", (l_aa, *rest))

    # (ab) the VNet chain: swta_t pretrain -> fine-tune -> test_3d
    reset_peak(on)
    l_ab, snap_v, *rest = pretrain_3d(
        data_root, device, "vnet", ("down_tr32.down_conv.weight",
                                    "up_tr32.up_conv.weight"),
        ("out_tr.conv2.weight",), "(ab) vnet", SPV_RULES,
        exclude=VNET_EXCLUDE)
    path_3d("vnet_pretrain", (l_ab, *rest))
    reset_peak(on)
    l_sup, run_v, *rest = phase_3d_finetune(
        data_root, snap_v, device, extra=SPV_RULES[:4],
        tag="(ab) vnet fine-tune", net="vnet", head="out_tr.conv2")
    path_3d("vnet_sup", (l_sup, *rest))
    launches["vnet_test"], tests["vnet_test"] = phase_3d_test(
        data_root, run_v, device, net="vnet", tag="(ab) vnet test")

    # (ac) VNet's semi runs from kaiming, then test_3d
    ac = phase_semi_3d_train(data_root, {}, device, runs=VNET_SEMI,
                             spv=SPV_RULES[:4], tag="ac", test_tag="ac",
                             suffix="_vnet_3d")
    launches.update(ac["launches"])
    for algo, net, _ in VNET_SEMI:
        paths[f"{algo}_vnet_3d"] = {k: ac[k].get(algo) for k in (
            "steps", "step_ms", "steady", "profile", "peak_gib")}
        tests[f"test_{algo}_vnet_3d"] = ac["test"][algo]
    record.update(
        launches=dict(launches),
        steps={k: v["steps"] for k, v in paths.items()},
        steady_step_ms=summary({k: v["steady"] for k, v in paths.items()}),
        profile=profile_summary({k: v["profile"]
                                 for k, v in paths.items()}),
        peak_gib={k: v["peak_gib"] for k, v in paths.items()},
        test=tests, patch=list(PATCH), spv=SPV_RULES)
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

    def lap(phase):
        log(f"phase {phase} done at {time.perf_counter() - t0:.1f} s")

    rows = phase_sites(device, images)
    lap(2)
    phase_small_reference(device)
    phase_deep4_reference(device)
    launches, run_a = phase_main_path(items)
    lap("3-4")
    l_d, snaps, steady_d, steps_d = phase_deep4_pretrain(items)
    launches.update(l_d)
    snaps["unet"] = os.path.join(run_a, "checkpoints", "last.ckpt")
    l_e, steady_e, steps_e, tests = phase_semi(items, snaps)
    log("deep4_semi_path " + json.dumps({
        "launches": {**l_d, **l_e}, "steps": {**steps_d, **steps_e},
        "steady_step_ms": summary({**steady_d, **steady_e}),
        "test": tests}))
    lap(5)

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
    lap(6)

    l_3d, record_3d, data_root, snap_k = phase_3d(device)
    launches.update(l_3d)
    log("hebbian_3d_path " + json.dumps(record_3d))
    lap(7)

    l_8, record_8 = phase_semi_3d(device, data_root, snap_k)
    launches.update(l_8)
    log("semi_3d_path " + json.dumps(record_8))
    lap(8)

    l_9, record_9 = phase_sweeps_tail(device, items, data_root)
    launches.update(l_9)
    log("sweeps_tail_path " + json.dumps(record_9))
    lap(9)

    l_w, record_w = phase_bf16_2d(items)
    l_x, record_x = phase_bf16_3d(data_root)
    l_y, record_y = phase_flags(items)
    l_10 = {**l_w, **l_x, **l_y}
    launches.update(l_10)
    log("bf16_flags_path " + json.dumps({"w": record_w, "x": record_x,
                                         "y": record_y}))
    lap(10)

    l_11, record_11 = phase_rules(items, images, data_root)
    launches.update(l_11)
    log("rules_vnet_path " + json.dumps(record_11))
    lap(11)

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
            "pretrain_3d", "sup_3d", "test_3d", *l_8, *l_9, *l_10,
            *l_11)},
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
