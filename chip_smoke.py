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
   of bytes and tensor-core time: the arithmetic it really does.  Then
   the folded 3D max pool's backward kernel (P1) at the shapes the
   networks give it (``unet3d_s2d``'s folded level at 96x96x80, x
   1x128x48x96x80 at f = (2, 1, 1), in float32 and bfloat16, and
   ``unet3d_urpc_s2d``'s two levels at (2, 2, 2)): its gradient equal to
   the bit to its plain version ``s2d3d.first_max_grad``, and the kernel,
   the plain version and the bytes bound (x and g read once, the
   gradient written once, over 3.35 TB/s) timed likewise;
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
12. data parallelism (``hebbax_torch.parallel``, hebbax's global-batch
   semantics): (ad) one process on the card, then 2 ranks spawned on the
   same card over gloo (a card holds one NCCL rank) with half of every
   batch each, run two steps of the ``unet`` swta_t pretraining step at
   batch 32, 128x128 (SGD at a constant lr 0.1), one EM and one CPS step
   with the sweep's flags, one ``unet3d`` fine-tune step at batch 2,
   96x96x80 (its fresh model's slider on a val volume first) and
   ``test_3d --dp_devices 2`` on the single process's snapshot: the ranks
   hold the same state, and the single process's losses (rtol 1e-5),
   merged deltas (TOL of max|delta|; step 2's 1e-3), states (parameters
   and BN statistics within 1e-3 of the update, no tensor beyond 0.1 of
   its own), slider logits (1e-5 of max|logit|) and test Dice / Jaccard
   (1e-3); K1 22 launches per rank per pretraining step, 0 elsewhere;
   which collectives gloo runs on CUDA tensors; step times of both; (ae)
   one pretraining step in a
   world-size-1 NCCL group equal to the plain step to the bit (cuDNN
   deterministic), with one NCCL all-reduce; one ``data_parallel_path``
   line carries them;
13. multi-class metrics, the CCT options and the delta dtype: (ag) a
   3-class copy of the synthetic set (``GlaS3``, registered in this
   process; class 2 on the right half of each disc):
   ``pretrain_hebbian_unsup_2d -n unet`` (swta_t, 4 steps: K1 22 launches
   per step), ``train_sup_2d --load_hebbian_weights`` validated through
   the confusion accumulator on the card (the snapshot stores no
   threshold), the card's confusion histogram of the validation logits
   equal to the CPU's on the same logits, ``test_2d --threshold 0.5``
   (finite Jaccard / Dice); (ah) ``unet_cct_s2d_batched``: its Hebbian
   pretraining runs hebbax's unfolded serial ``unet_cct`` (K1 58 per
   step), its own Hebbian training forward launches K1 22 times (the 12
   decoder sites at batch 4N), one ``train_semi_2d cct`` step, an eval
   forward equal to ``unet_cct``'s (1e-5 of max|logit|), K1 within TOL
   of its plain version at the 4N sites; (ai) one CCT step of
   ``unet3d_cct_s2d_rc`` and ``vnet_cct_s2d_rc`` against the folded
   ``unet3d_cct_s2d`` and ``vnet_cct_s2d`` (hebbax's ``_rc`` is its name
   without ``_rc`` but for the recompute) from the same state and draws
   at batch 1, 96x96x80:
   grads within 1e-6 of max|grad|, BN running statistics equal to the
   bit, the peak memory and the steady step times (``measure_step``) of
   each; (aj) the composed 3D delta at (j)'s 22 sites in float32 and in
   bfloat16 (``HEBBAX_DELTA_DTYPE``'s arithmetic), both timed, bf16's
   error against float32; one ``tail_path`` line carries them;
14. the space-to-depth folded networks (the ``_s2d`` names compute
   folded, so every run above that names or defaults to one runs a
   folded class: (b), (c), (i), (p), (t), (ah), (ai)): (ak) each 2D
   ``_s2d`` name and UNet2DS2D(head_depth=2) against its unfolded twin
   on the same weights and draws at batch 32, 128x128: eval outputs, a
   Hebbian (swta, K=50) training forward (K1 22 / 22 / 58 / 22 / 22
   launches; K1 within TOL of its plain version at
   the sites it saw), its deltas and BN running statistics, one
   fine-tune step's gradients; (al) each 3D ``_s2d`` name likewise at
   batch 1, 96x96x80 (no K1 launch) with both peaks and the folded
   step's P1 launches (its folded pools: 2 on ``unet3d_urpc_s2d``, 0 on
   the ``unet3d_s2d`` names, which run as their unfolded twins, and on
   the VNet names), ``unet3d_urpc_s2d``'s
   gradients compared in float64 on the CPU (P1 takes float32 and
   bfloat16); (am) steady step
   (``measure_step``), device busy share and peak memory of
   ``train_sup_2d`` on ``unet_s2d`` / ``unet``, EM on ``unet3d_s2d`` /
   ``unet3d``, URPC on ``unet3d_urpc_s2d`` / ``unet3d_urpc`` and
   ``train_sup_3d`` on ``vnet_s2d`` / ``vnet``, and the cuDNN times of
   one folded conv against its unfolded conv at ``unet3d``'s encoder1
   and ``unet``'s in_conv; (an) ``HEBBAX_S2D_FOLDED_DELTA``'s
   folded-layout delta against K1 at the 8 Hebbian folded sites of a
   ``unet_s2d`` Hebbian forward, timed, with their error; one
   ``s2d_path`` line carries them;
15. spatial sharding (``hebbax_torch.parallel.spatial_sharding``, hebbax's
   ``spatial_sharding``): eval forwards with the first spatial axis split
   over gloo ranks that share the card (one spawn per rank count), each
   rank's rows through explicit halo exchanges, the gathered outputs
   held by rank 0 to the replicated forward in its own process (within
   1e-4 of max(1, max|output|), TF32 off in every rank): (ao) ``unet``
   at batch 32, 128x128, H over 2 and over 4 ranks; (ap) ``unet3d`` on
   the whole 128x128x96 volume, D over 2; (aq) ``unet3d_urpc`` (its four
   outputs) and ``vnet`` likewise; K1 0 launches on each rank; each
   rank's forward ms (CUDA events) and peak memory beside the replicated
   forward's; one ``spatial_path`` line carries them with (m)'s slider
   seconds per volume;
16. the entry layer (``hebbax_torch.entry``, ``hebbax_torch.sweep``,
   ``hebbax_torch.tools``, RAD-DINO's HF key map): (ar) a seeded numpy
   dict in the HF dinov2 layout of ``microsoft/rad-dino`` (ViT-B/14, 12
   blocks, 224^2) mapped onto the card's and the CPU's encoders after the
   loader fell back offline: the mapped tensors equal to their sources
   under the stated reshapes, card and CPU tokens at batch 2 within 1e-4
   of max(1, max|tokens|), the frozen forward timed; (as) every line of
   the 19 ``reproduce_*.sh`` sweeps recorded (bash expands each, the
   recording ``python`` keeps its words; in threads beside (ar) and
   (at)) and parsed with the port's parsers, ``python -m hebbax_torch.sweep
   --record`` listing the Hebbian pretraining sweep's lines as recorded,
   then that sweep's first line run in-process through ``entry.run``
   (only ``--path_dataset``, ``--path_root_exp`` and ``-e 1`` changed;
   K1 22 launches per step); (at) the nine tools
   on phase 7's volumes, (m)'s predictions, (a)'s snapshot and the run
   tree (the 2D ones where PIL is installed): every output written,
   finite and in range, ``mask2sdf`` and ``atrial.postprocess`` equal to
   the bit to phase 7's ``mask_sdf1`` maps and (m)'s post-processing; K1
   0 launches in (ar) and (at); one ``entry_path`` line carries them;
17. print the ``{"kernels": [...]}`` line (K1 with ``launches_by_path``:
   a, urpc_pretrain, cct_pretrain and the paths of 6 to 16; P1 with
   ``urpc_3d``'s launches and those on (p), (t) and (al), where each
   run's count is a positive
   multiple of its steps on a network that pools folded and 0
   otherwise, and each (al) fine-tune step's count is the network's
   number of folded pools), the card's name and power limit, and last
   ``{"ok": true, "device": {...}}``.

It needs one card, imports nothing of JAX or of the ``hebbax`` package,
and writes only under ``build/`` beside this file.

    python3 chip_smoke.py --dp-cards

on a machine with N >= 2 cards runs phase 12's (ad) instead over N NCCL
ranks, one per card ((af): a batch of 32 over N, the 3D batch N), held
to one process on card 0 with the same gates, then phase 15's cases each
over the N NCCL ranks, and prints one ``data_parallel_cards_path`` and
one ``spatial_cards_path`` line before the card's name and the last
line.
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


# P1's cases: (label, unfolded x shape, fold, dtype)
POOL_CASES = (
    ("unet3d_s2d level 0", (1, 64, 96, 96, 80), (2, 1, 1), "float32"),
    ("unet3d_s2d level 0", (1, 64, 96, 96, 80), (2, 1, 1), "bfloat16"),
    ("unet3d_urpc_s2d conv1", (1, 16, 96, 96, 80), (2, 2, 2), "float32"),
    ("unet3d_urpc_s2d conv2", (1, 32, 48, 48, 40), (2, 2, 2), "float32"))


def phase_pool_kernel(device):
    """P1 against its plain version on post-ReLU card tensors at
    POOL_CASES: bit-equal gradients, one launch a call, and the kernel,
    the plain version and the bytes bound timed."""
    import torch
    from hebbax_torch.ops import s2d3d
    from hebbax_torch.ops.s2d3d_kernels import SUBPIXEL_MAX3

    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    for label, shape, f, dt in POOL_CASES:
        dtype = getattr(torch, dt)
        x = s2d3d.fold3(torch.relu(torch.randn(
            shape, generator=gen, device=device)), f).to(dtype)
        n, c, d, h, w = shape
        g = torch.randn((n, c, d // 2, h // 2, w // 2), generator=gen,
                        device=device).to(dtype)
        before = SUBPIXEL_MAX3.launches
        got = SUBPIXEL_MAX3(x, g, f)
        check(SUBPIXEL_MAX3.launches == before + 1,
              f"P1 {label} {dt}: one call counted "
              f"{SUBPIXEL_MAX3.launches - before} launches")
        check(torch.equal(got, s2d3d.first_max_grad(x, g, f)),
              f"P1 {label} {dt}: the gradient differs from the plain "
              f"version's")
        del got
        k_ms = cuda_time_ms(lambda: SUBPIXEL_MAX3(x, g, f))
        p_ms = cuda_time_ms(lambda: s2d3d.first_max_grad(x, g, f))
        nbytes = (2 * x.numel() + g.numel()) * x.element_size()
        b_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        rows.append(dict(case=label, x=list(x.shape), fold=list(f),
                         dtype=dt, bytes=nbytes, ms=k_ms, plain_ms=p_ms,
                         bound_ms=b_ms, equal_to_plain=True))
        log(f"P1 {label} {dt} x {tuple(x.shape)} f {f}: kernel {k_ms:.4f} "
            f"ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_ms / k_ms:.1%}), bit-equal")
        del x, g
        torch.cuda.empty_cache()
    log("pool_kernel " + json.dumps(rows))
    return rows


def p1_gate(tag, net, launches, steps, on):
    """P1's launches over a run of ``steps`` train steps of ``net``: a
    positive multiple of the steps on the card where the network pools
    folded (S2D_P1), none otherwise."""
    if on == "cuda" and S2D_P1.get(net, 0):
        ok = launches > 0 and launches % steps == 0
    else:
        ok = launches == 0
    check(ok, f"{tag} {net}: P1 launched {launches} times in {steps} "
              f"steps")


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


STEADY_MIN, STEADY_BUDGET_S = 3, 2.0


def steady_step_ms(trainer, step, n=10):
    """Host times (ms) of up to n more train steps on fixed batches, each
    ended by a synchronize, after the run's own steps warmed up cuDNN and
    the allocator; at least STEADY_MIN, and no more once they took
    STEADY_BUDGET_S (a 2D step gets its 10, a 3D step of 0.2–1.6 s 3–10:
    their times hold within 1%).  Made after the path's launch count was
    read."""
    import torch

    run = step_runner(trainer, step)
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if len(times) >= STEADY_MIN and sum(times) > STEADY_BUDGET_S * 1e3:
            break
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


def profile_steps(trainer, step, steady_ms, n=None):
    """torch.profiler over n train steps on fixed batches (3, or 2 for a
    step over half a second): device time per step by kernel class, its
    share of the unprofiled step's median host time ``steady_ms``, and
    the heaviest kernels.  Made after the path's launch count was read.
    Only the device is traced, and its kernel records are summed as the
    profiler returns them: tracing the host's ops as well and grouping
    them with ``key_averages`` took up to 11 s per profile of a 2D semi
    step on an H100 and moved its device time by under 1%."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    n = n or (3 if steady_ms < 500 else 2)

    run = step_runner(trainer, step)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    kernels = {}
    for evt in prof.profiler.kineto_results.events():
        if str(evt.device_type()).endswith("CUDA"):
            kernels[evt.name()] = (kernels.get(evt.name(), 0.0)
                                   + evt.duration_ns() / 1e6 / n)
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
        "test": test, "patch": list(PATCH), "volume": list(VOLUME),
        "run": run}
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
    the run's own steps after the first as its steady times (they hold
    within 1% of further steps), then profiled steps and the peak
    memory; (q) test_3d on
    each run's best_JI.ckpt, as (m).  ``runs``, ``spv``, the tags and the
    launch keys' ``suffix`` serve phase 11's VNet runs too."""
    import gc

    import torch
    from hebbax_torch.cli import common3d, train_semi_3d
    from hebbax_torch.hebb import kernels
    from hebbax_torch.ops.s2d3d_kernels import SUBPIXEL_MAX3

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
        SUBPIXEL_MAX3.launches = 0
        trainer.run()
        launches = kernels.SWTA_DELTA.launches
        p1 = P1_LAUNCHES[f"{algo}{suffix}"] = SUBPIXEL_MAX3.launches
        out["launches"][f"{algo}{suffix}"] = launches
        check(launches == 0, f"({tag}) {algo} launched K1 {launches} times")
        p1_gate(f"({tag}) {algo}", net, p1, len(times), on)
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
            f"{launches}, P1 launches {p1}, step ms {[round(t, 3) for t in times]}, losses "
            f"{losses}")
        out["steady"][algo] = times[1:]
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


def run_path(trainer, tag, on, watch=(), net=None):
    """Run ``trainer`` with its K1 and P1 launch counts zeroed just before
    and read just after: no K1 launch (and P1's count gated by p1_gate
    where ``net`` is given), finite losses, best_JI.ckpt and last.ckpt,
    the ``watch`` parameters moved; then 10 steady and 3 profiled steps,
    and the peak memory of the run and its timed steps."""
    import torch
    from hebbax_torch.hebb import kernels
    from hebbax_torch.ops.s2d3d_kernels import SUBPIXEL_MAX3

    model = trainer.state.model
    sd0 = model.state_dict()
    w0 = {n: sd0[n].detach().clone() for n in watch}
    times = []
    raw_step = trainer.train_step
    trainer.train_step = timed_step(raw_step, times)
    kernels.SWTA_DELTA.launches = 0
    SUBPIXEL_MAX3.launches = 0
    trainer.run()
    launches = kernels.SWTA_DELTA.launches
    p1 = SUBPIXEL_MAX3.launches
    check(launches == 0, f"{tag} launched K1 {launches} times")
    if net is not None:
        p1_gate(tag, net, p1, len(times), on)
    check(all_on(model, on), f"{tag}: a model tensor is off {on}")
    losses, ok = finite_losses(trainer)
    check(ok, f"{tag} losses {losses}")
    for name in ("best_JI.ckpt", "last.ckpt"):
        check(os.path.exists(os.path.join(trainer.paths.checkpoints, name)),
              f"{tag} wrote no {name}")
    sd = model.state_dict()
    still = [n for n in watch if torch.equal(sd[n], w0[n])]
    check(not still, f"{tag}: {still[:5]} ({len(still)}) did not move")
    log(f"{tag}: {len(times)} steps, K1 launches {launches}, P1 launches "
        f"{p1}, step ms {[round(t, 3) for t in times]}, losses {losses}")
    steady = steady_step_ms(trainer, raw_step)
    profiled = profile_steps(trainer, raw_step, float(np.median(steady)))
    log(f"{tag} profile " + json.dumps(profiled))
    peak = (torch.cuda.max_memory_allocated() / 2**30 if on == "cuda"
            else None)
    if peak is not None:
        log(f"{tag} peak memory {peak:.3f} GiB (torch.cuda."
            f"max_memory_allocated, the run and its timed steps)")
    return {"launches": launches, "p1_launches": p1, "steps": len(times),
            "step_ms": times,
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
                            watch=("encoder.encoder1.conv1.weight",),
                            net="unet3d_s2d")
        P1_LAUNCHES[key] = out[key]["p1_launches"]
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


# -- phase 12: data parallelism ----------------------------------------------

DP_RANKS = 2
DP_LR = 0.1
DP_STEPS = 2
DP_TIMED = 5
DP_SGD = ["--optimizer", "sgd", "-l", str(DP_LR), "--momentum", "0",
          "--wd", "-30"]
DP_TIMEOUT_S = 300
# the dp state's miss of the single process's, as a share of the update
# (hebbax's own multichip check allows 1e-2 for the delta merge); no
# tensor may miss by 0.1 of its own update (+1e-5: a conv bias before a
# batch norm has a gradient of rounding noise alone)
DP_STATE_TOL = 1e-3
DP_DEADLINE_S = 900
CUDA_COLLECTIVES = ("all_reduce", "broadcast", "all_gather",
                 "reduce_scatter_tensor", "all_to_all_single")


def _cpu_state(model):
    return {k: v.detach().cpu().clone() for k, v in
            model.state_dict().items()}


def _sampled_state(model):
    """Every 97th element of the model's concatenated state (the 3D
    network's full state is 360 MB a copy)."""
    import torch
    return torch.cat([v.detach().float().flatten().cpu() for v in
                      model.state_dict().values()])[::97]


def _constant_lr(state):
    for key in ("schedule", "schedule1", "schedule2"):
        if getattr(state, key, None) is not None:
            setattr(state, key, lambda count: DP_LR)


def _timed(run, n, sync):
    times = []
    for _ in range(n):
        sync()
        t0 = time.perf_counter()
        run()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def cuda_collectives(card):
    """Which collectives the process group's backend runs on CUDA
    tensors of ``card`` (the rest raise): every rank calls each, in the
    same order."""
    import torch
    import torch.distributed as dist
    from hebbax_torch import parallel

    n = parallel.world_size()
    x = torch.ones(2 * n, device=card)
    calls = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(n)], x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(2, device=card), x),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty_like(x), x)}
    table = {"backend": dist.get_backend()}
    for op in CUDA_COLLECTIVES:
        try:
            calls[op]()
            torch.cuda.synchronize(card)
            table[op] = "ok"
        except (RuntimeError, ValueError, NotImplementedError) as exc:
            table[op] = str(exc).splitlines()[0][:120]
    return table


def dp_job(items, data_root, root, snap_exp, device="0", batch_3d=2):
    """Phase 12's work in one process: the single process (``snap_exp``
    None) or one of the ranks sharing the card.  (ad) two steps of the
    ``unet`` swta_t pretraining step at batch 32 (the losses, the merged
    deltas, the state after, K1's launches), one EM and one CPS step with
    the sweep's flags, one ``unet3d`` fine-tune step at batch 2 (the slider
    of its fresh model on a val volume first), then ``test_3d`` on the
    single process's 3D snapshot (``--dp_devices`` the world size); SGD at
    a constant lr, so every step moves the parameters.  ``device`` 'rank'
    puts each rank on its own card; ``batch_3d`` is the 3D batch and the
    slider's."""
    import torch
    from hebbax_torch import parallel
    from hebbax_torch.cli import common, common3d
    from hebbax_torch.cli import pretrain_hebbian_unsup_2d as pretrain
    from hebbax_torch.cli import test_3d, train_semi_2d, train_sup_3d
    from hebbax_torch.data.augment3d import znormalize
    from hebbax_torch.data.volumes3d import VolumeDataset3D
    from hebbax_torch.engine import steps as steps_mod
    from hebbax_torch.engine.sliding import slide_window_inference_device
    from hebbax_torch.hebb import kernels
    from hebbax_torch.models import primary_logits

    if device == "rank":
        device = str(parallel.rank())
    card = common.resolve_device(device)

    def sync():
        if card.type == "cuda":
            torch.cuda.synchronize(card)

    world = parallel.world_size()
    rec = {"rank": parallel.rank(), "world": world}
    base = ["--device", device, "--path_dataset", "synthetic/GlaS",
            "--dataset_name", "GlaS", "--path_root_exp", root,
            "-b", str(BATCH), "-e", "1", "-w", "1", "--num_workers", "4",
            "--debug", ""]

    # (ad) the swta_t pretraining step
    args = pretrain.add_args(common.base_parser_2d()).parse_args(
        base + ["-n", "unet", "--exclude", "out_conv", "--hebb_mode",
                "swta_t", "--hebb_inv_temp", str(int(K_TEMP))] + DP_SGD)
    trainer = pretrain.build(args, make_loaders(items, args, 100))
    _constant_lr(trainer.state)
    it = iter(trainer.loaders["train"])
    batches = [trainer.prep(next(it)) for _ in range(DP_STEPS)]
    rec["rows"] = int(batches[0]["image"].shape[0])
    merged = []
    sum_dict = steps_mod.sum_dict

    def recording(deltas):
        out = sum_dict(deltas)
        merged.append({k: v.detach().cpu().clone() for k, v in out.items()})
        return out

    before = _cpu_state(trainer.state.model)
    steps_mod.sum_dict = recording
    kernels.SWTA_DELTA.launches = 0
    losses = []
    try:
        for b in batches:
            trainer.state, out = trainer.train_step(trainer.state, b)
            losses.append(float(out["loss"]))
    finally:
        steps_mod.sum_dict = sum_dict
    rec["pretrain"] = {
        "losses": losses, "deltas": merged, "before": before,
        "state": _cpu_state(trainer.state.model),
        "launches": kernels.SWTA_DELTA.launches,
        "ms": _timed(lambda: trainer.train_step(trainer.state, batches[-1]),
                     DP_TIMED, sync)}
    del trainer, batches
    release()

    # one EM and one CPS step, the sweep's flags at a constant lr
    for algo in ("em", "cps"):
        args = train_semi_2d.add_args(common.base_parser_2d(), algo)\
            .parse_args(base + ["-n", "unet", "--regime", "50", "--loss",
                                "dice", "--unsup_weight", "5"] + DP_SGD)
        trainer = train_semi_2d.build(args, algo,
                                      make_semi_loaders(items, args, 50))
        _constant_lr(trainer.state)
        unsup = trainer.prep(trainer.next_unsup())
        sup = trainer.prep(next(iter(trainer.loaders["train_sup"])))
        w = trainer.epoch_weight(0)
        models = ([trainer.state.model1, trainer.state.model2]
                  if algo == "cps" else [trainer.state.model])
        before = [_cpu_state(m) for m in models]
        kernels.SWTA_DELTA.launches = 0
        trainer.state, out = trainer.call_step(sup, unsup, w, 0)

        def again(trainer=trainer, sup=sup, unsup=unsup, w=w):
            trainer.state, _ = trainer.call_step(sup, unsup, w, 0)
        rec[algo] = {
            "losses": [float(out[k]) for k in ("loss", "loss_sup",
                                               "loss_unsup")],
            "before": before, "state": [_cpu_state(m) for m in models],
            "launches": kernels.SWTA_DELTA.launches,
            "ms": _timed(again, DP_TIMED, sync)}
        del trainer, models, sup, unsup
        release()

    # the unet3d fine-tune step at batch 2, the slider of its fresh model
    args = train_sup_3d.add_args(common3d.base_parser_3d()).parse_args(
        ["--device", device, "--path_dataset", data_root, "--dataset_name",
         "Atrial", "--path_root_exp", root, "-n", NET_3D, "-b",
         str(batch_3d), "-e", "1", "-w", "1",
         "--patch_size", ",".join(str(p) for p in PATCH),
         "--num_workers", "4", "--regime", "50",
         # the regime's 2 labelled volumes give one batch of batch_3d
         "--samples_per_volume_train", str(max(1, batch_3d // 2)),
         "--samples_per_volume_val", "1"] + DP_SGD)
    trainer = train_sup_3d.build(args)
    _constant_lr(trainer.state)
    model = trainer.state.model
    model.eval()
    vol = VolumeDataset3D(os.path.join(data_root, "val"), "image",
                          split="test", sup=False).load_raw(0)["image"]
    kernels.SWTA_DELTA.launches = 0
    t0 = time.perf_counter()
    logits = slide_window_inference_device(
        lambda p: primary_logits(NET_3D, model(p)),
        znormalize(vol, "mean"), PATCH, OVERLAP, 2, batch_size=batch_3d,
        device=card)
    sync()
    rec["slider"] = {"logits": logits.cpu().numpy(),
                     "s": time.perf_counter() - t0}
    batch = trainer.prep(next(iter(trainer.loaders["train"])))
    before = _sampled_state(model)
    trainer.state, out = trainer.train_step(trainer.state, batch)
    rec["sup_3d"] = {
        "losses": [float(out["loss"])], "before": before,
        "state": _sampled_state(model),
        "launches": kernels.SWTA_DELTA.launches,
        "ms": _timed(lambda: trainer.train_step(trainer.state, batch),
                     DP_TIMED, sync)}
    if snap_exp is None:
        trainer._save_last(0.5)
        snap_exp = trainer.paths.run
        rec["snap_exp"] = snap_exp
    del trainer, model, batch
    release()

    # test_3d --dp_devices <world> on the single process's snapshot
    kernels.SWTA_DELTA.launches = 0
    res = test_3d.main(
        ["--device", device, "--path_exp", snap_exp, "--path_dataset",
         data_root, "-n", NET_3D, "--best", "last", "-b", str(batch_3d),
         "--patch_size", ",".join(str(p) for p in PATCH),
         "--patch_overlap", ",".join(str(p) for p in OVERLAP),
         "--dp_devices", str(world)])
    rec["test_3d"] = {"metrics": res, "launches": kernels.SWTA_DELTA.launches}
    if world > 1 and card.type == "cuda":
        rec["cuda_collectives"] = cuda_collectives(card)
    return rec


def nccl_job(items, root, device="0"):
    """(ae) one ``unet`` swta_t pretraining step (cuDNN deterministic), in
    a world-size-1 NCCL group or in the plain process: the loss and the
    state after it; in the group also one NCCL all-reduce."""
    import torch
    import torch.distributed as dist
    from hebbax_torch.cli import common
    from hebbax_torch.cli import pretrain_hebbian_unsup_2d as pretrain
    from hebbax_torch.hebb import kernels

    card = common.resolve_device(device)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        args = pretrain.add_args(common.base_parser_2d()).parse_args(
            ["--device", device, "--path_dataset", "synthetic/GlaS",
             "--dataset_name", "GlaS", "--path_root_exp", root,
             "-b", str(BATCH), "-e", "1", "-w", "1", "--num_workers", "4",
             "--debug", "", "-n", "unet", "--exclude", "out_conv",
             "--hebb_mode", "swta_t", "--hebb_inv_temp", str(int(K_TEMP))]
            + DP_SGD)
        trainer = pretrain.build(args, make_loaders(items, args, 100))
        _constant_lr(trainer.state)
        batch = trainer.prep(next(iter(trainer.loaders["train"])))
        kernels.SWTA_DELTA.launches = 0
        trainer.state, out = trainer.train_step(trainer.state, batch)
        rec = {"loss": float(out["loss"]),
               "state": _cpu_state(trainer.state.model),
               "launches": kernels.SWTA_DELTA.launches}
        if dist.is_initialized():
            t = torch.full((4,), 3.0, device=card)
            dist.all_reduce(t)
            rec["backend"] = dist.get_backend()
            rec["all_reduce"] = t.cpu().tolist()
        return rec
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _state_miss(got, ref, before):
    """The dp run's miss of the single process's state as a share of the
    update the single process made (L2 norms): (over every tensor
    together, {tensor: (miss, update)} of the three worst tensors by
    miss / (update + 1e-6))."""
    import torch
    per, total_miss, total_upd = {}, 0.0, 0.0
    for k, r in ref.items():
        if not torch.is_floating_point(r):
            continue
        upd = float(torch.linalg.vector_norm((r - before[k]).double()))
        miss = float(torch.linalg.vector_norm((got[k] - r).double()))
        per[k] = (miss, upd)
        total_miss += miss ** 2
        total_upd += upd ** 2
    worst = sorted(per, key=lambda k: -per[k][0] / (per[k][1] + 1e-6))[:3]
    return (total_miss ** 0.5 / max(total_upd ** 0.5, 1e-30),
            {k: per[k] for k in worst})


def check_dp(ref, ranks, on_card, tag="(ad)"):
    """:func:`dp_job`'s results on ``ranks`` held against the single
    process's ``ref`` (the checks of :func:`phase_dp`); returns the
    errors by path, the merged deltas' misses by step and the slider's."""
    import torch

    n = len(ranks)
    got = ranks[0]
    check([r["rows"] for r in ranks] == [BATCH // n] * n,
          f"{tag} rows per rank {[r['rows'] for r in ranks]}")
    errs = {}
    for path in ("pretrain", "em", "cps", "sup_3d"):
        r_ref = ref[path]
        for r in ranks:
            check(np.allclose(r[path]["losses"], r_ref["losses"], rtol=1e-5,
                              atol=0),
                  f"{tag} {path} rank {r['rank']} losses "
                  f"{r[path]['losses']} vs {r_ref['losses']}")
        states = ([(got[path]["state"], r_ref["state"], r_ref["before"])]
                  if path in ("pretrain", "sup_3d") else
                  list(zip(got[path]["state"], r_ref["state"],
                           r_ref["before"])))
        worst, tensors = 0.0, {}
        for g, r, b in states:
            if not isinstance(r, dict):
                g, r, b = {"s": g}, {"s": r}, {"s": b}
            share, top = _state_miss(g, r, b)
            worst = max(worst, share)
            tensors.update(top)
        log(f"{tag} {path}: the dp state misses the single process's by "
            f"{worst:.3e} of the update; worst tensors (miss, update) "
            f"{tensors}")
        check(worst <= DP_STATE_TOL,
              f"{tag} {path}: the dp state misses the single process's by "
              f"{worst:.3e} of the update")
        check(all(m <= 0.1 * u + 1e-5 for m, u in tensors.values()),
              f"{tag} {path}: a tensor misses by more than 0.1 of its "
              f"update: {tensors}")
        errs[path] = {"loss_rel": max(abs(a - b) / abs(b) for a, b in zip(
            got[path]["losses"], r_ref["losses"])),
            "state_miss_of_update": worst}
        for r in ranks[1:]:       # every rank holds rank 0's state
            a, b = got[path]["state"], r[path]["state"]
            pairs = ([(a, b)] if not isinstance(a, list)
                     else list(zip(a, b)))
            check(all(torch.equal(x[k], y[k]) for x, y in pairs
                      for k in x) if isinstance(pairs[0][0], dict)
                  else all(torch.equal(x, y) for x, y in pairs),
                  f"{tag} {path}: rank {r['rank']}'s state differs from "
                  f"rank 0's")
    # step 1's deltas at K1's tolerance; step 2's come from step 1's
    # states, which may differ by DP_STATE_TOL of its update
    delta_err = []
    for i, (step_g, step_r) in enumerate(zip(got["pretrain"]["deltas"],
                                             ref["pretrain"]["deltas"])):
        check(set(step_g) == set(step_r) and len(step_r) == 22,
              f"{tag} merged deltas at {sorted(step_g)}")
        delta_err.append(max(
            float((step_g[k] - v).abs().max()) / (float(v.abs().max())
                                                  or 1.0)
            for k, v in step_r.items()))
        gate = TOL if i == 0 else DP_STATE_TOL
        check(delta_err[i] <= gate,
              f"{tag} step {i + 1}'s merged deltas miss by "
              f"{delta_err[i]:.3e} of max|delta|")
    for r in ranks:
        if on_card:
            check(r["pretrain"]["launches"] == 22 * DP_STEPS,
                  f"{tag} rank {r['rank']} launched K1 "
                  f"{r['pretrain']['launches']} times, expected 22 x "
                  f"{DP_STEPS}")
        for path in ("em", "cps", "sup_3d"):
            check(r[path]["launches"] == 0,
                  f"{tag} {path} rank {r['rank']} launched K1")
    lg, lr_ = got["slider"]["logits"], ref["slider"]["logits"]
    slider_err = float(np.abs(lg - lr_).max() / max(np.abs(lr_).max(), 1.0))
    check(slider_err <= 1e-5, f"{tag} dp slider misses the plain one by "
                              f"{slider_err:.3e}")
    m_got, m_ref = got["test_3d"]["metrics"], ref["test_3d"]["metrics"]
    check(all(r["test_3d"]["metrics"] is None for r in ranks[1:]),
          f"{tag} test_3d: a rank other than 0 returned metrics")
    check(abs(m_got["dice"] - m_ref["dice"]) <= 1e-3
          and abs(m_got["jaccard"] - m_ref["jaccard"]) <= 1e-3,
          f"{tag} test_3d --dp_devices {n} {m_got} vs plain {m_ref}")
    loss_rel = {k: v["loss_rel"] for k, v in errs.items()}
    miss = {k: v["state_miss_of_update"] for k, v in errs.items()}
    log(f"{tag} {n} ranks vs one process: losses rel {loss_rel}, state "
        f"miss / update {miss}, merged deltas by step {delta_err} of "
        f"max|delta|, slider {slider_err:.3e}, K1 launches per rank "
        f"{[r['pretrain']['launches'] for r in ranks]} in {DP_STEPS} steps")
    return errs, delta_err, slider_err


def dp_record(ref, ranks, errs, delta_err, slider_err, seconds):
    paths = ("pretrain", "em", "cps", "sup_3d")
    return {
        "ranks": len(ranks), "errors": errs, "delta_max_rel": delta_err,
        "slider_max_rel": slider_err,
        "step_ms": {p: {"single": ref[p]["ms"],
                        "ranks": [r[p]["ms"] for r in ranks]}
                    for p in paths},
        "slider_s": {"single": ref["slider"]["s"],
                     "ranks": [r["slider"]["s"] for r in ranks]},
        "test_3d": {"single": ref["test_3d"]["metrics"],
                    "dp": ranks[0]["test_3d"]["metrics"]},
        "seconds": seconds}


def phase_dp(items, data_root, device="0"):
    """Phase 12: data parallelism.  :func:`dp_job` in this process, then
    in 2 spawned ranks sharing the card over gloo (a card cannot hold two
    NCCL ranks), each with its half of every batch; the ranks must agree
    with each other and with the single process (:func:`check_dp`):
    losses within 1e-5, the merged deltas within 1e-4 of max|delta| (K1's
    tolerance; the second step's, which start from the first step's
    states, within 1e-3), the state after the steps (parameters and BN
    statistics) within 1e-3 of the update over all tensors (L2) and no
    tensor beyond 0.1 of its own (:data:`DP_STATE_TOL`), K1 22 launches
    per rank per (ad) step, the dp slider's logits within 1e-5 of
    max|logit| of the plain one, and ``test_3d --dp_devices 2``'s Dice
    and Jaccard within 1e-3 of the plain test's.  (ae) one NCCL
    world-size-1 step equal to the plain step to the bit.  Returns the
    launches by path and the ``data_parallel_path`` record."""
    import torch
    from hebbax_torch import parallel

    root = os.path.join(RUN_DIR, "dp")
    t0 = time.perf_counter()
    ref = dp_job(items, data_root, os.path.join(root, "single"), None,
                 device)
    t_single = time.perf_counter() - t0
    release()
    t0 = time.perf_counter()
    on_card = device != "cpu"
    ranks = parallel.run_ranks(
        dp_job, DP_RANKS,
        (items, data_root, os.path.join(root, "ranks"), ref["snap_exp"],
         device), device_type="cuda" if on_card else "cpu",
        backend="gloo", timeout=DP_TIMEOUT_S, deadline=DP_DEADLINE_S)
    t_ranks = time.perf_counter() - t0
    errs, delta_err, slider_err = check_dp(ref, ranks, on_card)
    got = ranks[0]
    log(f"(ad) collectives on CUDA tensors: {got.get('cuda_collectives')}")

    # (ae) NCCL at world size 1
    plain = nccl_job(items, os.path.join(root, "plain"), device)
    nccl = None
    if on_card:
        nccl = parallel.run_ranks(
            nccl_job, 1, (items, os.path.join(root, "nccl"), device),
            device_type="cuda", backend="nccl", timeout=DP_TIMEOUT_S,
            deadline=DP_DEADLINE_S)[0]
        check(nccl["backend"] == "nccl" and nccl["all_reduce"] == [3.0] * 4,
              f"(ae) NCCL group {nccl.get('backend')} "
              f"{nccl.get('all_reduce')}")
        check(nccl["loss"] == plain["loss"] and all(
            torch.equal(nccl["state"][k], v)
            for k, v in plain["state"].items()),
            "(ae) the NCCL world-size-1 step is not the plain step")
        check(nccl["launches"] == plain["launches"] == 22,
              f"(ae) K1 launches {nccl['launches']} / {plain['launches']}")
    launches = {
        "dp_pretrain": got["pretrain"]["launches"],
        "dp_pretrain_rank1": ranks[1]["pretrain"]["launches"],
        "dp_em": got["em"]["launches"], "dp_cps": got["cps"]["launches"],
        "dp_sup_3d": got["sup_3d"]["launches"],
        "dp_test_3d": got["test_3d"]["launches"],
        "dp_nccl_ws1": None if nccl is None else nccl["launches"]}
    record = dp_record(ref, ranks, errs, delta_err, slider_err,
                       {"single": t_single, "ranks": t_ranks})
    record.update(backend="gloo, ranks sharing one card", launches=launches,
                  cuda_collectives=got.get("cuda_collectives"),
                  nccl_ws1_bit_equal=nccl is not None)
    return launches, record


def phase_dp_cards(items, data_root):
    """``python3 chip_smoke.py --dp-cards`` on a machine with N >= 2
    cards: :func:`dp_job` in this process on card 0, then on N NCCL ranks,
    one per card (a batch of 32 over N, the 3D batch N), held to it as in
    :func:`phase_dp` (:func:`check_dp`).  Returns the
    ``data_parallel_cards_path`` record."""
    import torch
    from hebbax_torch import parallel

    n = torch.cuda.device_count()
    check(n >= 2, f"--dp-cards needs 2 or more cards, found {n}")
    root = os.path.join(RUN_DIR, "dp_cards")
    t0 = time.perf_counter()
    ref = dp_job(items, data_root, os.path.join(root, "single"), None, "0",
                 batch_3d=n)
    t_single = time.perf_counter() - t0
    release()
    t0 = time.perf_counter()
    ranks = parallel.run_ranks(
        dp_job, n, (items, data_root, os.path.join(root, "ranks"),
                    ref["snap_exp"], "rank", n),
        device_type="cuda", backend="nccl", timeout=DP_TIMEOUT_S,
        deadline=DP_DEADLINE_S)
    t_ranks = time.perf_counter() - t0
    errs, delta_err, slider_err = check_dp(ranks=ranks, ref=ref,
                                           on_card=True, tag="(af)")
    record = dp_record(ref, ranks, errs, delta_err, slider_err,
                       {"single": t_single, "ranks": t_ranks})
    record.update(backend="nccl, one rank per card",
                  launches_per_rank=[r["pretrain"]["launches"]
                                     for r in ranks],
                  cuda_collectives=ranks[0].get("cuda_collectives"))
    return record


# -- 13: multi-class metrics, the CCT options, the delta dtype ----------------

MC_DATASET, MC_CLASSES = "GlaS3", 3
# each _rc name against the folded name without _rc: hebbax's _rc is
# identical to it but for the recompute
RC_NAMES = (("unet3d_cct_s2d", "unet3d_cct_s2d_rc"),
            ("vnet_cct_s2d", "vnet_cct_s2d_rc"))
RC_GRAD_TOL = 1e-6              # of max|grad|: the recompute is exact
BATCHED_EVAL_TOL = 1e-5         # of max|logit|: one decode of 4N, eval


def register_multiclass_dataset():
    """``GlaS3``: GlaS with 3 classes, registered in this process only
    (hebbax has no multi-class dataset either)."""
    from hebbax_torch.config import datasets
    datasets._CONFIG[MC_DATASET] = dict(
        datasets.dataset_cfg("GlaS"), NUM_CLASSES=MC_CLASSES,
        PALETTE=[0, 0, 0, 255, 255, 255, 255, 0, 0])


def three_class_items(items):
    """The synthetic items with class 2 on the right half of each disc."""
    out = {}
    for split, rows in items.items():
        out[split] = []
        for name, img, mask in rows:
            m = mask.copy()
            m[:, m.shape[1] // 2:] *= 2
            out[split].append((name, img, m))
    return out


def cli_base_mc(device):
    return [a if a != "GlaS" else MC_DATASET for a in cli_base(device)]


def phase_multiclass(items, device="0"):
    """(ag) A 3-class run of the main path: ``pretrain_hebbian_unsup_2d
    -n unet`` (swta_t, 4 steps: K1 22 launches per step), ``train_sup_2d
    --load_hebbian_weights`` validated through the confusion accumulator
    on the card (no threshold stored), ``test_2d --threshold 0.5``; the
    card's confusion histogram of the validation logits equal to the
    CPU's on the same logits; finite Jaccard / Dice."""
    import torch
    from hebbax_torch.cli import common
    from hebbax_torch.cli import pretrain_hebbian_unsup_2d as pretrain
    from hebbax_torch.cli import test_2d, train_sup_2d
    from hebbax_torch.config.datasets import dataset_cfg, input_stats
    from hebbax_torch.data import Loader
    from hebbax_torch.hebb import kernels
    from hebbax_torch.ops.metrics import ConfusionAccumulator
    from hebbax_torch.utils.checkpoint import load_state_dict

    register_multiclass_dataset()
    items = three_class_items(items)
    on = "cpu" if device == "cpu" else "cuda"
    launches, record = {}, {}
    args = pretrain.add_args(common.base_parser_2d()).parse_args(
        cli_base_mc(device) + [
            "-n", "unet", "--exclude", "out_conv", "--hebb_mode", "swta_t",
            "--hebb_inv_temp", str(int(K_TEMP)), "--optimizer", "adam",
            "-l", "1e-6"])
    trainer = pretrain.build(args, make_loaders(items, args, 100))
    times = []
    trainer.train_step = timed_step(trainer.train_step, times)
    kernels.SWTA_DELTA.launches = 0
    trainer.run()
    launches["mc_pretrain"] = kernels.SWTA_DELTA.launches
    check(launches["mc_pretrain"] == 22 * len(times),
          f"(ag) pretrain launched K1 {launches['mc_pretrain']} times in "
          f"{len(times)} steps")
    check(trainer.num_classes == MC_CLASSES, "(ag) not a 3-class run")
    snap = os.path.join(trainer.paths.checkpoints, "last.ckpt")
    record["pretrain"] = {"steps": len(times), "step_ms": times}

    args = train_sup_2d.add_args(common.base_parser_2d()).parse_args(
        cli_base_mc(device) + ["--load_hebbian_weights", snap,
                               "--regime", "50"])
    trainer = train_sup_2d.build(args, make_loaders(items, args, 50))
    times = []
    raw_step = trainer.train_step
    trainer.train_step = timed_step(raw_step, times)
    kernels.SWTA_DELTA.launches = 0
    trainer.run()
    launches["mc_sup"] = kernels.SWTA_DELTA.launches
    losses, ok = finite_losses(trainer)
    check(ok, f"(ag) fine-tune losses {losses}")
    best = trainer.best_val
    check(best[0] is None and all(np.isfinite(best[1:])),
          f"(ag) best validation {best}")
    _, meta = load_state_dict(os.path.join(trainer.paths.checkpoints,
                                           "best_JI.ckpt"))
    check(meta["threshold"] is None,
          f"(ag) the snapshot stores threshold {meta['threshold']}")
    # the confusion histogram of the validation logits, card vs CPU
    acc_card, acc_cpu = (ConfusionAccumulator(MC_CLASSES),
                         ConfusionAccumulator(MC_CLASSES))
    for batch in trainer.loaders["val"]:
        b = trainer.prep(batch)
        logits = trainer.eval_step(b)["logits"]
        acc_card.update(logits, b["mask"])
        acc_cpu.update(logits.cpu(), b["mask"].cpu())
    check(acc_card.hist.device.type == on, "(ag) histogram off the card")
    check(torch.equal(acc_card.hist.cpu(), acc_cpu.hist),
          "(ag) the card's confusion histogram differs from the CPU's")
    ev = acc_card.finalize()
    check(ev == acc_cpu.finalize(), "(ag) card and CPU metrics differ")
    record["sup"] = {"steps": len(times), "step_ms": times,
                     "best_val": best, "val_recomputed": list(ev),
                     "histogram": acc_card.hist.cpu().tolist()}
    run = trainer.paths.run
    record["sup"]["steady_step_ms"] = steady_step_ms(trainer, raw_step)
    del trainer, raw_step
    release()

    targs = test_2d.build_parser().parse_args(
        ["--device", device, "--path_exp", run, "--dataset_name",
         MC_DATASET, "--threshold", "0.5", "-n", "unet",
         "--hebbian_pretrain", "1", "-b", str(BATCH), "--num_workers", "4"])
    mean, std = input_stats(dataset_cfg(MC_DATASET), "image")
    test_ds = array_dataset_class()(items["val"], mean, std, "test")
    kernels.SWTA_DELTA.launches = 0
    metrics = test_2d.run_test(targs, Loader(test_ds, BATCH,
                                             num_workers=4))
    launches["mc_test"] = kernels.SWTA_DELTA.launches
    check(metrics["thresh"] is None and all(
        np.isfinite(metrics[k]) for k in ("segm/dice", "segm/jaccard")),
        f"(ag) test metrics {metrics}")
    record["test"] = metrics
    log(f"(ag) 3-class: K1 {launches}, best validation {best}, histogram "
        f"card == CPU, test {metrics}")
    return launches, record


def phase_batched(card, items, images, device="0"):
    """(ah) ``unet_cct_s2d_batched``.  ``pretrain_hebbian_unsup_2d -n
    unet_cct_s2d_batched --exclude out_conv`` runs the unfolded serial
    ``unet_cct``, as hebbax's CLI does (``pretrain_base_network``): K1 58
    launches per step (4 steps at batch 32).  A Hebbian training forward
    of the batched network itself (``get_network``) launches K1 22 times,
    the 12 decoder sites at batch 4N = 128; then one ``train_semi_2d cct
    -n unet_cct_s2d_batched`` step from the pretraining snapshot; an eval
    forward equal to ``unet_cct``'s on the same weights (1e-5 of
    max|logit|); K1 against its plain version at the 22 sites of a
    batched training forward (TOL)."""
    import torch
    from hebbax_torch.cli import common
    from hebbax_torch.cli import pretrain_hebbian_unsup_2d as pretrain
    from hebbax_torch.cli import train_semi_2d
    from hebbax_torch.hebb import kernels, rules
    from hebbax_torch.hebb.spec import HebbSpec
    from hebbax_torch.hebb.surgery import pop_deltas
    from hebbax_torch.models import get_network
    from hebbax_torch.utils.seeding import make_generator

    net = "unet_cct_s2d_batched"
    launches, record = {}, {}
    args = pretrain.add_args(common.base_parser_2d()).parse_args(
        cli_base(device) + [
            "-n", net, "--exclude", "out_conv", "--hebb_mode", "swta_t",
            "--hebb_inv_temp", str(int(K_TEMP)), "--optimizer", "adam",
            "-l", "1e-6"])
    trainer = pretrain.build(args, make_loaders(items, args, 100))
    check(args.network == "unet_cct"
          and not trainer.state.model.batched_aux,
          f"(ah) pretraining ran {args.network}, not hebbax's unet_cct")
    times = []
    trainer.train_step = timed_step(trainer.train_step, times)
    kernels.SWTA_DELTA.launches = 0
    trainer.run()
    launches["batched_pretrain"] = kernels.SWTA_DELTA.launches
    check(launches["batched_pretrain"] == 58 * len(times),
          f"(ah) pretrain launched K1 {launches['batched_pretrain']} times "
          f"in {len(times)} steps, expected 58 per step")
    losses, ok = finite_losses(trainer)
    check(ok, f"(ah) pretrain losses {losses}")
    snap = os.path.join(trainer.paths.checkpoints, "last.ckpt")
    record["pretrain"] = {"network": args.network, "steps": len(times),
                          "step_ms": times}
    del trainer
    release()

    # the batched network's own Hebbian training forward
    spec = HebbSpec(mode="swta_t", k=K_TEMP, exclude=("out_conv",))
    models = [get_network(n, 3, 2, hebb=spec, device=card,
                          generator=make_generator(4),
                          perturb_generator=make_generator(5, card))
              for n in ("unet_cct", net)]
    models[1].load_state_dict(models[0].state_dict())
    # eval, before a training forward moves the statistics: the batched
    # name equals unet_cct on the same weights
    outs = []
    for m in models:
        m.eval()
        with torch.no_grad():
            outs.append(m(images)[0])
    scale = float(outs[0].abs().max())
    err = float((outs[1] - outs[0]).abs().max())
    check(err <= BATCHED_EVAL_TOL * scale,
          f"(ah) batched eval differs from unet_cct by {err} of {scale}")
    batches = []
    orig = kernels.swta_delta

    def seen(w, x, *a, **k):
        batches.append(x.shape[0])
        return orig(w, x, *a, **k)
    kernels.swta_delta = seen
    models[1].train()
    kernels.SWTA_DELTA.launches = 0
    try:
        with torch.no_grad():
            models[1](images)
        torch.cuda.synchronize()
    finally:
        kernels.swta_delta = orig
    launches["batched_forward"] = kernels.SWTA_DELTA.launches
    n = images.shape[0]
    check(launches["batched_forward"] == 22
          and sorted(batches) == [n] * 10 + [4 * n] * 12,
          f"(ah) batched forward: K1 {launches['batched_forward']}, "
          f"delta batches {sorted(batches)}")
    pop_deltas(models[1])

    sargs = train_semi_2d.add_args(common.base_parser_2d(), "cct")\
        .parse_args(cli_base(device) + [
            "-n", net, "--load_hebbian_weights", snap, "--hebb_inv_temp",
            str(int(K_TEMP)), "--regime", "50", "--optimizer", "sgd", "-l",
            "0.5", "--loss", "dice", "--unsup_weight", "5"])
    trainer = train_semi_2d.build(sargs, "cct",
                                  make_semi_loaders(items, sargs, 50))
    check(trainer.state.model.batched_aux, "(ah) the CCT run is not batched")
    kernels.SWTA_DELTA.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step_runner(trainer, trainer.train_step)()
    torch.cuda.synchronize()
    record["cct_step_ms"] = (time.perf_counter() - t0) * 1e3
    launches["batched_cct"] = kernels.SWTA_DELTA.launches
    check(launches["batched_cct"] == 0, "(ah) the CCT step launched K1")
    check(all(bool(torch.isfinite(p).all())
              for p in trainer.state.model.parameters()),
          "(ah) the CCT step left a non-finite parameter")
    del trainer
    release()

    # K1 against its plain version at the sites of a batched forward, on
    # the operands K1 sees there (a folded site's unfolded x and y)
    models[1].train()
    with torch.no_grad(), _SiteRecorder() as recorder:
        models[1](images)
    pop_deltas(models[1])
    sites = recorder.sites
    check(len(sites) == 22 and sum(x.shape[0] == 4 * n
                                   for _, x, *_ in sites) == 12,
          f"(ah) {len(sites)} sites")
    worst = 0.0
    for i, (w, x, y, k, pad, _) in enumerate(sites):
        pad = rules._tuple(pad, 2)
        plain = rules.swta_conv_delta(w, x, y, k, pad)
        got = kernels.SWTA_DELTA(w, x, y, k, pad)
        rel = float((got - plain).abs().max()) / float(plain.abs().max())
        check(np.isfinite(rel) and rel <= TOL,
              f"(ah) site {i}: K1 vs plain {rel} of max|delta|")
        worst = max(worst, rel)
    record.update(eval_err=err, eval_scale=scale, k1_vs_plain_rel=worst,
                  sites_4n=12)
    log(f"(ah) {net}: K1 {launches}, eval vs unet_cct {err:.3e} of "
        f"{scale:.3f}, K1 vs plain at the 4N sites {worst:.3e}")
    del models, sites
    release()
    return launches, record


def cct_3d_step(model, x, mask):
    """One CCT training forward and backward of a 3D CCT network (dice on
    the main output, the perturbed outputs' softmax MSE to it): returns
    the grads."""
    import torch
    from hebbax_torch.ops.losses import dice_loss, softmax_mse_loss

    outs = model(x)
    loss = dice_loss(outs[0], mask) + sum(
        softmax_mse_loss(a, outs[0]).mean() for a in outs[1:])
    return torch.autograd.grad(loss, [p for p in model.parameters()])


def phase_rc(card):
    """(ai) One CCT step of ``unet3d_cct_s2d_rc`` / ``vnet_cct_s2d_rc``
    against the folded ``unet3d_cct_s2d`` / ``vnet_cct_s2d`` (no
    recompute) from the same state and draws at batch 1, 96x96x80: the
    grads within RC_GRAD_TOL of max|grad|, the BN running statistics
    equal to the bit, the peak memory of each, and the steady step times
    (``measure_step``)."""
    import torch
    from hebbax_torch.models import get_network
    from hebbax_torch.utils.seeding import make_generator
    from hebbax_torch.utils.timing import measure_step

    on = torch.device(card).type
    x = torch.from_numpy(np.random.default_rng(21).standard_normal(
        (1, 1) + PATCH).astype(np.float32)).to(card)
    mask = (x[:, 0] > 0.5).long()
    record = {}
    for plain_name, rc_name in RC_NAMES:
        res = {}
        for name in (plain_name, rc_name):
            model = get_network(name, 1, 2, device=card,
                                generator=make_generator(6),
                                dropout_generator=make_generator(7, card),
                                perturb_generator=make_generator(8, card))
            model.train()
            release()
            reset_peak(on)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            grads = cct_3d_step(model, x, mask)
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
            peak = peak_gib(on)
            stats = {k: v.clone() for k, v in model.state_dict().items()
                     if k.endswith(("running_mean", "running_var"))}

            def step(s, model=model):
                return s + 1, cct_3d_step(model, x, mask)
            steady = measure_step(step, 0, n1=1, n2=3, warmup=1) * 1e3
            res[name] = dict(grads=grads, stats=stats, peak_gib=peak,
                             first_ms=first_ms, steady_ms=steady)
            del model, step
        a, b = res[plain_name], res[rc_name]
        scale = max(float(g.abs().max()) for g in a["grads"])
        err = max(float((u - v).abs().max())
                  for u, v in zip(a["grads"], b["grads"]))
        check(err <= RC_GRAD_TOL * scale,
              f"(ai) {rc_name} grads differ from {plain_name}'s by {err} "
              f"of {scale}")
        check(all(torch.equal(a["stats"][k], b["stats"][k])
                  for k in a["stats"]),
              f"(ai) {rc_name}: BN statistics differ from {plain_name}'s")
        record[rc_name] = {
            "grad_max_abs_diff": err, "grad_scale": scale,
            "stats_equal": True,
            **{f"{k}_{tag}": r[k] for tag, r in (("plain", a), ("rc", b))
               for k in ("peak_gib", "first_ms", "steady_ms")}}
        log(f"(ai) {rc_name} vs {plain_name}: grads {err:.3e} of "
            f"{scale:.3e}, BN statistics equal; peak GiB "
            f"{a['peak_gib']} -> {b['peak_gib']}, steady step ms "
            f"{a['steady_ms']:.2f} -> {b['steady_ms']:.2f}")
        del res, a, b
        release()
    return record


def phase_delta_dtype(card):
    """(aj) The composed swta delta at the 22 sites of a ``unet3d``
    training forward (batch 1, 96x96x80, as (j)) in float32 and in
    bfloat16 (``HEBBAX_DELTA_DTYPE``'s arithmetic: bf16 copies of w, x,
    y): both timed with CUDA events, bf16's error against float32."""
    import torch
    from hebbax_torch.hebb import rules

    model = hebbian_unet3d(card, seed=3)
    images = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (1, 1) + PATCH).astype(np.float32)).to(card)
    sites = capture_sites(model, images)
    check(len(sites) == 22, f"(aj) {len(sites)} unet3d sites")
    rows = []
    for name, w, xs, ys, _ in sites:
        mod = model.get_submodule(name)
        bf = [t.to(torch.bfloat16) for t in (w, xs, ys)]

        def delta(ops, dtype, mod=mod):
            return rules.compute_delta(mod.spec, *ops, mod.padding,
                                       mod.transpose, mod.stride,
                                       dtype=dtype).float()
        ref = delta((w, xs, ys), torch.float32)
        got = delta(bf, torch.bfloat16)
        rel = float((got - ref).abs().max()) / float(ref.abs().max())
        check(np.isfinite(rel), f"(aj) {name}: non-finite bf16 delta")
        f32_ms = cuda_time_ms(lambda: delta((w, xs, ys), torch.float32),
                              warmup=1, iters=5)
        bf16_ms = cuda_time_ms(lambda: delta(bf, torch.bfloat16),
                               warmup=1, iters=5)
        rows.append(dict(site=name, f32_ms=f32_ms, bf16_ms=bf16_ms,
                         bf16_rel_err=rel))
    total = {k: sum(r[k] for r in rows) for k in ("f32_ms", "bf16_ms")}
    worst = max(r["bf16_rel_err"] for r in rows)
    log(f"(aj) composed 3D delta over 22 sites: float32 "
        f"{total['f32_ms']:.2f} ms, bfloat16 {total['bf16_ms']:.2f} ms, "
        f"bf16 error up to {worst:.3e} of max|delta|")
    del model, sites
    release()
    return {**total, "bf16_rel_err_max": worst, "sites": rows}


def phase_tail(card, items, images, device="0"):
    """Phase 13: (ag)-(aj) (``card`` the torch device, ``device`` the
    CLIs' ``--device``); returns the launches by path and the
    ``tail_path`` record."""
    l_ag, r_ag = phase_multiclass(items, device)
    l_ah, r_ah = phase_batched(card, items, images, device)
    r_ai = phase_rc(card)
    r_aj = phase_delta_dtype(card)
    launches = {**l_ag, **l_ah}
    return launches, {"launches": launches, "ag": r_ag, "ah": r_ah,
                      "ai": r_ai, "aj": r_aj}


# -- phase 14: the space-to-depth folded networks ----------------------------

# each ``_s2d`` name (and UNet2DS2D(head_depth=2)) -> the unfolded twin's
# registry name and the class options the name adds
S2D_2D = {"unet_s2d": ("unet", {}), "unet_urpc_s2d": ("unet_urpc", {}),
          "unet_cct_s2d": ("unet_cct", {}),
          "unet_cct_s2d_batched": ("unet_cct", {"batched_aux": True}),
          "unet_s2d_head2": ("unet", {})}
S2D_3D = {"unet3d_s2d": ("unet3d", {}), "unet3d_dtc_s2d": ("unet3d_dtc", {}),
          "unet3d_cct_s2d": ("unet3d_cct", {}),
          "unet3d_cct_s2d_rc": ("unet3d_cct", {"remat": True,
                                               "remat_policy": "convs"}),
          "unet3d_cct_s2d_batched": ("unet3d_cct", {"batched_aux": True}),
          "unet3d_cct_s2d_batched_rc": ("unet3d_cct", {
              "batched_aux": True, "remat": True, "remat_policy": "convs"}),
          "unet3d_urpc_s2d": ("unet3d_urpc", {}),
          "vnet_s2d": ("vnet", {}), "vnet_dtc_s2d": ("vnet_dtc", {}),
          "vnet_cct_s2d": ("vnet_cct", {}),
          "vnet_cct_s2d_rc": ("vnet_cct", {"remat": True,
                                           "remat_policy": "convs"}),
          "vnet_cct_s2d_batched": ("vnet_cct", {"batched_aux": True}),
          "vnet_cct_s2d_batched_rc": ("vnet_cct", {
              "batched_aux": True, "remat": True, "remat_policy": "convs"})}
S2D_HEADS = {"unet": ("out_conv",), "unet_urpc": DEEP4["unet_urpc"][0],
             "unet_cct": ("out_conv",), "unet3d": ("conv",),
             "unet3d_dtc": ("out_sdf", "out_seg"), "unet3d_cct": ("conv",),
             "unet3d_urpc": ("dsv1", "dsv2", "dsv3", "dsv4"),
             "vnet": VNET_EXCLUDE,
             "vnet_dtc": ("out_sdf.conv2", "out_seg.conv2"),
             "vnet_cct": ("main_decoder.out_tr.conv2",)}
S2D_K1 = {"unet_s2d": 22, "unet_urpc_s2d": 22, "unet_cct_s2d": 58,
          "unet_cct_s2d_batched": 22, "unet_s2d_head2": 22}
# P1 launches of one fine-tune forward and backward on the card: the
# network's folded 3D pools (every other network: none; the unet3d_s2d
# names run as their unfolded twins and pool through F.max_pool3d)
S2D_P1 = {"unet3d_urpc_s2d": 2}
# P1 launches by path, filled by (p), (t) and (al)
P1_LAUNCHES = {}
S2D_OUT_TOL = 1e-4      # folded vs twin outputs, of max(1, max|output|)
S2D_DELTA_TOL = 1e-3    # folded vs twin deltas, of max|delta|
S2D_GRAD_TOL = 1e-3     # folded vs twin gradients, of the largest |grad|
S2D_STATS_RTOL, S2D_STATS_ATOL = 1e-4, 1e-5
S2D_FOLDED_DELTA_TOL = 1e-3     # (an) folded-layout delta vs K1's
S2D_GRADS_F64 = ("unet3d_urpc_s2d",)


def s2d_pair(name, card, nd):
    """(the folded network of ``name``, its unfolded twin), both Hebbian
    (swta_t, K=50, heads excluded), from the same generators (init on the
    CPU; dropout and perturbations on the card, equal draws)."""
    import torch
    from hebbax_torch.hebb.spec import HebbSpec
    from hebbax_torch.models import get_network, registry
    from hebbax_torch.models.unet2d_s2d import UNet2DS2D
    from hebbax_torch.utils.seeding import make_generator

    table = S2D_2D if nd == 2 else S2D_3D
    twin_name, opts = table[name]
    spec = HebbSpec(mode="swta_t", k=K_TEMP,
                    exclude=S2D_HEADS[twin_name])
    in_ch = 3 if nd == 2 else 1
    models = []
    for folded in (True, False):
        kw = dict(in_channels=in_ch, n_cls=2, hebb=spec, device=card,
                  generator=make_generator(31),
                  dropout_generator=make_generator(32, card))
        if "cct" in name:
            kw["perturb_generator"] = make_generator(33, card)
        if not folded:
            base = registry._REGISTRY[twin_name][0]
            m = base(**opts, **kw)
        elif name == "unet_s2d_head2":
            m = UNet2DS2D(head_depth=2, **kw)
        else:
            m = get_network(name, in_ch, 2, hebb=spec, device=card,
                            generator=kw["generator"],
                            dropout_generator=kw["dropout_generator"],
                            perturb_generator=kw.get("perturb_generator"))
        models.append(m)
    a, b = models
    check(all(torch.equal(u, v) for u, v in zip(a.state_dict().values(),
                                                b.state_dict().values())),
          f"(s2d) {name}: the folded network's parameters are not its "
          f"twin's")
    return a, b


def _outs(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _max_rel(got, ref, floor=0.0):
    """max |got - ref| over the pairs, over max(floor, max|ref|)."""
    err = max(float((g.float() - r.float()).abs().max())
              for g, r in zip(got, ref))
    scale = max(floor, max(float(r.float().abs().max()) for r in ref))
    return err / scale if scale else err


def _deltas_rel(a, b):
    check(a.keys() == b.keys() and a, f"(s2d) delta sites {sorted(a)} vs "
                                      f"{sorted(b)}")
    return max(float((a[k] - b[k]).abs().max())
               / max(float(b[k].abs().max()), 1e-30) for k in a)


def _stats(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _stats_ok(a, b):
    import torch
    return a.keys() == b.keys() and all(torch.allclose(
        a[k], b[k], rtol=S2D_STATS_RTOL, atol=S2D_STATS_ATOL) for k in a)


def _finetune_grads(model, x):
    """One fine-tune step's gradients: the spec at alpha 0 (normalized
    weights, no delta), the loss the mean square of every output."""
    import dataclasses

    import torch
    from hebbax_torch.hebb.layers import HConv

    for m in model.modules():
        if isinstance(m, HConv) and m.spec is not None:
            m.spec = dataclasses.replace(m.spec, alpha=0.0)
    model.train()
    loss = sum(torch.mean(o.float() ** 2) for o in _outs(model(x)))
    names = [n for n, _ in model.named_parameters()]
    return dict(zip(names, torch.autograd.grad(loss,
                                               list(model.parameters()))))


def _grads_rel(a, b):
    scale = max(float(v.abs().max()) for v in b.values())
    return max(float((a[k] - b[k]).abs().max()) for k in b) / scale


class _SiteRecorder:
    """Records the operands every ``kernels.swta_delta`` call receives
    (what K1 sees at a site: the unfolded x and y), while installed."""

    def __init__(self):
        self.sites = []

    def __enter__(self):
        from hebbax_torch.hebb import kernels
        self._orig = kernels.swta_delta

        def recording(w, x, y, k, padding, stride=1, dtype=None, **kw):
            self.sites.append((w.detach().clone(), x.detach().clone(),
                               y.detach().clone(), k, padding, stride))
            return self._orig(w, x, y, k, padding, stride,
                              **({} if dtype is None else {"dtype": dtype}))
        kernels.swta_delta = recording
        return self

    def __exit__(self, *exc):
        from hebbax_torch.hebb import kernels
        kernels.swta_delta = self._orig


def _k1_vs_plain(sites):
    """K1 against its plain version on recorded 2D stride-1 sites (these
    launches are not a path's): the largest error over max|plain|."""
    import torch
    from hebbax_torch.hebb import kernels, rules

    worst = 0.0
    for w, x, y, k, pad, stride in sites:
        got = kernels.SWTA_DELTA(w.float().contiguous(), x.float()
                                 .contiguous(), y.float().contiguous(), k,
                                 rules._tuple(pad, 2))
        ref = rules.swta_conv_delta(w, x, y, k, rules._tuple(pad, 2))
        torch.cuda.synchronize()
        worst = max(worst, float((got - ref).abs().max())
                    / float(ref.abs().max()))
    return worst


def s2d_twin_check(name, card, x, nd, tag):
    """Eval outputs, one Hebbian training forward (K1 launches, deltas,
    BN running statistics) and one fine-tune step's gradients of the
    folded network of ``name`` against its unfolded twin; the folded
    step's peak memory and P1 launches beside the twin's peak.  Returns
    (K1 launches of the folded Hebbian forward, the record)."""
    import torch
    from hebbax_torch.hebb import kernels
    from hebbax_torch.hebb.surgery import pop_deltas
    from hebbax_torch.ops.s2d3d_kernels import SUBPIXEL_MAX3

    on = torch.device(card).type
    a, b = s2d_pair(name, card, nd)
    a.eval(), b.eval()
    with torch.no_grad():
        eval_err = _max_rel(_outs(a(x)), _outs(b(x)), 1.0)
    check(eval_err <= S2D_OUT_TOL,
          f"{tag} {name}: eval outputs differ by {eval_err} of scale")
    rec = {"eval_rel_err": eval_err}
    a.train(), b.train()
    with torch.no_grad(), _SiteRecorder() as sites:
        kernels.SWTA_DELTA.launches = 0
        out_a = _outs(a(x))
        torch.cuda.synchronize()
        launches = kernels.SWTA_DELTA.launches
        out_b = _outs(b(x))
    want = S2D_K1.get(name, 0) if on == "cuda" else launches
    check(launches == want, f"{tag} {name}: K1 launched {launches} times "
                            f"in the Hebbian forward, expected {want}")
    rec["k1_launches"] = launches
    rec["train_rel_err"] = _max_rel(out_a, out_b, 1.0)
    check(rec["train_rel_err"] <= S2D_OUT_TOL,
          f"{tag} {name}: training outputs differ by "
          f"{rec['train_rel_err']} of scale")
    rec["delta_rel_err"] = _deltas_rel(pop_deltas(a), pop_deltas(b))
    check(rec["delta_rel_err"] <= S2D_DELTA_TOL,
          f"{tag} {name}: deltas differ by {rec['delta_rel_err']} of their "
          f"scale")
    check(_stats_ok(_stats(a), _stats(b)),
          f"{tag} {name}: BN running statistics differ from the twin's")
    rec["stats_equal_within_tol"] = True
    if nd == 2 and on == "cuda":
        rec["k1_vs_plain_rel_err"] = _k1_vs_plain(
            [s for s in sites.sites if len(s[0].shape) == 4])
        check(rec["k1_vs_plain_rel_err"] <= TOL,
              f"{tag} {name}: K1 vs its plain version "
              f"{rec['k1_vs_plain_rel_err']} at the folded sites")
    del sites, out_a, out_b
    peaks, grads, p1 = {}, {}, {}
    for key, m in (("folded", a), ("twin", b)):
        release()
        reset_peak(on)
        SUBPIXEL_MAX3.launches = 0
        grads[key] = {k: v.detach() for k, v in _finetune_grads(m,
                                                                x).items()}
        torch.cuda.synchronize()
        p1[key] = SUBPIXEL_MAX3.launches
        peaks[key] = peak_gib(on)
    want = S2D_P1.get(name, 0) if on == "cuda" else 0
    check(p1 == {"folded": want, "twin": 0},
          f"{tag} {name}: P1 launches {p1} in the fine-tune steps, "
          f"expected {want} (folded) and 0 (twin)")
    rec["p1_launches"] = p1["folded"]
    # URPC's float32 gradients are ill-conditioned (hebbax's own folded
    # and unfolded URPC differ by 2.8e-3 of the largest in float32, and
    # hebbax holds them in float64): its step is compared in float64, on
    # the CPU, since the folded pool takes float32 and bfloat16 alone on
    # the card (P1); the pair is made anew there from the same seeds
    f64 = name in S2D_GRADS_F64
    rec["grad_dtype"] = "float64" if f64 else "float32"
    rec["grad_device"] = "cpu" if f64 else on
    if f64:
        del grads
        release()
        a64, b64 = (m.double() for m in s2d_pair(name, "cpu", nd))
        x64 = x.cpu().double()
        grads = {key: _finetune_grads(m, x64)
                 for key, m in (("folded", a64), ("twin", b64))}
        del a64, b64
    rec["grad_rel_err"] = _grads_rel(grads["folded"], grads["twin"])
    check(rec["grad_rel_err"] <= S2D_GRAD_TOL,
          f"{tag} {name}: fine-tune grads differ by {rec['grad_rel_err']} "
          f"of the largest")
    rec["peak_gib"] = peaks
    log(f"{tag} {name}: eval {eval_err:.2e}, train "
        f"{rec['train_rel_err']:.2e}, deltas {rec['delta_rel_err']:.2e}, "
        f"grads {rec['grad_rel_err']:.2e} (of scale), K1 {launches}"
        + (f" (vs plain {rec['k1_vs_plain_rel_err']:.2e})"
           if "k1_vs_plain_rel_err" in rec else "")
        + f", P1 {p1['folded']}, peak GiB folded {peaks['folded']} twin "
        f"{peaks['twin']}")
    del a, b, grads
    release()
    return launches, rec


def phase_s2d_2d(card, images):
    """(ak) Every 2D ``_s2d`` name and UNet2DS2D(head_depth=2) against its
    unfolded twin at batch 32, 128x128."""
    launches, record = {}, {}
    for name in S2D_2D:
        n, record[name] = s2d_twin_check(name, card, images, 2, "(ak)")
        launches[f"ak_{name}"] = n
    return launches, record


def phase_s2d_3d(card):
    """(al) Every 3D ``_s2d`` name against its unfolded twin at batch 1,
    96x96x80: no K1 launch at the folded sites (the composed rule)."""
    import torch
    x = torch.from_numpy(np.random.default_rng(34).standard_normal(
        (1, 1) + PATCH).astype(np.float32)).to(card)
    launches, record = {}, {}
    for name in S2D_3D:
        n, record[name] = s2d_twin_check(name, card, x, 3, "(al)")
        launches[f"al_{name}"] = n
        P1_LAUNCHES[f"al_{name}"] = record[name]["p1_launches"]
    return launches, record


def _pair_timing(trainer, tag):
    """Steady step ms (``measure_step``), the profiled device busy share
    and the peak memory of one more train step of ``trainer``."""
    import torch
    from hebbax_torch.utils.timing import measure_step

    on = "cuda" if torch.cuda.is_available() else "cpu"
    run = step_runner(trainer, trainer.train_step)
    run()
    release()
    reset_peak(on)
    run()
    peak = peak_gib(on)

    probe = next(trainer_models(trainer)[0].parameters())

    def step(s):
        run()
        return s + 1, probe
    steady = measure_step(step, 0, n1=1, n2=3, warmup=1) * 1e3
    prof = profile_steps(trainer, trainer.train_step, steady)
    out = {"steady_ms": steady, "busy_share": prof["busy_share"],
           "device_ms": prof["device_ms"], "groups_ms": prof["groups_ms"],
           "peak_gib": peak}
    log(f"(am) {tag}: steady {steady:.2f} ms, device busy "
        f"{prof['busy_share']:.1%}, peak {peak} GiB")
    return out


def trainer_models(trainer):
    state = trainer.state
    return ([state.model1, state.model2] if hasattr(state, "model1")
            else [state.model])


def phase_s2d_measure(items, data_root, card, device="0"):
    """(am) the layout measurement: steady step, busy share and peak
    memory of train_sup_2d on unet_s2d / unet (batch 32, 128x128), EM on
    unet3d_s2d / unet3d, URPC on unet3d_urpc_s2d / unet3d_urpc and
    train_sup_3d on vnet_s2d / vnet (batch 1, 96x96x80); the cuDNN time
    of one folded conv against its unfolded conv (forward, and forward
    plus both backward convs) at unet3d's encoder1.conv1 / conv2 and
    unet's in_conv.conv1 / conv2."""
    import torch
    import torch.nn.functional as F
    from hebbax_torch.cli import common, common3d
    from hebbax_torch.cli import train_semi_3d, train_sup_2d, train_sup_3d
    from hebbax_torch.ops import s2d, s2d3d

    record = {}
    for net in ("unet_s2d", "unet"):
        args = train_sup_2d.add_args(common.base_parser_2d()).parse_args(
            cli_base(device) + ["-n", net, "--regime", "100"])
        trainer = train_sup_2d.build(args, make_loaders(items, args, 100))
        record[f"sup_2d_{net}"] = _pair_timing(trainer, f"train_sup_2d {net}")
        del trainer
        release()
    semi = ["--regime", "50", "--optimizer", "sgd", "-l", "0.1", "--loss",
            "dice", "--unsup_weight", "5"]
    for algo, nets in (("em", ("unet3d_s2d", "unet3d")),
                       ("urpc", ("unet3d_urpc_s2d", "unet3d_urpc"))):
        for net in nets:
            args = train_semi_3d.add_args(common3d.base_parser_3d(), algo)\
                .parse_args(cli_base_3d(device, data_root, net)
                            + SPV_3D_SEMI + semi)
            trainer = train_semi_3d.build(args, algo)
            record[f"{algo}_3d_{net}"] = _pair_timing(trainer,
                                                      f"{algo} {net}")
            del trainer
            release()
    for net in ("vnet_s2d", "vnet"):
        args = train_sup_3d.add_args(common3d.base_parser_3d()).parse_args(
            cli_base_3d(device, data_root, net) + SPV_3D_SEMI
            + ["--regime", "50"])
        trainer = train_sup_3d.build(args)
        record[f"sup_3d_{net}"] = _pair_timing(trainer, f"train_sup_3d {net}")
        del trainer
        release()

    g = torch.Generator().manual_seed(35)
    convs = {}
    for tag, x_shape, w_shape, fold in (
            ("unet3d.encoder1.conv1", (1, 1) + PATCH, (64, 1, 3, 3, 3),
             (2, 1, 1)),
            ("unet3d.encoder1.conv2", (1, 64) + PATCH, (64, 64, 3, 3, 3),
             (2, 1, 1)),
            ("unet.in_conv.conv1", (BATCH, 3, SIZE, SIZE), (16, 3, 3, 3),
             (2, 2)),
            ("unet.in_conv.conv2", (BATCH, 16, SIZE, SIZE), (16, 16, 3, 3),
             (2, 2))):
        x = torch.randn(x_shape, generator=g).to(card)
        w = (0.1 * torch.randn(w_shape, generator=g)).to(card)
        conv = F.conv3d if len(x_shape) == 5 else F.conv2d
        xf = s2d3d.fold_nd(x, fold)
        wf = (s2d3d.fold_conv_kernel3(w, (w_shape[1],), fold)
              if len(x_shape) == 5 else s2d.fold_conv_kernel(
                  w, (w_shape[1],)))
        ref = conv(x, w, padding=1)
        got = s2d3d.unfold_nd(conv(xf, wf, padding=1), fold)
        err = float((got - ref).abs().max()) / float(ref.abs().max())
        check(err <= S2D_OUT_TOL, f"(am) {tag}: the folded conv differs "
                                  f"from the conv by {err}")

        def fwd_bwd(conv=conv, x=x, w=w):
            xx = x.detach().requires_grad_(True)
            ww = w.detach().requires_grad_(True)
            y = conv(xx, ww, padding=1)
            torch.autograd.grad(y, [xx, ww], torch.ones_like(y))
        xf_, wf_ = xf.detach(), wf.detach()
        convs[tag] = {
            "unfolded_fwd_ms": cuda_time_ms(lambda: conv(x, w, padding=1),
                                            warmup=2, iters=5),
            "folded_fwd_ms": cuda_time_ms(lambda: conv(xf_, wf_, padding=1),
                                          warmup=2, iters=5),
            "unfolded_fwd_bwd_ms": cuda_time_ms(fwd_bwd, warmup=1, iters=3),
            "folded_fwd_bwd_ms": cuda_time_ms(
                lambda: fwd_bwd(conv, xf_, wf_), warmup=1, iters=3),
            "fold": list(fold), "rel_err": err}
        log(f"(am) {tag} conv fold {fold}: " + json.dumps(convs[tag]))
        del x, w, xf, wf, xf_, wf_, ref, got
    record["convs"] = convs
    release()
    return record


def phase_s2d_folded_delta(card, images):
    """(an) ``HEBBAX_S2D_FOLDED_DELTA``: at the folded sites of a
    ``unet_s2d`` Hebbian training forward (batch 32, 128x128), the
    folded-layout delta against K1 on the unfolded operands: both timed
    with CUDA events, their error against each other."""
    import torch
    from hebbax_torch.hebb import kernels
    from hebbax_torch.hebb.layers import FoldedHConv
    from hebbax_torch.hebb.spec import HebbSpec
    from hebbax_torch.models import get_network
    from hebbax_torch.ops import s2d
    from hebbax_torch.utils.seeding import make_generator

    spec = HebbSpec(mode="swta_t", k=K_TEMP, exclude=("out_conv",))
    model = get_network("unet_s2d", 3, 2, hebb=spec, device=card,
                        generator=make_generator(36),
                        dropout_generator=make_generator(37, card))
    sites, hooks = [], []
    for name, m in model.named_modules():
        if isinstance(m, FoldedHConv) and m.spec is not None:
            def hook(mod, inp, out, name=name):
                sites.append((name, mod, inp[0].detach(), out.detach()))
            hooks.append(m.register_forward_hook(hook))
    model.train()
    with torch.no_grad():
        model(images)
    for h in hooks:
        h.remove()
    for m in model.modules():
        if isinstance(m, FoldedHConv):
            m.delta = None
    rows = []
    for name, mod, xf, yf in sites:
        w = mod.weight.detach()
        pad = mod.padding

        def folded():
            return mod._folded_delta(mod.spec, "swta", w, xf, yf)

        def k1():
            xu = mod._unfold(xf, mod.in_groups)
            yu = s2d.unfold(yf)
            return kernels.SWTA_DELTA(w.contiguous(), xu.contiguous(),
                                      yu.contiguous(), K_TEMP, pad)
        with torch.no_grad():
            a, b = folded(), k1()
            err = float((a - b).abs().max()) / float(b.abs().max())
            check(err <= S2D_FOLDED_DELTA_TOL,
                  f"(an) {name}: folded-layout delta vs K1 {err}")
            rows.append(dict(site=name, shape=list(xf.shape),
                             folded_ms=cuda_time_ms(folded, 1, 5),
                             k1_ms=cuda_time_ms(k1, 1, 5), rel_err=err))
    total = {k: sum(r[k] for r in rows) for k in ("folded_ms", "k1_ms")}
    worst = max(r["rel_err"] for r in rows)
    log(f"(an) {len(rows)} folded sites: folded-layout delta "
        f"{total['folded_ms']:.2f} ms, K1 (with the unfold) "
        f"{total['k1_ms']:.2f} ms, error up to {worst:.2e} of max|delta|")
    del model, sites
    release()
    return {**total, "rel_err_max": worst, "sites": rows}


def phase_s2d(card, items, images, data_root, device="0"):
    """Phase 14: (ak)-(an); returns the launches by path and the
    ``s2d_path`` record."""
    l_ak, r_ak = phase_s2d_2d(card, images)
    l_al, r_al = phase_s2d_3d(card)
    r_am = phase_s2d_measure(items, data_root, card, device)
    r_an = phase_s2d_folded_delta(card, images)
    launches = {**l_ak, **l_al}
    return launches, {"launches": launches, "ak": r_ak, "al": r_al,
                      "am": r_am, "an": r_an}


# -- 15: spatial sharding -----------------------------------------------------

# (tag, network, input shape, rank counts): the eval forwards hebbax runs
# under spatial_sharding, at the main path's batch and the whole 3D volume
SP_CASES = (("ao", "unet", (BATCH, 3, SIZE, SIZE), (2, 4)),
            ("ap", NET_3D, (1, 1) + VOLUME, (2,)),
            ("aq", "unet3d_urpc", (1, 1) + VOLUME, (2,)),
            ("aq", "vnet", (1, 1) + VOLUME, (2,)))
SP_TOL = 1e-4                   # of max(1, max|output|), sharded vs whole
SP_TIMED = 3
SP_TIMEOUT_S = 120
SP_DEADLINE_S = 300


def _sp_forward_ms(run, on, n=SP_TIMED):
    """Milliseconds of ``n`` calls of ``run`` after one untimed call: CUDA
    events on the card (each call ended by a synchronize), the host clock
    on the CPU.  Every rank makes the same calls: they hold collectives."""
    import torch
    run()
    times = []
    for _ in range(n):
        if on == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            run()
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def _sp_collectives(run, on):
    """(all-reduce calls, their MiB, their host ms) in one call of
    ``run``, each call timed between two synchronizes."""
    import torch
    import torch.distributed as dist

    orig, calls = dist.all_reduce, []

    def timed(t, *args, **kwargs):
        if on == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(t, *args, **kwargs)
        if on == "cuda":
            torch.cuda.synchronize()
        calls.append((t.numel() * t.element_size() / 2**20,
                      (time.perf_counter() - t0) * 1e3))
        return out
    dist.all_reduce = timed
    try:
        run()
    finally:
        dist.all_reduce = orig
    return len(calls), sum(c[0] for c in calls), sum(c[1] for c in calls)


def sp_job(cases, device="0"):
    """Phase 15's work on one rank (``run_ranks(..., data_parallel=False)``,
    or one process): for each (tag, network, shape) the eval forward of
    this rank's rows of the first spatial axis under
    ``parallel.spatial_sharding``, timed, its K1 launches and peak memory;
    rank 0 also runs the replicated forward in this process and holds the
    gathered outputs to it (SP_TOL).  ``device``: "cpu", the card index of
    ranks sharing it under gloo, or "rank" (NCCL: this rank's card)."""
    import torch
    import torch.distributed as dist
    from hebbax_torch import parallel
    from hebbax_torch.hebb import kernels
    from hebbax_torch.models import get_network
    from hebbax_torch.utils.seeding import make_generator

    if device == "cpu":
        card = torch.device("cpu")
    else:
        card = torch.device("cuda", torch.cuda.current_device()
                            if device == "rank" else int(device))
        torch.cuda.set_device(card)
        # a spawned rank starts with PyTorch's defaults: cuDNN TF32 on
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    on = card.type
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    out = []
    for tag, name, shape in cases:
        model = get_network(name, shape[1], 2, device=card,
                            generator=make_generator(41)).eval()
        x = torch.from_numpy(np.random.default_rng(42).standard_normal(
            shape).astype(np.float32)).to(card)
        res = {"tag": tag, "name": name, "shape": list(shape),
               "ranks": world, "rank": rank}
        with torch.no_grad():
            xr = parallel.shard_spatial(x, 0)
            holder = {}

            def sharded():
                with parallel.spatial_sharding(0):
                    holder["y"] = model(xr)
            release()
            reset_peak(on)
            kernels.SWTA_DELTA.launches = 0
            res["ms"] = _sp_forward_ms(sharded, on)
            res["launches"] = kernels.SWTA_DELTA.launches
            res["peak_gib"] = peak_gib(on)
            (res["collectives"], res["collective_mib"],
             res["collective_ms"]) = _sp_collectives(sharded, on)
            res["local_rows"] = int(xr.shape[2])
            outs = holder.pop("y")
            outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
            got = [parallel.gather_spatial(o, 0) for o in outs]
            del outs
            if rank == 0:
                release()
                reset_peak(on)
                res["replicated_ms"] = _sp_forward_ms(
                    lambda: holder.__setitem__("ref", model(x)), on)
                res["replicated_peak_gib"] = peak_gib(on)
                ref = holder.pop("ref")
                ref = list(ref) if isinstance(ref, (tuple, list)) else [ref]
                res["max_rel"] = [max_rel(g, r) for g, r in zip(got, ref)]
                res["finite"] = all(bool(torch.isfinite(g).all())
                                    for g in got)
                res["outputs"] = [list(g.shape) for g in got]
                del ref
            del got
        del model, x, xr
        out.append(res)
    release()
    return out


def _sp_check(per_rank, n):
    """Phase 15's gates on one spawn's results; the tag -> record map."""
    rec = {}
    for i, head in enumerate(per_rank[0]):
        key = f"{head['tag']}_{head['name']}_x{n}"
        shard = [r[i] for r in per_rank]
        check(head["finite"] and all(e <= SP_TOL for e in head["max_rel"]),
              f"(sp) {key}: sharded vs replicated max_rel "
              f"{head['max_rel']} (gate {SP_TOL}), finite {head['finite']}")
        check(all(s["launches"] == 0 for s in shard),
              f"(sp) {key}: K1 launched {[s['launches'] for s in shard]}")
        check(all(s["local_rows"] * n == head["shape"][2] for s in shard),
              f"(sp) {key}: shard rows {[s['local_rows'] for s in shard]}")
        rec[key] = {
            "shape": head["shape"], "ranks": n, "outputs": head["outputs"],
            "max_rel": head["max_rel"],
            "rank_ms": [summary({"f": s["ms"]})["f"] for s in shard],
            "replicated_ms": summary({"f": head["replicated_ms"]})["f"],
            "rank_peak_gib": [s["peak_gib"] for s in shard],
            "replicated_peak_gib": head["replicated_peak_gib"],
            "collectives": head["collectives"],
            "collective_mib": head["collective_mib"],
            "collective_ms": [s["collective_ms"] for s in shard],
            "launches": [s["launches"] for s in shard]}
        log(f"(sp) {key}: max_rel {head['max_rel']}; ms per rank "
            f"{[float(np.median(s['ms'])) for s in shard]} vs replicated "
            f"{float(np.median(head['replicated_ms']))}; peak GiB per rank "
            f"{[s['peak_gib'] for s in shard]} vs replicated "
            f"{head['replicated_peak_gib']}; {head['collectives']} "
            f"all-reduces of {head['collective_mib']:.1f} MiB, host ms "
            f"{[round(s['collective_ms'], 2) for s in shard]}")
    return rec


def phase_sp(device="0", slider_s=None, cards=False):
    """Phase 15: spatial sharding.  One spawn per rank count: (ao)
    ``unet`` at batch BATCH, SIZE^2 over 2 and 4 ranks; (ap) ``NET_3D``
    and (aq) ``unet3d_urpc`` / ``vnet`` on the whole VOLUME over 2 ranks,
    the first spatial axis split; gloo ranks sharing the card (or, with
    ``cards``, one NCCL rank per card, every case over all of them).
    Returns the launches by path and the ``spatial_path`` record
    (``slider_s``: phase 7's (m) seconds per volume of the slider)."""
    import torch
    from hebbax_torch import parallel

    t0 = time.perf_counter()
    n_cards = torch.cuda.device_count() if cards else 0
    groups = {}
    for tag, name, shape, counts in SP_CASES:
        for n in ((n_cards,) if cards else counts):
            groups.setdefault(n, []).append((tag, name, shape))
    records, launches = {}, {}
    for n, todo in sorted(groups.items()):
        on_card = device != "cpu"
        per_rank = parallel.run_ranks(
            sp_job, n, (todo, "rank" if cards else device),
            device_type="cuda" if on_card else "cpu",
            backend="nccl" if cards else "gloo", timeout=SP_TIMEOUT_S,
            deadline=SP_DEADLINE_S, data_parallel=False,
            threads=None if on_card else 1)
        rec = _sp_check(per_rank, n)
        records.update(rec)
        launches.update({f"sp_{k}": v["launches"][0]
                         for k, v in rec.items()})
        release()
    record = {"paths": records, "launches": launches,
              "backend": ("nccl, one rank per card" if cards else
                          "gloo, ranks sharing one card"),
              "slider_s_per_volume": slider_s, "tol": SP_TOL,
              "seconds": time.perf_counter() - t0}
    return launches, record


# -- phase 16: the entry layer ------------------------------------------------

AR_TOL = 1e-4                   # of max(1, max|tokens|), card vs CPU
AR_BATCH = 2                    # the RAD-DINO sweep's batch size
SWEEP_LINE = "reproduce_hebbian_unsupervised_pretraining_2d.sh"
N_SWEEPS = 19


def raddino_hf_dict(depth=12, seed=0):
    """An HF dinov2 state dict of ``microsoft/rad-dino``'s key names and
    shapes (ViT-B/14 at 224^2, DINOv2's ``mask_token`` and LayerScale
    ``lambda1`` included), made with numpy from ``seed`` near a trained
    ViT's scales."""
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.02):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def gain(n):
        return (1.0 + 0.1 * rng.standard_normal(n)).astype(np.float32)

    e = "embeddings."
    sd = {e + "cls_token": w(1, 1, 768, scale=1.0),
          e + "mask_token": w(1, 768),
          e + "position_embeddings": w(1, 257, 768),
          e + "patch_embeddings.projection.weight": w(768, 3, 14, 14),
          e + "patch_embeddings.projection.bias": w(768)}
    for i in range(depth):
        b = f"encoder.layer.{i}."
        for n in ("norm1", "norm2"):
            sd[b + n + ".weight"], sd[b + n + ".bias"] = gain(768), w(768)
        for n in ("attention.attention.query", "attention.attention.key",
                  "attention.attention.value", "attention.output.dense"):
            sd[b + n + ".weight"], sd[b + n + ".bias"] = w(768, 768), w(768)
        sd[b + "mlp.fc1.weight"], sd[b + "mlp.fc1.bias"] = w(3072, 768), \
            w(3072)
        sd[b + "mlp.fc2.weight"], sd[b + "mlp.fc2.bias"] = w(768, 3072), \
            w(768)
        sd[b + "layer_scale1.lambda1"] = gain(768)
        sd[b + "layer_scale2.lambda1"] = gain(768)
    sd["layernorm.weight"], sd["layernorm.bias"] = gain(768), w(768)
    return sd


def raddino_expected(sd, depth=12):
    """The port's parameter name -> its HF source under the stated
    reshapes: q / k / v weights (12, 64, 768) and biases (12, 64), the
    output projection (768, 12, 64), everything else as it is."""
    import torch

    e = "embeddings."
    out = {"patch_embed.weight": sd[e + "patch_embeddings.projection.weight"],
           "patch_embed.bias": sd[e + "patch_embeddings.projection.bias"],
           "cls_token": sd[e + "cls_token"],
           "pos_embed": sd[e + "position_embeddings"],
           "norm.weight": sd["layernorm.weight"],
           "norm.bias": sd["layernorm.bias"]}
    for i in range(depth):
        b, p = f"encoder.layer.{i}.", f"block{i}."
        for n in ("norm1", "norm2", "mlp.fc1", "mlp.fc2"):
            for leaf in ("weight", "bias"):
                out[p + n.replace("mlp.", "") + "." + leaf] = \
                    sd[b + n + "." + leaf]
        for n in ("query", "key", "value"):
            src = b + "attention.attention." + n
            out[p + f"attn.{n}.weight"] = sd[src + ".weight"].reshape(
                12, 64, 768)
            out[p + f"attn.{n}.bias"] = sd[src + ".bias"].reshape(12, 64)
        out[p + "attn.out.weight"] = sd[
            b + "attention.output.dense.weight"].reshape(768, 12, 64)
        out[p + "attn.out.bias"] = sd[b + "attention.output.dense.bias"]
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in out.items()}


def phase_raddino_map(card):
    """(ar) RAD-DINO's HF key map at full width: the loader falls back
    offline (the card's encoder unchanged), a seeded HF-layout dict mapped
    onto the card's and the CPU's ViT-B/14 encoders, the card's tensors equal
    to their sources under the stated reshapes, card and CPU tokens at
    batch 2, 224^2 within AR_TOL of max(1, max|tokens|) (TF32 off), and
    the frozen forward timed with CUDA events; no K1 launch."""
    import torch
    from hebbax_torch.hebb import kernels
    from hebbax_torch.models import raddino
    from hebbax_torch.utils.seeding import make_generator

    t0 = time.perf_counter()
    parts = {}

    def lap(name, since):
        parts[name] = time.perf_counter() - since
        return time.perf_counter()

    kernels.SWTA_DELTA.launches = 0
    sd = raddino_hf_dict()
    t = lap("dict", t0)
    enc = raddino.ViTEncoder(device=card, generator=make_generator(0))
    enc.requires_grad_(False).eval()
    before = {k: v.clone() for k, v in enc.state_dict().items()}
    t = lap("init", t)
    got, ok = raddino.load_hf_rad_dino_params(enc)
    check(got is enc and not ok, "(ar) the HF loader did not fall back "
          "offline")
    check(all(torch.equal(v, before[k]) for k, v in enc.state_dict().items()),
          "(ar) the offline loader changed the encoder")
    del before
    t = lap("loader", t)
    encs = {"card": raddino.apply_hf_state_dict(enc, sd),
            "cpu": raddino.apply_hf_state_dict(raddino.ViTEncoder(), sd)}
    t = lap("map", t)
    want = raddino_expected(sd)
    mapped = encs["card"].state_dict()
    check(set(mapped) == set(want),
          f"(ar) mapped names {sorted(set(mapped) ^ set(want))[:5]}")
    off = [k for k, v in want.items() if not torch.equal(mapped[k].cpu(), v)]
    check(not off, f"(ar) {off[:5]} ({len(off)}) differ from their sources")
    check(not any(p.requires_grad for p in encs["card"].parameters()),
          "(ar) an encoder parameter takes grad")
    t = lap("check", t)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (AR_BATCH, 3, 224, 224)).astype(np.float32))
    with torch.no_grad():
        tok_cpu = encs["cpu"].eval()(x)
        x_card = x.to(card)
        tok_card = encs["card"](x_card)
        scale = max(1.0, float(tok_cpu.abs().max()))
        err = float((tok_card.cpu() - tok_cpu).abs().max())
        check(tuple(tok_card.shape) == (AR_BATCH, 257, 768)
              and bool(torch.isfinite(tok_card).all()),
              f"(ar) tokens {tuple(tok_card.shape)}")
        check(err <= AR_TOL * scale,
              f"(ar) card vs CPU tokens {err:.3e} > {AR_TOL} x {scale:.3f}")
        ms = (cuda_time_ms(lambda: encs["card"](x_card))
              if card.type == "cuda" else None)
    lap("tokens", t)
    launches = kernels.SWTA_DELTA.launches
    check(launches == 0, f"(ar) launched K1 {launches} times")
    seconds = time.perf_counter() - t0
    log(f"(ar) RAD-DINO HF map: {len(mapped)} tensors of ViT-B/14 (12 "
        f"blocks) equal to their sources; card vs CPU tokens max abs "
        f"{err:.3e} at scale {scale:.3f}; frozen forward at batch "
        f"{AR_BATCH}, 224^2: {ms} ms (CUDA events); {seconds:.1f} s "
        + json.dumps(parts))
    n = len(mapped)
    del enc, encs, mapped, want, sd, tok_card, x_card
    release()
    return launches, {"tensors": n, "max_abs": err, "scale": scale,
                      "forward_ms": ms, "batch": AR_BATCH,
                      "seconds": seconds, "parts_s": parts}


def _with(words, flag, value):
    """``words`` with ``flag``'s value replaced, or the pair appended."""
    words = list(words)
    if flag in words:
        words[words.index(flag) + 1] = value
    else:
        words += [flag, value]
    return words


def start_sweep_records():
    """Start what (as) reads, to run beside (ar) and (at): each of the 19
    sweeps recorded by ``hebbax_torch.sweep.record`` in a thread of its
    own (bash expands the script, the recording ``python`` keeps each
    line's words), and the command line ``python -m hebbax_torch.sweep
    <SWEEP_LINE> --record <file>`` in a process."""
    import glob
    from concurrent.futures import ThreadPoolExecutor

    from hebbax_torch import sweep

    def timed_record(script):
        t0 = time.perf_counter()
        lines = sweep.record(script)
        return lines, time.perf_counter() - t0

    scripts = sorted(glob.glob(os.path.join(ROOT, "reproduce_*.sh")))
    check(len(scripts) == N_SWEEPS, f"(as) {len(scripts)} sweeps")
    pool = ThreadPoolExecutor(len(scripts))
    futures = {s: pool.submit(timed_record, s) for s in scripts}
    pool.shutdown(wait=False)
    listing = os.path.join(RUN_DIR, "sweep_lines.txt")
    cli = subprocess.Popen(
        [sys.executable, "-m", "hebbax_torch.sweep", SWEEP_LINE, "--record",
         listing], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    return {"futures": futures, "cli": cli, "listing": listing}


def phase_sweep_lines(items, pending, device="0"):
    """(as) every line of the 19 sweeps (recorded by
    :func:`start_sweep_records`) parsed with the port's parsers, the
    command line's listing of SWEEP_LINE equal to them; then that
    sweep's first line run in-process through ``entry.run`` on the
    synthetic GlaS items, only ``--path_dataset``, ``--path_root_exp``
    and the epochs (``-e 1``) changed: K1 22 launches per step, finite
    losses, last.ckpt."""
    import csv
    import shlex

    import torch
    from hebbax_torch import entry, sweep
    from hebbax_torch.cli import pretrain_hebbian_unsup_2d as pretrain
    from hebbax_torch.hebb import kernels

    done = {s: f.result() for s, f in pending["futures"].items()}
    recorded = {s: lines for s, (lines, _) in done.items()}
    record_s = {os.path.basename(s): sec for s, (_, sec) in done.items()}
    t0 = time.perf_counter()
    lines = {}
    for script, words in recorded.items():
        check(words, f"(as) {script} recorded no line")
        lines[os.path.basename(script)] = len(sweep.parse_lines(words))
    parse_s = time.perf_counter() - t0
    _, err = pending["cli"].communicate(timeout=300)
    with open(pending["listing"]) as f:
        listed = [shlex.split(line)[1:] for line in f]
    check(pending["cli"].returncode == 0
          and listed == recorded[os.path.join(ROOT, SWEEP_LINE)],
          f"(as) python -m hebbax_torch.sweep --record: {err[-2000:]}")
    log(f"(as) sweeps: {sum(lines.values())} lines recorded (slowest "
        f"script {max(record_s.values()):.2f} s, beside (ar) and (at)) and "
        f"parsed in {parse_s:.2f} s; per script " + json.dumps(lines))

    words = recorded[os.path.join(ROOT, SWEEP_LINE)][0]
    root = os.path.join(RUN_DIR, "sweep_line")
    argv = _with(_with(words[1:], "--path_dataset",
                       os.path.join(root, "data", "GlaS")),
                 "--path_root_exp", os.path.join(root, "runs"))
    argv = _with(argv, "-e", "1")
    if device != "0":
        argv = _with(argv, "--device", device)
    args = entry.parse(words[0], argv)
    loaders = make_loaders(items, args, 100)
    times = []
    raw_build = pretrain.build

    def timed_build(*a, **kw):
        trainer = raw_build(*a, **kw)
        trainer.train_step = timed_step(trainer.train_step, times)
        return trainer

    pretrain.build = timed_build
    kernels.SWTA_DELTA.launches = 0
    t0 = time.perf_counter()
    try:
        entry.run(words[0], argv, loaders=loaders)
    finally:
        pretrain.build = raw_build
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = kernels.SWTA_DELTA.launches
    steps = len(times)
    check(steps == len(loaders["train"]) and steps > 0,
          f"(as) the line ran {steps} steps")
    check(launches == 22 * steps, f"(as) the line launched K1 {launches} "
          f"times, expected 22 x {steps}")
    ckpts = [d for d, _, files in os.walk(os.path.join(root, "runs"))
             if "last.ckpt" in files]
    check(len(ckpts) == 1, f"(as) last.ckpt in {ckpts}")
    with open(os.path.join(os.path.dirname(ckpts[0]),
                           "train_log.csv")) as f:
        losses = [float(row["loss"]) for row in csv.DictReader(f)]
    check(losses and all(np.isfinite(losses)), f"(as) losses {losses}")
    log(f"(as) {SWEEP_LINE} line 1 ({args.network}, batch "
        f"{args.batch_size}, K={args.hebb_inv_temp}): {steps} steps, K1 "
        f"launches {launches}, step ms median {np.median(times):.3f} "
        f"(min {min(times):.3f}), the run {run_s:.2f} s")
    return {"sweep_line": launches}, {
        "lines": lines, "record_s": record_s, "parse_s": parse_s,
        "line": ["python"] + [words[0]] + argv, "steps": steps,
        "step_ms": summary({"line": times})["line"], "run_s": run_s}


def _png_size(path):
    """(width, height) of a grey or RGB PNG the port wrote, its
    scanlines' length checked."""
    import struct
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"(at) {path} is not a PNG")
    w, h, _, colour = struct.unpack(">IIBB", data[16:26])
    idat, pos = b"", 8
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    check(len(zlib.decompress(idat)) == h * (1 + w * (3 if colour == 2
                                                      else 1)),
          f"(at) {path}: scanlines")
    return w, h


def _nrrds(d):
    from hebbax_torch.data.nrrd_io import read_nrrd
    return {n: read_nrrd(os.path.join(d, n))[0] for n in sorted(os.listdir(d))}


def phase_tools(items, data_root, run_3d, snap_a):
    """(at) the nine tools of ``hebbax_torch.tools`` on this run's files:
    ``atrial.preprocess`` on phase 7's val volumes and masks laid out as
    raw cases, ``atrial.postprocess`` and ``eval --if_3D`` on (m)'s
    ``test_3d`` predictions, ``mask2sdf`` (equal to the bit to the
    ``mask_sdf1`` maps phase 7 wrote), ``res_image_mask`` and
    ``wavelet3D`` on the val volumes, ``visualize_weights`` on (a)'s
    snapshot, ``report_results`` on the run tree; ``wavelet2D`` and the 2D
    ``eval`` on a 2D test's predictions where PIL is installed (they read
    PNGs with it).  Each output written, finite and in range; no K1
    launch."""
    from hebbax_torch.hebb import kernels
    from hebbax_torch.tools import (eval as eval_tool, mask2sdf,
                                    report_results, res_image_mask,
                                    visualize_weights, wavelet2D, wavelet3D)
    from hebbax_torch.tools.atrial import postprocess, preprocess
    from hebbax_torch.utils.images import save_png

    root = os.path.join(RUN_DIR, "tools")
    shutil.rmtree(root, ignore_errors=True)
    val = os.path.join(data_root, "val")
    seconds = {}
    kernels.SWTA_DELTA.launches = 0

    def run(name, tool, argv):
        t0 = time.perf_counter()
        out = tool.main(argv)
        seconds[name] = time.perf_counter() - t0
        return out

    for name in sorted(os.listdir(os.path.join(val, "image"))):
        case = os.path.join(root, "raw", name[:-5])
        os.makedirs(case)
        os.symlink(os.path.join(val, "image", name),
                   os.path.join(case, "lgemri.nrrd"))
        os.symlink(os.path.join(val, "mask", name),
                   os.path.join(case, "laendo.nrrd"))
    run("atrial.preprocess", preprocess, [
        "--data_path", os.path.join(root, "raw"), "--save_image_path",
        os.path.join(root, "crop", "image"), "--save_mask_path",
        os.path.join(root, "crop", "mask")])
    images, masks = _nrrds(os.path.join(val, "image")), \
        _nrrds(os.path.join(val, "mask"))
    crops = _nrrds(os.path.join(root, "crop", "mask"))
    for n, img in _nrrds(os.path.join(root, "crop", "image")).items():
        check(np.isfinite(img).all() and img.shape == crops[n].shape
              and img.shape[2] == images[n].shape[2]
              and all(a <= b for a, b in zip(img.shape, images[n].shape)),
              f"(at) preprocess {n}: {img.shape}")
        check(crops[n].sum() == masks[n].sum(), f"(at) preprocess {n} cut "
              f"the mask")

    preds = os.path.join(run_3d, "test_seg_preds")
    run("atrial.postprocess", postprocess, [
        "--pred_path", preds, "--save_path", os.path.join(root, "post")])
    post = _nrrds(os.path.join(root, "post"))
    ref = _nrrds(os.path.join(run_3d, "test_seg_preds_postprocessed"))
    check(sorted(post) == sorted(ref) and all(
        np.array_equal(post[n], ref[n]) for n in ref),
        "(at) postprocess differs from test_3d's post-processing")
    res_3d = run("eval", eval_tool, [
        "--pred_path", os.path.join(root, "post"), "--mask_path",
        os.path.join(val, "mask"), "--if_3D", "1"])
    check(0.0 <= res_3d["dice"] <= 1.0 and 0.0 <= res_3d["jaccard"] <= 1.0,
          f"(at) eval 3D {res_3d}")
    if any(p.any() for p in post.values()):
        check(np.isfinite(res_3d["95hd"]) and np.isfinite(res_3d["asd"]),
              f"(at) eval 3D distances {res_3d}")

    run("mask2sdf", mask2sdf, ["--mask_path", os.path.join(val, "mask"),
                               "--out_path", os.path.join(root, "sdf")])
    sdf, ref = _nrrds(os.path.join(root, "sdf")), \
        _nrrds(os.path.join(val, "mask_sdf1"))
    check(sorted(sdf) == sorted(ref) and all(
        np.array_equal(sdf[n], ref[n]) and np.abs(sdf[n]).max() <= 1.0
        for n in ref), "(at) mask2sdf differs from phase 7's mask_sdf1")

    run("res_image_mask", res_image_mask, [
        "--image_path", os.path.join(val, "image"), "--out_path",
        os.path.join(root, "res")])
    for n, r in _nrrds(os.path.join(root, "res")).items():
        check(r.shape == images[n].shape and np.isfinite(r).all()
              and not r[..., 0].any(), f"(at) res_image_mask {n}")
    run("wavelet3D", wavelet3D, [
        "--image_path", os.path.join(val, "image"), "--L_path",
        os.path.join(root, "w3", "L"), "--H_path",
        os.path.join(root, "w3", "H")])
    for band in ("L", "H"):
        for n, v in _nrrds(os.path.join(root, "w3", band)).items():
            check(v.shape == images[n].shape and np.isfinite(v).all(),
                  f"(at) wavelet3D {band} {n}")

    png = os.path.join(root, "filters.png")
    run("visualize_weights", visualize_weights, [
        "--snapshot", snap_a, "--out", png])
    w, h = _png_size(png)
    check(w > 0 and h > 0 and w % 16 == 0 and h % 16 == 0,
          f"(at) visualize_weights {w}x{h}")

    table = run("report_results", report_results, [
        "--exp_root", RUN_DIR, "--out", os.path.join(root, "summary.csv")])
    check(table and os.path.exists(os.path.join(root, "summary.csv")),
          "(at) report_results found no run")
    for group, stats in table.items():
        for metric, (mean, std, count) in stats.items():
            check(count >= 0 and (count == 0 or np.isfinite(mean)),
                  f"(at) report_results {group} {metric}")
            if metric in ("segm/dice", "segm/jaccard") and count:
                check(0.0 <= mean <= 1.0, f"(at) {group} {metric} {mean}")

    try:
        import PIL  # noqa: F401  (the 2D tools read PNGs with it)
        have_pil = True
    except ImportError:
        have_pil = False
    if have_pil:
        pred_2d = sorted(d for d, _, files in os.walk(RUN_DIR)
                         if os.path.basename(d) == "test_seg_preds"
                         and any(f.endswith(".png") for f in files))
        check(pred_2d, "(at) no 2D test predictions")
        names = sorted(os.listdir(pred_2d[0]))
        mask_dir = os.path.join(root, "mask_2d")
        os.makedirs(mask_dir)
        by_name = {n: m for n, _, m in items["val"]}
        for n in names:
            save_png(by_name[n] * 255, os.path.join(mask_dir, n))
        res_2d = run("eval_2d", eval_tool, ["--pred_path", pred_2d[0],
                                            "--mask_path", mask_dir])
        check(0.0 <= res_2d["dice"] <= 1.0, f"(at) eval 2D {res_2d}")
        run("wavelet2D", wavelet2D, [
            "--image_path", mask_dir, "--L_path",
            os.path.join(root, "w2", "L"), "--H_path",
            os.path.join(root, "w2", "H")])
        for band in ("L", "H"):
            check(sorted(os.listdir(os.path.join(root, "w2", band)))
                  == names, f"(at) wavelet2D {band}")
    launches = kernels.SWTA_DELTA.launches
    check(launches == 0, f"(at) the tools launched K1 {launches} times")
    pil = ("present" if have_pil
           else "absent: wavelet2D and the 2D eval not run")
    log(f"(at) tools, K1 launches {launches} (PIL {pil}): eval 3D "
        f"{res_3d}; seconds " + json.dumps(seconds))
    return {"tools": launches}, {"seconds": seconds, "pil": have_pil,
                                 "eval_3d": res_3d}


def phase_entry(card, items, data_root, run_3d, snap_a, device="0"):
    """Phase 16: (ar), (at), then (as), whose sweeps are recorded beside
    the other two; returns the launches by path and the ``entry_path``
    record."""
    t0 = time.perf_counter()
    pending = start_sweep_records()
    try:
        l_ar, rec_ar = phase_raddino_map(card)
        l_at, rec_at = phase_tools(items, data_root, run_3d, snap_a)
        l_as, rec_as = phase_sweep_lines(items, pending, device)
    finally:
        if pending["cli"].poll() is None:
            pending["cli"].kill()
        pending["cli"].wait()
    return ({"raddino_map": l_ar, **l_as, **l_at},
            {"ar": rec_ar, "as": rec_as, "at": rec_at,
             "seconds": time.perf_counter() - t0})


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
    # the RAD-DINO loader asks transformers for microsoft/rad-dino: offline
    # (set before transformers is imported), it falls back at once
    os.environ["HF_HUB_OFFLINE"] = "1"
    cards = sys.argv[1:] == ["--dp-cards"]

    t0 = time.perf_counter()
    built = build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s for "
        f"{sorted(build.LIBRARIES)} (compiled now: {sorted(built)})")
    for name, info in built.items():
        log(f"--- nvcc {name} ({info['seconds']:.2f} s)\n{info['log']}")

    items = synth_items(N_TRAIN, N_VAL, SIZE)
    if cards:
        shutil.rmtree(RUN_DIR, ignore_errors=True)
        data_root = synth_volumes(os.path.join(RUN_DIR, "data3d", "Atrial"),
                                  N_TRAIN_3D, N_VAL_3D, VOLUME)
        log("data_parallel_cards_path " + json.dumps(
            phase_dp_cards(items, data_root)))
        log("spatial_cards_path " + json.dumps(
            phase_sp("0", cards=True)[1]))
        return finish(device)
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
    pool_rows = phase_pool_kernel(device)
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

    l_12, record_12 = phase_dp(items, data_root)
    launches.update(l_12)
    log("data_parallel_path " + json.dumps(record_12))
    lap(12)

    l_13, record_13 = phase_tail(device, items, images)
    launches.update(l_13)
    log("tail_path " + json.dumps(record_13))
    lap(13)

    l_14, record_14 = phase_s2d(device, items, images, data_root)
    launches.update(l_14)
    log("s2d_path " + json.dumps(record_14))
    lap(14)

    l_15, record_15 = phase_sp(slider_s=record_3d["test"]["seconds"]["slider"])
    launches.update(l_15)
    log("spatial_path " + json.dumps(record_15))
    lap(15)

    l_16, record_16 = phase_entry(
        device, items, data_root, record_3d["run"],
        os.path.join(run_a, "checkpoints", "last.ckpt"))
    launches.update(l_16)
    log("entry_path " + json.dumps(record_16))
    lap(16)

    from hebbax_torch.hebb.kernels import SwtaDeltaKernel
    from hebbax_torch.ops.s2d3d_kernels import SubpixelMax3Kernel
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
            *l_11, *l_12, *l_13, *l_14, *l_15, *l_16)},
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
    }, {
        "name": SubpixelMax3Kernel.name,
        "route": "cuda",
        "source": SubpixelMax3Kernel.source,
        "replaces": None,
        "launches": P1_LAUNCHES["urpc_3d"],
        "launches_by_path": dict(P1_LAUNCHES),
        "ms": pool_rows[0]["ms"],
        "plain_ms": pool_rows[0]["plain_ms"],
        "bound_ms": pool_rows[0]["bound_ms"],
        "bound_by": "bytes",
        "equal_to_plain": all(r["equal_to_plain"] for r in pool_rows),
        "cases": pool_rows,
    }]}
    print(json.dumps(kernels_line), flush=True)
    return finish(device)


def finish(device):
    """The card's name and power limit, then the last line."""
    import torch
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
