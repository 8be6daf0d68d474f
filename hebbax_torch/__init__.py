"""hebbax_torch — the PyTorch/CUDA port of hebbax for one NVIDIA H100.

Same layout as ``hebbax`` so each module's counterpart is easy to find:

  config/   dataset constants, warmup+StepLR schedule, optimizers, ramps
  data/     2D folder dataset, numpy augmentations, threaded loader; 3D
            NRRD volumes, their augmentations and patch queues
  hebb/     HebbSpec, the Hebbian rules (swta, hpca, swta_t, hpca_t,
            contrastive), the SWTA-delta kernel dispatcher, HConv /
            HConvTranspose, gradient merging
  csrc/     hand-written CUDA kernels (built with nvcc at first use)
  models/   UNet2D, UNetURPC2D, UNetCCT2D, the unsupervised baselines
            (UNetVAE2D, UNetSuperpix2D, DDPMUNet), UNet3D, UNet3DDTC,
            UNet3DCCT, UNet3DURPC, VNet, VNetCCT, VNetDTC, their blocks,
            CCT perturbations and the recomputed (``_rc``) / batched
            (``_batched``) CCT decoders, the network registry
  ops/      losses, threshold-sweep and confusion metrics, HD95/ASSD,
            signed distance maps, dropout, EMA, diffusion schedules and
            losses, superpixel pseudo-masks, 3D post-processing, the
            single-level wavelet transforms
  engine/   train state, train/eval/probe-pretraining steps, the epoch
            harness, the semi-supervised steps and trainers (EM, UAMT,
            CPS, URPC, CCT, DTC), the 3D sliding-window slider
  utils/    seeding, run dirs, logging sinks, PNG writer, HBAXCKP1
            snapshots, the replay of a recomputed region, step timing
  cli/      ``python -m hebbax_torch.cli.<name>`` entry points
  bridge.py parameter map between a flax variable tree and a state_dict

The port imports torch, numpy and scipy only: no jax, flax, optax and
nothing of ``hebbax``.  Activations are channels-first (NCHW, NCDHW) and
conv weights torch's ``(O, I, *k)`` (transpose convs ``(I, O, *k)``);
snapshots are hebbax's own ``HBAXCKP1`` files, so a
snapshot crosses between the two packages in both directions.
"""

__version__ = "0.1.0"
