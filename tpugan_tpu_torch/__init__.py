"""tpugan_tpu_torch — the PyTorch / CUDA port of ``tpugan_tpu``.

The layout mirrors the JAX package so each counterpart is found by path:

  ops/neighbors.py       kNN (differentiable distances), graph kNN, FPS,
                         ball query, grouping, radius counts
  ops/metrics.py         nearest neighbour, Chamfer, the masking target,
                         auction assignment and EMD, Gaussian MMD
  ops/interpolate.py     SPH kernels; capped and dense SPH interpolation
  ops/kernels/           one module per hand-written CUDA kernel (csrc/*.cu),
                         each with its plain PyTorch version and launch count;
                         binned_interp.py: the cell-grid exact SPH sum
  nn/layers.py           BatchNorm, SpectralNorm (flax semantics), ConvLayer,
                         SharedMLP
  nn/edgeconv.py         EdgeConv, IDGCNLayer
  nn/setconv.py          SetConv;  nn/flow.py  FlowEmbedding, FlowModule
  models/generator.py    SRNet, the mask-history ring; NoMaskSRNet (action)
  models/discriminator.py  the fluid spatial and temporal critics; the
                         action spatial and temporal critics, ActionCls,
                         the transfer
  losses/                geometric and LSGAN losses
  train/                 Adam with the staircase schedule, the fluid and the
                         action GAN steps, the checkpoint writer
  data/                  synthetic fluid sequences and action videos,
                         dataset, batches; data/msr.py: action clips;
                         data/sampling.py: host FPS, kd-tree patches,
                         padding, free-surface particles
  eval/rollout.py        the serving rollout loop
  eval/analysis.py       Chamfer / EMD / MMD metrics, cycle consistency,
                         particle densities, free-surface counts
  cli/eval_fluid.py      the evaluation CLI; cli/train_fluid.py, the fluid
                         trainer; cli/action_demo.py, cli/eval_tempo_feat.py,
                         cli/train_action.py: the action twins
  checkpoint.py          flax msgpack reader, SRNet, NoMaskSRNet, action
                         critic and trainer-state bridges (fluid and action)

The package imports torch, numpy and scipy only. Entry points run on the
CUDA card unless the caller passes ``device="cpu"``; a wrapper around a
kernel takes its plain PyTorch version only for a tensor that lies on the
CPU.
"""

import torch

PAD_SENTINEL = 999.0   # pruned / padding points sit here (with a valid mask)
DT = 0.025             # advection timestep: features are pos || vel * DT

# TF32 keeps about three decimal digits: distances computed with it flip
# nearest-neighbor choices, and convolutions would drift from the f32
# reference. Both switches are pinned off for the whole package.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def default_device() -> torch.device:
    """The device entry points use when the caller names none: the CUDA card.

    Raises instead of falling back to the CPU, so a run that was meant for
    the card never measures the CPU by accident.
    """
    if not torch.cuda.is_available():
        raise RuntimeError(
            "tpugan_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device, or :func:`default_device` when None."""
    return default_device() if device is None else torch.device(device)


def device_name(device: torch.device) -> str:
    """The name results carry: the CUDA card's, or "cpu"."""
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


__version__ = "0.1.0"
