"""Fluid sequence upsampling demo (the port's twin of
``examples/fluid_demo.py``): a particle sequence (``data_{i}.npz`` frames
of ``--data_dir``, or a synthetic one: seed 7, 4,096 particles), each frame
cut to its low-res input by host farthest-point sampling (/8), the SRNet
rolled over the inputs with the 25-frame mask-history context, the wall
time, ``pred_{i}.npy`` per frame, and the mean normalised Chamfer against
the full frames, on the first min(prediction, ground truth) points. The
script computes ``position_metrics`` (with 50 auction rounds) and prints
its Chamfer alone; the twin computes that Chamfer alone
(``chamfer(a, b).mean() / n``, ``eval/analysis.py``'s term), not the EMD
and MMD that the script throws away.

    python -m tpugan_tpu_torch.cli.fluid_demo --ckpt checkpoints/fluid_vel_20k.ckpt \\
        --use_vel                                            # the card
    python -m tpugan_tpu_torch.cli.fluid_demo ... --device cpu   # plain

Without ``--ckpt`` the generator has random weights (a torch.Generator
seeded 0; the JAX script's flax init is not reproduced).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Fluid sequence upsampling demo")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--data_dir", default=None,
                   help="dir of data_{i}.npz frames; synthetic if omitted")
    p.add_argument("--num_frames", type=int, default=24)
    p.add_argument("--use_vel", action="store_true")
    p.add_argument("--out_dir", default="./demo_out")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card)")
    return p


def load_frames(opt):
    """The full-resolution (pos, vel) frames, in the script's order (names
    sorted as strings)."""
    if opt.data_dir:
        frames = []
        names = sorted(f for f in os.listdir(opt.data_dir)
                       if f.endswith(".npz"))
        for name in names[: opt.num_frames]:
            with np.load(os.path.join(opt.data_dir, name)) as z:
                frames.append((z["pos"], z.get("vel")))
        return frames
    from tpugan_tpu_torch.data.synthetic import synthetic_fluid_sequence

    return list(synthetic_fluid_sequence(seed=7, num_particles=4096,
                                         num_frames=opt.num_frames))


def lowres_frames(frames):
    """Each frame's FPS /8 (first point 0): what the trained model takes."""
    from tpugan_tpu_torch.data.sampling import farthest_point_sampling

    lowres = []
    for pos, vel in frames:
        idx, _ = farthest_point_sampling(pos, pos.shape[0] // 8, initial_idx=0)
        lowres.append((pos[idx], vel[idx] if vel is not None else None))
    return lowres


def main(argv=None) -> dict:
    """Run the demo on ``argv``; returns the rollout's seconds, each frame's
    normalised Chamfer and their mean."""
    import torch

    from tpugan_tpu_torch import resolve_device
    from tpugan_tpu_torch.cli.eval_fluid import generator_for_flags
    from tpugan_tpu_torch.eval.rollout import rollout_sequence
    from tpugan_tpu_torch.ops.metrics import chamfer

    opt = parser().parse_args(argv)
    dev = resolve_device(opt.device)
    frames = load_frames(opt)
    lowres = lowres_frames(frames)
    flags = argparse.Namespace(ckpt=opt.ckpt,
                               in_node_feats=6 if opt.use_vel else 3,
                               node_embedding=128, upsample_ratio=8)
    model, _ = generator_for_flags(flags, dev, None, "dynamic", seed=0)

    t0 = time.time()
    preds = rollout_sequence(model, lowres, use_vel=opt.use_vel)
    used = time.time() - t0
    print(f"Used: {used:.2f}s for {len(preds)} frames")

    os.makedirs(opt.out_dir, exist_ok=True)
    cds = []
    for i, pred in enumerate(preds):
        np.save(os.path.join(opt.out_dir, f"pred_{i}.npy"), pred)
        n = min(pred.shape[0], frames[i][0].shape[0])
        a = torch.from_numpy(np.ascontiguousarray(pred[None, :n])).to(dev)
        b = torch.from_numpy(np.ascontiguousarray(frames[i][0][None, :n])).to(dev)
        with torch.no_grad():
            cds.append(float(chamfer(a, b).mean() / n))
    print(f"mean normalized Chamfer vs ground truth: {np.mean(cds):.6f}")
    return {"frames": len(preds), "seconds": used, "chamfers": cds,
            "chamfer_mean": float(np.mean(cds))}


if __name__ == "__main__":
    main()
