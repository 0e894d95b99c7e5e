"""Upsample one MSR-Action3D clip with the action workload's NoMaskSRNet
(the port's twin of ``examples/action_demo.py``): each frame's 128-point FPS
downsample through the generator, outputs shifted back by the frame's
centroid (the test split centres every frame), saved as npz; with
``--eval_metrics`` the MSR-Action3D protocol (Chamfer / 2,048 and EMD)
against the clip's ground truth.

    python -m tpugan_tpu_torch.cli.action_demo \\
        --ckpt checkpoints/action_tempo_20k.ckpt               # the card
    python -m tpugan_tpu_torch.cli.action_demo ... --device cpu  # plain

Without ``--data_dir`` it writes a synthetic MSR-schema dataset (4 videos
of 30 frames of 3,000 points, seed 0) under ``--synthetic_dir`` and takes
the first test clip. Without ``--ckpt`` the generator has random weights
(seed 0). Serving runs without autograd.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from tpugan_tpu_torch import resolve_device
from tpugan_tpu_torch.config import ActionTrainConfig


def get_arguments(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Upsample an action clip")
    p.add_argument("--ckpt", default=None,
                   help="trained action checkpoint (random weights if "
                        "omitted)")
    p.add_argument("--data_dir", default=None,
                   help="MSR-Action3D npz dir; synthetic if omitted")
    p.add_argument("--synthetic_dir", default="runs/action_demo_msr",
                   help="where the synthetic dataset is written")
    p.add_argument("--frames_per_clip", type=int, default=24)
    p.add_argument("--num_points", type=int,
                   default=ActionTrainConfig.num_points)
    p.add_argument("--out", default="runs/action_demo_out.npz")
    p.add_argument("--eval_metrics", action="store_true",
                   help="the MSR-Action3D protocol (Chamfer / 2,048, EMD) "
                        "against the ground truth")
    p.add_argument("--emd_iters", type=int, default=3000)
    p.add_argument("--num_clips", type=int, default=1,
                   help="average --eval_metrics over the first N test clips")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card)")
    return p.parse_args(argv)


def load_model(ckpt: Optional[str], device):
    """The checkpoint's NoMaskSRNet, or one of random weights (in_feats 3,
    width 128, r 16, seed 0) without one."""
    from tpugan_tpu_torch.checkpoint import load_nomask_srnet
    from tpugan_tpu_torch.models.generator import NoMaskSRNet

    if ckpt:
        return load_nomask_srnet(ckpt, device=device)
    return NoMaskSRNet(in_feats=3, node_emb_dim=128, upsample_ratio=16,
                       device=device)


@torch.no_grad()
def upsample_clip(model, item, device) -> np.ndarray:
    """Each frame of ``item["lowres_pos"]`` [F, n, 3] through the model, one
    frame a forward, shifted back by ``item["centers"]``: [F, n * r, 3]."""
    lowres = torch.from_numpy(item["lowres_pos"]).to(device)
    centers = torch.from_numpy(item["centers"]).to(device)
    preds = [model(lowres[f][None], lowres[f][None])[0][0] + centers[f]
             for f in range(lowres.shape[0])]
    return torch.stack(preds).cpu().numpy()


def clip_metrics(ds, item, preds, model, device, num_clips, emd_iters):
    """(mean Chamfer / 2,048, mean EMD) over the frames of the first
    ``num_clips`` test clips, each clip and its ground truth resampled to
    2,048 points, y flipped and normalised per frame."""
    from tpugan_tpu_torch.eval.analysis import (action_position_metrics,
                                                pad_clip_with_appropriate_size)

    rng = np.random.default_rng(0)
    cds, emds = [], []
    for ci in range(min(num_clips, len(ds))):
        item_i = item if ci == 0 else ds[ci]
        preds_i = preds if ci == 0 else upsample_clip(model, item_i, device)
        gt = item_i["highres_pos"] + item_i["centers"][:, None, :]
        pred_clip = pad_clip_with_appropriate_size(list(preds_i), rng=rng)
        gt_clip = pad_clip_with_appropriate_size(list(gt), rng=rng)
        for f in range(pred_clip.shape[0]):
            cd, emd = action_position_metrics(
                torch.from_numpy(pred_clip[f]).to(device),
                torch.from_numpy(gt_clip[f]).to(device), emd_iters=emd_iters)
            cds.append(cd)
            emds.append(emd)
    return float(np.mean(cds)), float(np.mean(emds)), len(cds)


def main(argv=None) -> dict:
    from tpugan_tpu_torch.data.msr import MSRAction3DDataset
    from tpugan_tpu_torch.data.synthetic import make_synthetic_action_dataset

    opt = get_arguments(argv)
    device = resolve_device(opt.device)
    data_dir = opt.data_dir
    if data_dir is None:
        data_dir = make_synthetic_action_dataset(opt.synthetic_dir,
                                                 num_videos=4, frames=30,
                                                 points=3000)
    ds = MSRAction3DDataset(data_dir, frames_per_clip=opt.frames_per_clip,
                            num_points=opt.num_points, train=False,
                            fps_ratio=ActionTrainConfig.fps_ratio)
    item = ds[0]
    model = load_model(opt.ckpt, device)
    preds = upsample_clip(model, item, device)
    os.makedirs(os.path.dirname(os.path.abspath(opt.out)), exist_ok=True)
    np.savez(opt.out, pred=preds, label=item["label"])
    print(f"wrote {preds.shape} upsampled clip to {opt.out} "
          f"(label {int(item['label'])})", flush=True)
    result = {"out": opt.out, "shape": list(preds.shape),
              "label": int(item["label"])}
    if opt.eval_metrics:
        cd, emd, frames = clip_metrics(ds, item, preds, model, device,
                                       opt.num_clips, opt.emd_iters)
        print(f"action eval protocol: CD/2048 = {cd:.6f}, EMD = {emd:.6f} "
              f"over {frames} frames", flush=True)
        result.update(cd=cd, emd=emd, frames=frames)
    return result


if __name__ == "__main__":
    main()
