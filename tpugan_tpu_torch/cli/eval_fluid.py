"""Quantitative fluid evaluation CLI (``tpugan_tpu/cli/eval_fluid.py``).

Per sample of a test dataset: normalised Chamfer, EMD and Gaussian MMD of
the upsampled centre frame against ground truth, the free-surface particle
counts, and upsample-advect cycle consistency, from a trained checkpoint
(random weights, seeded, without one). Prints one JSON object with the JAX
CLI's keys.

    python -m tpugan_tpu_torch.cli.eval_fluid \\
        --ckpt checkpoints/fluid_vel_20k.ckpt --in_node_feats 6 --use_vel \\
        --patch_size 9216                      # on the CUDA card
    python -m tpugan_tpu_torch.cli.eval_fluid ... --device cpu

Without ``--dataset_path`` a synthetic dataset is written under the
repository's ``runs/eval_fluid_synth/``. ``--approx_graph`` turns the
approximate bf16 graph kNN on for the evaluated forwards (the exact twin of
``--agreement_vs_exact`` runs with it off); it reaches the kernel from
``--patch_size 32768`` (4,096 inputs) on. The switch is restored when the
evaluation returns.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Optional

import numpy as np

SYNTH_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "runs", "eval_fluid_synth")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate a fluid upsampler")
    p.add_argument("--ckpt", type=str, default=None,
                   help="checkpoint file, or a directory with a "
                        "latest_checkpoint.txt manifest")
    p.add_argument("--dataset_path", type=str, default=None,
                   help="case{i}/data_{t}.npz dir; synthetic if omitted")
    p.add_argument("--sequence_num", type=int, default=1)
    p.add_argument("--sequence_length", type=int, default=8)
    p.add_argument("--num_samples", type=int, default=8)
    p.add_argument("--patch_size", type=int, default=4096)
    p.add_argument("--in_node_feats", type=int, default=3)
    p.add_argument("--node_embedding", type=int, default=128)
    p.add_argument("--upsample_ratio", type=int, default=8)
    p.add_argument("--use_vel", action="store_true")
    p.add_argument("--R", type=float, default=0.10)
    p.add_argument("--emd_iters", type=int, default=2000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute_dtype", choices=["f32", "bf16"], default="f32")
    p.add_argument("--graph_mode", choices=["dynamic", "static"],
                   default="dynamic")
    p.add_argument("--approx_graph", action="store_true",
                   help="allow the approximate bf16 graph-kNN kernel "
                        "(default: exact)")
    p.add_argument("--agreement_vs_exact", action="store_true",
                   help="also run the exact f32 dynamic-graph forward on "
                        "every sample and report keep-mask agreement and "
                        "prediction Chamfer against it")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card)")
    return p


def generator_for_flags(opt, device, compute_dtype, graph_mode, seed):
    """(SRNet of the flags, checkpoint path or None): the checkpoint's
    weights (which must have the widths of ``opt.in_node_feats``,
    ``opt.node_embedding`` and ``opt.upsample_ratio``), or random ones drawn
    from a generator seeded ``seed`` without ``opt.ckpt``."""
    import torch

    from tpugan_tpu_torch.checkpoint import load_srnet, resolve_checkpoint
    from tpugan_tpu_torch.models.generator import SRNet

    if not opt.ckpt:
        return SRNet(in_feats=opt.in_node_feats,
                     node_emb_dim=opt.node_embedding,
                     upsample_ratio=opt.upsample_ratio,
                     compute_dtype=compute_dtype, graph_mode=graph_mode,
                     generator=torch.Generator().manual_seed(seed),
                     device=device), None
    path = resolve_checkpoint(opt.ckpt)
    model = load_srnet(path, device=device, compute_dtype=compute_dtype,
                       graph_mode=graph_mode)
    half = model.feature_extractor.EdgeConv_0.ConvLayer_0.Dense_0.weight.shape[0]
    got = (model.in_feats, 2 * half, model.upsample_ratio)
    want = (opt.in_node_feats, opt.node_embedding, opt.upsample_ratio)
    if got != want:
        raise ValueError(f"{path} holds (in_feats, node_embedding, "
                         f"upsample_ratio) = {got}; the flags say {want}")
    return model, path


def evaluate(opt, on_sample: Optional[Callable[[int], None]] = None) -> dict:
    """Run the evaluation of parsed flags ``opt``; returns the JSON dict.
    ``on_sample(i)`` is called after sample i's metrics, and with -1 once
    the data and the model are ready, before sample 0. The graph-kNN
    switch is restored on return."""
    from tpugan_tpu_torch.ops import neighbors

    prev = neighbors.APPROX_GRAPH_KNN
    try:
        return _evaluate(opt, on_sample)
    finally:
        neighbors.set_approx_graph_knn(prev)


def _evaluate(opt, on_sample):
    import torch

    from tpugan_tpu_torch import DT, resolve_device
    from tpugan_tpu_torch.data.fluid import SiamFluidDataset
    from tpugan_tpu_torch.data.sampling import pad_with_appropriate_size
    from tpugan_tpu_torch.data.synthetic import make_synthetic_fluid_dataset
    from tpugan_tpu_torch.eval.analysis import (
        cycle_consistency, free_surface_particle_count_diff,
        free_surface_particle_counts, position_metrics)
    from tpugan_tpu_torch.ops.metrics import chamfer
    from tpugan_tpu_torch.ops.neighbors import set_approx_graph_knn

    dev = resolve_device(opt.device)
    dataset_path = opt.dataset_path
    if dataset_path is None:
        dataset_path = make_synthetic_fluid_dataset(
            SYNTH_DIR, case_num=opt.sequence_num,
            case_steps=opt.sequence_length, num_particles=12000,
            seed=opt.seed + 100)
    ds = SiamFluidDataset(dataset_path, opt.sequence_num, opt.sequence_length,
                          sample_num=opt.patch_size, fps_ratio=0.125,
                          jitter=0.0, seed=opt.seed, emit_lowres=True)

    compute_dtype = torch.bfloat16 if opt.compute_dtype == "bf16" else None
    model, path = generator_for_flags(opt, dev, compute_dtype,
                                      opt.graph_mode, opt.seed)
    if path:
        print(f"restored generator from {path}")
    exact = (generator_for_flags(opt, dev, None, "dynamic", opt.seed)[0]
             if opt.agreement_vs_exact else None)

    def sr_apply(feature, pos):
        expanded, _, _, _ = model(feature, pos)
        return expanded

    use_vel = opt.use_vel and opt.in_node_feats == 6
    cds, emds, mmds, fs_diffs = [], [], [], []
    fs_preds, fs_gts, keep_rates, pred_counts, gt_counts = [], [], [], [], []
    cyc_cds, cyc_emds = [], []
    mask_agreements, cd_vs_exact = [], []
    tensor = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    if on_sample is not None:
        on_sample(-1)
    with torch.no_grad():
        for i in range(min(opt.num_samples, len(ds))):
            item = ds[i]
            low = tensor(item["lowres_pos"])             # [3, n, 3]
            high = tensor(item["highres_pos"])           # [3, m, 3]
            vel = tensor(item["lowres_vel"])
            feat = torch.cat([low, vel * DT], -1) if use_vel else low

            set_approx_graph_knn(opt.approx_graph)
            _, _, padded, valid = model(feat[1][None], low[1][None])
            if exact is not None:
                set_approx_graph_knn(False)
                _, _, padded_e, valid_e = exact(feat[1][None], low[1][None])
                mask_agreements.append(float((valid == valid_e).float().mean()))
                cd = float(chamfer(padded, padded_e, a_valid=valid,
                                   b_valid=valid_e)[0])
                scale = float((low[1] ** 2).sum(-1).mean())
                cd_vs_exact.append(cd / (padded.shape[1] * max(scale, 1e-12)))
                # the metrics and the cycle below run the requested mode
                set_approx_graph_knn(opt.approx_graph)
            pred = padded[0][valid[0]].float().cpu().numpy()
            gt = item["highres_pos"][1]
            # the Chamfer sees the whole prediction: padded to a bucket with
            # a validity mask; position_metrics cuts it for the EMD
            pred_padded, pred_valid = pad_with_appropriate_size(pred)
            cd, emd, mmd = position_metrics(
                tensor(pred_padded[None]), high[1][None],
                emd_iters=opt.emd_iters, pred_valid=tensor(pred_valid[None]))
            cds.append(cd)
            emds.append(emd)
            mmds.append(mmd)
            fs_diffs.append(free_surface_particle_count_diff(pred, gt,
                                                             radius=0.025))
            fp, fg = free_surface_particle_counts(pred, gt, radius=0.025)
            fs_preds.append(fp)
            fs_gts.append(fg)
            keep_rates.append(pred.shape[0]
                              / (low.shape[1] * opt.upsample_ratio))
            pred_counts.append(pred.shape[0])
            gt_counts.append(int(high.shape[1]))

            adv = tensor(item["highres_vel"][0] * DT)[None]
            ccd, cemd, _ = cycle_consistency(
                sr_apply, low[0][None], low[1][None], adv, high[0][None],
                cutoff=opt.R, use_vel=use_vel,
                lowres_vel_left=vel[0][None], lowres_vel_right=vel[1][None],
                emd_iters=opt.emd_iters)
            cyc_cds.append(ccd)
            cyc_emds.append(cemd)
            if on_sample is not None:
                on_sample(i)

    return {
        "serving_mode": {"compute_dtype": opt.compute_dtype,
                         "graph_mode": opt.graph_mode,
                         "approx_graph": bool(opt.approx_graph)},
        "chamfer_norm": float(np.mean(cds)),
        "emd": float(np.mean(emds)),
        "mmd": float(np.mean(mmds)),
        "free_surface_count_diff": float(np.mean(fs_diffs)),
        "free_surface_pred_count": float(np.mean(fs_preds)),
        "free_surface_gt_count": float(np.mean(fs_gts)),
        "keep_rate": float(np.mean(keep_rates)),
        "pred_point_count": float(np.mean(pred_counts)),
        "gt_point_count": float(np.mean(gt_counts)),
        "cycle_chamfer": float(np.mean(cyc_cds)),
        "cycle_emd": float(np.mean(cyc_emds)),
        "samples": len(cds),
        **({"keep_mask_agreement_vs_exact": float(np.mean(mask_agreements)),
            "chamfer_norm_vs_exact": float(np.mean(cd_vs_exact))}
           if mask_agreements else {}),
    }


def main(argv=None) -> dict:
    result = evaluate(parser().parse_args(argv))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
