"""Action GAN training CLI (``tpugan_tpu/cli/train_action.py``): the JAX
CLI's argument surface and loop on the PyTorch port.

    python -m tpugan_tpu_torch.cli.train_action --preset train_dir \\
        --device_sampling --synthetic --log_dir runs/train_dir   # the card
    python -m tpugan_tpu_torch.cli.train_action ... --device cpu  # plain

Preset (``--preset``, the reference's shell script): ``train_dir``
(``--iters 100000 --ckpt_every 10000 --dump_visualization``).
``--synthetic`` writes an MSR-Action3D-schema synthetic set under
``<log_dir>/synthetic_msr`` (subjects alternate between the train and the
test split); ``--resume`` continues from ``--path_to_resume`` (a checkpoint
file, or a directory with a ``latest_checkpoint.txt`` manifest; default
``<log_dir>/model_ckpt``) at its ``n_iter``. The learning rates decay every
``iters // 10`` steps, as in the JAX CLI. At iteration 1 of every
``ckpt_every`` (and at the last) the test split's per-point Chamfer is
logged (with ``--dump_visualization`` its clouds rendered to
``<log_dir>/samples``) and the whole trainer state is written to
``<log_dir>/model_ckpt`` in the JAX package's schema, keeping the newest 5.
``--profile`` writes a ``torch.profiler`` trace of steps 10-15 to
``<log_dir>/profile``.

``TPUGAN_FUSED_EDGECONV_TRAIN=1`` (the JAX package's switch) trains every
generator EdgeConv through the fused kernels and their backward
(``NoMaskSRNet(fused_train=True)``); the package itself reads no
environment variable. ``--exact_graph`` is accepted and changes nothing:
the port's graph kNN is exact unless ``set_approx_graph_knn`` turns the
approximate one on, which this CLI never does (and 128-point graphs never
reach it). ``--fast_d`` trains the critics through their stacked applies
(``tpugan_tpu_torch/train/step.py``). ``--data_parallel`` trains on the
ranks of a ``torchrun`` launch as ``cli/train_fluid.py``'s does
(``ActionGanStep(data_parallel=True)``; rank 0 writes the data, the
checkpoints, the test evaluations and the logs):

    torchrun --nproc_per_node 4 -m tpugan_tpu_torch.cli.train_action \
        --preset train_dir --device_sampling --synthetic --data_parallel
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Optional

import numpy as np

from tpugan_tpu_torch.cli.train_fluid import (FUSED_SWITCH, _profiler,
                                              _write_profile,
                                              join_data_parallel,
                                              leave_data_parallel, local_rows,
                                              print_network_sizes, rank0_first,
                                              rank0_writer)


def get_arguments(argv=None) -> argparse.Namespace:
    from tpugan_tpu_torch.config import parse_with_preset

    parser = argparse.ArgumentParser(description="Train action GAN")
    add = parser.add_argument
    add("--lr", type=float, default=3e-4)
    add("--resume", action="store_true")
    add("--path_to_resume", type=str, default=None)
    add("--iters", type=int, default=100000)
    add("--log_dir", type=str, default="./")
    add("--ckpt_every", type=int, default=10000)
    add("--node_embedding", type=int, default=128)
    add("--R", type=float, default=2.0)
    add("--data_dir", type=str, default="./MSR-Action3D")
    add("--batch_size", type=int, default=4)
    add("--num_points", type=int, default=2048)
    add("--w", type=float, default=2.0)
    add("--exact_graph", action="store_true",
        help="accepted for the JAX CLI's surface: the port's training "
             "graphs are always exact")
    add("--freeze_D", action="store_true")
    add("--fast_d", action="store_true",
        help="stack the critics' per-frame and fake/real applies into one "
             "batched apply (see train_fluid --fast_d)")
    add("--dump_visualization", action="store_true")
    add("--device_sampling", action="store_true",
        help="per-frame FPS downsample on the card inside the step instead "
             "of in the host loader")
    add("--synthetic", action="store_true")
    add("--synthetic_videos", type=int, default=6)
    add("--synthetic_classes", type=int, default=3)
    add("--synthetic_frames", type=int, default=10)
    add("--data_parallel", action="store_true",
        help="train on the ranks of a torchrun launch, each on its rows of "
             "the global batch")
    add("--profile", action="store_true",
        help="write a torch.profiler trace of steps 10-15 into "
             "<log_dir>/profile")
    add("--seed", type=int, default=1)
    add("--device", type=str, default=None,
        help="torch device (default: the CUDA card)")
    return parse_with_preset(parser, "train_action", argv)


def main(argv=None,
         hook: Optional[Callable[[str, int, Optional[dict]], None]] = None
         ) -> dict:
    """Run the CLI on ``argv``. ``hook(event, n_iter, metrics)``, when
    given, is called as by ``cli/train_fluid.main``: "start" before each
    step, "generator" and "critics" from inside it, "end" after it with
    the step's metrics. Returns ``{"n_iter", "state", "checkpoint",
    "metrics", "test_chamfer"}``."""
    import torch

    from tpugan_tpu_torch.checkpoint import load_action_trainer_state
    from tpugan_tpu_torch.config import ActionTrainConfig
    from tpugan_tpu_torch.data.msr import (MSRAction3DDataset,
                                           action_batch_iterator)
    from tpugan_tpu_torch.data.prefetch import prefetch_iterator
    from tpugan_tpu_torch.data.synthetic import make_synthetic_action_dataset
    from tpugan_tpu_torch.train.checkpoint import save_checkpoint_async
    from tpugan_tpu_torch.train.state import init_action_state
    from tpugan_tpu_torch.train.step import ActionGanStep
    from tpugan_tpu_torch.utils.logging import StepTimer

    opt = get_arguments(argv)
    dev, rank, made = join_data_parallel(opt)
    say = print if rank == 0 else (lambda *a, **k: None)
    say("Using following options")
    say(opt)
    fused = os.environ.get(FUSED_SWITCH, "0") == "1"

    data_dir = opt.data_dir
    if opt.synthetic:
        data_dir = os.path.join(opt.log_dir, "synthetic_msr")
        say(f"Generating synthetic MSR dataset at {data_dir}")
        rank0_first(rank, lambda: make_synthetic_action_dataset(
            data_dir, num_videos=opt.synthetic_videos,
            frames=opt.synthetic_frames, points=3000,
            num_classes=opt.synthetic_classes, seed=opt.seed))

    cfg = ActionTrainConfig(
        lr=opt.lr, iters=opt.iters, ckpt_every=opt.ckpt_every,
        node_embedding=opt.node_embedding, R=opt.R, data_dir=data_dir,
        batch_size=opt.batch_size, num_points=opt.num_points, w=opt.w,
        device_sampling=opt.device_sampling, freeze_D=opt.freeze_D,
        fast_d=opt.fast_d, dump_visualization=opt.dump_visualization,
        log_dir=opt.log_dir, seed=opt.seed)

    say("Preparing the data")
    dataset = MSRAction3DDataset(
        cfg.data_dir, frames_per_clip=cfg.frames_per_clip,
        num_points=cfg.num_points, fps_ratio=cfg.fps_ratio, seed=cfg.seed,
        return_lowres=not cfg.device_sampling)
    batches = prefetch_iterator(
        action_batch_iterator(dataset, cfg.batch_size, seed=cfg.seed), size=2)
    # the held-out split, evaluated at every checkpoint (reference
    # train_msr.py:230-262)
    test_dataset = MSRAction3DDataset(
        cfg.data_dir, frames_per_clip=cfg.frames_per_clip,
        num_points=cfg.num_points, fps_ratio=cfg.fps_ratio, seed=cfg.seed,
        train=False)
    test_batches = None
    if len(test_dataset) < cfg.batch_size:
        say("no held-out test clips found; skipping test-split eval")
    elif rank == 0:
        test_batches = action_batch_iterator(test_dataset, cfg.batch_size,
                                             seed=cfg.seed + 7)

    state = init_action_state(cfg, cfg.seed, dev, fused_train=fused)
    print_network_sizes(state, say)
    checkpoint_dir = os.path.join(cfg.log_dir, "model_ckpt")
    os.makedirs(checkpoint_dir, exist_ok=True)
    if opt.resume:
        fresh = state.sr.module
        state = load_action_trainer_state(opt.path_to_resume or checkpoint_dir,
                                          cfg, dev, fused_train=fused)
        got = [tuple(p.shape) for p in state.sr.module.parameters()]
        if got != [tuple(p.shape) for p in fresh.parameters()]:
            raise ValueError("--resume: the checkpoint's generator has other "
                             "widths than the flags (--node_embedding)")
        say("last checkpoint restored")

    writer, timer = rank0_writer(rank, cfg.log_dir), StepTimer()
    step = ActionGanStep(cfg, generator=torch.Generator().manual_seed(cfg.seed + 1),
                         data_parallel=opt.data_parallel)
    n_iter = start_iter = state.n_iter
    start = time.time()
    ckpt_future, ckpt_path, metrics, test_cds = None, None, {}, []
    profiler = None
    while n_iter < cfg.iters:
        batch = local_rows(opt, next(batches))
        feed = {k: torch.from_numpy(batch[k]).to(dev)
                for k in ("lowres_pos", "highres_pos") if k in batch}
        timer.data_ready()
        if opt.profile and n_iter == 10 and rank == 0:
            profiler = _profiler(torch)
            profiler.start()
        cur = n_iter + 1
        if hook is not None:
            hook("start", cur, None)
        metrics = step(state, feed, mark=None if hook is None
                       else (lambda event: hook(event, cur, None)))
        n_iter = state.n_iter
        timer.step_done()
        if hook is not None:
            hook("end", n_iter, metrics)
        writer.add(n_iter, metrics)
        if profiler is not None and n_iter == 15:
            profiler = _write_profile(torch, profiler, cfg.log_dir)

        if n_iter % 50 == 0:
            rate = (n_iter - start_iter) / (time.time() - start)
            say(f"iter {n_iter}/{cfg.iters} ({rate:.2f} it/s, "
                  f"eff {timer.compute_efficiency:.2f}): "
                  + ", ".join(f"{k}={v:.4f}" for k, v in metrics.items()),
                  flush=True)

        if rank == 0 and ((n_iter - 1) % cfg.ckpt_every == 0
                          or n_iter >= cfg.iters):
            if test_batches is not None:
                test_cd = _test_eval(state.sr.module, test_batches, cfg,
                                     n_iter, dev)
                test_cds.append(test_cd)
                writer.add(n_iter, {"test_Chamfer_distance": test_cd})
                print(f"iter {n_iter}: test Chamfer (per-point) = "
                      f"{test_cd:.6f}", flush=True)
            ckpt_path = os.path.join(checkpoint_dir,
                                     f"tpugan_checkpoint{n_iter}.ckpt")
            ckpt_future = save_checkpoint_async(state, ckpt_path, max_keep=5)

    if profiler is not None:
        _write_profile(torch, profiler, cfg.log_dir)
    if ckpt_future is not None:
        ckpt_future.result()            # join the writer before returning
    writer.close()
    leave_data_parallel(made)
    say("exiting...")
    return {"n_iter": n_iter, "state": state, "checkpoint": ckpt_path,
            "metrics": metrics, "test_chamfer": test_cds}


def _test_eval(model, test_batches, cfg, n_iter, dev, n_batches=4):
    """Serving forward over held-out test clips (reference
    train_msr.py:230-262): the mean per-point Chamfer distance on frame 0
    of each batch; with ``dump_visualization`` the first clip's ground
    truth, input and prediction rendered to PNG."""
    import torch

    from tpugan_tpu_torch.data.sampling import dump_pointcloud_visualization
    from tpugan_tpu_torch.ops.metrics import chamfer

    tensor = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    sample_dir = os.path.join(cfg.log_dir, "samples")
    cds = []
    for j in range(n_batches):
        batch = next(test_batches)
        lowres, highres = batch["lowres_pos"][0], batch["highres_pos"][0]
        with torch.no_grad():
            pred, _ = model(tensor(lowres), tensor(lowres))
            cd = chamfer(pred, tensor(highres))
        cds.append(float(cd.mean()) / highres.shape[-2])
        if cfg.dump_visualization:
            os.makedirs(sample_dir, exist_ok=True)
            for name, cloud in (("gt", highres[0]), ("input", lowres[0]),
                                ("pred", pred[0].cpu().numpy())):
                dump_pointcloud_visualization(
                    cloud, os.path.join(sample_dir,
                                        f"{name}_iter{n_iter}_{j}.png"))
    return float(np.mean(cds))


if __name__ == "__main__":
    main()
