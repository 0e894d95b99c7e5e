"""Fluid GAN training CLI (``tpugan_tpu/cli/train_fluid.py``): the JAX CLI's
argument surface and loop on the PyTorch port.

    python -m tpugan_tpu_torch.cli.train_fluid --preset train_vel \\
        --device_sampling --synthetic --log_dir runs/train_vel   # the card
    python -m tpugan_tpu_torch.cli.train_fluid ... --device cpu  # plain

Presets (``--preset``, the reference's shell scripts): ``train_vel``
(``--use_vel --in_node_feats 6``) and ``train_novel`` (the defaults).
``--synthetic`` writes a reference-schema synthetic dataset under
``<log_dir>/synthetic_data`` (and a held-out one for the test split);
``--resume`` continues from ``--path_to_resume`` (a checkpoint file, or a
directory with a ``latest_checkpoint.txt`` manifest; default
``<log_dir>/model_ckpt``) at its ``n_iter``. Every ``ckpt_every``
iterations (and at the last) the whole trainer state is written to
``<log_dir>/model_ckpt`` in the JAX package's schema, the test split's
Chamfer is logged, and with ``--dump_visualization`` sample clouds go to
``<log_dir>/samples``. ``--profile`` writes a ``torch.profiler`` trace of
steps 10-15 to ``<log_dir>/profile``.

``TPUGAN_FUSED_EDGECONV_TRAIN=1`` (the JAX CLI's switch) trains every
generator EdgeConv through the fused kernels and their backward
(``SRNet(fused_train=True)``); the package itself reads no environment
variable. ``--exact_graph`` is accepted and changes nothing: the port's
graph kNN is exact unless ``set_approx_graph_knn`` turns the approximate
one on, which this CLI never does. ``--fast_d`` trains the critics
through their stacked applies (``tpugan_tpu_torch/train/step.py``).

``--data_parallel`` trains on the ranks of a ``torchrun`` launch, one card
each (``cuda:LOCAL_RANK``, or ``--device``): every rank draws the same
global batch of ``--batch_size`` items and steps on its rows of it, and
the step equals the global batch's (``FluidGanStep(data_parallel=True)``).
Rank 0 writes the synthetic data, the checkpoints, the test evaluations,
the samples, the logs and the profile. The backend is NCCL on the card and
gloo on the CPU or where the ranks share a card
(``parallel/mesh.py : initialize_distributed``):

    torchrun --nproc_per_node 4 -m tpugan_tpu_torch.cli.train_fluid \
        --preset train_vel --device_sampling --synthetic --data_parallel
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Optional

import numpy as np

FUSED_SWITCH = "TPUGAN_FUSED_EDGECONV_TRAIN"


def get_arguments(argv=None) -> argparse.Namespace:
    from tpugan_tpu_torch.config import parse_with_preset

    parser = argparse.ArgumentParser(description="Train temporal consistent GAN")
    add = parser.add_argument
    add("--lr", type=float, default=3e-4)
    add("--resume", action="store_true")
    add("--path_to_resume", type=str, default=None)
    add("--iters", type=int, default=80000)
    add("--log_dir", type=str, default="./")
    add("--ckpt_every", type=int, default=5000)
    add("--ckpt_keep", type=int, default=5,
        help="max rotated checkpoints to retain (besides best_model)")
    add("--in_node_feats", type=int, default=3)
    add("--node_embedding", type=int, default=128)
    add("--R", type=float, default=0.10)
    add("--train_dataset_path", type=str,
        default="../../data/train_data_0.025_fine")
    add("--test_dataset_path", type=str,
        default="../../data/test_data_0.025_fine")
    add("--train_sequence_num", type=int, default=20)
    add("--test_sequence_num", type=int, default=4)
    add("--sequence_length", type=int, default=200)
    add("--batch_size", type=int, default=4)
    add("--small_batch", action="store_true")
    add("--w", type=float, default=0.5)
    add("--cutoff", type=float, default=0.025)
    add("--use_vel", action="store_true")
    add("--interp", choices=["dense", "capped"], default="dense",
        help="velocity-transfer interpolation: every in-radius neighbour "
             "(the dense kernel) or the reference's 32 nearest within it")
    add("--device_sampling", action="store_true",
        help="FPS-downsample + jitter the lowres inputs on the card inside "
             "the step instead of in the host loader")
    add("--exact_graph", action="store_true",
        help="accepted for the JAX CLI's surface: the port's training "
             "graphs are always exact")
    add("--freeze_D", action="store_true")
    add("--fast_d", action="store_true",
        help="stack the critics' per-frame and fake/real applies into one "
             "batched apply (grouped batch statistics keep per-call batch "
             "norm semantics; spectral-norm power iterations advance once "
             "per stacked apply). Requires fps_ratio * upsample_ratio == 1 "
             "so fake and real clouds share a point count")
    add("--dump_visualization", action="store_true")
    add("--synthetic", action="store_true",
        help="generate and train on synthetic SPH-like fixtures")
    add("--synthetic_particles", type=int, default=12000)
    add("--synthetic_cases", type=int, default=2)
    add("--synthetic_steps", type=int, default=8)
    add("--patch_size", type=int, default=None,
        help="override patch size (default: 9216, or 4096 for small batch)")
    add("--data_parallel", action="store_true",
        help="train on the ranks of a torchrun launch, each on its rows of "
             "the global batch")
    add("--profile", action="store_true",
        help="write a torch.profiler trace of steps 10-15 into "
             "<log_dir>/profile")
    add("--seed", type=int, default=1)
    add("--device", type=str, default=None,
        help="torch device (default: the CUDA card)")
    return parse_with_preset(parser, "train_fluid", argv)


def main(argv=None,
         hook: Optional[Callable[[str, int, Optional[dict]], None]] = None
         ) -> dict:
    """Run the CLI on ``argv``. ``hook(event, n_iter, metrics)``, when
    given, is called with "start" before each step, "generator" and
    "critics" from inside it (after the generator's and the critics'
    updates) and "end" after it with the step's metrics, so a caller can
    time the step and read the kernels' launch counts around it. Returns
    ``{"n_iter", "state", "checkpoint", "metrics", "test_chamfer"}``."""
    import torch

    from tpugan_tpu_torch.checkpoint import load_trainer_state
    from tpugan_tpu_torch.data.fluid import (SiamFluidDataset,
                                             fluid_batch_iterator)
    from tpugan_tpu_torch.data.prefetch import prefetch_iterator
    from tpugan_tpu_torch.data.synthetic import make_synthetic_fluid_dataset
    from tpugan_tpu_torch.train.checkpoint import save_checkpoint_async
    from tpugan_tpu_torch.train.state import init_fluid_state
    from tpugan_tpu_torch.train.step import FluidGanStep, FluidTrainConfig
    from tpugan_tpu_torch.utils.logging import StepTimer

    opt = get_arguments(argv)
    dev, rank, made = join_data_parallel(opt)
    say = print if rank == 0 else (lambda *a, **k: None)
    say("Using following options")
    say(opt)
    fused = os.environ.get(FUSED_SWITCH, "0") == "1"

    patch_size = opt.patch_size or (
        9216 if opt.batch_size <= 4 and not opt.small_batch else 4096)
    train_path = opt.train_dataset_path
    train_seq, seq_len = opt.train_sequence_num, opt.sequence_length
    if opt.synthetic:
        train_path = os.path.join(opt.log_dir, "synthetic_data")
        train_seq, seq_len = opt.synthetic_cases, opt.synthetic_steps
        say(f"Generating synthetic dataset at {train_path}")
        rank0_first(rank, lambda: make_synthetic_fluid_dataset(
            train_path, case_num=train_seq, case_steps=seq_len,
            num_particles=opt.synthetic_particles, seed=opt.seed))

    cfg = FluidTrainConfig(
        lr=opt.lr, batch_size=opt.batch_size, patch_size=patch_size,
        in_node_feats=opt.in_node_feats, node_embedding=opt.node_embedding,
        R=opt.R, w=opt.w, cutoff=opt.cutoff, use_vel=opt.use_vel,
        interp=opt.interp, device_sampling=opt.device_sampling,
        freeze_D=opt.freeze_D, fast_d=opt.fast_d)

    say("Preparing the data")
    dataset = SiamFluidDataset(
        train_path, train_seq, seq_len, sample_num=patch_size,
        fps_ratio=cfg.fps_ratio, jitter=cfg.jitter, seed=opt.seed,
        emit_lowres=not cfg.device_sampling)
    batches = prefetch_iterator(
        fluid_batch_iterator(dataset, cfg.batch_size, seed=opt.seed), size=2)

    # the test split: a held-out synthetic set, or test_dataset_path
    test_path, test_seq = opt.test_dataset_path, opt.test_sequence_num
    if opt.synthetic:
        test_path = os.path.join(opt.log_dir, "synthetic_test_data")
        test_seq = max(1, opt.synthetic_cases // 2)
        rank0_first(rank, lambda: make_synthetic_fluid_dataset(
            test_path, case_num=test_seq, case_steps=seq_len,
            num_particles=opt.synthetic_particles, seed=opt.seed + 7919))
    test_batches = None
    if rank == 0 and test_path and os.path.isdir(test_path):
        test_batches = fluid_batch_iterator(
            SiamFluidDataset(test_path, test_seq, seq_len,
                             sample_num=patch_size, fps_ratio=cfg.fps_ratio,
                             jitter=0.0, seed=opt.seed + 1, emit_lowres=True),
            cfg.batch_size, seed=opt.seed + 1)

    state = init_fluid_state(cfg, opt.seed, dev, fused_train=fused)
    print_network_sizes(state, say)
    checkpoint_dir = os.path.join(opt.log_dir, "model_ckpt")
    os.makedirs(checkpoint_dir, exist_ok=True)
    if opt.resume:
        fresh = state.sr.module
        state = load_trainer_state(opt.path_to_resume or checkpoint_dir, cfg,
                                   dev, fused_train=fused)
        got = [tuple(p.shape) for p in state.sr.module.parameters()]
        if got != [tuple(p.shape) for p in fresh.parameters()]:
            raise ValueError("--resume: the checkpoint's generator has other "
                             "widths than the flags (--in_node_feats, "
                             "--node_embedding)")
        say("last checkpoint restored")

    writer, timer = rank0_writer(rank, opt.log_dir), StepTimer()
    step = FluidGanStep(cfg, generator=torch.Generator().manual_seed(opt.seed + 1),
                        data_parallel=opt.data_parallel)
    n_iter = start_iter = state.n_iter
    start = time.time()
    ckpt_future, ckpt_path, metrics, test_cds = None, None, {}, []
    profiler = None
    while n_iter < opt.iters:
        batch = next(batches)
        feed = {k: torch.from_numpy(v).to(dev)
                for k, v in local_rows(opt, batch).items() if k != "h"}
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
        writer.add(n_iter, {k: v for k, v in metrics.items() if k != "gate"})
        if profiler is not None and n_iter == 15:
            profiler = _write_profile(torch, profiler, opt.log_dir)

        if n_iter % 50 == 0:
            rate = (n_iter - start_iter) / (time.time() - start)
            say(f"iter {n_iter}/{opt.iters} ({rate:.2f} it/s, "
                  f"eff {timer.compute_efficiency:.2f}): "
                  + ", ".join(f"{k}={float(v):.4f}"
                              for k, v in metrics.items()), flush=True)

        if rank == 0 and ((n_iter - 1) % opt.ckpt_every == 0
                          or n_iter >= opt.iters):
            ckpt_path = os.path.join(checkpoint_dir,
                                     f"tpugan_checkpoint{n_iter}.ckpt")
            ckpt_future = save_checkpoint_async(state, ckpt_path,
                                                max_keep=opt.ckpt_keep)
            if test_batches is not None:
                test_cd = _test_eval(state.sr.module, test_batches, cfg, opt,
                                     n_iter, dev)
                test_cds.append(test_cd)
                writer.add(n_iter, {"test_Chamfer_distance": test_cd})
                print(f"iter {n_iter}: test Chamfer (per-point) = "
                      f"{test_cd:.6f}", flush=True)
            if opt.dump_visualization:
                _dump_samples(state.sr.module, batch, cfg, opt, n_iter, dev)

    if profiler is not None:
        _write_profile(torch, profiler, opt.log_dir)
    if ckpt_future is not None:
        ckpt_future.result()            # join the writer before returning
    writer.close()
    leave_data_parallel(made)
    say("exiting...")
    return {"n_iter": n_iter, "state": state, "checkpoint": ckpt_path,
            "metrics": metrics, "test_chamfer": test_cds}


def join_data_parallel(opt):
    """(device, rank, whether this call made the process group). With
    ``--data_parallel`` this rank's device and rank in the ``torchrun``
    group (a ``ValueError`` without one); else the resolved ``--device``,
    rank 0 and no group."""
    from tpugan_tpu_torch import resolve_device

    if not opt.data_parallel:
        return resolve_device(opt.device), 0, False
    from tpugan_tpu_torch.parallel import mesh

    made = not mesh.is_distributed()
    mesh.initialize_distributed(device=opt.device)
    if not mesh.is_distributed():
        raise ValueError("--data_parallel runs over a torch.distributed "
                         "process group: launch with torchrun "
                         "--nproc_per_node N -m <this CLI> --data_parallel")
    return mesh.rank_device(opt.device), mesh.rank(), made


def leave_data_parallel(made: bool) -> None:
    """Destroy the process group :func:`join_data_parallel` made."""
    if made:
        import torch.distributed as dist

        dist.destroy_process_group()


def local_rows(opt, batch: dict) -> dict:
    """This rank's rows of a frame-major global batch with
    ``--data_parallel``, else the batch."""
    if not opt.data_parallel:
        return batch
    from tpugan_tpu_torch.parallel.mesh import batch_sharded

    return {k: np.ascontiguousarray(v) for k, v in batch_sharded(batch).items()}


def rank0_first(rank: int, make: Callable[[], None]) -> None:
    """``make()`` on rank 0, then every rank waits for it (data on a
    shared disk written once)."""
    if rank == 0:
        make()
    from tpugan_tpu_torch.parallel.mesh import is_distributed

    if is_distributed():
        import torch.distributed as dist

        dist.barrier()


class _NoWriter:
    """The metric writer of ranks other than 0."""

    def add(self, step, metrics) -> None:
        pass

    def close(self) -> None:
        pass


def rank0_writer(rank: int, log_dir: str):
    """Rank 0's metric writer; the other ranks write nothing."""
    from tpugan_tpu_torch.utils.logging import MetricWriter

    return MetricWriter(log_dir) if rank == 0 else _NoWriter()


def print_network_sizes(state, say=print) -> None:
    """The three networks' parameter totals, as the JAX train CLIs print
    them."""
    from tpugan_tpu_torch.train.state import param_count

    say("Building network")
    for name, net in (("sr_net", state.sr), ("tempo_dis", state.tempo),
                      ("spatial_dis", state.spatial)):
        say(f"Total trainable parameters ({name}): "
            f"{param_count(net.module)}")


def _profiler(torch):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def _write_profile(torch, prof, log_dir):
    """Stop ``prof`` and write its Chrome trace; returns None."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    out = os.path.join(log_dir, "profile")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, "steps_10_15.json"))
    print(f"profiler trace written to {out}")
    return None


def _features(lowres_pos, lowres_vel, cfg):
    from tpugan_tpu_torch import DT

    if cfg.use_vel and cfg.in_node_feats == 6:
        return np.concatenate([lowres_pos, lowres_vel * DT], -1)
    return lowres_pos


def _test_eval(model, test_batches, cfg, opt, n_iter, dev, n_batches=4):
    """Serving forward over held-out test batches (reference
    train_tempo.py:259-297): the mean per-point Chamfer distance between
    the hard-masked prediction and the high-res ground truth; with
    ``--dump_visualization`` the first item of each batch is saved."""
    import torch

    from tpugan_tpu_torch.ops.metrics import chamfer

    tensor = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    cds = []
    sample_dir = os.path.join(opt.log_dir, "samples")
    for j in range(n_batches):
        batch = next(test_batches)
        lowres = batch["lowres_pos"][1]
        feature = _features(lowres, batch["lowres_vel"][1], cfg)
        with torch.no_grad():
            _, _, padded, valid = model(tensor(feature), tensor(lowres))
            highres = tensor(batch["highres_pos"][1])
            cd = chamfer(padded, highres, a_valid=valid)
            denom = valid.sum(-1) + highres.shape[1]
            cds.append(float((cd / denom).mean()))
        if opt.dump_visualization:
            os.makedirs(sample_dir, exist_ok=True)
            pred = padded[0][valid[0]].cpu().numpy()
            for name, cloud in (("gt", batch["highres_pos"][1][0]),
                                ("input", lowres[0]), ("pred", pred)):
                np.save(os.path.join(sample_dir,
                                     f"test_{name}_iter{n_iter}_{j}.npy"), cloud)
    return float(np.mean(cds))


def _dump_samples(model, batch, cfg, opt, n_iter, dev):
    """Serving-forward sample dumps of a train batch's first item (reference
    train_tempo.py:259-297): ground truth, input and prediction as .npy and
    rendered to PNG where matplotlib imports."""
    import torch

    from tpugan_tpu_torch.data.sampling import (dump_pointcloud_visualization,
                                                farthest_point_sampling)

    sample_dir = os.path.join(opt.log_dir, "samples")
    os.makedirs(sample_dir, exist_ok=True)
    if "lowres_pos" in batch:
        lowres = batch["lowres_pos"][1][:1]
        lowres_vel = batch["lowres_vel"][1][:1]
    else:
        # device-sampled batches carry no lowres: the loader's downsample
        n_low = int(batch["highres_pos"].shape[2] * cfg.fps_ratio)
        idx, _ = farthest_point_sampling(batch["highres_pos"][1][0], n_low,
                                         rng=np.random.default_rng(n_iter))
        lowres = batch["highres_pos"][1][:1, idx]
        lowres_vel = batch["highres_vel"][1][:1, idx]
    feature = _features(lowres, lowres_vel, cfg)
    tensor = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    with torch.no_grad():
        _, _, padded, valid = model(tensor(feature), tensor(lowres))
    pred = padded[0][valid[0]].cpu().numpy()
    for name, cloud in (("gt", batch["highres_pos"][1][0]),
                        ("input", lowres[0]), ("pred", pred)):
        np.save(os.path.join(sample_dir, f"{name}_iter{n_iter}.npy"), cloud)
        dump_pointcloud_visualization(
            cloud, os.path.join(sample_dir, f"{name}_iter{n_iter}.png"))


if __name__ == "__main__":
    main()
