"""Sequence rollout CLI (``tpugan_tpu/cli/rollout.py``): every frame of a
sequence upsampled with the 25-frame mask-history context, the wall-clock
frames per second, and the outputs written as ``pred_{i}.npy`` (and
``pred_{i}.bgeo`` with ``--export_bgeo``).

    python -m tpugan_tpu_torch.cli.rollout --ckpt checkpoints/fluid_vel_20k.ckpt \\
        --use_vel --in_node_feats 6 --synthetic_particles 10240   # the card
    python -m tpugan_tpu_torch.cli.rollout ... --device cpu        # plain

Frames are ``data_{i}.npz`` files (pos, vel) of ``--data_dir``, in the
order of the digits in their names; with ``--synthetic`` or no
``--data_dir`` a synthetic sequence (seed 3, ``--synthetic_particles``
points, 24 frames unless ``--num_frames``). A uniform-size sequence runs
the device-resident rollout (one copy to the device per ``--chunk``
frames) unless ``--host_pipeline``; a ragged one the per-frame loop.
``--approx_graph`` turns the approximate bf16 graph kNN on for the rollout
(it reaches the kernel from 4,096 input points on).

``--shard_points`` shards every frame's points over the ranks of a
``torchrun`` launch (a uniform-size sequence only;
``parallel/sharded_serving.py``): each rank runs its rows on its own card
(``cuda:LOCAL_RANK``, or ``--device``), rank 0 gathers the frames and
writes the files. ``--mesh_devices``, when given, must equal the number of
ranks; the backend is NCCL on the card and gloo on the CPU or where the
ranks share a card (``parallel/mesh.py : initialize_distributed``):

    torchrun --nproc_per_node 2 -m tpugan_tpu_torch.cli.rollout \
        --ckpt checkpoints/fluid_vel_20k.ckpt --use_vel --in_node_feats 6 \
        --synthetic_particles 40960 --shard_points
"""

from __future__ import annotations

import argparse
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

Frame = Tuple[np.ndarray, Optional[np.ndarray]]


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="TPU-GAN sequence rollout")
    p.add_argument("--data_dir", type=str, default=None,
                   help="directory with data_{i}.npz frames")
    p.add_argument("--ckpt", type=str, default=None,
                   help="checkpoint file/dir (without one: random weights "
                        "from a torch.Generator seeded 0, which do not "
                        "reproduce the JAX CLI's flax init)")
    p.add_argument("--out_dir", type=str, default="./rollout_out")
    p.add_argument("--num_frames", type=int, default=None)
    p.add_argument("--use_vel", action="store_true")
    p.add_argument("--in_node_feats", type=int, default=3)
    p.add_argument("--node_embedding", type=int, default=128)
    p.add_argument("--upsample_ratio", type=int, default=8)
    p.add_argument("--export_bgeo", action="store_true")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic_particles", type=int, default=4096)
    p.add_argument("--compute_dtype", choices=["f32", "bf16"], default="f32",
                   help="bf16 runs the generator's inner convs/gathers in "
                        "bfloat16 (f32 params and outputs)")
    p.add_argument("--graph_mode", choices=["dynamic", "static"],
                   default="dynamic",
                   help="static reuses ONE k=20 input-space kNN graph in "
                        "every layer (serving approximation)")
    p.add_argument("--host_pipeline", action="store_true",
                   help="force the per-frame host loop; by default "
                        "uniform-size sequences run the chunked "
                        "device-resident rollout")
    p.add_argument("--chunk", type=int, default=100,
                   help="frames per device chunk in the device rollout")
    p.add_argument("--approx_graph", action="store_true",
                   help="allow the approximate bf16 graph-kNN kernel "
                        "(default: exact)")
    p.add_argument("--shard_points", action="store_true",
                   help="shard each frame's points over the ranks of a "
                        "torchrun launch (uniform-N sequences)")
    p.add_argument("--mesh_devices", type=int, default=None,
                   help="ranks to shard over: must equal the number "
                        "torchrun started (default: all of them)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card)")
    return p


def load_frames(opt) -> List[Frame]:
    """The sequence's (pos, vel) frames: ``--data_dir``'s npz files or the
    synthetic sequence."""
    if opt.synthetic or opt.data_dir is None:
        from tpugan_tpu_torch.data.synthetic import synthetic_fluid_sequence

        return list(synthetic_fluid_sequence(
            seed=3, num_particles=opt.synthetic_particles,
            num_frames=opt.num_frames or 24))
    names = sorted(
        (f for f in os.listdir(opt.data_dir) if f.endswith(".npz")),
        key=lambda s: int("".join(c for c in s if c.isdigit()) or 0))
    if opt.num_frames:
        names = names[: opt.num_frames]
    frames = []
    for name in names:
        with np.load(os.path.join(opt.data_dir, name)) as z:
            frames.append((z["pos"], z.get("vel")))
    return frames


def build_model(opt, device):
    """(SRNet of the flags, checkpoint path or None). A checkpoint whose
    widths disagree with the flags raises (``cli/eval_fluid.py``)."""
    import torch

    from tpugan_tpu_torch.cli.eval_fluid import generator_for_flags

    compute_dtype = torch.bfloat16 if opt.compute_dtype == "bf16" else None
    return generator_for_flags(opt, device, compute_dtype, opt.graph_mode,
                               seed=0)


def join_ranks(opt):
    """With ``--shard_points``: join the ranks' process group (refusing
    ``--mesh_devices`` other than its size) and return (this rank's
    device, rank, whether this call made the group); else None."""
    if not opt.shard_points:
        if opt.mesh_devices is not None:
            raise SystemExit("--mesh_devices shards frames: it needs "
                             "--shard_points")
        return None
    from tpugan_tpu_torch.parallel import mesh

    made = not mesh.is_distributed()
    world = mesh.initialize_distributed(device=opt.device)
    if opt.mesh_devices is not None and opt.mesh_devices != world:
        raise SystemExit(
            f"--mesh_devices {opt.mesh_devices}, but {world} rank(s) run: "
            f"launch with torchrun --nproc_per_node {opt.mesh_devices}")
    if not mesh.is_distributed():
        raise SystemExit("--shard_points runs over a torch.distributed "
                         "process group: launch with torchrun "
                         "--nproc_per_node N -m tpugan_tpu_torch.cli.rollout")
    return mesh.rank_device(opt.device), mesh.rank(), made


def run_rollout(model, frames: List[Frame], opt) -> List[np.ndarray]:
    """The CLI's dispatch: the point-sharded rollout with
    ``--shard_points`` (rank 0 returns the frames, the others nothing), the
    device-resident rollout for a uniform-size sequence (unless
    ``--host_pipeline``), else the per-frame loop, with the approximate
    graph kNN as ``--approx_graph`` says (restored after)."""
    from tpugan_tpu_torch.eval.rollout import (rollout_sequence,
                                               rollout_sequence_device)
    from tpugan_tpu_torch.ops import neighbors

    uniform = len({p.shape[0] for p, _ in frames}) == 1
    if opt.shard_points and not uniform:
        raise SystemExit("--shard_points needs a uniform-N sequence")
    prev = neighbors.APPROX_GRAPH_KNN
    neighbors.set_approx_graph_knn(opt.approx_graph)
    try:
        if opt.shard_points:
            from tpugan_tpu_torch.parallel.sharded_serving import (
                rollout_sequence_sharded)

            pos_seq = np.stack([p for p, _ in frames])
            vel_seq = (np.stack([v for _, v in frames])
                       if frames[0][1] is not None else None)
            return rollout_sequence_sharded(model, pos_seq, vel_seq,
                                            use_vel=opt.use_vel)
        if uniform and not opt.host_pipeline:
            pos_seq = np.stack([p for p, _ in frames])
            vel_seq = (np.stack([v for _, v in frames])
                       if frames[0][1] is not None else None)
            return rollout_sequence_device(
                model, pos_seq, vel_seq, use_vel=opt.use_vel,
                chunk=min(opt.chunk, len(frames)))
        return rollout_sequence(model, frames, use_vel=opt.use_vel)
    finally:
        neighbors.set_approx_graph_knn(prev)


def write_outputs(outputs: List[np.ndarray], out_dir: str,
                  export_bgeo: bool) -> None:
    """``pred_{i}.npy`` (and ``pred_{i}.bgeo``) of each frame, on 8 writer
    threads (the writes are disk-bound); a failed write raises."""
    from tpugan_tpu_torch.data.bgeo import write_bgeo

    def _write(i, pts):
        np.save(os.path.join(out_dir, f"pred_{i}.npy"), pts)
        if export_bgeo:
            write_bgeo(os.path.join(out_dir, f"pred_{i}.bgeo"), pts)

    with ThreadPoolExecutor(max_workers=8) as pool:
        for done in [pool.submit(_write, i, pts)
                     for i, pts in enumerate(outputs)]:
            done.result()


def main(argv=None) -> dict:
    """Run the CLI on ``argv``; returns the frame count, the rollout's
    seconds and frames per second, the device it ran on and the rank
    (0 without ``--shard_points``)."""
    from tpugan_tpu_torch import device_name, resolve_device

    opt = parser().parse_args(argv)
    ranks = join_ranks(opt)
    dev, rank, made = ranks if ranks else (resolve_device(opt.device), 0,
                                           False)
    try:
        model, path = build_model(opt, dev)
        if path and rank == 0:
            print(f"restored generator from {path}")
        frames = load_frames(opt)

        os.makedirs(opt.out_dir, exist_ok=True)
        t0 = time.time()
        outputs = run_rollout(model, frames, opt)  # ends with the copy back
        used = time.time() - t0
    finally:
        if made:
            import torch.distributed as dist

            dist.destroy_process_group()
    name = device_name(dev)
    if rank == 0:
        print(f"Used: {used:.2f}s for {len(frames)} frames "
              f"({len(frames) / used:.2f} frames/s) on {name}")
        write_outputs(outputs, opt.out_dir, opt.export_bgeo)
        print(f"wrote {len(outputs)} frames to {opt.out_dir}")
    return {"frames": len(frames), "seconds": used,
            "frames_per_s": len(frames) / used, "device": name, "rank": rank}


if __name__ == "__main__":
    main()
