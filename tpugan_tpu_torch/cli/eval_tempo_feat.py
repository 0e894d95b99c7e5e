"""Feature-transfer evaluation of a trained temporal critic (the port's twin
of ``tpugan_tpu/cli/eval_tempo_feat.py``): the critic's ``tower.sa1``,
``tower.sa2`` and ``tower.flow_module`` weights go into an ActionCls
classifier and are frozen (unless ``--no_freeze``); the SA pooling and the
head train with NLL on log-softmax; each epoch ends with per-video
probability accumulation over the test split.

    python -m tpugan_tpu_torch.cli.eval_tempo_feat --synthetic \\
        --ckpt_path checkpoints/action_tempo_20k.ckpt --epochs 2   # the card
    python -m tpugan_tpu_torch.cli.eval_tempo_feat ... --device cpu  # plain

Frozen parameters take no Adam update, but their BatchNorms still move
their running moments in train mode, as the JAX step keeps every
``batch_stats`` mutable. Dropout masks come from a ``torch.Generator``
seeded with ``--seed``. Training runs the plain grouped stacks; inference
(``ActionCls.infer``) runs the fused pooled-MLP kernel in every SetConv.
"""

from __future__ import annotations

import argparse
import os
import time
from collections import defaultdict

import numpy as np
import torch

from tpugan_tpu_torch import resolve_device
from tpugan_tpu_torch.config import parse_with_preset
from tpugan_tpu_torch.models.discriminator import TRANSFERRED


def get_arguments(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Eval temporal-D features")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--batch_size", type=int, default=24)
    p.add_argument("--data_dir", type=str, default="./MSR-Action3D")
    p.add_argument("--ckpt_path", type=str, default=None,
                   help="trained action GAN checkpoint (random features if "
                        "omitted)")
    p.add_argument("--log_dir", type=str, default="./eval_dis")
    p.add_argument("--cutoff", type=float, default=2.0)
    p.add_argument("--frames_per_clip", type=int, default=3)
    p.add_argument("--num_points", type=int, default=2048)
    p.add_argument("--no_freeze", action="store_true",
                   help="train the whole classifier, tower included (the "
                        "supervised ceiling the frozen arms are read "
                        "against)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic_videos", type=int, default=8)
    p.add_argument("--synthetic_classes", type=int, default=3)
    p.add_argument("--synthetic_frames", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card)")
    return parse_with_preset(p, "eval_tempo_feat", argv)


def build_classifier(frames: int, num_classes: int, ckpt_path, device,
                     freeze: bool, seed: int = 0):
    """ActionCls (weights from ``seed``), its tower's sa1, sa2 and flow
    module transferred from the checkpoint's temporal critic when given,
    and those frozen with ``freeze``: (model, {name: trainable
    parameter})."""
    from tpugan_tpu_torch.checkpoint import load_action_tempo_dis
    from tpugan_tpu_torch.models.discriminator import (
        ActionCls, transfer_feature_extractor)

    cls = ActionCls(frames, num_classes=num_classes,
                    generator=torch.Generator().manual_seed(seed),
                    device=device)
    if ckpt_path:
        transfer_feature_extractor(cls, load_action_tempo_dis(ckpt_path,
                                                              device=device))
        print("initialized feature extractor from", ckpt_path, flush=True)
    trainable = {}
    for name, p in cls.named_parameters():
        frozen = freeze and name.startswith(TRANSFERRED)
        p.requires_grad_(not frozen)
        if not frozen:
            trainable[name] = p
    return cls, trainable


def nll_and_accuracy(logits: torch.Tensor, labels: torch.Tensor):
    """(mean NLL of the log-softmax at the labels, share of argmax hits)."""
    logp = torch.log_softmax(logits, -1)
    nll = -logp.gather(1, labels[:, None]).mean()
    return nll, (logits.argmax(-1) == labels).float().mean()


def train_step(cls, opt, pos, labels, cutoff, generator=None, keep=None):
    """One step of the head: forward in train mode (every BatchNorm moves
    its running moments), NLL, gradients of the trainable parameters,
    Adam. pos [F, B, N, 3]; dropout multipliers ``keep`` (one per dropout
    layer) or drawn from ``generator``. Returns (nll, accuracy) tensors."""
    logits = cls([pos[i] for i in range(pos.shape[0])], cutoff, train=True,
                 keep=keep, generator=generator)
    nll, acc = nll_and_accuracy(logits, labels)
    grads = torch.autograd.grad(nll, list(opt.params.values()),
                                allow_unused=True)
    opt.step(dict(zip(opt.params, grads)))
    return nll.detach(), acc


def main(argv=None) -> dict:
    from tpugan_tpu_torch.data.msr import (MSRAction3DDataset,
                                           action_batch_iterator)
    from tpugan_tpu_torch.data.synthetic import make_synthetic_action_dataset
    from tpugan_tpu_torch.train.state import Adam
    from tpugan_tpu_torch.utils.logging import MetricWriter

    opt = get_arguments(argv)
    device = resolve_device(opt.device)
    data_dir = opt.data_dir
    if opt.synthetic:
        data_dir = make_synthetic_action_dataset(
            os.path.join(opt.log_dir, "synthetic_msr"),
            num_videos=opt.synthetic_videos, frames=opt.synthetic_frames,
            points=3000, num_classes=opt.synthetic_classes, seed=opt.seed)
    kw = dict(frames_per_clip=opt.frames_per_clip, num_points=opt.num_points,
              return_lowres=False, seed=opt.seed)
    train_ds = MSRAction3DDataset(data_dir, train=True, **kw)
    test_ds = MSRAction3DDataset(data_dir, train=False, **kw)
    num_classes = max(train_ds.num_classes, 20)
    print(f"{len(train_ds)} train clips / {len(test_ds)} test clips, "
          f"{num_classes} classes", flush=True)

    cls, trainable = build_classifier(opt.frames_per_clip, num_classes,
                                      opt.ckpt_path, device,
                                      not opt.no_freeze, opt.seed)
    print(f"Total parameters: {sum(p.numel() for p in cls.parameters())}",
          flush=True)
    # plain Adam (a staircase that never decays)
    adam = Adam(trainable, opt.lr, decay_steps=1, decay_rate=1.0)
    drop = torch.Generator().manual_seed(opt.seed + 7)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    writer = MetricWriter(opt.log_dir)
    steps_per_epoch = max(1, len(train_ds) // opt.batch_size)
    it = action_batch_iterator(train_ds, opt.batch_size, seed=opt.seed)
    best_acc, epochs, step_s, infer_s = 0.0, [], [], []
    for epoch in range(opt.epochs):
        losses, accs = [], []
        for _ in range(steps_per_epoch):
            batch = next(it)
            pos = torch.from_numpy(batch["highres_pos"]).to(device)
            labels = torch.from_numpy(batch["label"]).long().to(device)
            sync()
            t0 = time.perf_counter()
            loss, acc = train_step(cls, adam, pos, labels, opt.cutoff, drop)
            losses.append(float(loss))
            accs.append(float(acc))
            step_s.append(time.perf_counter() - t0)

        video_prob = defaultdict(lambda: np.zeros(num_classes))
        video_label = {}
        for batch in action_batch_iterator(
                test_ds, min(opt.batch_size, max(1, len(test_ds))),
                shuffle=False, endless=False):
            pos = torch.from_numpy(batch["highres_pos"]).to(device)
            sync()
            t0 = time.perf_counter()
            probs = cls.infer([pos[i] for i in range(pos.shape[0])],
                              opt.cutoff).cpu().numpy()
            infer_s.append(time.perf_counter() - t0)
            for b in range(probs.shape[0]):
                vid = int(batch["video_index"][b])
                video_prob[vid] += probs[b]
                video_label[vid] = int(batch["label"][b])
        correct = sum(int(np.argmax(video_prob[v]) == video_label[v])
                      for v in video_prob)
        video_acc = correct / max(1, len(video_prob))
        best_acc = max(best_acc, video_acc)
        print(f"epoch {epoch}: loss {np.mean(losses):.4f} "
              f"clip-acc {np.mean(accs):.3f} video-acc {video_acc:.3f}",
              flush=True)
        epochs.append({"nll": float(np.mean(losses)),
                       "clip_acc": float(np.mean(accs)),
                       "video_acc": video_acc})
        writer.add(epoch, epochs[-1])
    writer.close()
    print(f"Best video accuracy: {best_acc:.3f}", flush=True)
    return {"epochs": epochs, "best_video_acc": best_acc,
            "train_clips": len(train_ds), "test_clips": len(test_ds),
            "train_step_s": step_s, "infer_batch_s": infer_s}


if __name__ == "__main__":
    main()
