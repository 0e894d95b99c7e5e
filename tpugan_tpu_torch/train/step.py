"""The fluid GAN train step (``tpugan_tpu/train/step.py :
make_fluid_gan_step``, sequential-critic path) and its helpers.

One step, in order:

* the low-res inputs: with ``device_sampling``, FPS of each item's centre
  frame (the same indices for all three frames) from a random start, plus
  N(0, jitter) on the low-res positions; else the batch's own
  ``lowres_pos`` / ``lowres_vel`` (the loader's FPS and jitter);
* the generator's three frames as one [3B] batch (``train=True``; the
  generator has no batch statistics, so stacking is exact), the Chamfer +
  masking loss on the centre frame;
* when the masking loss is under ``ml_gate``: the spatial critic on the
  shuffled hard-masked centre frame, the SPH velocity transfer (``interp``
  "dense": the dense interp kernel; "capped": the reference's 32 nearest
  within the cutoff; no gradient; without ``use_vel`` no transfer: the
  temporal critic sees its positions only) and the temporal critic on the
  three frames, both critics in train mode (their BatchNorm and
  spectral-norm state moves, their parameters do not), LSGAN generator
  losses;
* the generator's Adam update;
* on even iterations with the gate open, unless ``freeze_D``: the temporal
  and then the spatial critic's update on (fake, real), with random
  rotations (p = 0.3).

Every random number of a step comes from one :class:`StepDraws`: drawn from
a ``torch.Generator`` by default, or given (a test rebuilds the JAX step's
draws and hands them over). The step's only host synchronisations are the
gate and the per-step metrics.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import torch

from tpugan_tpu_torch import DT
from tpugan_tpu_torch.losses.gan import (lsgan_discriminator_loss,
                                         lsgan_generator_loss, lsgan_labels)
from tpugan_tpu_torch.losses.geometry import tpugan_sr_loss
from tpugan_tpu_torch.models.discriminator import (dropout_multipliers,
                                                   dropout_widths)
from tpugan_tpu_torch.ops.interpolate import (cubic_interpolation,
                                              cubic_interpolation_dense)
from tpugan_tpu_torch.ops.neighbors import fps
from tpugan_tpu_torch.train.state import GanTrainState


@dataclasses.dataclass
class FluidTrainConfig:
    """The train step's settings (``tpugan_tpu/config.py :
    FluidTrainConfig``, the fields the step and :func:`init_fluid_state`
    read); the defaults are the ``train_vel`` preset with device sampling:
    generator inputs of positions and velocity * DT (``use_vel``,
    ``in_node_feats`` 6), the critics on advection features. The step
    takes the networks as the trainer state holds them; ``init_fluid_state``
    builds them from the widths here."""

    lr: float = 3e-4
    lr_decay_steps: int = 10000
    lr_decay_rate: float = 0.7
    dis_lr_factor: float = 0.33
    upsample_ratio: int = 8
    R: float = 0.10
    batch_size: int = 4
    patch_size: int = 9216
    fps_ratio: float = 0.125
    jitter: float = 0.003
    w: float = 0.5
    cutoff: float = 0.025
    masking_w: float = 100.0
    ml_gate: float = 0.1
    in_node_feats: int = 6
    node_embedding: int = 128
    use_vel: bool = True
    interp: str = "dense"            # velocity transfer: "dense" or "capped"
    device_sampling: bool = True
    freeze_D: bool = False

    @property
    def lowres_size(self) -> int:
        return int(self.patch_size * self.fps_ratio)


# ---------------------------------------------------------------- rotations

def rotation_matrix(angles: torch.Tensor) -> torch.Tensor:
    """Rz @ Ry @ Rx of Euler angles [..., 3] -> [..., 3, 3]."""
    c, s = torch.cos(angles), torch.sin(angles)
    one, zero = torch.ones_like(c[..., 0]), torch.zeros_like(c[..., 0])
    rx = torch.stack([one, zero, zero, zero, c[..., 0], -s[..., 0],
                      zero, s[..., 0], c[..., 0]], -1)
    ry = torch.stack([c[..., 1], zero, s[..., 1], zero, one, zero,
                      -s[..., 1], zero, c[..., 1]], -1)
    rz = torch.stack([c[..., 2], -s[..., 2], zero, s[..., 2], c[..., 2], zero,
                      zero, zero, one], -1)
    shape = angles.shape[:-1] + (3, 3)
    return rz.reshape(shape) @ ry.reshape(shape) @ rx.reshape(shape)


def rotate_frames(pos: torch.Tensor, rots: torch.Tensor) -> torch.Tensor:
    """[F, B, N, 3] x per-frame [F, 3, 3] -> [F, B, N, 3] (row vectors)."""
    return torch.einsum("fbnd,fde->fbne", pos, rots)


def rotate_items(pos: torch.Tensor, rots: torch.Tensor) -> torch.Tensor:
    """[B, N, 3] x per-item [B, 3, 3] -> [B, N, 3]."""
    return torch.einsum("bnd,bde->bne", pos, rots)


# ---------------------------------------------------------------- draws

@dataclasses.dataclass
class StepDraws:
    """Every random number of one step.

    labels: (valid, invalid) LSGAN labels; sp_perm / p0 / p2: point
    permutations [nr] of the spatial critic's frame and the side frames;
    sp_target / tp_target: the generator's LSGAN targets; do_rot / do_rot_s:
    whether the critics' updates rotate; rots_fake / rots_true: per-frame
    rotations [3, 3, 3] of the temporal update; rots0 / rots1: per-item
    rotations [B, 3, 3] of the spatial update's real / fake clouds;
    fps_start [B] and jitter [3, B, n, 3]: device sampling; keep: dropout
    multipliers by critic call ("spatial_g", "tempo_g", "tempo_fake",
    "tempo_real", "spatial_fake", "spatial_real"), one list each (see
    ``FCHead``; all ones turn dropout off).
    """

    labels: tuple
    sp_perm: torch.Tensor
    sp_target: float
    p0: torch.Tensor
    p2: torch.Tensor
    tp_target: float
    do_rot: bool
    rots_fake: torch.Tensor
    rots_true: torch.Tensor
    do_rot_s: bool
    rots0: torch.Tensor
    rots1: torch.Tensor
    fps_start: torch.Tensor
    jitter: torch.Tensor
    keep: Dict[str, List[torch.Tensor]]

    CALLS = ("spatial_g", "tempo_g", "tempo_fake", "tempo_real",
             "spatial_fake", "spatial_real")

    @classmethod
    def draw(cls, gen: torch.Generator, cfg: FluidTrainConfig, m: int,
             keep_widths: List[int], p_drop: float = 0.2) -> "StepDraws":
        """Draws on the CPU from ``gen`` for a batch of ``cfg.batch_size``
        items of ``m`` high-res points."""
        b, n = cfg.batch_size, cfg.lowres_size
        nr = n * cfg.upsample_ratio
        u = lambda *s: torch.rand(s, generator=gen)
        angles = lambda k: u(k, 3) * (2 * math.pi)
        return cls(
            labels=lsgan_labels(gen),
            sp_perm=torch.randperm(nr, generator=gen),
            sp_target=float(0.8 + 0.4 * u(1)),
            p0=torch.randperm(nr, generator=gen),
            p2=torch.randperm(nr, generator=gen),
            tp_target=float(0.8 + 0.4 * u(1)),
            do_rot=bool(u(1) > 0.7),
            rots_fake=rotation_matrix(angles(3)),
            rots_true=rotation_matrix(angles(3)),
            do_rot_s=bool(u(1) > 0.7),
            rots0=rotation_matrix(angles(b)),
            rots1=rotation_matrix(angles(b)),
            fps_start=torch.randint(0, m, (b,), generator=gen),
            jitter=torch.randn(3, b, n, 3, generator=gen),
            keep=cls._keep(gen, b, keep_widths, p_drop))

    @classmethod
    def _keep(cls, gen, b, widths, p_drop):
        """Dropout multipliers by critic call. The critic updates share
        theirs as the JAX step shares its dropout keys: the temporal and
        spatial fake calls one, the two real calls another."""
        keep = {c: [dropout_multipliers((b, w), p_drop, gen) for w in widths]
                for c in ("spatial_g", "tempo_g", "tempo_fake", "tempo_real")}
        keep["spatial_fake"] = keep["tempo_fake"]
        keep["spatial_real"] = keep["tempo_real"]
        return keep

    def to(self, device) -> "StepDraws":
        moved = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        for k, v in moved.items():
            if isinstance(v, torch.Tensor):
                moved[k] = v.to(device)
        moved["keep"] = {c: [m.to(device) for m in ms]
                         for c, ms in self.keep.items()}
        return StepDraws(**moved)


# ---------------------------------------------------------------- helpers

def device_sample_lowres(highres_pos: torch.Tensor, highres_vel: torch.Tensor,
                         n_low: int, jitter: float, start: torch.Tensor,
                         noise: torch.Tensor):
    """FPS of the centre frame from ``start`` [B] (the same indices for
    every frame: particle identity is shared), gather, then
    ``jitter * noise`` on the low-res positions. [F, B, M, 3] ->
    ([F, B, n, 3], [F, B, n, 3])."""
    idx = fps(highres_pos[1], n_low, start=start)             # [B, n]
    f = highres_pos.shape[0]
    take = lambda a: torch.gather(
        a, 2, idx[None, :, :, None].expand(f, -1, -1, 3))
    lowres_pos, lowres_vel = take(highres_pos), take(highres_vel)
    if jitter:
        lowres_pos = lowres_pos + jitter * noise
    return lowres_pos, lowres_vel


def interpolate_vel_lst(pred_pos_frames: torch.Tensor,
                        gt_pos_frames: torch.Tensor,
                        gt_vel_frames: torch.Tensor, cutoff: float,
                        mode: str = "dense"):
    """Ground-truth advection (vel * DT) and its SPH transfer onto the
    predicted particles, per frame, over the [F*B] rows in one call: the
    dense-interp kernel (``mode="dense"``, every in-cutoff neighbour) or
    the capped form (``"capped"``, the 32 nearest within the cutoff); no
    gradient. Returns (gt_adv, pred_adv)."""
    if mode not in ("dense", "capped"):
        raise ValueError(f"interp mode {mode!r}")
    f, b = pred_pos_frames.shape[:2]
    gt_adv = gt_vel_frames * DT
    flat = lambda a: a.reshape((f * b,) + a.shape[2:])
    interp = (cubic_interpolation_dense if mode == "dense"
              else lambda q, fld, p, c: cubic_interpolation(q, fld, p, c, k=32))
    with torch.no_grad():
        pred_adv = interp(flat(pred_pos_frames.detach()), flat(gt_adv),
                          flat(gt_pos_frames), cutoff)
    return gt_adv, pred_adv.reshape(pred_pos_frames.shape)


def _frames(feat: Optional[torch.Tensor]) -> Optional[List[torch.Tensor]]:
    """[F, B, N, 3] advection features as the temporal critic's per-frame
    list; None (no ``use_vel``): the critic takes the positions instead."""
    return None if feat is None else list(feat)


# ---------------------------------------------------------------- the step

class FluidGanStep:
    """``step(state, batch, draws=None, mark=None)`` runs one train step in
    place on ``state`` (:class:`GanTrainState`) and returns its metrics as
    floats. ``batch`` holds ``highres_pos`` / ``highres_vel`` [3, B, M, 3]
    on the networks' device; ``draws`` defaults to
    ``StepDraws.draw(generator)``. ``mark``, when given, is called with
    "generator" after the generator's update and "critics" after the
    critics' (a timer's hook)."""

    def __init__(self, cfg: FluidTrainConfig,
                 generator: Optional[torch.Generator] = None):
        self.cfg = cfg
        self.generator = generator or torch.Generator().manual_seed(0)

    def __call__(self, state: GanTrainState, batch: Dict[str, torch.Tensor],
                 draws: Optional[StepDraws] = None,
                 mark: Optional[Callable[[str], None]] = None
                 ) -> Dict[str, float]:
        cfg = self.cfg
        sr, tempo, spatial = (state.sr.module, state.tempo.module,
                              state.spatial.module)
        dev = next(sr.parameters()).device
        highres_pos, highres_vel = batch["highres_pos"], batch["highres_vel"]
        f, b, m = highres_pos.shape[:3]
        if draws is None:
            draws = StepDraws.draw(self.generator, cfg, m,
                                   dropout_widths(spatial))
        draws = draws.to(dev)
        cur_iter = state.n_iter + 1
        valid_lbl, invalid_lbl = draws.labels
        radius = cfg.cutoff               # furthest distance is pinned to 1
        n = cfg.lowres_size

        if cfg.device_sampling and "lowres_pos" not in batch:
            lowres_pos, lowres_vel = device_sample_lowres(
                highres_pos, highres_vel, n, cfg.jitter, draws.fps_start,
                draws.jitter)
        else:
            lowres_pos, lowres_vel = batch["lowres_pos"], batch["lowres_vel"]
        if cfg.use_vel and cfg.in_node_feats == 6:
            feats = torch.cat([lowres_pos, lowres_vel * DT], -1)
        else:
            feats = lowres_pos

        # ----- generator update
        out = sr(feats.reshape((f * b,) + feats.shape[2:]),
                 lowres_pos.reshape((f * b,) + lowres_pos.shape[2:]),
                 train=True)
        expanded, mask, padded, valid = (t.reshape((f, b) + t.shape[1:])
                                         for t in out)
        position_loss, cd, ml = tpugan_sr_loss(
            cfg.masking_w, highres_pos[1], expanded[1], lowres_pos[1], mask[1],
            radius, cur_iter)
        gate = bool(ml < cfg.ml_gate)
        zero = torch.zeros((), device=dev)
        tempo_loss = spatial_loss = zero
        if gate:
            sp_fake = spatial(padded[1][:, draws.sp_perm],
                              valid[1][:, draws.sp_perm], train=True,
                              keep=draws.keep["spatial_g"])
            spatial_loss = lsgan_generator_loss(sp_fake, draws.sp_target)
            pred_seq = torch.stack([padded[0][:, draws.p0], padded[1],
                                    padded[2][:, draws.p2]])
            pred_valid = torch.stack([valid[0][:, draws.p0], valid[1],
                                      valid[2][:, draws.p2]])
            if cfg.use_vel:
                gt_adv, pred_adv = interpolate_vel_lst(
                    pred_seq, highres_pos, highres_vel, 1.6 * cfg.R,
                    cfg.interp)
            else:
                gt_adv = pred_adv = None
            tp_fake = tempo(list(pred_seq), cfg.R, feat_lst=_frames(pred_adv),
                            valid_lst=list(pred_valid), train=True,
                            keep=draws.keep["tempo_g"])
            tempo_loss = lsgan_generator_loss(tp_fake, draws.tp_target)
        sr_loss = tempo_loss + spatial_loss + cfg.w * position_loss
        state.sr.opt.step(state.sr.grads(sr_loss))
        if mark is not None:
            mark("generator")

        # ----- critic updates (every 2nd iteration, gated)
        t_loss = s_loss = zero
        if cur_iter % 2 == 0 and gate and not cfg.freeze_D:
            pred_seq = pred_seq.detach()
            # the reference's spatial update reuses the side-frame loop's
            # variable: the LAST frame's unshuffled prediction
            padded_last, last_valid = padded[2].detach(), valid[2]
            fake_pos, true_pos = pred_seq, highres_pos
            fake_feat, true_feat = pred_adv, gt_adv
            if draws.do_rot:
                fake_pos = rotate_frames(pred_seq, draws.rots_fake)
                true_pos = rotate_frames(highres_pos, draws.rots_true)
                if cfg.use_vel:
                    fake_feat = rotate_frames(pred_adv, draws.rots_fake)
                    true_feat = rotate_frames(gt_adv, draws.rots_true)
            fake = tempo(list(fake_pos), cfg.R, feat_lst=_frames(fake_feat),
                         valid_lst=list(pred_valid), train=True,
                         keep=draws.keep["tempo_fake"])
            true = tempo(list(true_pos), cfg.R, feat_lst=_frames(true_feat),
                         valid_lst=None, train=True,
                         keep=draws.keep["tempo_real"])
            t_loss = lsgan_discriminator_loss(true, fake, valid_lbl,
                                              invalid_lbl)
            state.tempo.opt.step(state.tempo.grads(t_loss))

            true_center, fake_cloud = highres_pos[1], padded_last
            if draws.do_rot_s:
                true_center = rotate_items(true_center, draws.rots0)
                fake_cloud = rotate_items(fake_cloud, draws.rots1)
            fake = spatial(fake_cloud, last_valid, train=True,
                           keep=draws.keep["spatial_fake"])
            true = spatial(true_center, None, train=True,
                           keep=draws.keep["spatial_real"])
            s_loss = lsgan_discriminator_loss(true, fake, valid_lbl,
                                              invalid_lbl)
            state.spatial.opt.step(state.spatial.grads(s_loss))

        if mark is not None:
            mark("critics")
        state.n_iter = cur_iter
        return {"tempo_G_loss": float(tempo_loss.detach()),
                "tempo_D_loss": float(t_loss.detach()),
                "Chamfer_distance_no_norm": float(cd.detach()),
                "masking_loss": float(ml.detach()),
                "spatial_G_loss": float(spatial_loss.detach()),
                "spatial_D_loss": float(s_loss.detach()), "gate": gate}
