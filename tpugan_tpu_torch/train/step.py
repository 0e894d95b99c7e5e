"""The fluid and the action GAN train steps (``tpugan_tpu/train/step.py :
make_fluid_gan_step`` and ``make_action_gan_step``, with their
sequential-critic and their stacked-critic (``fast_d``) paths) and their
helpers.

One fluid step, in order:

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

With ``fast_d`` (the JAX package's ``fast_d`` contract): the temporal
critic's generator pass stacks its frames (``stack_frames``); each critic
update scores fake and real as one apply on their rows stacked along the
batch axis under ``stat_groups(2)`` (the temporal one with the frames
stacked as well, the real half's valid mask all ones), the scores split at
B. Every batch norm keeps each call's moments, the running averages replay
in the stacked block order (frame-major over fake, real), and each
spectral norm advances once per stacked apply. The padded prediction
bucket must equal the high-res point count.

Every random number of a step comes from one :class:`StepDraws`: drawn from
a ``torch.Generator`` by default, or given (a test rebuilds the JAX step's
draws and hands them over). The step's only host synchronisations are the
gate and the per-step metrics.

The action GAN step (``make_action_gan_step``), :class:`ActionGanStep`,
is not the fluid step with a flag:

* device sampling is one FPS over the flattened [F*B] clip frames, each
  from its own random start (independent per frame), and no jitter;
* the generator (NoMaskSRNet) runs the F frames as one batch, the Chamfer
  loss on the centre frame with the masking loss pinned at 1.0; there is
  no gate, so both critics' generator losses run on every iteration: the
  spatial critic on the shuffled centre frame, the temporal critic on
  every frame shuffled (the centre frame too);
* on even iterations, unless ``freeze_D``: the temporal and then the
  spatial critic's update on (fake, real), with no rotations, the spatial
  update's fake cloud the centre frame under a fresh permutation;
* six dropout draws, one per critic call, at the heads' two rates (with
  ``fast_d`` two more, [2B] rows each, for the stacked updates).

Its random numbers come from an :class:`ActionStepDraws`.

Data parallelism (``data_parallel=True``, the twin of ``_finalize_step`` /
``shard_gan_step``, which GSPMD makes a global-batch step): each rank of a
``torch.distributed`` group takes its contiguous rows of the batch, and
the step on those rows equals the step on the global batch:

* the draws are global, the same on every rank (one generator, one seed),
  and each rank takes its rows of the per-item ones (``rows``);
* every train-mode batch norm pools its moments over the ranks
  (``cross_rank_stats``, at more than one rank; the pooled-MLP kernel
  sums its layers' moment sums over the ranks between its passes, one
  all-reduce a layer each way, as many as the plain stack's);
* the masking-loss gate is decided on the all-reduced mean, so every rank
  takes the same branch;
* each update's gradients are averaged in one flattened all-reduce (every
  loss is a mean over equal shards, so the average is the global mean),
  and the metrics are all-reduced before they leave the step.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, List, Optional

import torch

from tpugan_tpu_torch import DT
from tpugan_tpu_torch.losses.gan import (lsgan_discriminator_loss,
                                         lsgan_generator_loss, lsgan_labels)
from tpugan_tpu_torch.losses.geometry import tpugan_sr_loss
from tpugan_tpu_torch.models.discriminator import (dropout_layers,
                                                   dropout_multipliers,
                                                   dropout_widths)
from tpugan_tpu_torch.nn.layers import cross_rank_stats, stat_groups
from tpugan_tpu_torch.ops.interpolate import (cubic_interpolation,
                                              cubic_interpolation_dense)
from tpugan_tpu_torch.ops.neighbors import fps
from tpugan_tpu_torch.parallel import mesh
from tpugan_tpu_torch.train.state import GanTrainState, NetState


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
    # the critics' stacked applies (grouped batch statistics); needs
    # lowres_size * upsample_ratio == patch_size
    fast_d: bool = False

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


def random_angles(gen: torch.Generator, *shape: int) -> torch.Tensor:
    """Euler angles [*shape, 3], uniform on [0, 2 pi), drawn on the CPU
    from ``gen`` (as the step's draws take them)."""
    return torch.rand(shape + (3,), generator=gen) * (2 * math.pi)


def get_rotation_matrix(gen: torch.Generator) -> torch.Tensor:
    """A random Euler rotation Rz @ Ry @ Rx [3, 3] from ``gen`` (reference
    train_step_final.py:10-30)."""
    return rotation_matrix(random_angles(gen))


def advect_particle(pos, vel, sign):
    """pos + sign * vel * DT (reference train_step_final.py:33-35)."""
    return pos + sign * vel * DT


def rotate_lst(gen: torch.Generator, pos_frames: torch.Tensor,
               vel_frames: Optional[torch.Tensor] = None):
    """Every frame of [F, B, N, 3] rotated by its own random rotation from
    ``gen`` (reference ``rotate_lst``, train_step_final.py:38-48); with
    ``vel_frames``, (positions, velocities) under the same rotations."""
    rots = rotation_matrix(random_angles(gen, pos_frames.shape[0])).to(
        pos_frames)
    rotated = rotate_frames(pos_frames, rots)
    if vel_frames is not None:
        return rotated, rotate_frames(vel_frames, rots)
    return rotated


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
    ``FCHead``; all ones turn dropout off); with ``fast_d`` also
    "tempo_both" and "spatial_both", the stacked updates' [2B, w]
    multipliers (one draw, shared as the JAX step shares its key).
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
    STACKED = ("tempo_both", "spatial_both")

    @classmethod
    def draw(cls, gen: torch.Generator, cfg: FluidTrainConfig, m: int,
             keep_widths: List[int], p_drop: float = 0.2) -> "StepDraws":
        """Draws on the CPU from ``gen`` for a batch of ``cfg.batch_size``
        items of ``m`` high-res points."""
        b, n = cfg.batch_size, cfg.lowres_size
        nr = n * cfg.upsample_ratio
        u = lambda *s: torch.rand(s, generator=gen)
        angles = lambda k: random_angles(gen, k)
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
            keep=cls._keep(gen, b, keep_widths, p_drop, cfg.fast_d))

    @classmethod
    def _keep(cls, gen, b, widths, p_drop, stacked=False):
        """Dropout multipliers by critic call. The critic updates share
        theirs as the JAX step shares its dropout keys: the temporal and
        spatial fake calls one, the two real calls another, and the two
        stacked calls (drawn last, only when ``stacked``) one."""
        keep = {c: [dropout_multipliers((b, w), p_drop, gen) for w in widths]
                for c in ("spatial_g", "tempo_g", "tempo_fake", "tempo_real")}
        keep["spatial_fake"] = keep["tempo_fake"]
        keep["spatial_real"] = keep["tempo_real"]
        if stacked:
            keep["tempo_both"] = [dropout_multipliers((2 * b, w), p_drop, gen)
                                  for w in widths]
            keep["spatial_both"] = keep["tempo_both"]
        return keep

    def items(self) -> int:
        """The batch size the draws were made for."""
        return self.fps_start.shape[0]

    def rows(self, rank: int, world: int) -> "StepDraws":
        """This rank's rows of the per-item draws (``fps_start``,
        ``jitter``, ``rots0`` / ``rots1``, the dropout multipliers; of a
        stacked [2B, w] multiplier its rows of each half); the rest is
        shared."""
        sl = mesh.rows_of(self.fps_start.shape[0], world, rank)
        return dataclasses.replace(
            self, rots0=self.rots0[sl], rots1=self.rots1[sl],
            fps_start=self.fps_start[sl], jitter=self.jitter[:, sl],
            keep=_keep_rows(self.keep, self.STACKED, sl))

    def to(self, device) -> "StepDraws":
        moved = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        for k, v in moved.items():
            if isinstance(v, torch.Tensor):
                moved[k] = v.to(device)
        moved["keep"] = {c: [m.to(device) for m in ms]
                         for c, ms in self.keep.items()}
        return StepDraws(**moved)


def _keep_rows(keep, stacked, sl: slice):
    """Dropout multipliers by call cut to the rows ``sl`` of the batch; a
    stacked [2B, w] multiplier keeps those rows of each half."""
    def cut(c, m):
        if c not in stacked:
            return m[sl]
        b = m.shape[0] // 2
        return torch.cat([m[:b][sl], m[b:][sl]])

    return {c: [cut(c, m) for m in ms] for c, ms in keep.items()}


class DataParallel:
    """The collectives of a data-parallel step over ``group``; at one rank
    the batch norms run as in a single-process step (the pooled-MLP kernel
    included). Raises without a process group."""

    def __init__(self, group=mesh.DATA_AXIS):
        mesh.require_group("a data-parallel train step")
        self.group = group
        self.world, self.rank = mesh.world_size(group), mesh.rank(group)

    def batch_stats(self):
        """The context of the step's critic applies."""
        if self.world == 1:
            return contextlib.nullcontext()
        return cross_rank_stats(
            lambda t: mesh.all_reduce(t, self.group), self.world)

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """``t``'s mean over the ranks (no autograd)."""
        return mesh.mean_over_ranks(t, self.group)

    def grads(self, net: NetState, loss: torch.Tensor):
        """``net``'s gradients of ``loss``, the mean over the ranks."""
        return mesh.average_gradients(net.grads(loss), self.group)

    def check_batch(self, b: int, global_b: int) -> None:
        if b * self.world != global_b:
            raise ValueError(f"data-parallel step: {b} rows on each of "
                             f"{self.world} ranks, but the global batch is "
                             f"{global_b}")


def _grads(dp: Optional[DataParallel], net: NetState, loss: torch.Tensor):
    """``net``'s gradients of ``loss``, averaged over the ranks under data
    parallelism."""
    return net.grads(loss) if dp is None else dp.grads(net, loss)


def _run(step, state, batch, draws, b, mark):
    """``step._step`` on this rank's rows of the (global) draws, under the
    data-parallel batch statistics when ``step.dp`` is set."""
    dp = step.dp
    dev = next(state.sr.module.parameters()).device
    if dp is None:
        return step._step(state, batch, draws.to(dev), mark)
    dp.check_batch(b, draws.items())
    with dp.batch_stats():
        return step._step(state, batch,
                          draws.rows(dp.rank, dp.world).to(dev), mark)


def _metrics(dp: Optional[DataParallel], names, values) -> Dict[str, float]:
    """Floats of the step's scalar metrics, averaged over the ranks in one
    all-reduce under data parallelism."""
    v = torch.stack([x.detach().float() for x in values])
    if dp is not None:
        v = dp.mean(v)
    return dict(zip(names, v.tolist()))


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


def _both(fake, true) -> Optional[List[torch.Tensor]]:
    """Per-frame [fake; true] along the batch axis (None stays None)."""
    if fake is None:
        return None
    return [torch.cat([f, t], 0) for f, t in zip(fake, true)]


def stacked_scores(critic: Callable, b: int, *args, **kw):
    """One train-mode critic apply on fake and real stacked along the batch
    axis under ``stat_groups(2)``; returns the (fake, true) scores, split
    at ``b``."""
    with stat_groups(2):
        score = critic(*args, train=True, **kw)
    return score[:b], score[b:]


# ---------------------------------------------------------------- the step

class FluidGanStep:
    """``step(state, batch, draws=None, mark=None)`` runs one train step in
    place on ``state`` (:class:`GanTrainState`) and returns its metrics as
    floats. ``batch`` holds ``highres_pos`` / ``highres_vel`` [3, B, M, 3]
    on the networks' device; ``draws`` defaults to
    ``StepDraws.draw(generator)``. ``mark``, when given, is called with
    "generator" after the generator's update and "critics" after the
    critics' (a timer's hook).

    ``data_parallel``: ``batch`` holds this rank's rows of the global batch
    of ``cfg.batch_size`` items, ``draws`` (and the default draws) are the
    global batch's; see the module note."""

    def __init__(self, cfg: FluidTrainConfig,
                 generator: Optional[torch.Generator] = None,
                 data_parallel: bool = False):
        self.cfg = cfg
        self.generator = generator or torch.Generator().manual_seed(0)
        self.dp = DataParallel() if data_parallel else None

    def __call__(self, state: GanTrainState, batch: Dict[str, torch.Tensor],
                 draws: Optional[StepDraws] = None,
                 mark: Optional[Callable[[str], None]] = None
                 ) -> Dict[str, float]:
        _, b, m = batch["highres_pos"].shape[:3]
        if draws is None:
            draws = StepDraws.draw(self.generator, self.cfg, m,
                                   dropout_widths(state.spatial.module))
        return _run(self, state, batch, draws, b, mark)

    def _step(self, state, batch, draws, mark):
        cfg, dp = self.cfg, self.dp
        sr, tempo, spatial = (state.sr.module, state.tempo.module,
                              state.spatial.module)
        dev = next(sr.parameters()).device
        highres_pos, highres_vel = batch["highres_pos"], batch["highres_vel"]
        f, b, m = highres_pos.shape[:3]
        cur_iter = state.n_iter + 1
        valid_lbl, invalid_lbl = draws.labels
        radius = cfg.cutoff               # furthest distance is pinned to 1
        n = cfg.lowres_size
        if cfg.fast_d and n * cfg.upsample_ratio != m:
            raise ValueError(
                "--fast_d stacks the fake and real clouds along the batch "
                "axis, which requires the padded prediction bucket "
                f"({n * cfg.upsample_ratio} = lowres_size * upsample_ratio) "
                f"to equal the high-res point count ({m}); configs with "
                "fps_ratio * upsample_ratio != 1 must use the sequential "
                "critic path")

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
        gate = bool((ml if dp is None else dp.mean(ml)) < cfg.ml_gate)
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
                            keep=draws.keep["tempo_g"],
                            stack_frames=cfg.fast_d)
            tempo_loss = lsgan_generator_loss(tp_fake, draws.tp_target)
        sr_loss = tempo_loss + spatial_loss + cfg.w * position_loss
        state.sr.opt.step(_grads(dp, state.sr, sr_loss))
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
            if cfg.fast_d:
                ones = torch.ones_like(pred_valid[0])
                fake, true = stacked_scores(
                    tempo, b, _both(fake_pos, true_pos), cfg.R,
                    feat_lst=_both(_frames(fake_feat), _frames(true_feat)),
                    valid_lst=[torch.cat([v, ones]) for v in pred_valid],
                    keep=draws.keep["tempo_both"], stack_frames=True)
            else:
                fake = tempo(list(fake_pos), cfg.R,
                             feat_lst=_frames(fake_feat),
                             valid_lst=list(pred_valid), train=True,
                             keep=draws.keep["tempo_fake"])
                true = tempo(list(true_pos), cfg.R,
                             feat_lst=_frames(true_feat), valid_lst=None,
                             train=True, keep=draws.keep["tempo_real"])
            t_loss = lsgan_discriminator_loss(true, fake, valid_lbl,
                                              invalid_lbl)
            state.tempo.opt.step(_grads(dp, state.tempo, t_loss))

            true_center, fake_cloud = highres_pos[1], padded_last
            if draws.do_rot_s:
                true_center = rotate_items(true_center, draws.rots0)
                fake_cloud = rotate_items(fake_cloud, draws.rots1)
            if cfg.fast_d:
                fake, true = stacked_scores(
                    spatial, b, torch.cat([fake_cloud, true_center]),
                    torch.cat([last_valid, torch.ones_like(last_valid)]),
                    keep=draws.keep["spatial_both"])
            else:
                fake = spatial(fake_cloud, last_valid, train=True,
                               keep=draws.keep["spatial_fake"])
                true = spatial(true_center, None, train=True,
                               keep=draws.keep["spatial_real"])
            s_loss = lsgan_discriminator_loss(true, fake, valid_lbl,
                                              invalid_lbl)
            state.spatial.opt.step(_grads(dp, state.spatial, s_loss))

        if mark is not None:
            mark("critics")
        state.n_iter = cur_iter
        out = _metrics(dp, ("tempo_G_loss", "tempo_D_loss",
                            "Chamfer_distance_no_norm", "masking_loss",
                            "spatial_G_loss", "spatial_D_loss"),
                       (tempo_loss, t_loss, cd, ml, spatial_loss, s_loss))
        return {**out, "gate": gate}


# ---------------------------------------------------------------- action

@dataclasses.dataclass
class ActionStepDraws:
    """Every random number of one action step.

    labels: (valid, invalid) LSGAN labels; perms: point permutations
    [F, nr] of the frames for the temporal critic's generator pass; sp_perm:
    [nr], the spatial critic's; sp_target / tp_target: the generator's
    LSGAN targets; sp_perm_d: [nr], the spatial update's fake cloud;
    fps_start: [F*B] device sampling's starts (frame-major rows); keep:
    dropout multipliers by critic call (``StepDraws.CALLS``), one list
    each, drawn at each layer's own rate (see ``FCHead``; all ones turn
    dropout off); with ``fast_d`` also "tempo_both" and "spatial_both",
    the stacked updates' [2B, w] multipliers (two draws, as the JAX step's
    two keys).
    """

    labels: tuple
    perms: torch.Tensor
    sp_perm: torch.Tensor
    sp_target: float
    tp_target: float
    sp_perm_d: torch.Tensor
    fps_start: torch.Tensor
    keep: Dict[str, List[torch.Tensor]]

    CALLS = StepDraws.CALLS
    STACKED = StepDraws.STACKED

    @classmethod
    def draw(cls, gen: torch.Generator, cfg, shape,
             spatial_layers: List[tuple], tempo_layers: List[tuple]
             ) -> "ActionStepDraws":
        """Draws on the CPU from ``gen`` for a batch of ``shape`` (F, B, M)
        (frames, clips, high-res points); ``*_layers``: each critic's
        dropout layers, (width, rate) (``dropout_layers``)."""
        f, b, m = shape
        nr = cfg.lowres_size * cfg.upsample_ratio
        target = lambda: float(0.8 + 0.4 * torch.rand(1, generator=gen))
        layers = lambda c: (spatial_layers if c.startswith("spatial")
                            else tempo_layers)
        draws = cls(
            labels=lsgan_labels(gen),
            perms=torch.stack([torch.randperm(nr, generator=gen)
                               for _ in range(f)]),
            sp_perm=torch.randperm(nr, generator=gen),
            sp_target=target(), tp_target=target(),
            sp_perm_d=torch.randperm(nr, generator=gen),
            fps_start=torch.randint(0, m, (f * b,), generator=gen),
            keep={c: [dropout_multipliers((b, w), p, gen) for w, p in
                      layers(c)]
                  for c in cls.CALLS})
        if cfg.fast_d:
            for c in cls.STACKED:
                draws.keep[c] = [dropout_multipliers((2 * b, w), p, gen)
                                 for w, p in layers(c)]
        return draws

    def items(self) -> int:
        """The batch size the draws were made for."""
        return self.fps_start.shape[0] // self.perms.shape[0]

    def rows(self, rank: int, world: int) -> "ActionStepDraws":
        """This rank's rows of the per-item draws: of the frame-major
        ``fps_start`` [F*B] rows f*B + its items for each frame, and of the
        dropout multipliers as :meth:`StepDraws.rows` takes them."""
        b = self.items()
        sl = mesh.rows_of(b, world, rank)
        return dataclasses.replace(
            self, fps_start=self.fps_start.reshape(-1, b)[:, sl].reshape(-1),
            keep=_keep_rows(self.keep, self.STACKED, sl))

    def to(self, device) -> "ActionStepDraws":
        return dataclasses.replace(
            self, perms=self.perms.to(device), sp_perm=self.sp_perm.to(device),
            sp_perm_d=self.sp_perm_d.to(device),
            fps_start=self.fps_start.to(device),
            keep={c: [m.to(device) for m in ms] for c, ms in self.keep.items()})


def device_sample_frames(highres_pos: torch.Tensor, n_low: int,
                         start: torch.Tensor) -> torch.Tensor:
    """Per-frame FPS of every frame of every clip, independently, as one
    call over the [F*B] rows from ``start`` [F*B]; [F, B, M, 3] ->
    [F, B, n_low, 3]."""
    f, b, m = highres_pos.shape[:3]
    flat = highres_pos.reshape(f * b, m, 3)
    idx = fps(flat, n_low, start=start)                         # [F*B, n]
    low = torch.gather(flat, 1, idx[:, :, None].expand(-1, -1, 3))
    return low.reshape(f, b, n_low, 3)


class ActionGanStep:
    """``step(state, batch, draws=None, mark=None)`` runs one action train
    step in place on ``state`` (a :class:`GanTrainState` of NoMaskSRNet,
    ActionTempoDis and ActionSpatialDis) and returns its five metrics as
    floats. ``batch`` holds ``highres_pos`` [F, B, M, 3] (and
    ``lowres_pos`` [F, B, n, 3] without device sampling) on the networks'
    device; ``cfg`` is an ``ActionTrainConfig``; ``draws`` defaults to
    ``ActionStepDraws.draw(generator)``; ``mark`` and ``data_parallel``
    as for :class:`FluidGanStep`."""

    def __init__(self, cfg, generator: Optional[torch.Generator] = None,
                 data_parallel: bool = False):
        self.cfg = cfg
        self.generator = generator or torch.Generator().manual_seed(0)
        self.dp = DataParallel() if data_parallel else None

    def __call__(self, state: GanTrainState, batch: Dict[str, torch.Tensor],
                 draws: Optional[ActionStepDraws] = None,
                 mark: Optional[Callable[[str], None]] = None
                 ) -> Dict[str, float]:
        f, b, m = batch["highres_pos"].shape[:3]
        if draws is None:
            world = 1 if self.dp is None else self.dp.world
            draws = ActionStepDraws.draw(
                self.generator, self.cfg, (f, b * world, m),
                dropout_layers(state.spatial.module),
                dropout_layers(state.tempo.module))
        return _run(self, state, batch, draws, b, mark)

    def _step(self, state, batch, draws, mark):
        cfg, dp = self.cfg, self.dp
        sr, tempo, spatial = (state.sr.module, state.tempo.module,
                              state.spatial.module)
        dev = next(sr.parameters()).device
        highres_pos = batch["highres_pos"]
        f, b, m = highres_pos.shape[:3]
        cur_iter = state.n_iter + 1
        valid_lbl, invalid_lbl = draws.labels
        n = cfg.lowres_size
        if cfg.device_sampling and "lowres_pos" not in batch:
            lowres_pos = device_sample_frames(highres_pos, n, draws.fps_start)
        else:
            lowres_pos = batch["lowres_pos"]

        # ----- generator update: no gate, both critics every iteration
        flat = lowres_pos.reshape((f * b,) + lowres_pos.shape[2:])
        out, _ = sr(flat, flat, train=True)
        pred = out.reshape((f, b) + out.shape[1:])
        position_loss, cd, _ = tpugan_sr_loss(0, highres_pos[1], pred[1], None,
                                              None, 0.0, cur_iter)
        sp_fake = spatial(pred[1][:, draws.sp_perm], None, train=True,
                          keep=draws.keep["spatial_g"])
        spatial_loss = lsgan_generator_loss(sp_fake, draws.sp_target)
        # every frame shuffled for the temporal critic (reference
        # train_step_final.py:270-274)
        pred_seq = torch.stack([pred[i][:, draws.perms[i]] for i in range(f)])
        tp_fake = tempo(list(pred_seq), cfg.R, valid_lst=None, train=True,
                        keep=draws.keep["tempo_g"], stack_frames=cfg.fast_d)
        tempo_loss = lsgan_generator_loss(tp_fake, draws.tp_target)
        sr_loss = tempo_loss + spatial_loss + cfg.w * position_loss
        state.sr.opt.step(_grads(dp, state.sr, sr_loss))
        if mark is not None:
            mark("generator")

        # ----- critic updates (every 2nd iteration)
        zero = torch.zeros((), device=dev)
        t_loss = s_loss = zero
        if cur_iter % 2 == 0 and not cfg.freeze_D:
            pred_seq, pred_center = pred_seq.detach(), pred[1].detach()
            if cfg.fast_d:
                fake, true = stacked_scores(
                    tempo, b, _both(pred_seq, highres_pos), cfg.R,
                    valid_lst=None, keep=draws.keep["tempo_both"],
                    stack_frames=True)
            else:
                fake = tempo(list(pred_seq), cfg.R, valid_lst=None, train=True,
                             keep=draws.keep["tempo_fake"])
                true = tempo(list(highres_pos), cfg.R, valid_lst=None,
                             train=True, keep=draws.keep["tempo_real"])
            t_loss = lsgan_discriminator_loss(true, fake, valid_lbl,
                                              invalid_lbl)
            state.tempo.opt.step(_grads(dp, state.tempo, t_loss))

            if cfg.fast_d:
                fake, true = stacked_scores(
                    spatial, b, torch.cat([pred_center[:, draws.sp_perm_d],
                                           highres_pos[1]]), None,
                    keep=draws.keep["spatial_both"])
            else:
                fake = spatial(pred_center[:, draws.sp_perm_d], None,
                               train=True, keep=draws.keep["spatial_fake"])
                true = spatial(highres_pos[1], None, train=True,
                               keep=draws.keep["spatial_real"])
            s_loss = lsgan_discriminator_loss(true, fake, valid_lbl,
                                              invalid_lbl)
            state.spatial.opt.step(_grads(dp, state.spatial, s_loss))

        if mark is not None:
            mark("critics")
        state.n_iter = cur_iter
        return _metrics(dp, ("tempo_G_loss", "tempo_D_loss",
                             "Chamfer_distance_no_norm", "spatial_G_loss",
                             "spatial_D_loss"),
                        (tempo_loss, t_loss, cd, spatial_loss, s_loss))
