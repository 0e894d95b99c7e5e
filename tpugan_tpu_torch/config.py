"""The port's copy of parts of ``tpugan_tpu/config.py``: the presets of the
``train_fluid``, ``train_action`` and ``eval_tempo_feat`` CLIs and their
parser (each preset is a reference shell script's flag set, applied as
argparse defaults, so flags given explicitly still win);
``ActionTrainConfig`` (the action GAN trainer's settings, which the clip
loader and the demo also read); and ``EvalTempoFeatConfig``.
"""

from __future__ import annotations

import dataclasses

PRESETS = {
    "train_fluid": {
        # train_fluid/train_vel/train.sh
        "train_vel": dict(ckpt_every=10000, iters=80000,
                          dump_visualization=True, batch_size=4,
                          use_vel=True, in_node_feats=6),
        # train_fluid/train_novel/train.sh
        "train_novel": dict(ckpt_every=10000, iters=80000,
                            dump_visualization=True, batch_size=4),
    },
    "train_action": {
        # train_action/train_dir/train.sh
        "train_dir": dict(ckpt_every=10000, iters=100000, lr=3e-4,
                          batch_size=4, dump_visualization=True),
    },
    "eval_tempo_feat": {
        # train_action/eval_dis/run.sh (its data and checkpoint paths are
        # its machine's; the recipe is the default hyperparameters)
        "eval_dis": dict(lr=1e-3, epochs=60, batch_size=24, cutoff=2.0,
                         frames_per_clip=3),
    },
}


@dataclasses.dataclass
class ActionTrainConfig:
    """The action GAN trainer's settings (reference train_msr.py:30-83,
    133-141), the JAX package's ``ActionTrainConfig`` with the same
    defaults; ``device_sampling``: per-frame independent FPS of the
    low-res inputs inside the step instead of in the loader; ``fast_d``:
    the critics' stacked applies (``tpugan_tpu_torch/train/step.py``). Its
    ``data_parallel`` is the CLI's ``--data_parallel`` (the step's
    ``data_parallel`` argument) and its ``mesh_shape`` the ``torchrun``
    world, so neither is a field here."""

    lr: float = 3e-4
    iters: int = 100000
    ckpt_every: int = 10000
    lr_decay_rate: float = 0.72
    dis_lr_factor: float = 0.33
    in_node_feats: int = 3
    node_embedding: int = 128
    upsample_ratio: int = 16
    feature_extractor_depth: int = 3
    R: float = 2.0
    data_dir: str = "data/MSR-Action3D"
    frames_per_clip: int = 3
    num_points: int = 2048
    fps_ratio: float = 0.0625    # reference msr_dataset.py:93
    batch_size: int = 4
    w: float = 2.0
    device_sampling: bool = False
    freeze_D: bool = False
    fast_d: bool = False
    dump_visualization: bool = False
    log_dir: str = "./"
    seed: int = 1

    @property
    def lr_decay_steps(self) -> int:
        # reference train_msr.py:134: a tenth of the run, so a resume at
        # --iters 20004 decays every 2,000 steps (as the JAX trainer does)
        return self.iters // 10

    @property
    def lowres_size(self) -> int:
        return int(self.num_points * self.fps_ratio)


@dataclasses.dataclass
class EvalTempoFeatConfig:
    # reference eval_tempo_feat.py:20-31
    lr: float = 1e-3
    epochs: int = 60
    batch_size: int = 24
    data_dir: str = "data/MSR-Action3D"
    ckpt_path: str = ""
    log_dir: str = "./eval_dis"
    cutoff: float = 2.0
    frames_per_clip: int = 3
    seed: int = 0


def parse_with_preset(parser, cli: str, argv=None):
    """Parse ``argv`` honouring ``--preset``: the preset's values become the
    parser's defaults, so flags given on the command line override them."""
    table = PRESETS[cli]
    parser.add_argument("--preset", choices=sorted(table), default=None,
                        help="blessed reference config (flag values from "
                             "the reference's shell scripts); explicit "
                             "flags override preset values")
    pre, _ = parser.parse_known_args(argv)
    if pre.preset:
        parser.set_defaults(**table[pre.preset])
    return parser.parse_args(argv)
