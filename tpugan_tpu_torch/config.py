"""The ``train_fluid`` presets and their parser, the port's copy of that part
of ``tpugan_tpu/config.py``: each preset is a reference shell script's flag
set (train_fluid/train_vel/train.sh, train_fluid/train_novel/train.sh),
applied as argparse defaults, so flags given explicitly still win.
"""

from __future__ import annotations

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
}


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
