"""Dataset-generation CLI (``tpugan_tpu/cli/sim_fluid_sequence.py``):
loop scene creation + simulation + conversion over train/test seeds.

Equivalent of reference fluid_data_generation/sim_fluid_sequence.py:1-30
(20 train + 4 test seeds at particle radius 0.0125). Without the external
SPlisHSPlasH solver, pass ``--synthetic`` to produce solver-free synthetic
sequences in exactly the same npz schema (the JAX CLI's arrays, value for
value).

    python -m tpugan_tpu_torch.cli.sim_fluid_sequence --synthetic \\
        --out_root data --num_frames 200

Nothing here runs on the card: the scenes, the solver launcher and the
conversion are host code (``tpugan_tpu_torch/datagen/``).
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out_root", type=str, default="./data")
    p.add_argument("--train_seeds", type=int, default=20)
    p.add_argument("--test_seeds", type=int, default=4)
    p.add_argument("--particle_radius", type=float, default=0.0125)
    p.add_argument("--coarse_ratio", type=float, default=None)
    p.add_argument("--obj_dir", type=str, default=None,
                   help="directory of .obj fluid shapes (reference shape "
                        "dataset path); default: parametric blob pool")
    p.add_argument("--synthetic", action="store_true",
                   help="generate synthetic sequences (no solver needed)")
    p.add_argument("--num_particles", type=int, default=12000)
    p.add_argument("--num_frames", type=int, default=200)
    opt = p.parse_args(argv)

    tag = f"{opt.particle_radius}_fine"
    train_root = os.path.join(opt.out_root, f"train_data_{tag}")
    test_root = os.path.join(opt.out_root, f"test_data_{tag}")

    if opt.synthetic:
        from tpugan_tpu_torch.data.synthetic import make_synthetic_fluid_dataset

        make_synthetic_fluid_dataset(
            train_root, case_num=opt.train_seeds, case_steps=opt.num_frames,
            num_particles=opt.num_particles, seed=0,
        )
        make_synthetic_fluid_dataset(
            test_root, case_num=opt.test_seeds, case_steps=opt.num_frames,
            num_particles=opt.num_particles, seed=10_000,
        )
        print(f"synthetic datasets at {train_root} and {test_root}")
        return

    from tpugan_tpu_torch.datagen import create_fluid_scene, process_case, run_simulator

    for split, root, seeds in (
        ("train", train_root, range(opt.train_seeds)),
        ("test", test_root, range(10_000, 10_000 + opt.test_seeds)),
    ):
        for i, seed in enumerate(seeds):
            scene_dir = os.path.join(opt.out_root, "scenes", f"{split}_{seed}")
            print(f"[{split}] scene {i + 1}: seed {seed}")
            create_fluid_scene(
                scene_dir, seed=seed, particle_radius=opt.particle_radius,
                coarse_ratio=opt.coarse_ratio, obj_dir=opt.obj_dir,
            )
            run_simulator(scene_dir)
            process_case(
                os.path.join(scene_dir, "sim_output"),
                os.path.join(root, f"case{i + 1}"),
            )


if __name__ == "__main__":
    main()
