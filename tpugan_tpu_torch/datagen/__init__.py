"""Fluid dataset generation, host-side numpy (the port's copy of the
framework-free ``tpugan_tpu/datagen/``): random SPlisHSPlasH scenes, the
external solver's launcher (its binary is not in the repository), and the
conversion of its bgeo output to ``case{i}/data_{t}.npz`` frames.
"""

from tpugan_tpu_torch.datagen.scene_gen import (
    SIM_DEFAULTS,
    create_fluid_scene,
    run_simulator,
)
from tpugan_tpu_torch.datagen.process import process_case, process_dataset

__all__ = [
    "SIM_DEFAULTS",
    "create_fluid_scene",
    "run_simulator",
    "process_case",
    "process_dataset",
]
