"""Paths to the external SPlisHSPlasH binaries.

Equivalent of reference fluid_data_generation/splishsplash_config.py: the
DFSPH solver is an out-of-tree C++ dependency; point these at your build
(or set the environment variables). Everything else in the data-generation
pipeline runs without it — synthetic fixtures cover CI.
"""

import os
import shutil

SIMULATOR_BIN = os.environ.get(
    "SPLISHSPLASH_SIMULATOR",
    shutil.which("DynamicBoundarySimulator") or "DynamicBoundarySimulator",
)
VOLUME_SAMPLING_BIN = os.environ.get(
    "SPLISHSPLASH_VOLUME_SAMPLING",
    shutil.which("VolumeSampling") or "VolumeSampling",
)


def simulator_available() -> bool:
    return shutil.which(SIMULATOR_BIN) is not None
