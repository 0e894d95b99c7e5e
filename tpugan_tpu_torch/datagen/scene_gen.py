"""Random SPH scene synthesis + solver launcher.

Equivalent of reference fluid_data_generation/create_physics_scenes.py
(:37-90 sim defaults, :148-219 free-space rasterization, :230-509 scene
creation, :222-227 solver subprocess): sample 1-3 fluid blobs with random
rotation/scale/velocity into the free space of a box, write the scene as
SPlisHSPlasH-schema ``scene.json`` + per-fluid ``.bgeo`` particle blocks,
and (when the external DFSPH binary is available) run the simulation.

Shapes: with ``obj_dir`` fluid blobs are volume-sampled from .obj meshes
via tpugan_tpu_torch.datagen.mesh (numpy equivalents of the reference's
VolumeSampling binary / Open3D Poisson disk); the default pool is
parametric (box / sphere / cylinder point lattices), pluggable via
``SHAPE_SAMPLERS``. A matched coarse-resolution twin scene (the reference's
``--coarse_ratio``) is supported through ``coarse_ratio``.
"""

from __future__ import annotations

import json
import os
import subprocess
from typing import Dict, List, Optional

import numpy as np

from tpugan_tpu_torch.data.bgeo import write_bgeo
from tpugan_tpu_torch.datagen import splishsplash_config as ss_cfg

# Simulation defaults (reference create_physics_scenes.py:37-90).
SIM_DEFAULTS: Dict = {
    "Configuration": {
        "pause": False,
        "stopAt": 5.0,
        "particleRadius": 0.025,
        "numberOfStepsPerRenderUpdate": 1,
        "density0": 1000,
        "simulationMethod": 4,          # DFSPH
        "gravitation": [0, -9.81, 0],
        "cflMethod": 0,
        "cflFactor": 1,
        "cflMaxTimeStepSize": 0.005,
        "maxIterations": 100,
        "maxError": 0.01,
        "maxIterationsV": 100,
        "maxErrorV": 0.1,
        "stiffness": 50000,
        "exponent": 7,
        "velocityUpdateMethod": 0,
        "enableDivergenceSolver": True,
        "enablePartioExport": True,
        "enableRigidBodyExport": False,
        "particleFPS": 40.0,
        "partioAttributes": "density;velocity",
    },
    "Simulation": {
        "timeStepSize": 0.001,
        "particleRadius": 0.025,
        "simulationMethod": 4,
        "boundaryHandlingMethod": 0,
        "kernel": 4,
        "cflMethod": 1,
        "cflFactor": 0.5,
        "cflMaxTimeStepSize": 0.005,
        "maxIterations": 100,
        "maxError": 0.01,
        "maxIterationsV": 100,
        "maxErrorV": 0.1,
        "gravitation": [0, -9.81, 0],
        "density0": 1000,
    },
    "RigidBodies": [],
    "FluidModels": [],
    "Materials": [
        {
            "id": "Fluid",
            "viscosity": 0.01,
            "viscosityMethod": 3,
        }
    ],
}


def _lattice_ball(radius, spacing, rng):
    g = np.arange(-radius, radius + spacing, spacing)
    pts = np.stack(np.meshgrid(g, g, g), -1).reshape(-1, 3)
    return pts[np.linalg.norm(pts, axis=1) <= radius]


def _lattice_box(extent, spacing, rng):
    gs = [np.arange(-e / 2, e / 2 + spacing, spacing) for e in extent]
    return np.stack(np.meshgrid(*gs), -1).reshape(-1, 3)


def _lattice_cylinder(radius_height, spacing, rng):
    r, h = radius_height
    g = np.arange(-r, r + spacing, spacing)
    gz = np.arange(-h / 2, h / 2 + spacing, spacing)
    pts = np.stack(np.meshgrid(g, gz, g), -1).reshape(-1, 3)
    return pts[np.sqrt(pts[:, 0] ** 2 + pts[:, 2] ** 2) <= r]


SHAPE_SAMPLERS = {
    "sphere": lambda rng, spacing: _lattice_ball(rng.uniform(0.15, 0.3), spacing, rng),
    "box": lambda rng, spacing: _lattice_box(rng.uniform(0.2, 0.5, 3), spacing, rng),
    "cylinder": lambda rng, spacing: _lattice_cylinder(
        (rng.uniform(0.1, 0.25), rng.uniform(0.2, 0.5)), spacing, rng
    ),
}


def random_rotation_matrix(rng) -> np.ndarray:
    """Uniform random rotation (reference create_physics_scenes.py:93-119)."""
    q = rng.standard_normal(4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _occupancy(points: np.ndarray, box_min, box_max, cell: float) -> np.ndarray:
    """Rasterize points into a coarse occupancy grid (the free-space test of
    reference create_physics_scenes.py:148-181)."""
    dims = np.maximum(((box_max - box_min) / cell).astype(int), 1)
    grid = np.zeros(dims, bool)
    if len(points):
        ijk = ((points - box_min) / cell).astype(int)
        ijk = np.clip(ijk, 0, dims - 1)
        grid[ijk[:, 0], ijk[:, 1], ijk[:, 2]] = True
    return grid


def _mesh_blob(objpath: str, rng, spacing: float) -> np.ndarray:
    """Sample a fluid blob from an .obj mesh: normalize to unit extent,
    random target size like the parametric pool, volume-fill at the
    particle spacing (reference create_physics_scenes.py:122-131 via
    obj_volume_to_particles)."""
    from tpugan_tpu_torch.datagen.mesh import load_obj, obj_volume_to_particles

    verts, _ = load_obj(objpath)
    max_extent = float((verts.max(0) - verts.min(0)).max())
    scale = rng.uniform(0.25, 0.55) / max(max_extent, 1e-9)
    pts, _ = obj_volume_to_particles(objpath, spacing / 2, scale=scale)
    return pts - pts.mean(0) if len(pts) else pts


def create_fluid_scene(
    output_dir: str,
    seed: int = 0,
    particle_radius: float = 0.025,
    box_min=(-1.0, 0.0, -1.0),
    box_max=(1.0, 2.0, 1.0),
    max_blobs: int = 3,
    coarse_ratio: Optional[float] = None,
    default_config: Optional[Dict] = None,
    obj_dir: Optional[str] = None,
) -> Dict:
    """Synthesize one scene: random fluid blobs placed collision-free in
    the box, written as scene.json + .bgeo blocks. Returns the scene dict.

    With ``coarse_ratio``, a matched twin scene at coarser particle radius
    (same blob placements/velocities) is written to ``output_dir + '_coarse'``
    (reference --coarse_ratio, create_physics_scenes.py:256-294).

    With ``obj_dir``, blob shapes are volume-sampled from the directory's
    .obj meshes (the reference's shape-dataset path,
    create_physics_scenes.py:122-145) instead of the parametric pool.
    """
    rng = np.random.default_rng(seed)
    os.makedirs(output_dir, exist_ok=True)
    box_min = np.asarray(box_min, np.float64)
    box_max = np.asarray(box_max, np.float64)
    spacing = 2 * particle_radius

    obj_pool: List[str] = []
    if obj_dir is not None:
        obj_pool = sorted(
            os.path.join(obj_dir, f) for f in os.listdir(obj_dir)
            if f.endswith(".obj")
        )
        if not obj_pool:
            raise ValueError(f"no .obj files in {obj_dir}")

    n_blobs = int(rng.integers(1, max_blobs + 1))
    occupied = np.zeros((0, 3))
    blobs: List[Dict] = []
    for bi in range(n_blobs):
        if obj_pool:
            objpath = obj_pool[int(rng.integers(len(obj_pool)))]
            shape = os.path.basename(objpath)
            base = _mesh_blob(objpath, rng, spacing)
            if len(base) == 0:
                continue
        else:
            shape = list(SHAPE_SAMPLERS)[int(rng.integers(len(SHAPE_SAMPLERS)))]
            base = SHAPE_SAMPLERS[shape](rng, spacing)
        rot = random_rotation_matrix(rng)
        pts = base @ rot.T
        # find a collision-free start position (reference :182-219)
        placed = False
        for _ in range(50):
            lo, hi = pts.min(0), pts.max(0)
            center = rng.uniform(box_min - lo + 0.05, box_max - hi - 0.05)
            cand = pts + center
            if len(occupied):
                from scipy.spatial import cKDTree

                if cKDTree(occupied).query(cand, 1)[0].min() < 2 * spacing:
                    continue
            occupied = np.concatenate([occupied, cand])
            vel = rng.uniform(-1.5, 1.5, 3)
            vel[1] = rng.uniform(-2.0, 0.0)
            blobs.append({"shape": shape, "points": cand, "velocity": vel})
            placed = True
            break
        if not placed:
            continue

    if not blobs:
        # every sampled shape came back empty (e.g. mesh scale below the
        # particle spacing) or failed placement — a zero-FluidModels scene
        # would only fail later inside the solver with an opaque error.
        raise RuntimeError(
            f"create_fluid_scene: no fluid blob could be placed in "
            f"{output_dir} (seed={seed}, spacing={spacing}); check shape "
            f"scales against the particle radius"
        )

    scene = json.loads(json.dumps(SIM_DEFAULTS))  # deep copy
    scene["Configuration"]["particleRadius"] = particle_radius
    scene["RigidBodies"] = [{
        "geometryFile": "",
        "translation": ((box_min + box_max) / 2).tolist(),
        "scale": ((box_max - box_min) / 2).tolist(),
        "type": "box",
        "isDynamic": False,
        "isWall": True,
        "mapInvert": True,
    }]
    for i, blob in enumerate(blobs):
        bgeo_name = f"fluid_{i}.bgeo"
        vel = np.tile(blob["velocity"][None], (blob["points"].shape[0], 1))
        write_bgeo(os.path.join(output_dir, bgeo_name),
                   blob["points"].astype(np.float32), vel.astype(np.float32))
        scene["FluidModels"].append({
            "particleFile": bgeo_name,
            "id": "Fluid",
            "translation": [0.0, 0.0, 0.0],
            "scale": [1, 1, 1],
            "initialVelocity": blob["velocity"].tolist(),
        })

    with open(os.path.join(output_dir, "scene.json"), "w") as fh:
        json.dump(scene, fh, indent=2)

    if coarse_ratio is not None:
        coarse_dir = output_dir.rstrip("/") + "_coarse"
        os.makedirs(coarse_dir, exist_ok=True)
        c_radius = particle_radius / coarse_ratio
        c_spacing = 2 * c_radius
        c_scene = json.loads(json.dumps(scene))
        c_scene["Configuration"]["particleRadius"] = c_radius
        c_scene["FluidModels"] = []
        for i, blob in enumerate(blobs):
            # resample the same blob extent on the coarse lattice
            pts = blob["points"]
            lo, hi = pts.min(0), pts.max(0)
            grid = _lattice_box(hi - lo, c_spacing, rng) + (lo + hi) / 2
            occ = _occupancy(pts, lo - c_spacing, hi + c_spacing, c_spacing)
            ijk = np.clip(((grid - (lo - c_spacing)) / c_spacing).astype(int),
                          0, np.array(occ.shape) - 1)
            keep = occ[ijk[:, 0], ijk[:, 1], ijk[:, 2]]
            cpts = grid[keep]
            name = f"fluid_{i}.bgeo"
            vel = np.tile(blob["velocity"][None], (cpts.shape[0], 1))
            write_bgeo(os.path.join(coarse_dir, name),
                       cpts.astype(np.float32), vel.astype(np.float32))
            c_scene["FluidModels"].append({
                "particleFile": name,
                "id": "Fluid",
                "translation": [0.0, 0.0, 0.0],
                "scale": [1, 1, 1],
                "initialVelocity": blob["velocity"].tolist(),
            })
        with open(os.path.join(coarse_dir, "scene.json"), "w") as fh:
            json.dump(c_scene, fh, indent=2)

    return scene


def run_simulator(scene_dir: str, output_dir: Optional[str] = None) -> None:
    """Run the external DFSPH solver headless on a generated scene
    (reference create_physics_scenes.py:222-227). Requires SPlisHSPlasH."""
    if not ss_cfg.simulator_available():
        raise RuntimeError(
            "SPlisHSPlasH DynamicBoundarySimulator not found; set "
            "SPLISHSPLASH_SIMULATOR or use synthetic fixtures "
            "(tpugan_tpu_torch.data.synthetic)."
        )
    output_dir = output_dir or os.path.join(scene_dir, "sim_output")
    os.makedirs(output_dir, exist_ok=True)
    subprocess.run(
        [ss_cfg.SIMULATOR_BIN, os.path.join(scene_dir, "scene.json"),
         "--no-gui", "--output-dir", output_dir],
        check=True,
    )
