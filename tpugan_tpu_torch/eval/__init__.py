"""Evaluation: the serving rollout loop and the quantitative metrics."""

from tpugan_tpu_torch.eval.analysis import (
    action_position_metrics,
    cycle_consistency,
    eval_spatial_grid_gradient,
    free_surface_particle_count_diff,
    free_surface_particle_counts,
    get_1st_derivative,
    get_2nd_derivative,
    get_particle_density,
    nearest_set,
    pad_clip_with_appropriate_size,
    particle_dns2grid_dns,
    pc_normalize,
    position_metrics,
)
from tpugan_tpu_torch.eval.rollout import rollout_sequence

__all__ = [
    "rollout_sequence",
    "position_metrics",
    "action_position_metrics",
    "pad_clip_with_appropriate_size",
    "pc_normalize",
    "cycle_consistency",
    "get_particle_density",
    "particle_dns2grid_dns",
    "nearest_set",
    "get_1st_derivative",
    "get_2nd_derivative",
    "eval_spatial_grid_gradient",
    "free_surface_particle_count_diff",
    "free_surface_particle_counts",
]
