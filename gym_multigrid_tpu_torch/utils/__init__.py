"""Host utilities of the port: maps, rendering primitives, misc."""

from gym_multigrid_tpu_torch.utils.map import (
    closest_area_pos,
    distance_area_point,
    distance_points,
    load_text_map,
    position_in_positions,
)
from gym_multigrid_tpu_torch.utils.misc import save_frames_as_gif, set_seed

__all__ = [
    "closest_area_pos",
    "distance_area_point",
    "distance_points",
    "load_text_map",
    "position_in_positions",
    "save_frames_as_gif",
    "set_seed",
]
