"""Config presets — the launch-file equivalents.

Each preset mirrors one of the reference's launch configurations
(swarm_planner/launch/*.launch) as a Param plus world/mission hints, so
`preset("rbp_random_forest")` reproduces `roslaunch swarm_planner
plan_rbp_random_forest.launch` knob-for-knob.

A copy of swarm_simulator_tpu/core/config.py (host code),
so that the PyTorch port never imports the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .types import Param


@dataclass(frozen=True)
class Preset:
    param: Param
    mission: str  # default mission file name (missions/ dir)
    replay_map: Optional[str] = None
    obs_num: int = 20
    obs_r_min: float = 0.3
    obs_r_max: float = 0.3
    obs_h_min: float = 0.0
    obs_h_max: float = 2.5
    obs_margin: float = 0.5


_PRESETS = {
    # plan_rbp_random_forest.launch:16-66 (canonical 64-agent demo)
    "rbp_random_forest": Preset(
        param=Param(world_z_min=0.3, grid_xy_res=0.5, grid_z_res=1.0,
                    grid_margin=0.2, ecbs_w=1.3, box_xy_res=0.1,
                    box_z_res=0.1, time_scale=True, time_step=1.0,
                    downwash=2.0, sequential=True, batch_size=4,
                    batch_iter=-1, iteration=1),
        mission="mission_64agents_15.json",
        replay_map="ICRA2020_64agents_presentation.bt",
    ),
    # plan_rbp_test.launch (50-map benchmark sweep, w=1.5)
    "rbp_test": Preset(
        param=Param(world_z_min=0.0, grid_xy_res=0.5, grid_z_res=1.0,
                    ecbs_w=1.5, sequential=False, time_scale=True),
        mission="mission_8agents_12.json",
    ),
    # flat-corridor demo (plan_rbp_flat launch family)
    "rbp_flat": Preset(
        param=Param(world_z_min=0.3, grid_xy_res=0.5, grid_z_res=1.0,
                    corridor_mode="flat", sequential=False),
        mission="mission_8agents_12.json",
    ),
    # SCP baseline node (plan_scp_empty_space.launch:19,30: 8-agent
    # mission, plan/time_step 0.5; swarm_traj_planner_scp.cpp:30 adds
    # 0.01 start noise)
    "scp": Preset(
        param=Param(world_z_min=0.0, time_step=0.5),
        mission="mission_8agents_15.json",
    ),
}


def preset(name: str) -> Preset:
    if name not in _PRESETS:
        raise KeyError(
            f"unknown preset {name!r}; available: {sorted(_PRESETS)}")
    return _PRESETS[name]


def available() -> list[str]:
    return sorted(_PRESETS)
