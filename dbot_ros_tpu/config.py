"""Flat configuration dataclasses with the reference's parameter names.

Replaces the ROS param-server → ``ri::read<T>`` → builder-struct pipeline
(dbot_ros launch/*.launch + config/*.yaml + R8; SURVEY.md §5 config row):
one dataclass per tracker, loadable from YAML/JSON dicts, consumed once at
build time (static jit constants thereafter). Parameter names and defaults
follow the reference YAML (`object/…`, `downsampling_factor`,
`evaluation_count`, `max_kl_divergence`, noise sigmas, occlusion
probabilities, `tail_weight`, `moving_average_update_rate`) so configs are
portable and RMSE comparisons are apples-to-apples.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Sequence


@dataclasses.dataclass
class ObjectConfig:
    """Which meshes to track (ref: ObjectResourceIdentifier, D2)."""

    meshes: List[str] = dataclasses.field(default_factory=list)  # .obj paths
    directory: str = ""          # optional base directory (ref: package/dir)
    package: str = ""            # kept for config compatibility; unused
    scale: float = 1.0
    center_object: bool = True   # rotate about centroid (ref D4)

    def mesh_paths(self) -> List[str]:
        import os
        base = self.directory or ""
        return [os.path.join(base, m) if base else m for m in self.meshes]


@dataclasses.dataclass
class CameraConfig:
    """Camera intrinsics + downsampling (ref: CameraData / providers, D6)."""

    camera_matrix: Optional[Sequence[float]] = None  # row-major 3x3; None → Kinect
    resolution: Sequence[int] = (480, 640)           # (H, W) native
    downsampling_factor: int = 8
    frame_rate: float = 30.0


@dataclasses.dataclass
class ObservationConfig:
    """Beam + occlusion model parameters (ref D9/D10 + fl BodyTail)."""

    tail_weight: float = 0.02
    model_sigma: float = 0.003
    sigma_factor: float = 0.0014
    min_depth: float = 0.4
    max_depth: float = 5.0
    exponential_rate: float = 1.5
    p_occluded_visible: float = 0.1
    p_occluded_occluded: float = 0.7
    initial_occlusion_prob: float = 0.1


@dataclasses.dataclass
class TransitionConfig:
    """Process model parameters (ref D7/D8 builders)."""

    linear_acceleration_sigma: float = 0.02
    angular_acceleration_sigma: float = 0.1
    damping: float = 4.0  # a.k.a. velocity damping / (1 - velocity_factor)


@dataclasses.dataclass
class ParticleTrackerConfig:
    """Full particle-tracker assembly config (ref ParticleTrackerBuilder)."""

    object: ObjectConfig = dataclasses.field(default_factory=ObjectConfig)
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    observation: ObservationConfig = dataclasses.field(
        default_factory=ObservationConfig)
    transition: TransitionConfig = dataclasses.field(
        default_factory=TransitionConfig)
    evaluation_count: int = 200        # particle count (ref name)
    max_kl_divergence: float = 1.0
    moving_average_update_rate: float = 1.0  # 1.0 = no smoothing
    backend: str = "xla"               # ref `use_gpu` CPU/GPU switch
    # extra kwargs for the sensor backend factory (e.g. the pallas
    # sensor's num_candidates/radius/nb/levels — ref: the GPU builder's
    # BufferConfiguration knobs, D14/D21)
    backend_options: dict = dataclasses.field(default_factory=dict)
    seed: int = 0


@dataclasses.dataclass
class GaussianTrackerConfig:
    """Gaussian-tracker assembly config (ref GaussianTrackerBuilder)."""

    object: ObjectConfig = dataclasses.field(default_factory=ObjectConfig)
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    observation: ObservationConfig = dataclasses.field(
        default_factory=ObservationConfig)
    transition: TransitionConfig = dataclasses.field(
        default_factory=TransitionConfig)
    update_iterations: int = 3
    # Temporal occlusion memory (default ON): per-pixel occluder-prior
    # chain (the PF's D10 occlusion process, adapted to the GF's
    # mixture; uses the observation config's p_occluded_*). Measured
    # (round 4, occluder protocol over 4 seeds): worst-case position
    # 0.054-0.095 m -> 0.017-0.022 m and rotation lock-ins eliminated
    # (0.90-1.20 rad -> 0.087-0.106), at a small nominal cost
    # (rot 0.073 -> 0.087).
    occlusion_memory: bool = True
    # Evaluate the update on every s-th pixel (ICRA-2016 §experiments uses
    # sparse pixel subsets; 1 = all pixels; <= 0 = auto degrade-to-budget
    # via ops/budget.rgf_pixel_stride — the GF analog of the reference's
    # BufferConfiguration D14). Applied on the flattened (downsampled)
    # pixel grid; background/renders follow the same subset.
    pixel_stride: int = 1
    # Sigma-point render backend: "deferred" =
    # candidate one-hot matmul pass (one exact reference scan per IPLF
    # iteration + per-sigma candidate matmuls — the PF's D12 candidate
    # machinery shared with the GF, as the reference shares D5);
    # "exact" = full scan-over-triangles per sigma pose (oracle path).
    sigma_backend: str = "deferred"
    sigma_radius: int = 3        # candidate dilation radius (pixels)
    sigma_candidates: int = 6    # candidate triangle ids per pixel
    trust_sigma: float = 1.0
    lin_floor_pos: float = 0.008
    lin_floor_rot: float = 0.04
    # Linearization-probe CAP (upper twin of the floor): bounds the
    # sigma-point probe and per-step trust radius when dt-aware
    # prediction inflates P over dropped-frame gaps — reach beyond the
    # cap comes from iterated re-renders (filters/rgf.py update()).
    lin_cap_pos: float = 0.04
    lin_cap_rot: float = 0.25
    bg_sigma: float = 0.02
    init_pos_sigma: float = 0.02
    init_rot_sigma: float = 0.1
    init_vel_sigma: float = 0.1
    moving_average_update_rate: float = 1.0
    seed: int = 0


def _from_dict(cls, data):
    if isinstance(data, cls):
        return data
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in dict(data).items():
        if k not in fields:
            raise ValueError(f"unknown config key {k!r} for {cls.__name__}")
        ftype = fields[k].type
        nested = {
            "ObjectConfig": ObjectConfig, "CameraConfig": CameraConfig,
            "ObservationConfig": ObservationConfig,
            "TransitionConfig": TransitionConfig,
        }.get(str(ftype).replace("typing.", "").strip("'\""))
        kwargs[k] = _from_dict(nested, v) if nested and isinstance(
            v, dict) else v
    return cls(**kwargs)


def particle_config_from_dict(data) -> ParticleTrackerConfig:
    return _from_dict(ParticleTrackerConfig, data)


def gaussian_config_from_dict(data) -> GaussianTrackerConfig:
    return _from_dict(GaussianTrackerConfig, data)


def load_config(path: str):
    """Load a tracker config from JSON or YAML (type tagged by 'tracker')."""
    with open(path) as fh:
        text = fh.read()
    if path.endswith((".yaml", ".yml")):
        try:
            import yaml  # type: ignore
            data = yaml.safe_load(text)
        except ImportError as e:
            raise RuntimeError(
                "YAML config requires pyyaml; use JSON instead") from e
    else:
        data = json.loads(text)
    kind = data.pop("tracker", "particle")
    if kind == "particle":
        return particle_config_from_dict(data)
    if kind == "gaussian":
        return gaussian_config_from_dict(data)
    raise ValueError(f"unknown tracker type {kind!r}")
