"""Rao-Blackwell depth-image sensor: render → compare → occlusion-filter.

The contract (ref D16, ``rb_observation_model.h``):

    loglik_fn(states [P,K,13], occ [P,N], z_obs [N], dt) →
        (loglik [P], occ_post [P,N])

``make_rb_sensor`` assembles it from a mesh list + camera + model params,
playing the role of ``RbSensorBuilder`` (D21) with its CPU/GPU switch — here
the switch is backend="xla" (chunked matmul raycast, ops/raycast.py) vs
backend="pallas" (fused render+likelihood kernel, ops/raycast_pallas.py).

Multi-object scenes (K > 1) follow the reference's
``FreeFloatingRigidBodiesState`` semantics: each object has its own mesh and
pose; the predicted depth is the per-pixel min over objects (mutual
occlusion between tracked objects is handled by geometry, occlusion by
*untracked* objects by the latent occlusion chain).
"""

from __future__ import annotations

from typing import Sequence

import jax.numpy as jnp

from dbot_ros_tpu.models.beam import BeamParams
from dbot_ros_tpu.models.image_loglik import image_loglik
from dbot_ros_tpu.models.occlusion import OcclusionParams
from dbot_ros_tpu.ops import raycast
from dbot_ros_tpu.utils.camera import CameraModel
from dbot_ros_tpu.utils.mesh import TriangleMesh


def render_scene(meshes: Sequence[TriangleMesh], poses, rays,
                 tri_chunk: int = 512):
    """Min-depth over objects: poses [..., K, 7] → depth [..., N]."""
    depth = None
    for k, mesh in enumerate(meshes):
        d = raycast.raycast_depth(mesh, poses[..., k, :], rays, tri_chunk)
        depth = d if depth is None else jnp.minimum(depth, d)
    return depth


def make_rb_sensor(meshes, camera: CameraModel, beam_params: BeamParams,
                   occ_params: OcclusionParams, frame_rate: float = 30.0,
                   backend: str = "xla", tri_chunk: int = 512,
                   **backend_kwargs):
    """Build the loglik_fn closure for the particle filter.

    ``backend_kwargs`` forward to the backend factory (e.g. the pallas
    sensor's ``nb``, ``num_candidates``, ``radius``, ``interpret``).
    """
    if isinstance(meshes, TriangleMesh):
        meshes = [meshes]
    meshes = list(meshes)

    if backend == "pallas":
        from dbot_ros_tpu.ops.raycast_pallas import make_fused_sensor
        return make_fused_sensor(meshes, camera, beam_params, occ_params,
                                 frame_rate, **backend_kwargs)

    if backend == "deferred":
        # Large-particle-batch matmul path (ops/deferred.py): one exact
        # reference render per object at the particles' mean pose, then
        # candidate-set intersection for the whole batch; multi-object
        # scenes min-combine per-object deferred depths (the same
        # composition the exact path uses — mutual occlusion between
        # tracked objects is geometric).
        from dbot_ros_tpu.ops.deferred import make_deferred_renderer
        from dbot_ros_tpu.utils import se3
        renders = [
            make_deferred_renderer(m, camera.rays, camera.height,
                                   camera.width, tri_chunk=tri_chunk)
            for m in meshes]

        def loglik_fn(states, occ, z_obs, dt):
            depth = None
            for k, render in enumerate(renders):
                ref_k = se3.states_mean(states[:, k])[:7]
                d = render(ref_k, states[..., k, :7])
                depth = d if depth is None else jnp.minimum(depth, d)
            return image_loglik(depth, z_obs, occ, beam_params, occ_params,
                                dt_frames=dt * frame_rate)

        return loglik_fn

    if backend != "xla":
        raise ValueError(f"unknown sensor backend: {backend!r}")

    def loglik_fn(states, occ, z_obs, dt):
        from dbot_ros_tpu.ops.budget import xla_tri_chunk

        poses = states[..., :7]
        # particle count is static at trace time: degrade the triangle
        # chunk so the (P, N, chunk) scan intermediate fits (ref D14)
        chunk = xla_tri_chunk(states.shape[0], camera.num_pixels,
                              tri_chunk)
        depth = render_scene(meshes, poses, camera.rays, chunk)
        return image_loglik(depth, z_obs, occ, beam_params, occ_params,
                            dt_frames=dt * frame_rate)

    return loglik_fn
