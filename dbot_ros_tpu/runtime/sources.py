"""Depth-frame sources: recorded replay and synthetic simulation.

Replaces the reference's camera plumbing and simulation fixtures:
  * ``RosCameraDataProvider`` (R7) → :class:`ReplaySource` over npz/npy
    depth stacks (the rosbag-replay analog — SURVEY.md §4 system tests);
  * ``VirtualCameraDataProvider`` + the ``*_simulation_node`` ground-truth
    renderers (R3/R4, D6) → :class:`SyntheticSource`, which renders a
    scripted ground-truth trajectory through the production raycaster and
    adds sensor noise/dropout — the closed-loop integration fixture.

Sources iterate (frame_index, depth_image, ground_truth_pose | None).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import jax
import jax.numpy as jnp
import numpy as np

from dbot_ros_tpu.ops.raycast import render_depth_image
from dbot_ros_tpu.utils import se3
from dbot_ros_tpu.utils.camera import CameraModel
from dbot_ros_tpu.utils.mesh import TriangleMesh


@dataclasses.dataclass
class Frame:
    index: int
    depth: np.ndarray                       # (H, W) float32, NaN = invalid
    ground_truth: Optional[np.ndarray] = None  # (K, 7) model-frame poses
    # frames dropped since the last one; None = pull source (the count
    # is only meaningful for push sources like ThreadedSource)
    skipped: Optional[int] = None


class ReplaySource:
    """Replay a recorded depth sequence from .npz/.npy.

    Accepted layouts:
      * .npz with `depth` (T, H, W) and optional `poses` (T, K, 7);
      * .npy with just the (T, H, W) depth stack.
    Depth in meters, NaN/0/negative = invalid.
    """

    def __init__(self, path: str):
        if str(path).endswith(".npz"):
            data = np.load(path)
            self.depth = np.asarray(data["depth"], np.float32)
            self.poses = (np.asarray(data["poses"], np.float32)
                          if "poses" in data else None)
        else:
            self.depth = np.asarray(np.load(path), np.float32)
            self.poses = None
        if self.depth.ndim != 3:
            raise ValueError(f"depth stack must be (T, H, W), "
                             f"got {self.depth.shape}")

    def __len__(self):
        return self.depth.shape[0]

    def __iter__(self) -> Iterator[Frame]:
        for t in range(len(self)):
            gt = self.poses[t] if self.poses is not None else None
            yield Frame(t, self.depth[t], gt)


def record_npz(path: str, depth_stack, poses=None):
    """Write a replay file (the rosbag-record analog)."""
    arrays = {"depth": np.asarray(depth_stack, np.float32)}
    if poses is not None:
        arrays["poses"] = np.asarray(poses, np.float32)
    np.savez_compressed(path, **arrays)


class OracleSource:
    """Independent-renderer evaluation source (no inverse crime).

    Like :class:`SyntheticSource` but renders through
    ``ops.raycast.raycast_oracle`` — an independently-derived textbook
    Möller–Trumbore path that shares no code with the production
    raycaster/kernels the trackers use — so closed-loop RMSE numbers
    measure the tracker against *external* geometry, the way the
    reference is validated against recorded sequences (SURVEY.md §4
    system tier). Adds the papers' stress protocols:

      * ``occluder`` + ``occluder_fn(t) → (7,)``: an untracked occluder
        mesh rendered in front of the scene (min-combined) — the
        moving-occluder sweep of Wüthrich 2013 / Issac 2016;
      * ``dropout_frames=(a, b)``: ``dropout_prob`` applies only inside
        the frame window — sensor-dropout bursts;
      * ``noise_sigma``: Gaussian depth noise.

    The occluder is NOT part of the ground truth — the tracked objects'
    poses are returned unchanged; the latent occlusion chain has to
    absorb it.
    """

    def __init__(self, meshes, camera: CameraModel, trajectory_fn,
                 num_frames: int, noise_sigma: float = 0.003,
                 background_depth: float = 2.0, seed: int = 0,
                 occluder: TriangleMesh = None, occluder_fn=None,
                 dropout_prob: float = 0.0, dropout_frames=None,
                 edge_artifacts: float = 0.0, edge_threshold: float = 0.03,
                 quantize_mm: bool = False):
        """Extra realism knobs (SURVEY §4 acceptance tier —
        Kinect-class artifact models):

          * ``edge_artifacts``: probability that a pixel adjacent to a
            depth discontinuity (> ``edge_threshold`` m vs a 4-neighbor)
            misbehaves — half the draws return NaN (edge shadow: the
            structured-light correlator fails at silhouette boundaries),
            the other half return a neighboring surface's depth (flying
            pixels / lateral noise);
          * ``quantize_mm``: round depth to whole millimeters — the u16
            sensor transport quantization (pair with
            :class:`U16CameraAdapter` to exercise the full native
            conversion pipeline).
        """
        from dbot_ros_tpu.ops.raycast import raycast_oracle
        from dbot_ros_tpu.trackers.base import to_center_frame

        if isinstance(meshes, TriangleMesh):
            meshes = [meshes]
        self.meshes = list(meshes)
        self.camera = camera
        self.trajectory_fn = trajectory_fn
        self.num_frames = num_frames
        self.key = jax.random.PRNGKey(seed)
        self.occluder = occluder
        self.occluder_fn = occluder_fn
        self.dropout_prob = dropout_prob
        self.dropout_frames = dropout_frames

        def render(poses_model, occ_pose, dropout_p, key):
            depth = None
            for k, mesh in enumerate(self.meshes):
                pc = to_center_frame(poses_model[k], mesh.center)
                d = raycast_oracle(mesh, pc, camera.rays)
                depth = d if depth is None else jnp.minimum(depth, d)
            if occluder is not None:
                d = raycast_oracle(occluder, occ_pose, camera.rays)
                depth = jnp.minimum(depth, d)
            z = jnp.where(jnp.isfinite(depth), depth,
                          jnp.float32(background_depth))
            k1, k2, k3, k4, k5 = jax.random.split(key, 5)
            if noise_sigma > 0:
                z = z + noise_sigma * jax.random.normal(k1, z.shape)
            if edge_artifacts > 0:
                z2 = z.reshape(camera.height, camera.width)
                shift = [jnp.roll(z2, s, axis=a)
                         for a in (0, 1) for s in (1, -1)]
                edge = jnp.zeros_like(z2, bool)
                for nb in shift:
                    edge = edge | (jnp.abs(z2 - nb) > edge_threshold)
                hit = jax.random.bernoulli(k3, edge_artifacts, z2.shape)
                mode = jax.random.bernoulli(k4, 0.5, z2.shape)
                # flying pixel: adopt a random (vertical or lateral)
                # neighbor's depth — the neighbor choice needs its OWN
                # key, or the shadow/fly select masks one arm
                nb_v = jax.random.bernoulli(k5, 0.5, z2.shape)
                fly = jnp.where(nb_v, shift[0], shift[2])
                z2 = jnp.where(edge & hit,
                               jnp.where(mode, fly, jnp.nan), z2)
                z = z2.reshape(-1)
            drop = jax.random.bernoulli(k2, dropout_p, z.shape)
            z = jnp.where(drop, jnp.nan, z)
            if quantize_mm:
                z = jnp.round(z * 1000.0) / 1000.0
            return z

        self._render = jax.jit(render)

    def __len__(self):
        return self.num_frames

    def __iter__(self) -> Iterator[Frame]:
        idq = np.array([1.0, 0, 0, 0], np.float32)
        far = jnp.concatenate(
            [jnp.array([0.0, 0.0, -10.0]), jnp.asarray(idq)])
        for t in range(self.num_frames):
            poses = jnp.asarray(self.trajectory_fn(t), jnp.float32)
            if poses.ndim == 1:
                poses = poses[None]
            occ_pose = (jnp.asarray(self.occluder_fn(t), jnp.float32)
                        if self.occluder_fn is not None else far)
            p_drop = self.dropout_prob
            if self.dropout_frames is not None:
                a, b = self.dropout_frames
                p_drop = p_drop if a <= t < b else 0.0
            self.key, k = jax.random.split(self.key)
            z = self._render(poses, occ_pose, jnp.float32(p_drop), k)
            yield Frame(t, np.asarray(z), np.asarray(poses))


class SyntheticSource:
    """Render a scripted ground-truth trajectory into noisy depth frames.

    trajectory_fn(t: int) → (K, 7) model-frame poses (host-side python).
    """

    def __init__(self, meshes, camera: CameraModel, trajectory_fn,
                 num_frames: int, noise_sigma: float = 0.003,
                 dropout_prob: float = 0.0, background_depth: float = 2.0,
                 seed: int = 0):
        if isinstance(meshes, TriangleMesh):
            meshes = [meshes]
        self.meshes = list(meshes)
        self.camera = camera
        self.trajectory_fn = trajectory_fn
        self.num_frames = num_frames
        self.noise_sigma = noise_sigma
        self.dropout_prob = dropout_prob
        self.background_depth = background_depth
        self.key = jax.random.PRNGKey(seed)

        from dbot_ros_tpu.trackers.base import to_center_frame

        def render(poses_model, key):
            depth = None
            for k, mesh in enumerate(self.meshes):
                pc = to_center_frame(poses_model[k], mesh.center)
                d = render_depth_image(mesh, pc, camera)
                depth = d if depth is None else jnp.minimum(depth, d)
            z = jnp.where(jnp.isfinite(depth), depth,
                          jnp.float32(background_depth))
            k1, k2 = jax.random.split(key)
            if noise_sigma > 0:
                z = z + noise_sigma * jax.random.normal(k1, z.shape)
            if dropout_prob > 0:
                drop = jax.random.bernoulli(k2, dropout_prob, z.shape)
                z = jnp.where(drop, jnp.nan, z)
            return z

        self._render = jax.jit(render)

    def __len__(self):
        return self.num_frames

    def __iter__(self) -> Iterator[Frame]:
        for t in range(self.num_frames):
            poses = jnp.asarray(self.trajectory_fn(t), jnp.float32)
            if poses.ndim == 1:
                poses = poses[None]
            self.key, k = jax.random.split(self.key)
            z = self._render(poses, k)
            yield Frame(t, np.asarray(z), np.asarray(poses))


class ThreadedSource:
    """Push-based frame ingestion decoupled from tracking (ref R5/P4).

    The reference's camera is a ROS subscriber callback on its own
    thread, decoupled from the tracking loop so a slow tracker never
    blocks the driver and always sees the freshest frame
    (``ObjectTrackerRos`` run-loop). Here the decoupling is the native
    SPSC ``native.FrameRing`` (drop-oldest): a producer — either an
    internal thread replaying ``inner``, or any external camera thread
    calling :meth:`push` — writes frames into the ring; iteration pops
    the LATEST frame and reports how many were dropped since the last
    pop (``Frame.skipped`` → the skipped-frame metric).

    Modes:
      * ``ThreadedSource(inner, rate_hz=...)`` — replay an iterable
        source from a producer thread at ``rate_hz`` (None = flat out;
        the tracker keeps up only with the freshest frames);
      * ``ThreadedSource(frame_shape=(H, W))`` — externally-driven: a
        camera callback calls ``push(depth, ...)`` and ``close()``.
    """

    def __init__(self, inner=None, frame_shape=None, capacity: int = 8,
                 rate_hz: Optional[float] = None):
        import threading

        if inner is None and frame_shape is None:
            raise ValueError("need an inner source or a frame_shape")
        self.inner = inner
        self.rate_hz = rate_hz
        self.capacity = capacity
        self.skipped_total = 0
        self._gt = {}
        self._gt_lock = threading.Lock()
        self._count = 0
        self._max_pushed = -1
        self._last_idx = -1
        self._done = threading.Event()
        self._started = False
        self._ring = None
        if frame_shape is not None:
            from dbot_ros_tpu.native import FrameRing
            self._ring = FrameRing(tuple(frame_shape), capacity)

    def push(self, depth, index: Optional[int] = None, ground_truth=None):
        """Producer side (any thread): enqueue a frame, drop-oldest."""
        depth = np.ascontiguousarray(depth, np.float32)
        if self._ring is None:
            from dbot_ros_tpu.native import FrameRing
            self._ring = FrameRing(depth.shape, self.capacity)
        # auto-index = max-seen + 1, so producers may mix explicit and
        # implicit indices without collisions corrupting the
        # index-continuity skipped-frame accounting (advisor r4)
        if index is None:
            index = self._max_pushed + 1
        self._max_pushed = max(self._max_pushed, int(index))
        if ground_truth is not None:
            with self._gt_lock:
                self._gt[int(index)] = np.asarray(ground_truth)
        self._ring.push(depth, float(index))
        self._count += 1

    def close(self):
        """Producer side: no more frames will be pushed."""
        self._done.set()

    def _producer(self):
        import time as _time

        try:
            for fr in self.inner:
                self.push(fr.depth, fr.index, fr.ground_truth)
                if self.rate_hz:
                    _time.sleep(1.0 / self.rate_hz)
        finally:
            self._done.set()

    def __iter__(self) -> Iterator[Frame]:
        import threading
        import time as _time

        if self.inner is not None and not self._started:
            self._started = True
            threading.Thread(target=self._producer, daemon=True).start()
        while True:
            item = self._ring.pop_latest() if self._ring is not None \
                else None
            if item is None:
                if self._done.is_set() and (
                        self._ring is None or len(self._ring) == 0):
                    return
                _time.sleep(0.001)
                continue
            depth, stamp, _ring_skips = item
            idx = int(stamp)
            # index continuity counts EVERY drop — ring-overwrite at push
            # time as well as stale frames skipped at pop time
            skipped = max(idx - self._last_idx - 1, 0)
            self._last_idx = idx
            self.skipped_total += skipped
            with self._gt_lock:
                gt = self._gt.pop(idx, None)
                # prune ground truths of dropped frames (in place — the
                # producer thread may be inserting concurrently)
                for k in [k for k in self._gt if k < idx]:
                    del self._gt[k]
            yield Frame(idx, depth, gt, skipped=skipped)


class U16CameraAdapter:
    """The reference's camera transport pipeline, end to end (R7/R8).

    Wraps a native-resolution source of float-meter frames and applies
    what ``RosCameraDataProvider`` + ``ri::to_eigen`` do to a real
    Kinect stream: float meters → **uint16 millimeters** (the sensor
    wire format: quantization + 0 = invalid) → the native
    ``preprocess_depth_u16`` conversion (C++ strided downsample,
    mm → m, 0 → NaN). The tracker downstream sees exactly what it
    would see from recorded sensor data.

    The inner source renders at ``downsampling ×`` the tracker camera's
    resolution (build it with a scaled-up camera); ground truth passes
    through untouched.
    """

    def __init__(self, inner, downsampling: int):
        self.inner = inner
        self.downsampling = int(downsampling)

    def __len__(self):
        return len(self.inner)

    def __iter__(self) -> Iterator[Frame]:
        from dbot_ros_tpu.native import preprocess_depth_u16

        for fr in self.inner:
            cam = getattr(self.inner, "camera", None)
            d = np.asarray(fr.depth, np.float32)
            if d.ndim == 1:
                if cam is None:
                    raise ValueError(
                        "U16CameraAdapter needs (H, W) frames, or an "
                        "inner source with a .camera to reshape flat "
                        "frames")
                d = d.reshape(cam.height, cam.width)
            mm = np.round(d * 1000.0)
            mm = np.where(np.isfinite(mm) & (mm > 0) & (mm < 65536),
                          mm, 0.0).astype(np.uint16)
            depth = preprocess_depth_u16(mm, self.downsampling)
            yield Frame(fr.index, depth, fr.ground_truth,
                        getattr(fr, "skipped", None))


def scale_camera(camera: CameraModel, factor: int) -> CameraModel:
    """A camera with ``factor``× the resolution/intrinsics — the native
    sensor grid whose strided downsample lands back on ``camera``."""
    from dbot_ros_tpu.utils.camera import make_camera

    K = np.asarray(camera.camera_matrix, np.float64).copy()
    K[:2, :] *= factor
    return make_camera(K, camera.height * factor, camera.width * factor)
