"""Device-memory budgeting for particle configurations.

Replaces ``dbot/gpu/buffer_configuration.h`` (D14): the reference checks
GPU texture/memory limits and degrades the particle count to fit. The
analog here estimates the device-memory footprint of a tracker
configuration (belief
pytree + per-frame constants + kernel workspaces) against the chip's
capacity and recommends the largest particle count that fits.
"""

from __future__ import annotations

import dataclasses

import jax


@dataclasses.dataclass
class MemoryEstimate:
    belief_bytes: int          # states + weights + occlusion map
    constants_bytes: int       # per-frame transformed triangle slabs
    workspace_bytes: int       # transposes/intermediates (pallas path)
    total_bytes: int

    def human(self) -> str:
        return (f"belief={self.belief_bytes / 1e6:.0f}MB "
                f"constants={self.constants_bytes / 1e6:.0f}MB "
                f"workspace={self.workspace_bytes / 1e6:.0f}MB "
                f"total={self.total_bytes / 1e6:.0f}MB")


def _round_up(x, m):
    return (x + m - 1) // m * m


def estimate_memory(num_particles: int, num_pixels: int,
                    padded_triangles: int, num_objects: int = 1,
                    backend: str = "pallas") -> MemoryEstimate:
    p = num_particles
    belief = p * num_objects * 13 * 4 + p * 4 + p * num_pixels * 4
    if backend in ("pallas", "deferred"):
        p_pad = _round_up(p, 128)
        constants = padded_triangles * 10 * p_pad * 4
    else:
        constants = padded_triangles * 10 * p * 4  # G + t_num per chunk
    if backend == "pallas":
        n_pad = _round_up(num_pixels, 64)
        workspace = 2 * n_pad * _round_up(p, 128) * 4  # occ relayouts
    elif backend == "deferred":
        workspace = num_pixels * p * 10 * 4            # selected constants
    else:
        workspace = num_pixels * p * 4                 # depth images
    total = belief + constants + workspace
    return MemoryEstimate(belief, constants, workspace, total)


def device_memory_bytes(device=None) -> int:
    """Memory the (first) device's allocator may use, from its
    ``memory_stats()["bytes_limit"]`` (on a GPU: the share of the card
    this process reserved). Raises for a device that reports none."""
    d = device or jax.devices()[0]
    stats = d.memory_stats()
    if not stats or "bytes_limit" not in stats:
        raise ValueError(
            f"device {d} reports no memory limit; pass an explicit "
            f"budget (estimate_memory) instead")
    return int(stats["bytes_limit"])


def max_particles(num_pixels: int, padded_triangles: int,
                  num_objects: int = 1, backend: str = "pallas",
                  memory_fraction: float = 0.6,
                  device=None) -> int:
    """Largest particle count whose footprint fits in the budget.

    Mirrors BufferConfiguration's degrade-to-fit behavior: callers pass
    their requested ``evaluation_count`` through
    ``min(requested, max_particles(...))``.
    """
    budget = device_memory_bytes(device) * memory_fraction
    lo, hi = 128, 1 << 22
    while lo < hi:
        mid = (lo + hi + 1) // 2
        est = estimate_memory(mid, num_pixels, padded_triangles,
                              num_objects, backend)
        if est.total_bytes <= budget:
            lo = mid
        else:
            hi = mid - 1
    return lo


def check_fit(num_particles: int, num_pixels: int, padded_triangles: int,
              num_objects: int = 1, backend: str = "pallas",
              device=None) -> MemoryEstimate:
    """Estimate + warn (returns the estimate either way)."""
    est = estimate_memory(num_particles, num_pixels, padded_triangles,
                          num_objects, backend)
    cap = device_memory_bytes(device)
    if est.total_bytes > 0.9 * cap:
        import warnings
        warnings.warn(
            f"particle configuration needs {est.total_bytes / 1e9:.1f} GB "
            f"of ~{cap / 1e9:.0f} GB HBM ({est.human()}); consider "
            f"max_particles() to degrade-to-fit", RuntimeWarning)
    return est


def rgf_pixel_stride(num_pixels: int, padded_triangles: int,
                     num_objects: int = 1, iterations: int = 3,
                     sigma_backend: str = "deferred",
                     num_candidates: int = 6,
                     budget_gflops: float = 5.0, max_stride: int = 64
                     ) -> int:
    """Degrade-to-fit for the Gaussian tracker (the GF analog of ref D14).

    The RGF's per-frame cost that the stride cuts is the sigma-point
    render: (2·12K+1) sigma poses × pixels × the triangles each pixel
    tests, repeated for each iterated update. ``sigma_backend`` names
    the renderer in use (GaussianTrackerConfig.sigma_backend): the
    ``"exact"`` scan tests every padded triangle (ops/raycast.py); the
    ``"deferred"`` pass tests ``num_candidates`` per object
    (ops/deferred.make_sigma_renderer). The deferred pass's one exact
    scan at the mean covers the full grid whatever the stride, so it is
    not counted. Returns the smallest power-of-two ``pixel_stride`` that
    keeps the estimate under ``budget_gflops`` (≈60 flops per
    ray-triangle test).
    """
    n_sigma = 2 * 12 * num_objects + 1
    if sigma_backend == "exact":
        tests = padded_triangles
    elif sigma_backend == "deferred":
        tests = num_objects * num_candidates
    else:
        raise ValueError(f"unknown sigma_backend {sigma_backend!r}")
    per_px = n_sigma * tests * (iterations + 1) * 60
    total = per_px * num_pixels
    stride = 1
    while (total / stride > budget_gflops * 1e9
           and stride < max_stride):
        stride *= 2
    return stride


def xla_tri_chunk(num_particles: int, num_pixels: int,
                  requested: int = 512,
                  budget_bytes: int = 2 * 1024 ** 3,
                  min_chunk: int = 16) -> int:
    """Degrade the exact raycaster's triangle-chunk to the particle count.

    The XLA backend's chunked scan materializes a (P, N, chunk) f32
    intermediate; a fixed chunk that is fine at 2k particles OOMs at 8k
    (measured: 512-chunk × 8192 × 1200 px = 20 GB). Shrink the chunk so
    the intermediate stays under ``budget_bytes`` — the per-frame FLOPs
    are unchanged, only the scan gets more steps (ref D14
    BufferConfiguration's degrade-to-fit, applied to the CPU-path
    analog)."""
    per_chunk = max(num_particles * num_pixels * 4, 1)
    fit = int(budget_bytes // per_chunk)
    degraded = max(min_chunk, (fit // 16) * 16)
    requested = int(requested)
    if requested <= 0:                  # non-positive = "auto"
        return degraded
    # degrade-only: never raise an explicitly tiny (but valid) request
    return min(requested, degraded)
