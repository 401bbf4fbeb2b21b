"""Memory budgeting (ref D14 BufferConfiguration) + profiling helpers."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest

from dbot_ros_tpu.ops import budget
from dbot_ros_tpu.utils.profiling import Stopwatch, measure, pv


def test_estimate_scales_linearly_in_particles():
    e1 = budget.estimate_memory(1000, 4800, 1408)
    e2 = budget.estimate_memory(2000, 4800, 1408)
    assert e2.total_bytes > 1.8 * e1.total_bytes
    assert e1.belief_bytes == 1000 * 13 * 4 + 1000 * 4 + 1000 * 4800 * 4


class _Card:
    """A device as a JAX GPU process reports it: 60 GB = three quarters
    of an 80 GB card, the share the allocator reserves by default."""

    def memory_stats(self):
        return {"bytes_limit": 60 * 1024 ** 3}


class _NoStats:
    def memory_stats(self):
        return None


def test_max_particles_fits_budget():
    card = _Card()
    mp = budget.max_particles(4800, 1408, backend="pallas", device=card)
    est = budget.estimate_memory(mp, 4800, 1408, backend="pallas")
    assert est.total_bytes <= budget.device_memory_bytes(card) * 0.6
    # and the next doubling would not fit
    est2 = budget.estimate_memory(mp * 2, 4800, 1408, backend="pallas")
    assert est2.total_bytes > budget.device_memory_bytes(card) * 0.6
    assert mp >= 10_000  # the north-star config fits comfortably


def test_check_fit_warns_when_oversized():
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        budget.check_fit(1 << 21, 4800, 1408, device=_Card())
        assert any("HBM" in str(x.message) for x in w)


def test_device_memory_requires_reported_limit():
    """No guessed capacity: a device without a memory limit (the CPU)
    is an error, not a default."""
    assert budget.device_memory_bytes(_Card()) == 60 * 1024 ** 3
    with pytest.raises(ValueError, match="no memory limit"):
        budget.device_memory_bytes(_NoStats())


def test_stopwatch_and_measure(capsys):
    sw = Stopwatch()
    x = jnp.ones((8, 8)).sum()
    dt = sw.measure("toy", x)
    assert dt >= 0
    with measure("ctx") as out:
        out.append(jnp.zeros((4,)) + 1)
    pv("v", 3)
    text = capsys.readouterr().out
    assert "toy:" in text and "ctx:" in text and "v: 3" in text


def test_rgf_pixel_stride_degrade():
    """GF degrade-to-fit (ref D14 analog): stride grows with the work of
    the sigma renderer in use, 1 for small problems, capped;
    GaussianTracker honors pixel_stride=0=auto."""
    import pytest

    from dbot_ros_tpu.ops.budget import rgf_pixel_stride

    assert rgf_pixel_stride(400, 128, sigma_backend="exact") == 1
    s1 = rgf_pixel_stride(4800, 1408, sigma_backend="exact")
    s3 = rgf_pixel_stride(4800, 1408, num_objects=3, sigma_backend="exact")
    assert s1 > 1 and s3 >= s1
    assert rgf_pixel_stride(4800 * 64, 4096 * 16,
                            sigma_backend="exact") <= 64  # capped
    # deferred (the default renderer) tests 6 candidates per pixel, not
    # every triangle: the 80×60 frame keeps every pixel, even with 3
    # objects; full 640×480 resolution degrades
    assert rgf_pixel_stride(4800, 1408) == 1
    assert rgf_pixel_stride(4800, 1408, num_objects=3) == 1
    d1 = rgf_pixel_stride(4800 * 64, 1408)
    assert 1 < d1 < rgf_pixel_stride(4800 * 64, 1408, num_objects=3)
    with pytest.raises(ValueError, match="sigma_backend"):
        rgf_pixel_stride(4800, 1408, sigma_backend="raster")

    import numpy as np
    from dbot_ros_tpu import config as cfg
    from dbot_ros_tpu.trackers.gaussian import GaussianTracker
    from dbot_ros_tpu.utils.camera import default_kinect_camera, make_camera
    from dbot_ros_tpu.utils.mesh import box_mesh, icosphere_mesh

    K = np.array([[48.0, 0, 16], [0, 48.0, 16], [0, 0, 1.0]])
    cam = make_camera(K, 32, 32)
    conf = cfg.GaussianTrackerConfig(pixel_stride=0)
    tr = GaussianTracker(conf, meshes=[box_mesh(0.06, 0.05, 0.04)],
                         camera=cam)
    # tiny problem → auto keeps every pixel
    assert tr._pixel_idx is None
    # the example config's operating point (80×60, 1280-triangle
    # icosphere, deferred sigma renders) keeps every pixel; the exact
    # scan there degrades
    ico = icosphere_mesh(radius=0.06, subdivisions=3)
    kin = default_kinect_camera(8)
    tr = GaussianTracker(conf, meshes=[ico], camera=kin)
    assert tr._pixel_idx is None
    tr = GaussianTracker(cfg.GaussianTrackerConfig(
        pixel_stride=0, sigma_backend="exact"), meshes=[ico], camera=kin)
    assert tr._pixel_idx is not None and tr._pixel_idx[1] > 1


def test_xla_tri_chunk_degrades_with_particles():
    from dbot_ros_tpu.ops.budget import xla_tri_chunk

    # small batches keep the requested chunk
    assert xla_tri_chunk(512, 1200, 512) == 512
    # 8192 x 1200 px: 512-chunk would need 20 GB -> shrink under 2 GB
    c = xla_tri_chunk(8192, 1200, 512)
    assert c < 512
    assert 8192 * 1200 * c * 4 <= 2 * 1024 ** 3
    assert c % 16 == 0 and c >= 16
    # never below the floor
    assert xla_tri_chunk(10 ** 7, 10 ** 5, 512) == 16


def test_xla_tri_chunk_nonpositive_request_means_auto():
    from dbot_ros_tpu.ops.budget import xla_tri_chunk

    assert xla_tri_chunk(512, 1200, 0) >= 16       # auto, never 0
    assert xla_tri_chunk(512, 1200, -3) >= 16
    assert xla_tri_chunk(512, 1200, 8) == 8        # tiny explicit honored
