"""Headline benchmark: particle-likelihood evaluations per second per chip,
plus the full RBC-PF filter-step latencies (north star #2).

Measures the fused hot path of the flagship tracker — per-particle depth
rendering + beam likelihood + Rao-Blackwellized occlusion update — at the
reference's north-star operating point (BASELINE.md): 10,000 particles,
80×60 depth frame (640×480 downsampled by 8), reference-class mesh.

The headline counts all 4800 pixels for every particle, though the
sensor's compaction ladder evaluates only the pixels near the object
(448 at this scene's tight level), so it is not a count of work done.
10k particles × 4800 px × 30 Hz = 1.44e9/s is the rate this operating
point needs (BASELINE.md row 2), not a measured throughput of the
reference, so no ratio against it is printed.

The extra ``full_step`` object checks north star #2 (≥10k particles @
30 Hz): rbcpf_step latency/Hz with resampling never / every-frame /
KL-triggered (the production trigger).

Runs on one GPU (the fused kernel compiled, never interpreted) and fails
without one; any failing leg fails the run. Prints the device line and
then exactly one JSON line. Its numbers are information, not a claim:
no benchmark cell is defined yet.
"""

import functools
import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp

P = 10_000
DOWNSAMPLING = 8  # 640x480 / 8 -> 80x60 = 4800 px (reference default)


def main():
    from dbot_ros_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX backend is "
                 f"{jax.default_backend()!r}")
    dev = jax.devices()[0]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}"
          f"; {card}", flush=True)

    from dbot_ros_tpu.filters import rbcpf
    from dbot_ros_tpu.models import beam, occlusion, transition
    from dbot_ros_tpu.models.sensor import make_rb_sensor
    from dbot_ros_tpu.ops.raycast import raycast_depth
    from dbot_ros_tpu.utils import se3
    from dbot_ros_tpu.utils.camera import default_kinect_camera
    from dbot_ros_tpu.utils.mesh import icosphere_mesh

    cam = default_kinect_camera(DOWNSAMPLING)
    n_pix = cam.num_pixels
    # Reference-class object mesh: ~1.3k triangles, fist-sized.
    mesh = icosphere_mesh(radius=0.06, subdivisions=3)

    bp = beam.make_beam_params()
    op = occlusion.make_occlusion_params()
    tp = transition.make_transition_params(0.1, 0.5, damping=4.0)
    sensor = make_rb_sensor(mesh, cam, bp, op, backend="pallas")

    key = jax.random.PRNGKey(0)
    ref = jnp.concatenate([jnp.array([0.0, 0.0, 0.8]), se3.quat_identity()])
    k1, k2 = jax.random.split(key)
    dpos = 0.01 * jax.random.normal(k1, (P, 3))
    states = jnp.zeros((P, 1, 13), jnp.float32)
    states = states.at[:, 0, :3].set(ref[:3] + dpos)
    states = states.at[:, 0, 3:7].set(ref[3:7])

    z_true = raycast_depth(mesh, ref, cam.rays)
    z_obs = jnp.where(jnp.isfinite(z_true), z_true, 2.0)
    occ = (sensor.init_occlusion(P, 0.1)
           if hasattr(sensor, "init_occlusion")
           else jnp.full((P, n_pix), 0.1))

    # Donate the occlusion state: it feeds back frame-to-frame exactly as
    # in the tracker (whose step donates the whole belief).
    step = jax.jit(lambda s, o, z: sensor(s, o, z, 1.0 / 30.0),
                   donate_argnums=(1,))

    # Warmup / compile (occ is donated — carry the new handle).
    ll, occ = step(states, occ, z_obs)
    ll.block_until_ready()

    # Min over repeated timing windows (host dispatch jitter varies a
    # single window's reading; the minimum is the de-noised estimator).
    iters = 20
    windows = 3

    def timed_window():
        nonlocal occ
        t0 = time.perf_counter()
        for _ in range(iters):
            ll, o = step(states, occ, z_obs)
            occ = o
        ll.block_until_ready()
        return (time.perf_counter() - t0) / iters

    dt = min(timed_window() for _ in range(windows))
    evals_per_s = P * n_pix / dt

    # --- north star #2: full filter-step latency (never / always / KL)
    full_step = {}
    for max_kl, tag in ((1e9, "never"), (-1.0, "always"), (1.0, "kl")):
        belief = rbcpf.init_belief(jax.random.PRNGKey(0), ref, P,
                                   n_pix, sensor=sensor)
        fstep = jax.jit(functools.partial(
            rbcpf.rbcpf_step, loglik_fn=sensor, trans_params=tp,
            dt=1.0 / 30.0, max_kl_divergence=max_kl),
            donate_argnums=(0,))
        belief, info = fstep(belief, z_obs)
        jax.block_until_ready(info.mean_state)

        def fwindow():
            nonlocal belief, info
            t0 = time.perf_counter()
            for _ in range(iters):
                belief, info = fstep(belief, z_obs)
            # block on the WHOLE belief: waiting on mean_state alone
            # under-synchronizes (the final step's occlusion outputs may
            # still be in flight)
            jax.block_until_ready(belief)
            return (time.perf_counter() - t0) / iters

        ms = 1e3 * min(fwindow() for _ in range(windows))
        full_step[tag] = {"ms": round(ms, 3), "hz": round(1e3 / ms, 1)}

    # --- axis-size-1 shard_map step vs the plain step above: the
    # distributed machinery on one card (the cond-free resample,
    # docs/SCALING.md).
    from dbot_ros_tpu.parallel import dist_filter

    mesh1 = dist_filter.make_particle_mesh(1)
    dbelief = dist_filter.init_distributed_belief(
        jax.random.PRNGKey(0), ref, P, mesh1, n_pix, sensor=sensor)
    dstep = dist_filter.make_distributed_step(
        mesh1, sensor, tp, 1.0 / 30.0, max_kl_divergence=1.0)
    dbelief, dms, dess = dstep(dbelief, z_obs)
    jax.block_until_ready((dbelief, dms))

    def dwindow():
        nonlocal dbelief
        t0 = time.perf_counter()
        for _ in range(iters):
            dbelief, dms, dess = dstep(dbelief, z_obs)
        jax.block_until_ready((dbelief, dms))
        return (time.perf_counter() - t0) / iters

    dms_ms = 1e3 * min(dwindow() for _ in range(windows))
    dist_axis1 = {"ms": round(dms_ms, 3),
                  "vs_plain_kl": round(dms_ms / full_step["kl"]["ms"], 3)}

    # --- the second estimator: chained GF step (deferred sigma renders)
    # at the production frame size on the same mesh.
    from dbot_ros_tpu.filters import rgf
    from dbot_ros_tpu.ops.deferred import make_sigma_renderer

    render_fn = make_sigma_renderer([mesh], cam.rays, cam.height,
                                    cam.width)
    gstep = jax.jit(functools.partial(
        rgf.rgf_step, render_fn=render_fn, trans_params=tp,
        dt=1.0 / 30.0, bp=bp, iterations=6, trust_sigma=1.5,
        occ_params=op), donate_argnums=(0,))
    gbelief = rgf.init_belief(jax.random.PRNGKey(0), ref,
                              num_pixels=n_pix, first_frame=z_obs,
                              initial_occlusion_prob=0.1)
    gbelief, ginfo = gstep(gbelief, z_obs)
    jax.block_until_ready((gbelief, ginfo))

    def gwindow():
        nonlocal gbelief, ginfo
        t0 = time.perf_counter()
        for _ in range(iters):
            gbelief, ginfo = gstep(gbelief, z_obs)
        jax.block_until_ready((gbelief, ginfo))
        return (time.perf_counter() - t0) / iters

    gms = 1e3 * min(gwindow() for _ in range(windows))
    rgf_leg = {"ms": round(gms, 3), "hz": round(1e3 / gms, 1)}

    data = {
        "metric": "particle_likelihood_evals_per_s_per_chip",
        "value": float(evals_per_s),
        "unit": "particle-pixel evals/s",
        "full_step": full_step,
        "dist_axis1_kl": dist_axis1,
        "rgf_step": rgf_leg,
        "north_star_10k_30hz": full_step["kl"]["hz"] >= 30.0,
    }
    data["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices()), "card": card}
    print(json.dumps(data))


if __name__ == "__main__":
    main()
