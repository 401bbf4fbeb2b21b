"""CLI node executables (ref R1-R4 tracker/simulation nodes + R10 config).

Drives ``python -m dbot_ros_tpu {record,track,simulate}`` in-process
(conftest already pins the 8-device CPU backend) over a tiny box scene:
record a synthetic sequence to .npz, replay-track it with ground-truth
init and with --auto-init, and run the closed-loop simulate command.
"""

import json
import os

import numpy as np
import pytest

from dbot_ros_tpu.runtime.cli import main

_BOX_OBJ = "\n".join(
    [f"v {x} {y} {z}" for x, y, z in
     [(-0.04, -0.03, -0.025), (0.04, -0.03, -0.025), (0.04, 0.03, -0.025),
      (-0.04, 0.03, -0.025), (-0.04, -0.03, 0.025), (0.04, -0.03, 0.025),
      (0.04, 0.03, 0.025), (-0.04, 0.03, 0.025)]]
    + ["f 1 4 3 2", "f 5 6 7 8", "f 1 2 6 5", "f 3 4 8 7",
       "f 2 3 7 6", "f 1 5 8 4"])


@pytest.fixture
def config_path(tmp_path):
    obj = tmp_path / "box.obj"
    obj.write_text(_BOX_OBJ)
    conf = {
        "tracker": "particle",
        "object": {"meshes": [str(obj)]},
        "camera": {
            "camera_matrix": [48.0, 0, 16, 0, 48.0, 16, 0, 0, 1],
            "resolution": [32, 32],
            "downsampling_factor": 1,
        },
        "observation": {"model_sigma": 0.005, "sigma_factor": 0.0},
        "transition": {"linear_acceleration_sigma": 0.4,
                       "angular_acceleration_sigma": 2.0,
                       "damping": 4.0},
        "evaluation_count": 128,
        "max_kl_divergence": 0.8,
        "seed": 3,
    }
    p = tmp_path / "tracker.json"
    p.write_text(json.dumps(conf))
    return str(p)


def test_record_track_roundtrip(config_path, tmp_path, capsys):
    seq = str(tmp_path / "seq.npz")
    out = str(tmp_path / "states.jsonl")
    assert main(["record", "--config", config_path, "--output", seq,
                 "--frames", "12", "--distance", "0.6",
                 "--noise-sigma", "0.002"]) == 0
    data = np.load(seq)
    assert data["depth"].shape == (12, 32, 32)
    assert data["poses"].shape == (12, 1, 7)

    assert main(["track", "--config", config_path, "--input", seq,
                 "--output", out]) == 0
    printed = capsys.readouterr().out
    summary = json.loads(printed.strip().splitlines()[-1].split(": ", 1)[1])
    assert summary["frames"] == 12
    assert summary["position_rmse_m"] < 0.03

    with open(out) as fh:
        records = [json.loads(line) for line in fh]
    assert len(records) == 12
    assert set(records[0]) >= {"name", "frame", "position", "orientation"}
    assert abs(records[0]["position"][2] - 0.6) < 0.05


def test_track_auto_init(config_path, tmp_path, capsys):
    seq = str(tmp_path / "seq.npz")
    assert main(["record", "--config", config_path, "--output", seq,
                 "--frames", "10", "--distance", "0.6",
                 "--noise-sigma", "0.002"]) == 0
    # --init-budget: the production search-cost knob (and a suite-time
    # trim — the default 12,4,256,4 budget costs ~4x this on 2 CPUs);
    # the box's symmetries make any budget orientation-equivalent, so
    # the assertion is about locking on, not basin coverage
    assert main(["track", "--config", config_path, "--input", seq,
                 "--auto-init", "--init-budget", "6,2,96,2"]) == 0
    printed = capsys.readouterr().out
    summary = json.loads(printed.strip().splitlines()[-1].split(": ", 1)[1])
    # auto-init searches coarsely; just require it locked on and tracked
    assert summary["position_rmse_m"] < 0.08


def test_simulate_gate(config_path, capsys):
    assert main(["simulate", "--config", config_path, "--frames", "12",
                 "--distance", "0.6", "--noise-sigma", "0.002",
                 "--max-rmse", "0.05"]) == 0
    # an absurd gate fails with exit code 1
    assert main(["simulate", "--config", config_path, "--frames", "4",
                 "--distance", "0.6", "--max-rmse", "1e-9"]) == 1


def test_track_explicit_initial_pose_and_checkpoint(config_path, tmp_path):
    seq = str(tmp_path / "seq.npz")
    ckpt = str(tmp_path / "belief.npz")  # np.savez appends .npz otherwise
    main(["record", "--config", config_path, "--output", seq,
          "--frames", "8", "--distance", "0.6"])
    assert main(["track", "--config", config_path, "--input", seq,
                 "--initial-pose", "0 0 0.6 1 0 0 0",
                 "--checkpoint", ckpt, "--checkpoint-every", "4"]) == 0
    assert os.path.exists(ckpt)


def test_example_configs_parse():
    """The committed examples/ configs (the reference's config/*.yaml
    analog, R10) must load into valid tracker configs."""
    import os

    from dbot_ros_tpu import config as cfg

    root = os.path.join(os.path.dirname(__file__), "..", "examples")
    pc = cfg.load_config(os.path.join(root, "particle_tracker.yaml"))
    assert isinstance(pc, cfg.ParticleTrackerConfig)
    assert pc.evaluation_count == 10000 and pc.backend == "pallas"
    gc = cfg.load_config(os.path.join(root, "gaussian_tracker.yaml"))
    assert isinstance(gc, cfg.GaussianTrackerConfig)
    assert gc.occlusion_memory and gc.update_iterations == 6
    # the JSON twins (no pyyaml needed) hold the same configurations
    assert cfg.load_config(os.path.join(root, "particle_tracker.json")) == pc
    assert cfg.load_config(os.path.join(root, "gaussian_tracker.json")) == gc
