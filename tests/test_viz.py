"""SRBD animation helper: frame logging + headless gif render.

Role parity with the reference's debug-only matplotlib animation
(`casadi/utils/animation.py`); here the helper is tested (the reference's
never was) by rendering a tiny synthetic walking log to a gif.
"""

import os

import numpy as np
import pytest

from biped_pympc_tpu.utils.viz import SrbdFrames, animate_srbd, log_rollout_frame


def _synthetic_frames(n=5):
    t = np.linspace(0.0, 1.0, n)
    pose = np.zeros((n, 6))
    pose[:, 3] = 0.3 * t  # walk forward
    pose[:, 5] = 0.55
    foot = np.zeros((n, 2, 3))
    foot[:, 0, 1], foot[:, 1, 1] = 0.06, -0.06
    foot[:, :, 0] = pose[:, None, 3]
    grf = np.zeros((n, 2, 3))
    grf[:, 0, 2] = 140.0
    grm = np.zeros((n, 2, 3))
    return SrbdFrames(pose=pose, foot_pos=foot, grf=grf, grm=grm)


def test_animate_srbd_renders_gif(tmp_path):
    pytest.importorskip("matplotlib")
    path = str(tmp_path / "walk.gif")
    animate_srbd(_synthetic_frames(), save_path=path, interval_ms=100)
    assert os.path.exists(path) and os.path.getsize(path) > 1000


def test_log_rollout_frame_shapes():
    import jax.numpy as jnp

    from biped_pympc_tpu import ControllerConf, MPCConf, MPCController

    ctrl = MPCController(ControllerConf(), MPCConf(), num_envs=2, gait_id=1)
    pose, foot, grf, grm = log_rollout_frame(ctrl, env=0)
    assert pose.shape == (6,)
    assert foot.shape == (2, 3)
    assert grf.shape == (2, 3) and grm.shape == (2, 3)
    frames = SrbdFrames(*map(np.stack, zip(*[(pose, foot, grf, grm)] * 3)))
    assert frames.pose.shape == (3, 6)


def test_plot_results_generates_figures(tmp_path):
    """`tools/plot_results.py` (the reference's MATLAB-plotting role,
    `cusadi/plotting/*.m`) renders figures from synthetic artifacts."""
    pytest.importorskip("matplotlib")
    import importlib.util
    import json

    spec = importlib.util.spec_from_file_location(
        "plot_results",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tools", "plot_results.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    d = tmp_path
    rows = {
        "bench_sweep.jsonl": [
            {"method": "a", "batch": 256, "solve_units_per_sec": 1e5},
            {"method": "a", "batch": 1024, "solve_units_per_sec": 2e5},
            {"method": "b", "batch": 256, "solve_units_per_sec": 5e4},
        ],
        "bench.jsonl": [
            {"metric": "qp_solves_per_sec_chip", "value": 3e5,
             "extra": {"solver": "ric_aug"}},
        ],
    }
    for name, rs in rows.items():
        with open(d / name, "w") as f:
            for r in rs:
                f.write(json.dumps(r) + "\n")
    import sys

    old = sys.argv
    sys.argv = ["plot_results.py", "--results-dir", str(d)]
    try:
        mod.main()
    finally:
        sys.argv = old
    for fig in ("sweep.png", "headline_history.png"):
        p = d / "plots" / fig
        assert p.exists() and p.stat().st_size > 5000, fig
