"""Unit tests for the benchmark harness machinery (bench.py): the driver's
only perf evidence for a round is one `python bench.py` run, so the budget
gating and the background renderer must not regress (VERDICT r3 item 1)."""

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import Budget, RenderFeed
from boslam_tpu.config import CameraConfig, SlamConfig
from boslam_tpu.io import synthetic


def test_budget_gates_and_records_skips():
    b = Budget(0.2)
    assert b.allow("cheap", 0.0)
    assert not b.allow("expensive", 10.0)
    assert b.skipped == ["expensive"]
    time.sleep(0.25)
    assert b.remaining() < 0
    assert not b.allow("late", 0.01)
    # No estimate: a phase runs only while budget remains.
    assert not b.allow("unestimated")
    assert b.skipped == ["expensive", "late", "unestimated"]
    with b.timed("late"):
        time.sleep(0.05)
    assert 0.0 <= b.phase_times["late"] < 5.0


def test_render_feed_incremental_and_extra_jobs():
    cam = CameraConfig(width=64, height=48, fx=32.0, fy=32.0, cx=32.0,
                       cy=24.0, depth_wire_stride=2)
    cfg = SlamConfig(camera=cam)
    traj = synthetic.orbit_trajectory(6, radius=0.3)
    rf = RenderFeed(cfg, traj, depth_noise=0.0, seed=0, room_scale=1.0)
    rf.queue("alt", cfg, traj, depth_noise=0.02, seed=1, room_scale=1.0)

    ts, gray, d16 = rf.get(2)  # blocking incremental access
    assert gray.dtype == np.uint8 and gray.shape == (48, 64)
    assert d16.dtype == np.uint16 and d16.shape == cam.depth_wire_shape
    main = rf.wait_main()
    assert len(main) == 6
    extra = rf.wait_extra("alt", timeout_s=60.0)
    assert extra is not None and len(extra) == 6
    # Extra render differs (noise + seed) but shares geometry scale.
    assert not np.array_equal(extra[0][2], main[0][2])
    # Missing job times out to None instead of hanging.
    assert rf.wait_extra("nope", timeout_s=0.2) is None
