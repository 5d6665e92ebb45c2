"""The byte and operation counts of benchmark/roofline.py on hand-counted
cases, the readers that turn them into shares, and the trace reduction."""

from __future__ import annotations

import pytest
import torch

from benchmark import roofline, trace
from benchmark.readers import device_idle, kernel_roofline, stage_seconds


def test_scan_need_by_hand():
    # 2 walks, 3 steps, H = 64, 4 distinct rows, 5 distinct picks
    b, o = roofline.scan_need(2, 3, 64, 4, 5)
    assert b == 2 * 8 + 4 * 256 + 5 * 16 + 5 * 2 * 3 * 4
    assert o == 2 * 3 * (64 + 60)


def test_scan_counter_counts_distinct_rows_and_picks():
    c = roofline.ScanCounter(10, "cpu")
    c.add(torch.tensor([[1, 2, 2], [3, 3, 3]]), torch.tensor([[10, 20, 20], [30, 31, -1]]))
    c.add(torch.tensor([[1, 9]]), torch.tensor([[10, -1]]))
    # rows 1, 2, 3, 9; picks (1,10) (2,20) (3,30) (3,31) (3,-1) (9,-1)
    assert c.counts() == (4, 6)


def test_resolve_need_by_hand():
    steps = torch.tensor([2, 3, 0, 1])
    success = torch.tensor([True, False, False, False])
    active = torch.tensor([True, True, False, True])
    s, w = 3, 4
    b, o = roofline.resolve_need(w, s, steps, success, active)
    # reads: success 2, killed at 3 (clamped to S) 3, inactive 0, killed after 1: 2
    reads = [2, 3, 0, 2]
    assert b == 5 * w + 8 * sum(reads) + 12 * int(steps.sum()) + w * ((2 * s + 1) * 4 + 17)
    assert o == sum(r * (r + 1) // 2 for r in reads)
    assert roofline.resolve_all_planes_bytes(w, s) == 5 * w + 20 * w * s + w * 45


def test_bound_picks_the_larger_time():
    t, by = roofline.bound_s(3.35e12, 1.0)
    assert t == pytest.approx(1.0) and by == "bytes"
    t, by = roofline.bound_s(1.0, 67e12 * 2)
    assert t == pytest.approx(2.0) and by == "operations"


def test_kernel_roofline_reader():
    need = {"scan": [3.35e9, 0], "calls": 1}
    obs = {"need": need, "profile": {"kernel_s": {"void walk_scan_kernel<2>(int)": 0.004,
                                                  "other": 1.0}}}
    assert kernel_roofline.read(obs, kernels=["walk_scan_kernel"], need="scan") == \
        pytest.approx(25.0)
    # a kernel off the path, or no count: silent, never 0
    assert kernel_roofline.read(obs, kernels=["gone_kernel"], need="scan") is None
    assert kernel_roofline.read({"profile": obs["profile"]}, kernels=["walk_scan_kernel"],
                                need="scan") is None


def test_stage_and_idle_readers():
    obs = {"stage_timings": [{"load_sequences": 0.2, "parse_paf": 0.5, "rescue_round_0": 1.0},
                             {"load_sequences": 0.4, "parse_paf": 0.7}],
           "profile": {"busy_s": 0.01, "window_s": 2.0}}
    assert stage_seconds.read(obs, stages=["load_sequences", "parse_paf"]) == pytest.approx(0.9)
    assert stage_seconds.read(obs, prefixes=["rescue_round_"]) == pytest.approx(0.5)
    assert stage_seconds.read({}, stages=["x"]) is None
    assert device_idle.read(obs) == pytest.approx(99.5)
    assert device_idle.read({"profile": {"busy_s": None, "window_s": 1.0}}) is None


def test_reduce_events_busy_gaps_and_labels():
    ops = [("k1", 10, 20), ("k2", 15, 30), ("k1", 60, 70), ("k3", 95, 130)]
    spans = [("ingest", 0, 50), ("walks", 50, 100), ("walks.inner", 80, 90)]
    out = trace.reduce_events(ops, spans, (0, 100))
    assert out["busy_s"] == pytest.approx((20 + 10 + 5) / 1e6)
    assert out["window_s"] == pytest.approx(100 / 1e6)
    assert out["kernel_s"]["k1"] == pytest.approx(20 / 1e6)
    assert out["device_ops"][0][0] == "k1"
    # idle [0,10) ingest; [30,60) cut at 50: ingest 20, walks 10; [70,95) cut at 80 and
    # 90: walks 10, walks.inner 10, walks 5
    got = sorted((n, round(s * 1e6)) for n, s in out["idle_gaps"])
    assert got == [("ingest", 10), ("ingest", 20), ("walks", 5), ("walks", 10), ("walks", 10),
                   ("walks.inner", 10)]
    assert out["idle_gaps"][0] == ["ingest", pytest.approx(20 / 1e6)]
