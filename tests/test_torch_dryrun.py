"""The port's multi-device dry run (telomeri_tpu_torch/dryrun.py) on gloo worlds
of 1 and 2 CPU processes, against the reference's dryrun_multichip on a jax
mesh of the same size: the same counts, the same FASTA size, the same per-shard
table. And the walk table rebuilt on the device from device scores, against the
host's packing. Exact everywhere."""

import dataclasses
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from telomeri_tpu_torch import dryrun
from telomeri_tpu_torch.config import ScaffoldConfig
from telomeri_tpu_torch.kernels.walk_table import graph_to_device, mc_weights
from test_torch_dist import INPUTS, LAUNCHER_ENV, ROOT

LINE = re.compile(
    r"dryrun_multichip\((\d+)\): (\d+) walks sharded over \d+ devices, (\d+) successful, "
    r"(\d+) bridges; .*\(1dev == mesh == rowshard, (\d+) bytes\); "
    r"per-shard active/successful: (\[.*\])")


def _env(tmp_path):
    env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_ENV}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1", TELOMERI_CACHE=str(tmp_path / "cache"))
    return env


def _parse(text: str) -> tuple:
    m = LINE.search(text)
    assert m, text[-3000:]
    return tuple(int(x) for x in m.groups()[:5]) + (m.group(6).replace('"', "'"),)


@pytest.fixture(scope="module", params=[1, 2])
def port_dryrun(request, tmp_path_factory):
    n = request.param
    proc = subprocess.run(
        [sys.executable, "-m", "telomeri_tpu_torch.dryrun", "--device", "cpu", "--mesh", str(n)],
        capture_output=True, text=True, env=_env(tmp_path_factory.mktemp("dryrun")),
        timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return n, proc.stdout


def test_dryrun_world_passes_and_reports(port_dryrun):
    n, out = port_dryrun
    summary = json.loads(out.strip().splitlines()[-1])["dryrun"]
    assert summary["devices"] == n and summary["device"] == "cpu"
    assert summary["successful"] > 0 and summary["bridges"] > 0 and summary["fasta_bytes"] > 0
    assert len(summary["per_shard_active_successful"]) == n
    active = sum(int(s.split("/")[0]) for s in summary["per_shard_active_successful"])
    assert 0 < active <= summary["walks"] and summary["walks"] % n == 0
    assert set(summary["launches"].values()) == {0}   # CPU tensors launch no kernel
    assert "rebuilt from device scores bit-equal" in out


def test_dryrun_counts_equal_the_reference(port_dryrun, tmp_path):
    """The reference's dryrun_multichip(n) on n virtual CPU devices prints the
    same walks, successes, bridges, FASTA bytes and per-shard table."""
    n, out = port_dryrun
    code = ("import jax; jax.config.update('jax_platforms', 'cpu'); "
            f"import __graft_entry__ as g; g.dryrun_multichip({n})")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=_env(tmp_path), timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert _parse(out) == _parse(proc.stdout)


def test_dryrun_needs_a_card_unless_asked_for_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        dryrun.main([])
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(1, "cuda")


@pytest.mark.parametrize("max_degree", [64, 6], ids=["flat_rows", "hub_rows"])
def test_rebuilt_walk_table_equals_the_hosts(toy_dataset_dir, max_degree):
    """cum and ES blocks recomputed from a device scoring of every edge equal
    pack_wide's; at max_degree 6 the rows of hubs hold hierarchy hops, which
    keep their host-computed weights."""
    from telomeri_tpu_torch.pipeline import build_graph, load_inputs

    cfg = ScaffoldConfig(max_degree=max_degree)
    edges, graph = build_graph(*load_inputs(*[os.path.join(toy_dataset_dir, f) for f in INPUTS]),
                               cfg, device="cpu")
    assert (graph.stats["n_virtual_nodes"] > 0) == (max_degree == 6)
    gd = graph_to_device(graph, "cpu")
    got = dryrun.rebuild_walk_table(gd, edges, "cpu")
    assert got.wide.dtype == torch.int32 and torch.equal(got.wide, gd.wide)


def test_rebuilt_walk_table_follows_the_scores(toy_dataset_dir):
    """Other geometry, other scores: the rebuilt cum block is the running sum
    of mc_weights over the new ES of each slot's edge, pads carrying the total."""
    from telomeri_tpu_torch.kernels.scoring import score_arrays_np
    from telomeri_tpu_torch.pipeline import build_graph, load_inputs

    edges, graph = build_graph(*load_inputs(*[os.path.join(toy_dataset_dir, f) for f in INPUTS]),
                               ScaffoldConfig(), device="cpu")
    gd = graph_to_device(graph, "cpu")
    rng = np.random.default_rng(5)
    moved = dataclasses.replace(edges, el=(edges.el - rng.integers(0, 4000, len(edges)))
                                .astype(edges.el.dtype))
    got = dryrun.rebuild_walk_table(gd, moved, "cpu").wide.numpy()
    k = gd.h
    es_edges = score_arrays_np(*moved.geom_args())[3]
    eid = gd.wide.numpy()[:, 2 * k:3 * k]
    es_tab = np.where(eid >= 0, es_edges[np.maximum(eid, 0)], np.float32(0)).astype(np.float32)
    assert (es_tab <= 0).any() and (es_tab > 0).any()
    np.testing.assert_array_equal(got[:, 4 * k:5 * k].view(np.float32), es_tab)
    np.testing.assert_array_equal(got[:, k:2 * k], np.cumsum(mc_weights(es_tab), axis=1))
    for b in (0, 2, 3, 5):   # the other blocks pass through
        np.testing.assert_array_equal(got[:, b * k:(b + 1) * k],
                                      gd.wide.numpy()[:, b * k:(b + 1) * k])
