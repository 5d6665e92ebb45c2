"""The port's host-only tools against the reference's: validate_scaffolds (the
resumable per-scaffold validation) and adopt_index (stamping orphaned
k-mer index arrays into the validate cache). Exact: equal reports, equal arrays."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from telomeri_tpu_torch.io.fasta import read_fasta, write_fasta
from telomeri_tpu_torch.utils.validate import _cached_index, validate_assembly

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FLAGS = ["--seed-kmer", "24", "--stride", "32", "--sample", "1", "--jobs", "1"]


def _run(cmd, timeout=300):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, *cmd], capture_output=True, text=True, env=env,
                          timeout=timeout, cwd=ROOT)


@pytest.fixture(scope="module")
def assemblies(toy_dataset_dir, tmp_path_factory):
    """The toy simulation's contigs as the assembly to validate, one copy for
    each tool (a tool keeps its parts beside the scaffolds file)."""
    d = tmp_path_factory.mktemp("tools")
    out = {}
    for name in ("port", "ref"):
        sub = d / name
        sub.mkdir()
        for f in ("contigs.fa", "genome.fa"):
            shutil.copy(os.path.join(toy_dataset_dir, f), sub / f)
        out[name] = (str(sub / "contigs.fa"), str(sub / "genome.fa"))
    return out


@pytest.fixture(scope="module")
def port_report(assemblies):
    scaffolds, genome = assemblies["port"]
    proc = _run(["-m", "telomeri_tpu_torch.validate_scaffolds", "--scaffolds", scaffolds,
                 "--genome", genome, *FLAGS])
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(scaffolds + ".validate.json") as f:
        return json.load(f), proc


def test_validate_scaffolds_equals_validate_assembly(assemblies, port_report):
    merged, proc = port_report
    scaffolds, genome = assemblies["port"]
    scafs = read_fasta(scaffolds)
    assert len(scafs.names) >= 2 and proc.stderr.count("rc=0") == len(scafs.names)
    want = validate_assembly(scafs, read_fasta(genome), k=24, stride=32, sample=1, n_jobs=1)
    by_name = lambda ps: sorted(ps, key=lambda p: p["scaffold"])
    assert by_name(merged["placements"]) == by_name(want["placements"])
    # the tool validates the largest scaffold first
    lens = dict(zip(scafs.names, scafs.lengths))
    got = [lens[p["scaffold"]] for p in merged["placements"]]
    assert got == sorted(got, reverse=True)
    assert merged["n_validated"] == want["n_scaffolds"] == merged["n_scaffolds"]
    for k in want:
        if k != "placements":
            assert merged[k] == want[k], k
    # the summary printed on stdout is the merged report without its placements
    assert json.loads(proc.stdout) == {k: v for k, v in merged.items() if k != "placements"}


def test_validate_scaffolds_equals_the_reference_tool(assemblies, port_report):
    scaffolds, genome = assemblies["ref"]
    proc = _run([os.path.join(ROOT, "tools", "validate_scaffolds.py"), "--scaffolds", scaffolds,
                 "--genome", genome, *FLAGS])
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(scaffolds + ".validate.json") as f:
        assert json.load(f) == port_report[0]
    parts = lambda s: sorted(os.listdir(s + ".validate_parts"))
    assert parts(scaffolds) == parts(assemblies["port"][0])
    for name in parts(scaffolds):   # part by part, as each child wrote it
        with open(os.path.join(scaffolds + ".validate_parts", name)) as a, \
                open(os.path.join(assemblies["port"][0] + ".validate_parts", name)) as b:
            assert json.load(a) == json.load(b), name


def test_validate_scaffolds_rerun_skips_finished_parts(assemblies, port_report):
    scaffolds, genome = assemblies["port"]
    parts_dir = scaffolds + ".validate_parts"
    names = sorted(os.listdir(parts_dir))
    os.remove(os.path.join(parts_dir, names[0]))   # one scaffold left to do
    proc = _run(["-m", "telomeri_tpu_torch.validate_scaffolds", "--scaffolds", scaffolds,
                 "--genome", genome, *FLAGS, "--out", scaffolds + ".again.json"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stderr.count("already done, skipping") == len(names) - 1
    assert proc.stderr.count("rc=0") == 1
    with open(scaffolds + ".again.json") as f:
        assert json.load(f) == port_report[0]


def test_validate_scaffolds_child_failure_is_the_exit_code(assemblies, tmp_path):
    """A scaffold whose child fails is left out of the merge and the tool exits 1."""
    scaffolds = str(tmp_path / "s.fa")
    shutil.copy(assemblies["port"][0], scaffolds)
    proc = _run(["-m", "telomeri_tpu_torch.validate_scaffolds", "--scaffolds", scaffolds,
                 "--genome", str(tmp_path / "missing_genome.fa"), *FLAGS])
    assert proc.returncode == 1
    assert json.loads(proc.stdout)["n_validated"] == 0


def _rand_seq(n, seed):
    return np.frombuffer(b"ACGT", np.uint8)[np.random.default_rng(seed).integers(0, 4, n)]


def _orphaned_index(tmp_path):
    """A built index whose fingerprints (and raw pack) are lost."""
    g = _rand_seq(60_000, 7)
    stem = str(tmp_path / "genome.k24.idx")
    _cached_index(g, 24, stem)
    for p in ("sorted_km", "sorted_pos", "raw"):
        os.remove(f"{stem}.{p}.fp.npy")
    os.remove(stem + ".raw.npy")
    fa = str(tmp_path / "genome.fa")
    write_fasta(fa, ["genome"], [g])
    return g, stem, fa


def test_adopt_index_stamps_what_cached_index_accepts(tmp_path, monkeypatch):
    import telomeri_tpu_torch.utils.validate as V
    from telomeri_tpu_torch.utils.align import KmerIndex

    g, stem, fa = _orphaned_index(tmp_path)
    proc = _run(["-m", "telomeri_tpu_torch.adopt_index", fa, stem, "--samples", "5000"])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    # accepted: the sort is reused, never redone
    monkeypatch.setattr(KmerIndex, "from_packed", staticmethod(
        lambda *a, **k: (_ for _ in ()).throw(AssertionError("re-sorted an adopted index"))))
    idx = V._cached_index(g, 24, stem)
    monkeypatch.undo()
    fresh = _cached_index(g, 24, None)
    np.testing.assert_array_equal(np.asarray(idx.sorted_km), np.asarray(fresh.sorted_km))
    np.testing.assert_array_equal(np.asarray(idx.sorted_pos), np.asarray(fresh.sorted_pos))


def test_adopt_index_stamps_the_reference_tools_fingerprints(tmp_path):
    """Both tools write the same fingerprint files for the same orphaned index."""
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    _, stem_a, fa_a = _orphaned_index(tmp_path / "a")
    _, stem_b, fa_b = _orphaned_index(tmp_path / "b")
    a = _run(["-m", "telomeri_tpu_torch.adopt_index", fa_a, stem_a, "--samples", "5000"])
    b = _run([os.path.join(ROOT, "tools", "adopt_index.py"), fa_b, stem_b, "--samples", "5000"])
    assert a.returncode == 0 and b.returncode == 0, a.stdout + b.stdout + b.stderr
    assert a.stdout.replace(stem_a, "STEM") == b.stdout.replace(stem_b, "STEM")
    for part in ("sorted_km", "sorted_pos"):
        np.testing.assert_array_equal(np.load(f"{stem_a}.{part}.fp.npy"),
                                      np.load(f"{stem_b}.{part}.fp.npy"))
    assert sorted(os.listdir(tmp_path / "a")) == sorted(os.listdir(tmp_path / "b"))


def test_adopt_index_refuses_a_corrupted_sort(tmp_path):
    g, stem, fa = _orphaned_index(tmp_path)
    km = np.load(stem + ".sorted_km.npy")
    km[::10] += 12345            # 10% corrupted: the content sample must hit
    np.save(stem + ".sorted_km.npy", km)
    proc = _run(["-m", "telomeri_tpu_torch.adopt_index", fa, stem, "--samples", "5000"])
    assert proc.returncode != 0
    assert not os.path.exists(stem + ".sorted_km.fp.npy")
