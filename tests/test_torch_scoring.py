"""The port's scoring against the reference: the plain torch version and the
port's numpy oracle are bit-equal to the reference's numpy oracle and to its
Pallas kernels run in interpret mode (4-output and 2-output); device rescoring
on CPU tensors leaves build_edges' EdgeSoA unchanged. The CUDA kernel itself is
held against the plain version on the card (test_torch_pipeline.py, gpu marker,
and chip_smoke.py)."""

import dataclasses

import numpy as np
import pytest
import torch

from telomeri_tpu.config import ScaffoldConfig
from telomeri_tpu.io.paf import PafRecords
from telomeri_tpu.kernels import scoring as ref
from telomeri_tpu_torch import interop
from telomeri_tpu_torch.io.geometry import build_edges, rescore_edges_device
from telomeri_tpu_torch.kernels import scoring


def geometry(rng, n):
    """Random geometry with the edge cases: bl = 0, negative extensions and
    values above 2**24 (int -> float32 rounding)."""
    g = [
        rng.integers(0, 5000, n),            # nm
        rng.integers(0, 6000, n),            # bl (0 -> max(bl, 1))
        rng.integers(0, 6000, n),            # ol1
        rng.integers(0, 6000, n),            # ol2
        rng.integers(0, 2000, n),            # oh1
        rng.integers(0, 2000, n),            # oh2
        rng.integers(-30000, 30000, n),      # el1
        rng.integers(-30000, 30000, n),      # el2
    ]
    g = [a.astype(np.int32) for a in g]
    if n >= 8:
        g[1][:4] = 0
        big = rng.integers(2**24, 2**31 - 1, n // 4).astype(np.int32)
        for a in (g[0], g[2], g[6], g[7]):
            a[: len(big)] = big
        g[6][-4:] = -(2**31) + 1
    return g


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("n", [1, 1000, 70001])
def test_torch_and_port_oracle_match_reference_oracle(rng, n):
    g = geometry(rng, n)
    want = ref.score_arrays_np(*g)
    port_np = scoring.score_arrays_np(*g)
    got = scoring.score_overlaps_torch(*[torch.from_numpy(a) for a in g])
    two = scoring.score_overlaps(*[torch.from_numpy(a) for a in g], outputs=2)
    for w, p, t in zip(want, port_np, got):
        np.testing.assert_array_equal(_bits(p), _bits(w))
        np.testing.assert_array_equal(_bits(t.numpy()), _bits(w))
    np.testing.assert_array_equal(_bits(two[0].numpy()), _bits(want[1]))
    np.testing.assert_array_equal(_bits(two[1].numpy()), _bits(want[3]))


@pytest.mark.parametrize("outputs", [4, 2])
def test_torch_matches_pallas_interpret(rng, outputs):
    g = geometry(rng, 9000)
    if outputs == 4:
        want = ref.score_overlaps_pallas(*g, interpret=True)
    else:
        want = ref.score_os_es2_pallas(*g, interpret=True)
    got = scoring.score_overlaps(*[torch.from_numpy(a) for a in g], outputs=outputs)
    assert len(got) == outputs
    for w, t in zip(want, got):
        np.testing.assert_array_equal(_bits(t.numpy()), _bits(np.asarray(w)))


def test_dispatch_rejects_bad_geometry():
    a = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        scoring.score_overlaps(*([a] * 7 + [a.to(torch.int64)]))
    with pytest.raises(ValueError):
        scoring.score_overlaps_cuda(*([a] * 8))   # CPU tensors never reach the kernel


def _paf(rng, n_rows, n_seqs=30, seq_len=4000):
    qid = rng.integers(0, n_seqs, n_rows)
    tid = rng.integers(0, n_seqs, n_rows)
    qlen = np.full(n_rows, seq_len)
    tlen = np.full(n_rows, seq_len)
    qs = rng.integers(0, seq_len // 2, n_rows)
    qe = qs + rng.integers(200, seq_len // 2, n_rows)
    ts = rng.integers(0, seq_len // 2, n_rows)
    te = ts + rng.integers(200, seq_len // 2, n_rows)
    bl = np.maximum(qe - qs, te - ts)
    nm = (bl * rng.uniform(0.75, 1.0, n_rows)).astype(np.int64)
    i32 = lambda a: np.asarray(a, np.int32)
    return PafRecords(qid=i32(qid), qlen=i32(qlen), qstart=i32(qs), qend=i32(qe),
                      strand=rng.integers(0, 2, n_rows).astype(np.int8),
                      tid=i32(tid), tlen=i32(tlen), tstart=i32(ts), tend=i32(te),
                      nmatch=i32(nm), blocklen=i32(bl))


def test_rescore_on_cpu_keeps_edges(rng):
    from telomeri_tpu.io.geometry import build_edges as ref_build_edges

    paf = _paf(rng, 3000)
    cfg = ScaffoldConfig()
    host, st = build_edges(interop.paf_from_reference(paf),
                           interop.config_from_reference(cfg), 30)
    want, ref_st = ref_build_edges(paf, cfg, 30)
    assert st.as_dict() == ref_st.as_dict() and len(host) > 100
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(host, f.name), getattr(want, f.name))
    dev = rescore_edges_device(dataclasses.replace(host), "cpu")
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(dev, f.name), getattr(want, f.name),
                                      err_msg=f.name)
