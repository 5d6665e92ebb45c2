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


TAIL_ROWS = [1, 3, 5, 127, 1000, 70001]   # n % 4 != 0 is the card's scalar tail


def _assert_scores(got, want4, outputs):
    """got (torch tensors) against the 4 reference columns, as int32 bit patterns."""
    cols = (0, 1, 2, 3) if outputs == 4 else (1, 3)
    assert len(got) == outputs
    for c, t in zip(cols, got):
        assert t.shape == want4[c].shape and t.dtype == torch.float32 and t.is_contiguous()
        np.testing.assert_array_equal(_bits(t.numpy()), _bits(want4[c]))


def _pallas_interpret(g, outputs):
    """The reference's pallas_call (score_overlaps_pallas_tiled) in interpret
    mode on inputs tiled with numpy, the padding cut off with numpy."""
    n = len(g[0])
    rows, cols = ref.scoring_tile_shape(n)
    tiled = [np.pad(a, (0, rows * cols - n)).reshape(rows, cols) for a in g]
    got = ref.score_overlaps_pallas_tiled(*tiled, interpret=True, outputs=outputs)
    return [np.asarray(a).reshape(-1)[:n] for a in got]


@pytest.mark.parametrize("outputs", [4, 2])
@pytest.mark.parametrize("n", TAIL_ROWS)
def test_scores_match_reference_oracle_and_pallas(rng, n, outputs):
    """Tolerance 0: the dispatch and the plain version against the reference's
    numpy oracle and its Pallas kernels in interpret mode, bit for bit. The
    1-D wrapper score_os_es2_pallas is left out below 128 rows: there XLA CPU
    fuses its padding and slice into the arithmetic and its ES2 leaves the
    reference's own oracle by one ulp in some rows (the pallas_call itself and
    the 4-output wrapper do not)."""
    g = geometry(rng, n)
    want = ref.score_arrays_np(*g)
    pallas = [_pallas_interpret(g, outputs)]
    if outputs == 4:
        pallas.append(ref.score_overlaps_pallas(*g, interpret=True))
    elif n >= 128:
        pallas.append(ref.score_os_es2_pallas(*g, interpret=True))
    t = [torch.from_numpy(a) for a in g]
    for got in (scoring.score_overlaps(*t, outputs=outputs),
                scoring.score_overlaps_torch(*t, outputs=outputs)):
        _assert_scores(got, want, outputs)
        for cols in pallas:
            assert len(cols) == outputs
            for w, k in zip(cols, got):
                np.testing.assert_array_equal(_bits(k.numpy()), _bits(np.asarray(w)))


@pytest.mark.parametrize("outputs", [4, 2])
@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("n", [5, 127, 1000])
def test_scores_on_offset_views_match_reference(rng, n, offset, outputs):
    """Contiguous views that start off a 16-byte boundary (the shapes that take
    the card's 4-byte kernel) score as the arrays they show."""
    base = [torch.from_numpy(a) for a in geometry(rng, n + offset)]
    views = [a[offset:] for a in base]
    assert all(v.is_contiguous() and v.data_ptr() % 16 for v in views)
    want = ref.score_arrays_np(*[v.numpy() for v in views])
    _assert_scores(scoring.score_overlaps(*views, outputs=outputs), want, outputs)
    _assert_scores(scoring.score_overlaps_torch(*views, outputs=outputs), want, outputs)


@pytest.mark.parametrize("outputs", [4, 2])
@pytest.mark.parametrize("n", TAIL_ROWS)
def test_kernel_outputs_are_aligned_rows_of_one_buffer(n, outputs):
    """What the card's wrapper returns: float32 (n,) contiguous tensors, as the
    plain version's, each starting on 16 bytes whatever n % 4 is."""
    rows = scoring._output_rows(n, outputs, "cpu")
    plain = scoring.score_overlaps_torch(
        *[torch.zeros(n, dtype=torch.int32)] * 8, outputs=outputs)
    assert len(rows) == len(plain) == outputs
    for r, p in zip(rows, plain):
        assert (r.shape, r.dtype, r.stride()) == (p.shape, p.dtype, p.stride())
        assert r.is_contiguous() and r.data_ptr() % 16 == 0
    ptrs = sorted(r.data_ptr() for r in rows)
    assert all(b - a >= 4 * n for a, b in zip(ptrs, ptrs[1:]))   # no row overlaps the next
    assert rows[0].numpy().base is not None or n == 0


def test_dispatch_rejects_bad_geometry():
    a = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        scoring.score_overlaps(*([a] * 7 + [a.to(torch.int64)]))
    with pytest.raises(ValueError):
        scoring.score_overlaps_cuda(*([a] * 8))   # CPU tensors never reach the kernel
    with pytest.raises(ValueError):
        scoring.score_overlaps(*([a] * 7 + [a[:3]]))          # one length
    with pytest.raises(ValueError):
        scoring.score_overlaps(*([a.reshape(2, 2)] * 8))      # 1-D
    with pytest.raises(ValueError):
        scoring.score_overlaps(*([a] * 7 + [torch.zeros(8, dtype=torch.int32)[::2]]))
    with pytest.raises(ValueError):
        scoring._check_geom([a] * 7)


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


def test_rescore_on_cpu_matches_reference_rescore_on_toy_edges(toy_dataset_dir):
    """rescore_edges_device on CPU tensors against the reference's on its jnp
    backend, on the toy simulation's edges: os_ / es equal bit for bit, the
    other columns untouched."""
    import os

    from telomeri_tpu.io.geometry import build_edges as ref_build_edges
    from telomeri_tpu.io.geometry import rescore_edges_device as ref_rescore
    from telomeri_tpu.pipeline import load_inputs as ref_load_inputs

    files = ("contigs.fa", "reads.fa", "read2contig.paf", "read2read.paf")
    contigs, reads, paf = ref_load_inputs(*[os.path.join(toy_dataset_dir, f) for f in files])
    cfg = ScaffoldConfig()
    n_seqs = len(contigs) + len(reads)
    want = ref_rescore(ref_build_edges(paf, cfg, n_seqs)[0], backend="jnp")
    host, _ = build_edges(interop.paf_from_reference(paf), interop.config_from_reference(cfg),
                          n_seqs)
    host.os_, host.es = np.zeros_like(host.os_), np.zeros_like(host.es)   # must be rewritten
    got = rescore_edges_device(host, "cpu")
    assert got is host and len(got) > 1000
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        np.testing.assert_array_equal(a.view(np.int32) if a.dtype == np.float32 else a,
                                      b.view(np.int32) if b.dtype == np.float32 else b,
                                      err_msg=f.name)
