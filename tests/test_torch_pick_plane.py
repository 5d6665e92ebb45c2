"""The MC walk scan's pick plane (kernels/walk_table.py pick_plane and
GraphDev.picks): the (N, H, 8) int32 plane of {nbr, eid, adv, es_bits} a slot
and the {total, span} of the row the pick leads to (row_header), read by the
CUDA kernel for its pick and the next step's cum read, against the wide table
it is built from.

On the CPU: the plane slot by slot against the CSR tables packed into `wide`,
pads included; the header of every entry against the destination row, on
tables of the rows a span could get wrong (dead, degree 1, K = H, zero weights
mid-row, int32-wrapped and non-monotone sums); the count below the span
against the whole block's; one build per GraphDev, none on a CPU scan or the
row-sharded path; and the plain scan's records against a plain torch model of
the kernel's reads (the whole cum block at step 0, then only the chunks below
the span the plane's header gives, and the pick from the plane).

The gpu-marked tests hold the kernel with the plane to walk_scan_torch on the
card. This file imports neither jax nor the reference package, so they run
there with: python -m pytest tests/test_torch_pick_plane.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from telomeri_tpu_torch.kernels import walk_scan, walk_table
from telomeri_tpu_torch.kernels.walk_common import stable_bits_table
from telomeri_tpu_torch.utils.profiling import counters
from telomeri_tpu_torch.walk import engine

BUILDS = "walk.pick_plane_builds"


def builds() -> int:
    return counters().get(BUILDS, 0)


def csr_tables(rng, n: int, k: int):
    """(N, K) CSR tables of a random graph: rows of 0..K edges, some dead (all
    weights 0), neighbours over every node."""
    deg = rng.integers(0, k + 1, n)
    slot = np.arange(k)[None, :] < deg[:, None]
    nbr = np.where(slot, rng.integers(0, n, (n, k)), -1)
    es = np.where(slot & (rng.random((n, k)) < 0.9), rng.uniform(0.5, 50, (n, k)), 0)
    cum = np.cumsum(np.ceil(es), axis=1).astype(np.int32)
    eid = np.where(slot, rng.integers(0, 10 * n, (n, k)), -1)
    adv = np.where(slot, rng.integers(1, 3000, (n, k)), 0)
    os_ = np.where(slot, rng.uniform(0.5, 50, (n, k)), 0)
    return nbr, cum, eid, adv, es, os_


def packed(rng, n: int, k: int) -> tuple[np.ndarray, tuple]:
    tables = csr_tables(rng, n, k)
    return walk_table.pack_wide(*tables, walk_table.lane_width(k)), tables


ROW_KINDS = ("dead", "degree_1", "full", "zero_mid", "zero_all", "wrapped", "shuffled",
             "random")


def adversarial_wide(rng, n: int, h: int) -> np.ndarray:
    """An (N, 6H) table whose rows cycle through ROW_KINDS: no edge; one edge
    (span 0); K = H edges and no pad; zero weights mid-row (and at its end);
    live edges of weight 0 (total 0); weights of 2**28 to 2**31, whose int32
    running sums wrap (total of either sign, non-monotone); and live cum words
    drawn at random over int32 with a positive last one."""
    kind = np.arange(n) % len(ROW_KINDS)
    deg = rng.integers(2, h + 1, n)
    deg[kind == 0], deg[kind == 1], deg[kind == 2] = 0, 1, h
    slot = np.arange(h)[None, :] < deg[:, None]
    nbr = np.where(slot, rng.integers(0, n, (n, h)), -1)
    weight = rng.integers(1, 5000, (n, h))
    weight[kind == 3] *= rng.random(((kind == 3).sum(), h)) < 0.5
    weight[kind == 4] = 0
    weight[kind == 5] = rng.integers(2**28, 2**31, ((kind == 5).sum(), h))
    cum = np.cumsum(np.where(slot, weight, 0), axis=1).astype(np.int32)   # wraps
    for v in np.flatnonzero(kind == 6):
        d = deg[v]
        cum[v, :d] = rng.integers(-2**31, 2**31, d)
        cum[v, d - 1] = rng.integers(1, 2**31)
        cum[v, d:] = cum[v, d - 1]
    es = np.where(slot, rng.uniform(0.5, 50, (n, h)), 0)
    eid = np.where(slot, rng.integers(0, 10 * n, (n, h)), -1)
    adv = np.where(slot, rng.integers(1, 3000, (n, h)), 0)
    wide = walk_table.pack_wide(nbr, cum, eid, adv, es, es, h)
    total = cum[:, -1]
    assert (total[kind == 5] < 0).any() and (total[kind == 5] > 0).any()
    return wide


def header_of(cum: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """total and span of each (H,) cum row, by the rule's words."""
    h = cum.shape[1]
    total = cum[:, -1]
    span = np.array([h if t <= 0 else (np.flatnonzero(c < t).max() + 1 if (c < t).any() else 0)
                     for c, t in zip(cum, total)])
    return total, span


def tables(kind: str, k: int, seed: int, n: int = 200) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return packed(rng, n, k)[0]
    return adversarial_wide(rng, n, walk_table.lane_width(k))


@pytest.mark.parametrize("k", [48, 100, 200])   # H = 64, 128, 256
def test_pick_plane_is_the_four_picked_blocks_slot_by_slot(k):
    rng = np.random.default_rng(k)
    wide, (nbr, _, eid, adv, es, _) = packed(rng, 300, k)
    h = walk_table.lane_width(k)
    plane = walk_table.pick_plane(torch.from_numpy(wide)).numpy()
    assert plane.shape == (300, h, 8) and plane.dtype == np.int32
    es_bits = es.astype(np.float32).view(np.int32)
    for word, table, pad in ((0, nbr, -1), (1, eid, -1), (2, adv, 0), (3, es_bits, 0)):
        np.testing.assert_array_equal(plane[:, :k, word], table.astype(np.int32))
        assert (plane[:, k:, word] == pad).all(), word
    # and against the wide row itself: word i of slot j is column j of block 0, 2, 3, 4
    for word, block in enumerate(walk_table.PICKED_BLOCKS):
        np.testing.assert_array_equal(plane[:, :, word], wide[:, block * h:(block + 1) * h])
    assert (plane[:, :, 6:] == 0).all()


@pytest.mark.parametrize("entries", [None, 7 * 64 + 5], ids=["one-block", "ragged-blocks"])
@pytest.mark.parametrize("kind", ["adversarial", "random"])
@pytest.mark.parametrize("k", [64, 100])   # H = 64 (K = H), 128
def test_plane_header_is_the_destination_rows_total_and_span(k, kind, entries, monkeypatch):
    """Words 4-5 of every entry, pads included, are total and span of u = nbr
    (the entry's own row at a pad), by the rule's words; 6-7 are zero; built
    in one block or in blocks of rows that end mid-table."""
    if entries is not None:
        monkeypatch.setattr(walk_table, "PLANE_BUILD_ENTRIES", entries)
    wide = tables(kind, k, k + len(kind))
    h = walk_table.lane_width(k)
    plane = walk_table.pick_plane(torch.from_numpy(wide)).numpy()
    total, span = header_of(walk_table.blocks(wide).cum)
    nbr = walk_table.blocks(wide).nbr
    u = np.where(nbr >= 0, nbr, np.arange(len(wide))[:, None])
    np.testing.assert_array_equal(plane[:, :, 4], total[u])
    np.testing.assert_array_equal(plane[:, :, 5], span[u])
    assert (plane[:, :, 6:] == 0).all()
    if kind == "adversarial":   # each kind of row is there, and led to
        assert (span == 0).any() and (span == h).any() and (nbr >= 0).all(1).any()
        assert (plane[:, :, 5] == 0).any() and (plane[:, :, 4] < 0).any()


@pytest.mark.parametrize("k", [64, 100, 200])   # H = 64 (K = H), 128, 256
def test_count_below_the_span_is_the_whole_blocks(k):
    """For every row and every r in [0, total) at which the count can change
    (0, total - 1, and each cum word and its neighbours), #{j < span : cum[j] <=
    r} equals #{j : cum[j] <= r}; a dead row's span is its whole block."""
    wide = tables("adversarial", k, 3 * k)
    cum = walk_table.blocks(wide).cum.astype(np.int64)
    head = walk_table.row_header(torch.from_numpy(walk_table.blocks(wide).cum)).numpy()
    h = cum.shape[1]
    for c, (total, span) in zip(cum, head):
        if total <= 0:
            assert span == h
            continue
        r = np.unique(np.concatenate([[0, total - 1], c - 1, c, c + 1]))
        r = r[(r >= 0) & (r < total)]
        np.testing.assert_array_equal((c[:span, None] <= r).sum(0), (c[:, None] <= r).sum(0))


def test_pick_plane_of_an_empty_table():
    plane = walk_table.pick_plane(torch.zeros((0, 6 * 64), dtype=torch.int32))
    assert plane.shape == (0, 64, 8) and plane.dtype == torch.int32


def test_cum_span_words_counts_the_rows_spans():
    wide = tables("adversarial", 64, 5)
    _, span = header_of(walk_table.blocks(wide).cum)
    before = counters().get("walk.cum_span_words", 0)
    walk_table.pick_plane(torch.from_numpy(wide))
    assert counters()["walk.cum_span_words"] - before == span.sum() > 0


def test_pick_plane_rejects_what_is_no_wide_table():
    with pytest.raises(ValueError, match="6H"):
        walk_table.pick_plane(torch.zeros((4, 100), dtype=torch.int32))
    with pytest.raises(ValueError, match="6H"):
        walk_table.pick_plane(torch.zeros((4, 384), dtype=torch.int64))


def test_graph_dev_builds_its_plane_once():
    rng = np.random.default_rng(3)
    gd = walk_table.GraphDev(wide=torch.from_numpy(packed(rng, 200, 64)[0]))
    before_builds, before_bytes = builds(), counters().get("bytes.pick_plane", 0)
    planes = [gd.picks for _ in range(4)]
    assert builds() - before_builds == 1
    assert counters()["bytes.pick_plane"] - before_bytes == 200 * 64 * 32
    assert all(p is planes[0] for p in planes)
    assert gd.h == 64 and gd.wide.shape == (200, 6 * 64)


@pytest.mark.parametrize("k", [48, 100, 200])   # H = 64, 128, 256
def test_device_walk_bytes_are_the_bytes_the_table_and_its_plane_hold(k):
    """The placement's count (device_walk_bytes) is what graph_to_device and
    GraphDev.picks allocate: the table alone where no plane is built (a CPU),
    the table and its plane on a card."""
    from telomeri_tpu_torch.graph.tensorize import GraphTensors

    rng = np.random.default_rng(k + 1)
    n = 90
    nbr, cum, eid, adv, es, os_ = csr_tables(rng, n, k)
    g = GraphTensors(nbr=nbr.astype(np.int32), es=es.astype(np.float32),
                     os_=os_.astype(np.float32), adv=adv.astype(np.int32),
                     eid=eid.astype(np.int32), deg=(nbr >= 0).sum(1).astype(np.int32),
                     seq_len=np.full(n // 2, 5000, np.int32), n_anchors=4, cumw=cum)
    gd = walk_table.graph_to_device(g, "cpu")
    assert gd.h == walk_table.lane_width(k)
    assert walk_table.device_walk_bytes(g, "cpu") == gd.wide.nbytes
    assert walk_table.device_walk_bytes(g, "cuda") == gd.wide.nbytes + gd.picks.nbytes


def test_graph_dev_table_is_read_only():
    """A new table is a new GraphDev: rebinding `wide` would leave the cached
    plane describing the old one."""
    rng = np.random.default_rng(5)
    gd = walk_table.GraphDev(wide=torch.from_numpy(packed(rng, 50, 64)[0]))
    plane = gd.picks
    with pytest.raises(AttributeError):
        gd.wide = torch.zeros_like(gd.wide)
    assert gd.picks is plane


def test_cpu_scans_build_no_plane():
    """A CPU table runs the plain scan from `wide` alone, through walk_scan and
    the engine's MC section, and its GraphDev never builds a plane."""
    rng = np.random.default_rng(4)
    gd = walk_table.GraphDev(wide=torch.from_numpy(packed(rng, 200, 64)[0]))
    w = 64
    pd = engine.PlanDev(start=torch.from_numpy(rng.integers(0, 200, w).astype(np.int32)),
                        first_edge=torch.full((w,), -1, dtype=torch.int32),
                        mode=torch.full((w,), 2, dtype=torch.int32),
                        uid=torch.arange(w, dtype=torch.int32),
                        active=torch.ones(w, dtype=torch.bool))
    before = builds()
    recs = walk_scan.walk_scan(gd.wide, pd.start, pd.uid, 5, 12)
    res = engine.run_walks_mc(gd, pd, 5, n_anchors=10, max_steps=12)
    res2 = engine.run_walks_prepared(gd, [("mc", pd)], 5, n_anchors=10, max_steps=12)
    assert builds() == before and gd._picks is None
    assert recs.shape == (5, w, 12)
    for a, b in zip(res, res2):
        assert torch.equal(a, b)


def test_row_sharded_path_builds_no_plane(monkeypatch):
    """The row-sharded placement keeps its plain scans and collective fetch on
    `wide`: a world of 1 in this process builds no plane."""
    from telomeri_tpu_torch.config import ScaffoldConfig
    from telomeri_tpu_torch.dist import mesh as tmesh
    from telomeri_tpu_torch.dist.rowshard import run_walks_rowsharded
    from telomeri_tpu_torch.graph.tensorize import GraphTensors
    from telomeri_tpu_torch.walk.plan import plan_walks

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    rng = np.random.default_rng(6)
    n, k, anchors = 120, 6, 10
    nbr, cum, eid, adv, es, os_ = csr_tables(rng, n, k)
    g = GraphTensors(nbr=nbr.astype(np.int32), es=es.astype(np.float32),
                     os_=os_.astype(np.float32), adv=adv.astype(np.int32),
                     eid=eid.astype(np.int32), deg=(nbr >= 0).sum(1).astype(np.int32),
                     seq_len=np.full(n // 2, 5000, np.int32), n_anchors=anchors)
    plan = plan_walks(g, ScaffoldConfig(mc_walks_per_end=4, max_steps=8))
    tmesh.init_distributed("cpu")
    try:
        m = tmesh.make_walk_mesh(1, "cpu")
        before = builds()
        res = run_walks_rowsharded(g, plan, 11, max_steps=8, mesh=m)
    finally:
        tmesh.shutdown_distributed()
    assert builds() == before
    assert res.n_rows == len(plan) > 0


def scan_from_plane(wide: torch.Tensor, plane: torch.Tensor, start: torch.Tensor,
                    bits: torch.Tensor, s: int) -> torch.Tensor:
    """The kernel's reads in plain torch: at step 0 the row's total from `wide`
    and its whole cum block; at every later step the total and span from the
    header of the entry the step before picked, and only the 16-byte chunks of
    the cum block whose first word lies below the span (an unloaded chunk
    counts nothing); the picked words from plane[cur, choice]. (5, W, S)
    records."""
    h = plane.shape[1]
    cur = start.long()
    total = wide[cur, 2 * h - 1]
    span = torch.full_like(total, h)
    chunk_start = torch.arange(h) // 4 * 4   # the first word of each word's chunk
    out = torch.empty((5, len(start), s), dtype=torch.int32)
    for t in range(s):
        r = torch.remainder(bits[t].long() & 0x7FFFFFFF, total.long().clamp_min(1))
        loaded = chunk_start[None, :] < span[:, None]
        count = ((wide[cur, h:2 * h] <= r[:, None]) & loaded).sum(1)
        entry = plane[cur, count.clamp_max(h - 1)]   # (W, 8)
        nbr = entry[:, 0]
        out[:, :, t] = torch.stack([nbr, total, entry[:, 1], entry[:, 2], entry[:, 3]])
        cur = torch.where(nbr >= 0, nbr.long(), cur)
        total, span = entry[:, 4], entry[:, 5]
    return out


def scan_matches_the_model(kind: str, k: int, s: int) -> torch.Tensor:
    wide = torch.from_numpy(tables(kind, k, k + s, n=400))
    w = 300
    rng = np.random.default_rng(k * s)
    start = torch.from_numpy(rng.integers(0, 400, w).astype(np.int32))
    uid = torch.from_numpy(rng.integers(-2**31, 2**31, w).astype(np.int32))
    bits = stable_bits_table(-77, uid, s)
    got = walk_scan.walk_scan_torch(wide, start, bits, s)
    plane = walk_table.pick_plane(wide)
    torch.testing.assert_close(got, scan_from_plane(wide, plane, start, bits, s),
                               rtol=0, atol=0)
    return got


@pytest.mark.parametrize("k,s", [(48, 32), (100, 30), (200, 9)])
def test_plain_scan_records_equal_the_kernels_reads_from_the_plane(k, s):
    scan_matches_the_model("random", k, s)


@pytest.mark.parametrize("k,s", [(64, 32), (128, 13), (100, 30)])   # H = 64 (K = H), 128
def test_plain_scan_records_equal_the_kernels_reads_on_adversarial_tables(k, s):
    got = scan_matches_the_model("adversarial", k, s)
    # pads, dead rows and the rows of wrapped or shuffled sums were walked
    assert (got[0] < 0).any() and (got[1] <= 0).any() and (got[1] > 2**30).any()


# --- on the card ----------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the walk-scan kernel has no CPU path")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["random", "adversarial"])
@pytest.mark.parametrize("given", [True, False], ids=["picks", "no-picks"])
@pytest.mark.parametrize("s", [32, 30])
@pytest.mark.parametrize("k", [64, 100, 200, 400])   # H = 64, 128, 256 and 512 (<16, 0>)
def test_kernel_with_plane_equals_plain_scan(k, s, given, kind):
    """The kernel's records equal the plain scan's, on random tables and on
    tables of every row kind a span could get wrong (K = H at H = 64)."""
    dev = _cuda()
    rng = np.random.default_rng(k * s)
    n, w = 3000, 20_000
    wide = torch.from_numpy(tables(kind, k, k * s, n=n)).to(dev)
    start = torch.from_numpy(rng.integers(0, n, w).astype(np.int32)).to(dev)
    uid = torch.from_numpy(rng.integers(-2**31, 2**31, w).astype(np.int32)).to(dev)
    seed = int(rng.integers(0, 2**31))
    picks = walk_table.pick_plane(wide) if given else None
    if given:   # the card builds the plane the CPU builds
        assert torch.equal(picks.cpu(), walk_table.pick_plane(wide.cpu()))
    before = builds()
    got = walk_scan.walk_scan_cuda(wide, start, uid, seed, s, picks=picks)
    assert builds() - before == (0 if given else 1)
    want = walk_scan.walk_scan_torch(wide, start, stable_bits_table(seed, uid, s), s)
    torch.cuda.synchronize()
    assert torch.equal(want, got)
    assert (got[0] < 0).any() and (got[1] <= 0).any()   # pads and dead rows were picked


@pytest.mark.gpu
def test_kernel_reads_plane_offsets_past_2_to_the_31_words():
    """H = 256 and 2.2M rows: a 13.5 GB table and an 18.0 GB plane, made on
    the card, whose upper rows lie past 2**31 words of the plane; walks start
    and mostly stay among them."""
    dev = _cuda()
    n, k, h, w, s = 2_200_000, 200, 256, 16_384, 32
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    top = 2**31 // (8 * h)   # the first row whose plane offset passes 2**31 words
    rand = lambda lo, hi, shape: torch.randint(lo, hi, shape, generator=gen, device=dev,
                                               dtype=torch.int32)
    wide = torch.empty((n, 6 * h), dtype=torch.int32, device=dev)
    deg = rand(0, k + 1, (n, 1))
    slot = torch.arange(h, device=dev, dtype=torch.int32)[None, :] < deg
    near_top = rand(0, 2, (n, 1)).bool()   # half the rows lead only to rows past `top`
    nbr = torch.where(near_top, rand(top, n, (n, h)), rand(0, n, (n, h)))
    wide[:, :h] = torch.where(slot, nbr, -1)
    del nbr
    weight = torch.where(slot, rand(0, 50, (n, h)), 0)
    wide[:, h:2 * h] = torch.cumsum(weight, dim=1, dtype=torch.int32)
    wide[:, 2 * h:3 * h] = torch.where(slot, rand(0, 2**31 - 1, (n, h)), -1)
    wide[:, 3 * h:4 * h] = torch.where(slot, rand(1, 3000, (n, h)), 0)
    wide[:, 4 * h:5 * h] = weight.float().view(torch.int32)
    wide[:, 5 * h:] = 0
    del weight, slot
    start = rand(top, n, (w,))
    uid = torch.arange(w, dtype=torch.int32, device=dev)
    picks = walk_table.pick_plane(wide)
    assert picks.numel() > 2**31
    got = walk_scan.walk_scan_cuda(wide, start, uid, 21, s, picks=picks)
    want = walk_scan.walk_scan_torch(wide, start, stable_bits_table(21, uid, s), s)
    torch.cuda.synchronize()
    assert torch.equal(want, got)
    assert (got[0] >= top).float().mean() > 0.4   # about half the steps land past `top`
