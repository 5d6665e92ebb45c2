"""The MC walk scan's pick plane (kernels/walk_table.py pick_plane and
GraphDev.picks): the (N, H, 4) int32 plane of {nbr, eid, adv, es_bits} a slot,
read by the CUDA kernel for its pick, against the wide table it is built from.

On the CPU: the plane slot by slot against the CSR tables packed into `wide`,
pads included; one build per GraphDev, none on a CPU scan or the row-sharded
path; and the plain scan's records against a numpy transcription of the
kernel's reads (the cum block from `wide`, the pick from the plane).

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


@pytest.mark.parametrize("k", [48, 100, 200])   # H = 64, 128, 256
def test_pick_plane_is_the_four_picked_blocks_slot_by_slot(k):
    rng = np.random.default_rng(k)
    wide, (nbr, _, eid, adv, es, _) = packed(rng, 300, k)
    h = walk_table.lane_width(k)
    plane = walk_table.pick_plane(torch.from_numpy(wide)).numpy()
    assert plane.shape == (300, h, 4) and plane.dtype == np.int32
    es_bits = es.astype(np.float32).view(np.int32)
    for word, table, pad in ((0, nbr, -1), (1, eid, -1), (2, adv, 0), (3, es_bits, 0)):
        np.testing.assert_array_equal(plane[:, :k, word], table.astype(np.int32))
        assert (plane[:, k:, word] == pad).all(), word
    # and against the wide row itself: word i of slot j is column j of block 0, 2, 3, 4
    for word, block in enumerate(walk_table.PICKED_BLOCKS):
        np.testing.assert_array_equal(plane[:, :, word], wide[:, block * h:(block + 1) * h])


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
    assert counters()["bytes.pick_plane"] - before_bytes == 200 * 64 * 16
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


def scan_from_plane(wide: np.ndarray, plane: np.ndarray, start: np.ndarray, bits: np.ndarray,
                    s: int) -> np.ndarray:
    """The kernel's reads in numpy: the cum block of row `cur` from `wide`, the
    four picked words from plane[cur, choice]; (5, W, S) records."""
    h = plane.shape[1]
    cur = start.astype(np.int64)
    out = np.empty((5, len(start), s), np.int32)
    for t in range(s):
        cum = wide[cur, h:2 * h]
        total = cum[:, -1]
        r = (bits[t].astype(np.int64) & 0x7FFFFFFF) % np.maximum(total, 1)
        choice = np.minimum((cum <= r[:, None]).sum(1), h - 1)
        nbr, eid, adv, es = plane[cur, choice].T
        out[:, :, t] = nbr, total, eid, adv, es
        cur = np.where(nbr >= 0, nbr, cur)
    return out


@pytest.mark.parametrize("k,s", [(48, 32), (100, 30), (200, 9)])
def test_plain_scan_records_equal_the_kernels_reads_from_the_plane(k, s):
    rng = np.random.default_rng(k + s)
    wide, _ = packed(rng, 400, k)
    w = 300
    start = rng.integers(0, 400, w).astype(np.int32)
    uid = torch.from_numpy(rng.integers(-2**31, 2**31, w).astype(np.int32))
    bits = stable_bits_table(-77, uid, s)
    got = walk_scan.walk_scan_torch(torch.from_numpy(wide), torch.from_numpy(start), bits, s)
    plane = walk_table.pick_plane(torch.from_numpy(wide)).numpy()
    np.testing.assert_array_equal(got.numpy(), scan_from_plane(wide, plane, start,
                                                               bits.numpy(), s))


# --- on the card ----------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the walk-scan kernel has no CPU path")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("given", [True, False], ids=["picks", "no-picks"])
@pytest.mark.parametrize("s", [32, 30])
@pytest.mark.parametrize("k", [64, 100, 200, 400])   # H = 64, 128, 256 and 512 (<16, 0>)
def test_kernel_with_plane_equals_plain_scan(k, s, given):
    dev = _cuda()
    rng = np.random.default_rng(k * s)
    n, w = 3000, 20_000
    wide = torch.from_numpy(packed(rng, n, k)[0]).to(dev)
    start = torch.from_numpy(rng.integers(0, n, w).astype(np.int32)).to(dev)
    uid = torch.from_numpy(rng.integers(-2**31, 2**31, w).astype(np.int32)).to(dev)
    seed = int(rng.integers(0, 2**31))
    picks = walk_table.pick_plane(wide) if given else None
    before = builds()
    got = walk_scan.walk_scan_cuda(wide, start, uid, seed, s, picks=picks)
    assert builds() - before == (0 if given else 1)
    want = walk_scan.walk_scan_torch(wide, start, stable_bits_table(seed, uid, s), s)
    torch.cuda.synchronize()
    assert torch.equal(want, got)
    assert (got[0] < 0).any() and (got[1] <= 0).any()   # pads and dead rows were picked


@pytest.mark.gpu
def test_kernel_reads_plane_offsets_past_2_to_the_31_words():
    """H = 256 and 2.2M rows: a 13.5 GB table and a 9.0 GB plane, made on the
    card, whose upper rows lie past 2**31 words of the plane; walks start and
    mostly stay among them."""
    dev = _cuda()
    n, k, h, w, s = 2_200_000, 200, 256, 16_384, 32
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    top = 2**31 // (4 * h)   # the first row whose plane offset passes 2**31 words
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
