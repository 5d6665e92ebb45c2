"""Path grouping and consensus selection in torch: the port of telomeri_tpu/consensus/grouping.py.

The normative rules 1-6 (canonical pair, windowed or fixed length groups,
winner by raw count with the shorter group on ties, representative by exact
max score_sum with the smaller uid on ties, support gate by walk count or by
distinct paths) are the reference's module docstring. The implementation is
the same chain of stable sorts and fixed-shape segment reductions, on whatever
device the summary lies:

  - stable argsorts: torch.argsort(stable=True), everywhere;
  - jax.ops.segment_{sum,max,min}: scatter_add_ / scatter_reduce_ into tensors
    filled with JAX's identities (0; int32 min or -inf for a max; int32 max for
    a min), so empty segments hold what the reference gives them;
  - uint32 arithmetic (path_signature's murmur mix): int64 tensors masked to 32
    bits, with each 32 x 32-bit multiply split at 16 bits so no product
    overflows int64. Signatures come back as int64 tensors of uint32 values.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_I32MAX = 2**31 - 1
_I32MIN = -(2**31)
_M32 = 0xFFFFFFFF


class WalkSummary(NamedTuple):
    """The per-walk fields consensus needs (tensors on one device)."""

    start: torch.Tensor       # (W,) int32
    terminal: torch.Tensor    # (W,) int32
    success: torch.Tensor     # (W,) bool
    path_len: torch.Tensor    # (W,) int32
    score_sum: torch.Tensor   # (W,) float32
    uid: torch.Tensor         # (W,) int32
    # (W,) int64 holding uint32 canonical interior-path signatures, or None
    sig: torch.Tensor | None = None


class ConsensusResult(NamedTuple):
    """Per-segment outputs, fixed shape (W,); rows with valid=False are padding.
    win_distinct is in ORIGINAL walk order (reference docstring)."""

    valid: torch.Tensor
    pair_a: torch.Tensor
    pair_b: torch.Tensor
    count: torch.Tensor
    bucket: torch.Tensor
    rep_uid: torch.Tensor
    rep_score: torch.Tensor
    distinct: torch.Tensor | None = None
    win_distinct: torch.Tensor | None = None

    def to_numpy(self) -> "ConsensusResult":
        return ConsensusResult(*[None if a is None else a.cpu().numpy() for a in self])


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for uint32 x (int64 tensor) and constant c."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 of (x + 1) as uint32 (bijective; +1 keeps node 0 nonzero)."""
    x = (x + 1) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def path_signature(nodes: torch.Tensor, steps: torch.Tensor,
                   virtual_base: int) -> torch.Tensor:
    """(W,) canonical signature of each walk's INTERIOR path: the wrapping
    uint32 sum of mix(node) over nodes[1:steps] that are real (0 <= node <
    virtual_base), min over the path and its reverse complement (node ^ 1)."""
    w, sp1 = nodes.shape
    ii = torch.arange(sp1, device=nodes.device)[None, :]
    interior = ((ii >= 1) & (ii < steps[:, None]) & (nodes >= 0)
                & (nodes < virtual_base))
    n64 = nodes.to(torch.int64)
    zero = torch.zeros((), dtype=torch.int64, device=nodes.device)
    fwd = torch.where(interior, _mix(n64), zero).sum(dim=1) & _M32
    mir = torch.where(interior, _mix(n64 ^ 1), zero).sum(dim=1) & _M32
    return torch.minimum(fwd, mir)


def summarize(res, uid: torch.Tensor, virtual_base: int | None = None) -> WalkSummary:
    """WalkResult -> WalkSummary (start is nodes[:, 0]); pass virtual_base to
    compute the path signatures that support="read_diverse" needs."""
    sig = (None if virtual_base is None
           else path_signature(res.nodes, res.steps, int(virtual_base)))
    return WalkSummary(start=res.nodes[:, 0], terminal=res.terminal,
                       success=res.success, path_len=res.path_len,
                       score_sum=res.score_sum, uid=uid.to(res.nodes.device), sig=sig)


def _lexsort_rows(keys_minor_to_major) -> torch.Tensor:
    """Stable argsort by several keys (last = most significant), like np.lexsort."""
    order = torch.argsort(keys_minor_to_major[0], stable=True)
    for k in keys_minor_to_major[1:]:
        order = order[torch.argsort(k[order], stable=True)]
    return order


def _segment(v: torch.Tensor, seg: torch.Tensor, n: int, reduce: str) -> torch.Tensor:
    """jax.ops.segment_{sum,max,min}(v, seg, num_segments=n)."""
    if reduce == "sum":
        return torch.zeros(n, dtype=v.dtype, device=v.device).scatter_add_(0, seg, v)
    if v.dtype.is_floating_point:
        init = float("-inf") if reduce == "amax" else float("inf")
    else:
        init = _I32MIN if reduce == "amax" else _I32MAX
    out = torch.full((n,), init, dtype=v.dtype, device=v.device)
    return out.scatter_reduce_(0, seg, v, reduce, include_self=True)


def group_and_select(
    s: WalkSummary, *, n_anchors: int = 0, group_window: int, min_support: int,
    grouping: str = "windowed", support: str = "walk_count",
) -> ConsensusResult:
    """Rules 1-6 over a walk summary (n_anchors is unused, kept for symmetry
    with the reference)."""
    if grouping not in ("windowed", "fixed"):
        raise ValueError(f"grouping must be windowed/fixed, got {grouping!r}")
    if support not in ("walk_count", "read_diverse"):
        raise ValueError(f"support must be walk_count/read_diverse, got {support!r}")
    diverse = support == "read_diverse"
    if diverse and s.sig is None:
        raise ValueError("support='read_diverse' needs path signatures: build "
                         "the summary with summarize(res, uid, virtual_base)")
    dev = s.start.device
    i32 = torch.int32
    w = s.start.shape[0]
    if w == 0:   # no walks at all: nothing to group
        zi = torch.zeros(0, dtype=i32, device=dev)
        zb = torch.zeros(0, dtype=torch.bool, device=dev)
        return ConsensusResult(
            valid=zb, pair_a=zi, pair_b=zi, count=zi, bucket=zi, rep_uid=zi,
            rep_score=torch.zeros(0, dtype=torch.float32, device=dev),
            distinct=zi if diverse else None, win_distinct=zb if diverse else None)

    a = s.start.to(i32)
    b = s.terminal.to(i32)
    # canonical undirected pair: min((a, b), (b^1, a^1)) lexicographic (rule 2)
    ra, rb = b ^ 1, a ^ 1
    flip = (ra < a) | ((ra == a) & (rb < b))
    ca = torch.where(flip, ra, a)
    cb = torch.where(flip, rb, b)

    plen = s.path_len.to(i32)
    key = (torch.div(plen, group_window, rounding_mode="floor")
           if grouping == "fixed" else plen)
    valid = s.success
    ca = torch.where(valid, ca, _I32MAX)
    cb = torch.where(valid, cb, _I32MAX)
    key_k = torch.where(valid, key, _I32MAX)

    keys = [s.sig, plen, key_k, cb, ca] if diverse else [key_k, cb, ca]
    order = _lexsort_rows(keys)
    ca_s, cb_s, key_s = ca[order], cb[order], key_k[order]
    valid_s = valid[order]
    score_s = s.score_sum[order]
    uid_s = s.uid.to(i32)[order]

    one = torch.ones(1, dtype=torch.bool, device=dev)
    neq = lambda x: torch.cat([one, x[1:] != x[:-1]])
    pair_first = neq(ca_s) | neq(cb_s)
    if grouping == "fixed":
        seg_first = pair_first | neq(key_s)
    else:
        # a new group starts where sorted path lengths jump by MORE than the window
        gap = torch.cat([torch.zeros(1, dtype=i32, device=dev),
                         key_s[1:] - key_s[:-1]]) > group_window
        seg_first = pair_first | gap
    seg_id = (torch.cumsum(seg_first.to(i32), 0, dtype=i32) - 1).long()
    pair_id = torch.cumsum(pair_first.to(i32), 0, dtype=i32) - 1

    ssum = lambda v: _segment(v, seg_id, w, "sum")
    smax_seg = lambda v: _segment(v, seg_id, w, "amax")

    if diverse:
        # gate unit = distinct (path_len, sig): the first row of each duplicate
        # run inside its segment counts
        distinct_first = seg_first | neq(plen[order]) | neq(s.sig[order])
        unit_s = valid_s & distinct_first
        seg_distinct = ssum(unit_s.to(i32))
    else:
        unit_s = valid_s
        seg_distinct = None
    seg_count = ssum(valid_s.to(i32))        # RAW count: rules 1 + 4
    seg_pair = smax_seg(torch.where(valid_s, pair_id, -1))
    seg_bucket = -smax_seg(torch.where(valid_s, -key_s, -_I32MAX))
    seg_bucket = torch.where(seg_count > 0, seg_bucket, -1)
    seg_ca = smax_seg(torch.where(valid_s, ca_s, -1))
    seg_cb = smax_seg(torch.where(valid_s, cb_s, -1))

    # winner per pair (rule 4): max count, ties to the smaller bucket
    pair_ix = torch.clamp_min(seg_pair, 0).long()
    best_count = _segment(seg_count, pair_ix, w, "amax")
    at_best = (seg_count > 0) & (seg_count == best_count[pair_ix])
    win_bucket = _segment(torch.where(at_best, seg_bucket, _I32MAX), pair_ix, w, "amin")
    seg_is_winner = at_best & (seg_bucket == win_bucket[pair_ix])

    # representative (rule 5): max score in the winning segment, ties to min uid
    win_pos = valid_s & seg_is_winner[seg_id]
    smax = smax_seg(torch.where(win_pos, score_s, float("-inf")))
    best_pos = win_pos & (score_s == smax[seg_id])
    rep_uid = _segment(torch.where(best_pos, uid_s, _I32MAX), seg_id, w, "amin")

    gate = seg_distinct if diverse else seg_count   # rule 6
    out_valid = seg_is_winner & (gate >= min_support)
    win_distinct = None
    if diverse:
        win_distinct = torch.zeros(w, dtype=torch.bool, device=dev)
        win_distinct[order] = unit_s & out_valid[seg_id]
    return ConsensusResult(
        valid=out_valid, pair_a=seg_ca, pair_b=seg_cb, count=seg_count,
        bucket=seg_bucket, rep_uid=rep_uid, rep_score=smax.to(torch.float32),
        distinct=seg_distinct, win_distinct=win_distinct)


def summarize_in_chunks(res, uid: torch.Tensor, virtual_base: int | None, chunk: int,
                        device) -> WalkSummary:
    """summarize over records that lie off `device` (host tensors or numpy),
    `chunk` walks at a time: each chunk is uploaded, summarized and dropped, so
    the device holds one chunk's records and the whole plan's summaries. A
    summary is per walk, so the result equals summarize over all records."""
    parts = []
    for lo in range(0, int(uid.shape[0]), chunk):
        rows = type(res)(*[torch.as_tensor(a[lo:lo + chunk]).to(device) for a in res])
        parts.append(summarize(rows, uid[lo:lo + chunk], virtual_base=virtual_base))
    return WalkSummary(*[None if cols[0] is None else torch.cat(cols) for cols in zip(*parts)])


def summary_consensus(summary: WalkSummary, cfg, support: str) -> ConsensusResult:
    """group_and_select over a whole plan's summary under cfg's (a
    ScaffoldConfig) grouping rules with the given support; host numpy."""
    return group_and_select(
        summary, group_window=cfg.group_window, min_support=cfg.min_group_support,
        grouping=cfg.grouping, support=support).to_numpy()


def walk_consensus(res, uid: torch.Tensor, cfg, *, virtual_base: int | None,
                   support: str, gather=None) -> ConsensusResult:
    """summarize, then summary_consensus. gather, where given, maps this
    process's summary to the whole plan's (dist/mesh.py gather_summary)."""
    summary = summarize(res, uid, virtual_base=virtual_base)
    if gather is not None:
        summary = gather(summary)
    return summary_consensus(summary, cfg, support)


def oracle_interior_key(nodes_row, steps_i: int, virtual_base: int):
    """EXACT canonical interior-path key of one walk (the scalar mirror of
    path_signature's hashed one): min(interior, mirror) over the hop-stripped
    interior node tuple. Used by the oracle and the cut-read gate tests."""
    interior = tuple(int(x) for x in nodes_row[1:steps_i]
                     if 0 <= x < virtual_base)
    mirror = tuple(x ^ 1 for x in reversed(interior))
    return min(interior, mirror)


def consensus_oracle(
    s: WalkSummary, n_anchors: int, group_window: int, min_support: int,
    grouping: str = "windowed", support: str = "walk_count",
    nodes: np.ndarray | None = None, steps: np.ndarray | None = None,
    virtual_base: int | None = None,
) -> list[dict]:
    """Scalar python reference of rules 1-6: the rows compress() gives for
    group_and_select on the same summary (tensors or host arrays).

    support="read_diverse" needs the walk records (nodes, steps, virtual_base)
    and counts distinct (path_len, exact canonical interior) per group — an
    independent, hash-free mirror of the device's (path_len, sig) key, so the
    parity test also certifies the hash has no collisions on its inputs."""
    by_pair: dict[tuple[int, int], list[int]] = {}
    start = np.asarray(s.start); term = np.asarray(s.terminal)
    succ = np.asarray(s.success); plen = np.asarray(s.path_len)
    score = np.asarray(s.score_sum); uid = np.asarray(s.uid)
    diverse = support == "read_diverse"
    if diverse and (nodes is None or steps is None or virtual_base is None):
        raise ValueError("read_diverse oracle needs nodes/steps/virtual_base")
    for i in range(len(start)):
        if not succ[i]:
            continue
        a, b = int(start[i]), int(term[i])
        cand = min((a, b), (b ^ 1, a ^ 1))
        by_pair.setdefault(cand, []).append(i)

    def n_units(walks: list[int]) -> int:
        if not diverse:
            return len(walks)
        return len({(int(plen[i]),
                     oracle_interior_key(nodes[i], int(steps[i]), virtual_base))
                    for i in walks})

    out = []
    for (a, b), members in sorted(by_pair.items()):
        # groups keyed by bucket index (fixed) or group min path length (windowed)
        if grouping == "fixed":
            buckets: dict[int, list[int]] = {}
            for i in members:
                buckets.setdefault(int(plen[i]) // group_window, []).append(i)
        else:
            members = sorted(members, key=lambda i: int(plen[i]))
            buckets = {}
            cur_key = None
            prev_len = None
            for i in members:
                li = int(plen[i])
                if prev_len is None or li - prev_len > group_window:
                    cur_key = li            # group's min length
                buckets.setdefault(cur_key, []).append(i)
                prev_len = li
        # rule 4 winner by RAW count; rule 6 gate by distinct units
        bk = min(buckets, key=lambda k: (-len(buckets[k]), k))
        walks = buckets[bk]
        if n_units(walks) < min_support:
            continue
        rep = min(walks, key=lambda i: (-score[i], uid[i]))
        row = dict(pair=(a, b), count=len(walks), bucket=bk,
                   rep_uid=int(uid[rep]), rep_score=float(score[rep]))
        if diverse:
            row["distinct"] = n_units(walks)
        out.append(row)
    return out


def compress(c: ConsensusResult) -> list[dict]:
    """Host-side: valid rows of a ConsensusResult as a sorted list of bridge dicts."""
    if isinstance(c.valid, torch.Tensor):
        c = c.to_numpy()
    rows = []
    for i in np.flatnonzero(c.valid):
        row = dict(pair=(int(c.pair_a[i]), int(c.pair_b[i])),
                   count=int(c.count[i]), bucket=int(c.bucket[i]),
                   rep_uid=int(c.rep_uid[i]), rep_score=float(c.rep_score[i]))
        if c.distinct is not None:
            row["distinct"] = int(c.distinct[i])
        rows.append(row)
    rows.sort(key=lambda r: r["pair"])
    return rows
