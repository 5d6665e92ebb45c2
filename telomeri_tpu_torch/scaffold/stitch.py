"""Scaffold chain assembly + sequence stitching (host — SURVEY.md §3 row 14).

Reference parity: the C++ reference's SequenceGenerator splicing (mount empty,
SURVEY.md §0). Semantics:

A scaffold chain is a maximal path of contigs connected by accepted bridges. Each bridge
carries its representative walk: oriented nodes [u, r1, ..., rk, v] and edge ids. The
spliced sequence follows io/geometry.py's coordinate contract: appending edge u->v (with
aligned-block ends ue on u, ve on v, both in oriented coordinates) to a scaffold where u
starts at global offset g_u means

    cut the scaffold back to g_u + ue, append oriented_seq(v)[ve:], set g_v = g_u + ue - ve.

Walk direction vs chain direction: bridges are stored in the representative walk's own
direction. Traversing a chain may need the mirror: nodes reversed and orientation-flipped
(n ^ 1), edge ids reversed and mirror-flipped (eid ^ 1 — build_edges emits forward/mirror
edges as adjacent even/odd pairs).

Determinism: chains are emitted sorted by their smallest contig id, each traversed from
the endpoint with the smaller (contig id, Left<Right) key; singleton contigs are emitted
as-is, forward. Output FASTA order: scaffolds then singletons, by that key.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from telomeri_tpu_torch.io.fasta import SequenceSet, reverse_complement
from telomeri_tpu_torch.io.geometry import EdgeSoA
from telomeri_tpu_torch.scaffold.bridge import Bridge, End


@dataclass
class WalkPath:
    """A representative walk's realized path (host numpy extraction)."""

    nodes: list[int]
    eids: list[int]

    def mirrored(self) -> "WalkPath":
        return WalkPath(
            nodes=[n ^ 1 for n in reversed(self.nodes)],
            eids=[e ^ 1 for e in reversed(self.eids)],
        )


def extract_path(walk_nodes: np.ndarray, walk_eids: np.ndarray, steps: int,
                 virtual_base: int | None = None) -> WalkPath:
    """Walk records -> WalkPath, stripping hierarchy hops (graph/tensorize.py):
    a hop step lands on a virtual node (id >= virtual_base) with eid == -2 and
    contributes nothing; the following leaf step carries the ORIGINAL edge whose
    src is the hub node, so the stripped path is edge-consistent."""
    nodes = [int(n) for n in walk_nodes[: steps + 1]]
    eids = [int(e) for e in walk_eids[:steps]]
    if virtual_base is not None:
        keep = [i for i, n in enumerate(nodes) if i == 0 or n < virtual_base]
        nodes = [nodes[i] for i in keep]
        eids = [eids[i - 1] for i in keep[1:]]
    assert all(e >= 0 for e in eids), "hierarchy hop survived extraction"
    return WalkPath(nodes=nodes, eids=eids)


@dataclass
class Scaffold:
    name: str
    seq: np.ndarray
    # composition of the PATH: list of (kind, id, orient); kind in {"contig", "read"}
    parts: list[tuple[str, int, int]] = field(default_factory=list)
    # emitted spans after splicing (AGP source): list of
    # (kind, id, orient, src_start, scaffold_start, length) where src_start is in
    # the component's ORIENTED frame (the frame the bytes were taken from); a
    # path part spliced out entirely by a later trim has no segment
    segments: list[tuple[str, int, int, int, int, int]] = field(default_factory=list)
    # the chain's accepted Bridges in traversal order (round 5, polish stage):
    # read segments between the k-th and (k+1)-th contig segment belong to
    # bridges[k], whose pair keys the junction's spanning-read set
    bridges: list = field(default_factory=list)


class _Splicer:
    """Growing byte sequence with trim-to-position splicing.

    Each appended chunk carries optional metadata; segments() reports the
    surviving spans with their final scaffold coordinates (chunks fully removed
    by trims disappear, truncated chunks report their shortened length)."""

    def __init__(self, first: np.ndarray, meta=None):
        self.chunks: list[np.ndarray] = [first]
        self.metas: list = [meta]
        self.length = len(first)

    def trim_to(self, n: int) -> None:
        assert 0 <= n <= self.length
        drop = self.length - n
        while drop > 0:
            last = self.chunks[-1]
            if len(last) <= drop:
                drop -= len(last)
                self.chunks.pop()
                self.metas.pop()
            else:
                self.chunks[-1] = last[: len(last) - drop]
                drop = 0
        self.length = n

    def append(self, a: np.ndarray, meta=None) -> None:
        self.chunks.append(a)
        self.metas.append(meta)
        self.length += len(a)

    def result(self) -> np.ndarray:
        return np.concatenate(self.chunks) if self.chunks else np.empty(0, np.uint8)

    def segments(self) -> list:
        out, pos = [], 0
        for chunk, meta in zip(self.chunks, self.metas):
            if len(chunk) and meta is not None:
                out.append((*meta, pos, len(chunk)))
            pos += len(chunk)
        return out


class Stitcher:
    def __init__(self, contigs: SequenceSet, reads: SequenceSet, edges: EdgeSoA):
        self.contigs = contigs
        self.reads = reads
        self.edges = edges
        self.n_contigs = len(contigs)

    def seq_of(self, node: int) -> np.ndarray:
        sid, o = node // 2, node % 2
        s = (self.contigs.seqs[sid] if sid < self.n_contigs
             else self.reads.seqs[sid - self.n_contigs])
        return reverse_complement(s) if o else s

    def kind_of(self, node: int) -> tuple[str, int, int]:
        sid, o = node // 2, node % 2
        if sid < self.n_contigs:
            return ("contig", sid, o)
        return ("read", sid - self.n_contigs, o)

    def stitch_chain(self, name: str, node_path: list[int], eid_path: list[int]) -> Scaffold:
        """Splice a full chain path (anchors and reads interleaved)."""
        sp = _Splicer(self.seq_of(node_path[0]),
                      meta=(*self.kind_of(node_path[0]), 0))
        g_u = 0
        parts = [self.kind_of(node_path[0])]
        for node, eid in zip(node_path[1:], eid_path):
            ue = int(self.edges.ue[eid])
            ve = int(self.edges.ve[eid])
            if int(self.edges.src[eid]) != node_path[len(parts) - 1] or \
               int(self.edges.dst[eid]) != node:
                raise ValueError(
                    f"edge {eid} ({self.edges.src[eid]}->{self.edges.dst[eid]}) does not "
                    f"match path step {node_path[len(parts) - 1]}->{node}")
            cut = g_u + ue
            sp.trim_to(cut)
            seq_v = self.seq_of(node)
            sp.append(seq_v[ve:], meta=(*self.kind_of(node), ve))
            g_u = cut - ve
            parts.append(self.kind_of(node))
        return Scaffold(name=name, seq=sp.result(), parts=parts,
                        segments=sp.segments())


def build_chains(accepted: list[Bridge], paths: dict[int, WalkPath],
                 n_contigs: int) -> list[list[tuple[Bridge, bool]]]:
    """Order accepted bridges into chains.

    Returns, per chain, the bridges in traversal order with a `mirrored` flag
    (True = the chain crosses the bridge from end_b to end_a).
    """
    by_end: dict[End, tuple[Bridge, bool]] = {}
    for b in accepted:
        # forward traversal leaves end_a; mirrored traversal leaves end_b
        by_end[b.end_a] = (b, False)
        by_end[b.end_b] = (b, True)

    in_chain: set[int] = set()
    chains: list[list[tuple[Bridge, bool]]] = []
    # deterministic start order: contigs ascending, each trying Left then Right
    for c in range(n_contigs):
        if c in in_chain:
            continue
        ends_here = [e for e in (End(c, False), End(c, True)) if e in by_end]
        if not ends_here:
            continue
        if len(ends_here) == 2:
            continue  # interior contig; its chain starts elsewhere
        chain: list[tuple[Bridge, bool]] = []
        in_chain.add(c)
        # leave through the single used end
        leave = ends_here[0]
        while leave in by_end:
            b, mirrored = by_end[leave]
            chain.append((b, mirrored))
            arrive = b.end_b if not mirrored else b.end_a
            nxt = arrive.contig
            in_chain.add(nxt)
            # continue out the other end of nxt
            leave = End(nxt, not arrive.right)
        chains.append(chain)
    return chains


def emit_scaffolds(
    accepted: list[Bridge],
    paths: dict[int, WalkPath],
    stitcher: Stitcher,
) -> list[Scaffold]:
    """Assemble all scaffolds + singleton contigs, deterministically ordered."""
    n_contigs = stitcher.n_contigs
    chains = build_chains(accepted, paths, n_contigs)

    scaffolds: list[Scaffold] = []
    used: set[int] = set()
    for chain in chains:
        node_path: list[int] = []
        eid_path: list[int] = []
        for b, mirrored in chain:
            wp = paths[b.rep_uid]
            # the stored walk may run in either direction of the canonical pair;
            # orient it to start at the node we are leaving from
            want_start = b.pair[0] if not mirrored else b.pair[1] ^ 1
            if wp.nodes[0] != want_start:
                wp = wp.mirrored()
            if wp.nodes[0] != want_start:
                raise ValueError(f"bridge walk does not connect {want_start}: {wp.nodes}")
            if not node_path:
                node_path = list(wp.nodes)
                eid_path = list(wp.eids)
            else:
                assert wp.nodes[0] == node_path[-1], (wp.nodes[0], node_path[-1])
                node_path += wp.nodes[1:]
                eid_path += wp.eids
        first_contig = min(n // 2 for n in node_path if n // 2 < n_contigs)
        sc = stitcher.stitch_chain(f"scaffold_{first_contig:05d}", node_path, eid_path)
        sc.bridges = [b for b, _ in chain]
        scaffolds.append((first_contig, sc))
        used.update(n // 2 for n in node_path if n // 2 < n_contigs)

    # documented order: bridged scaffolds first (by smallest member contig id,
    # NUMERIC — zero-padded names would mis-sort past 99999 contigs), then
    # untouched contigs as singletons by contig id
    scaffolds.sort(key=lambda t: t[0])
    out = [sc for _, sc in scaffolds]
    for c in range(n_contigs):
        if c not in used:
            seq = stitcher.contigs.seqs[c]
            out.append(Scaffold(
                name=f"scaffold_{c:05d}", seq=seq,
                parts=[("contig", c, 0)],
                segments=[("contig", c, 0, 0, 0, len(seq))]))
    return out


def write_agp(path: str, scaffolds: list[Scaffold], contigs, reads) -> None:
    """Write an AGP v2.1 file describing scaffold composition.

    One W (WGS component) line per emitted segment; our scaffolds are fully
    spliced, so there are no gap (N/U) lines. Component coordinates are 1-based
    inclusive in the component's FORWARD frame; orientation - means the segment
    bytes came from the reverse complement. Round-trip property (tested):
    concatenating the oriented component slices reproduces the scaffold
    sequence byte-for-byte."""
    with open(path, "w") as f:
        f.write("##agp-version\t2.1\n")
        for sc in scaffolds:
            for i, (kind, sid, orient, src_start, sc_start, ln) in enumerate(
                    sc.segments, start=1):
                seqs = contigs if kind == "contig" else reads
                comp_len = int(seqs.lengths[sid])
                if orient == 0:
                    beg, end = src_start + 1, src_start + ln
                else:  # oriented frame is the reverse complement of forward
                    beg = comp_len - (src_start + ln) + 1
                    end = comp_len - src_start
                f.write("\t".join(map(str, (
                    sc.name, sc_start + 1, sc_start + ln, i, "W",
                    seqs.names[sid], beg, end, "-" if orient else "+"))) + "\n")
