"""Bridge conflict resolution (host; tiny N — SURVEY.md §3 row 13).

Reference parity: the C++ reference's scaffold-conflict logic (mount empty, SURVEY.md §0).
Normative rules (deterministic):

  1. Candidate bridges are the consensus output, ordered by (support count desc,
     rep_score desc, canonical pair asc).
  2. Each PHYSICAL contig end — (contig, Left|Right) — may be used by at most one bridge.
  3. A bridge is rejected if its two endpoints resolve to the same physical end
     (inversion self-loop) or if its contigs are already in the same scaffold chain
     (cycle prevention, union-find).
  4. Surviving bridges are accepted greedily in rule-1 order.

Physical-end mapping (node encoding in io/geometry.py): a walk STARTS at oriented anchor
u = 2c+o and extends past c's Right end if o == 0, else its Left end. A walk TERMINATES
entering oriented anchor v = 2c'+o' from its left, i.e. through c''s Left end if o' == 0,
else its Right end.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class End:
    contig: int
    right: bool  # True = Right end

    def __repr__(self) -> str:
        return f"{self.contig}{'R' if self.right else 'L'}"


def start_end(u: int) -> End:
    """Physical end a walk leaves from, given its start node u = 2c+o."""
    return End(u // 2, u % 2 == 0)


def terminal_end(v: int) -> End:
    """Physical end a walk arrives at, given its terminal node v = 2c'+o'."""
    return End(v // 2, v % 2 == 1)


@dataclass
class Bridge:
    pair: tuple[int, int]   # canonical (a, b) oriented anchor nodes
    count: int
    rep_score: float
    rep_uid: int
    end_a: End
    end_b: End
    # copy-coherence demotion flag (consensus/coherence.py, round 5): pairs
    # whose every distinct path carries a below-top-SI (cross-copy-signature)
    # edge rank BELOW coherent pairs at equal count — re-ordering only, never
    # a refusal. Default True keeps legacy rows/tests byte-identical.
    coherent: bool = True


def make_bridge(row: dict) -> Bridge:
    a, b = row["pair"]
    return Bridge(
        pair=(a, b), count=row["count"], rep_score=row["rep_score"],
        rep_uid=row["rep_uid"], end_a=start_end(a), end_b=terminal_end(b),
        coherent=bool(row.get("coherent", True)),
    )


def resolve_conflicts(rows: list[dict],
                      pre_accepted: list[Bridge] | None = None) -> list[Bridge]:
    """Greedy accept per rules 1-4 (see resolve_with_blockers)."""
    accepted, _ = resolve_with_blockers(rows, [], pre_accepted=pre_accepted)
    return accepted


def resolve_with_blockers(
    rows: list[dict], blockers: list[dict],
    pre_accepted: list[Bridge] | None = None,
    pre_blocked: set[End] | frozenset = frozenset(),
) -> tuple[list[Bridge], set[End]]:
    """Greedy accept per rules 1-4. Input rows are consensus/compress() dicts.

    blockers (round 4): cut-read-gate-refused rows. They compete in the SAME
    rule-1 order but, when they win an end, they only CLAIM it (no bridge, no
    chain join). Why: a refused junction is still that end's best-supported
    adjacency hypothesis — leaving its ends free let weaker wrong-copy
    bridges claim them (measured misjoins on hg002-sub; consensus/evidence.py
    docstring). A blocker claims each of its ends that is still free,
    independently, and never joins the union-find.

    pre_accepted seeds the used-end set and scaffold union-find with bridges
    already accepted by an earlier pass (rescue rounds, walk/rescue.py);
    pre_blocked seeds blocker-claimed ends from an earlier pass. New rows can
    only claim still-free ends and never flip a prior decision.
    Returns (newly_accepted, all_blocked_ends)."""
    ranked = ([(make_bridge(r), False) for r in rows]
              + [(make_bridge(r), True) for r in blockers])
    # rule-1 order with the round-5 coherence demotion between count and
    # score: measured on hg002-sub, a wrong-copy hijack pair TIED a true
    # pair's count and won on rep_score, cascading 3 misjoins — the
    # incoherent pair now loses the tie instead (BASELINE.md case study)
    ranked.sort(key=lambda t: (-t[0].count, not t[0].coherent,
                               -t[0].rep_score, t[0].pair))

    used: set[End] = set(pre_blocked)
    blocked_ends: set[End] = set(pre_blocked)
    parent: dict[int, int] = {}

    def find(x: int) -> int:
        while parent.setdefault(x, x) != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for b in pre_accepted or ():
        used.add(b.end_a)
        used.add(b.end_b)
        parent[find(b.end_a.contig)] = find(b.end_b.contig)

    accepted = []
    for b, is_blocker in ranked:
        if is_blocker:
            for e in (b.end_a, b.end_b):
                if e not in used:
                    used.add(e)
                    blocked_ends.add(e)
            continue
        if b.end_a == b.end_b:
            continue  # rule 3: inversion self-loop
        if b.end_a in used or b.end_b in used:
            continue  # rule 2
        ra, rb = find(b.end_a.contig), find(b.end_b.contig)
        if ra == rb:
            continue  # rule 3: cycle
        parent[ra] = rb
        used.add(b.end_a)
        used.add(b.end_b)
        accepted.append(b)
    return accepted, blocked_ends
