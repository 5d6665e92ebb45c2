"""The plain references: the walk reference against the program's plain scan
and event resolution, and the assembly judge on hand-made scaffolds."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.gen import walk_table
from benchmark.reference import assembly as asm
from benchmark.reference import walks as ref


def _toy(n_anchors: int, seed: int = 4, n: int = 600, k: int = 12):
    gen = torch.Generator().manual_seed(seed)
    wide = walk_table.make_table(n, k, n_anchors=n_anchors, deg=(1, k), es=(0.5, 40.0),
                                 adv=(1, 50), gen=gen, device="cpu")
    # make some anchors reachable, some rows dead, some pads pickable
    if n_anchors:
        wide[::7, 0] = torch.arange(0, n, 7, dtype=torch.int32) % (2 * n_anchors)
    wide[5::31, 64:128] = 0
    plan = walk_table.make_plan(3000, n_anchors=n_anchors, gen=gen, device="cpu")
    plan["active"][::13] = False
    return wide, plan


@pytest.mark.parametrize("steps", [1, 7, 32, 48])
@pytest.mark.parametrize("n_anchors", [3, 20])
def test_reference_walks_equal_the_programs_plain_versions(steps, n_anchors):
    from telomeri_tpu_torch.kernels.walk_events import resolve_events_torch
    from telomeri_tpu_torch.kernels.walk_scan import walk_scan_torch
    from telomeri_tpu_torch.walk.engine import stable_bits_table

    wide, plan = _toy(n_anchors)
    seed = 2**31 - 5
    bits = stable_bits_table(seed, plan["uid"], steps)
    program = walk_scan_torch(wide, plan["start"], bits, steps)
    want = resolve_events_torch(plan["start"], plan["active"], *program, n_nodes=wide.shape[0],
                                n_anchors=n_anchors, max_steps=steps)
    blocks = list(ref.walk_blocks(wide, plan["start"], plan["uid"], plan["active"], seed,
                                  n_anchors=n_anchors, steps=steps, block=1024))
    assert len(blocks) == 3
    rec = torch.cat([b[3] for b in blocks], dim=1)
    assert torch.equal(rec, program)
    got = tuple(torch.cat(parts) for parts in zip(*[b[2] for b in blocks]))
    assert int(ref.differing(want, got).sum()) == 0
    assert int(got[3].sum()) > 0 or steps == 1


def test_draw_bits_are_the_programs_table():
    from telomeri_tpu_torch.walk.engine import stable_bits_table

    uid = torch.arange(0, 5000, 7, dtype=torch.int32)
    for seed in (0, 1, 2**31 - 1, 2**32 + 17):
        want = stable_bits_table(seed, uid, 9).T.long() & 0xFFFFFFFF
        assert torch.equal(ref.draw_bits(seed, uid, 9), want)


def test_differing_counts_each_field_and_score_bits():
    wide, plan = _toy(20)
    fields = next(ref.walk_blocks(wide, plan["start"], plan["uid"], plan["active"], 3,
                                  n_anchors=20, steps=8))[2]
    assert int(ref.differing(fields, fields).sum()) == 0
    for i in range(7):
        other = [f.clone() for f in fields]
        if other[i].dtype == torch.bool:
            other[i][4] = ~other[i][4]
        elif other[i].dtype == torch.float32:
            other[i][4] = -other[i][4] if other[i][4] != 0 else -0.0
        else:
            other[i].view(-1)[other[i].shape[-1] * 4 if other[i].dim() == 2 else 4] += 1
        assert int(ref.differing(tuple(other), fields).sum()) == 1, ref.FIELDS[i]


def test_control_differs_only_in_the_sum():
    wide, plan = _toy(20)
    args = (wide, plan["start"], plan["uid"], plan["active"], 9)
    f32 = next(ref.walk_blocks(*args, n_anchors=20, steps=32))[2]
    b16 = next(ref.walk_blocks(*args, n_anchors=20, steps=32, score_dtype=torch.bfloat16))[2]
    assert all(torch.equal(a, b) for a, b in zip(f32[:6], b16[:6]))
    assert int(ref.differing(b16, f32).sum()) > 0


def _genome(seed=1, n=300_000):
    return np.frombuffer(b"ACGT", np.uint8)[np.random.default_rng(seed).integers(0, 4, n)].tobytes()


def test_judge_hand_made_assemblies():
    g = _genome()
    pos = [(0, 100_000), (102_000, 200_000), (202_000, 300_000)]
    fills = [g[100_000:102_000], g[200_000:202_000]]
    whole = g[0:100_000] + fills[0] + g[102_000:200_000] + fills[1] + g[200_000 + 2000:]
    assert whole == g
    ok = asm.judge([("s0", whole)], g, pos)
    assert ok == dict(misjoins=0, contig_errors=0, joins_missing=0, gap_error_bp=0,
                      join_edits=0, end_edits=0, unplaced_bases=0)
    # the other strand reads the same
    assert asm.judge([("s0", asm.revcomp(whole))], g, pos) == ok
    # a fill 30 bases short
    short = g[:100_000] + fills[0][30:] + g[102_000:]
    got = asm.judge([("s0", short)], g, pos)
    assert got["gap_error_bp"] == 30 and got["join_edits"] == 30
    # unjoined contigs
    apart = [(f"c{i}", g[a:b]) for i, (a, b) in enumerate(pos)]
    assert asm.judge(apart, g, pos) == dict(misjoins=0, contig_errors=0, joins_missing=2,
                                            gap_error_bp=0, join_edits=0, end_edits=0,
                                            unplaced_bases=0)
    # contig 2 joined to contig 0, contig 1 alone: one misjoin
    wrong = [("s0", g[0:100_000] + fills[0] + g[202_000:]), ("s1", g[102_000:200_000])]
    got = asm.judge(wrong, g, pos)
    assert got["misjoins"] == 1 and got["joins_missing"] == 2
    # a contig on the wrong strand, a contig lost, a contig twice
    flip = g[:102_000] + asm.revcomp(g[102_000:200_000]) + g[200_000:]
    assert asm.judge([("s0", flip)], g, pos)["misjoins"] == 2
    assert asm.judge([("s0", g[:150_000])], g, pos)["contig_errors"] == 2
    assert asm.judge([("s0", g), ("s1", g[:100_000])], g, pos)["contig_errors"] == 1
    # one base of a contig's interior changed
    mut = bytearray(g)
    mut[150_000] = ord("A") if mut[150_000] != ord("A") else ord("C")
    assert asm.judge([("s0", bytes(mut))], g, pos)["contig_errors"] == 1


def _levenshtein(a: bytes, b: bytes) -> int:
    prev = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        cur = [i]
        for j, y in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (x != y)))
        prev = cur
    return prev[-1]


def test_edit_distance_is_levenshtein():
    rng = np.random.default_rng(5)
    for _ in range(300):
        a = bytes(rng.choice(list(b"ACGT"), rng.integers(0, 50)).tolist())
        b = bytearray(a)
        for _ in range(rng.integers(0, 12)):
            k = int(rng.integers(0, len(b) + 1))
            op = rng.integers(0, 3)
            if op == 0:
                b.insert(k, int(rng.choice(list(b"ACGT"))))
            elif k < len(b):
                if op == 1:
                    del b[k]
                else:
                    b[k] = int(rng.choice(list(b"ACGT")))
        want = _levenshtein(a, bytes(b))
        assert asm.edit_distance(a, bytes(b)) == want == asm.edit_distance(bytes(b), a)
        assert asm.stretch_edits(bytes(b), a) >= want


def test_judge_compares_every_base_beyond_the_interiors():
    g = _genome()
    pos = [(0, 100_000), (102_000, 200_000), (202_000, 300_000)]
    rng = np.random.default_rng(3)
    junk = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 2000)].tobytes()
    # a fill of random bases at its length: edits, no length error
    got = asm.judge([("s0", g[:100_000] + junk + g[102_000:])], g, pos)
    assert got["gap_error_bp"] == 0 and 900 < got["join_edits"] <= 2000
    # ten bases of a contig's end, past its interior, changed
    mut = bytearray(g)
    for q in range(190_000, 190_100, 10):
        mut[q] = ord("A") if mut[q] != ord("A") else ord("C")
    got = asm.judge([("s0", bytes(mut))], g, pos)
    assert got["join_edits"] == 10 and got["contig_errors"] == 0
    # the scaffold's first and last bases, outside every interior
    head = junk[:500] + g[500:]
    assert asm.judge([("s0", head)], g, pos)["end_edits"] > 200
    assert asm.judge([("s0", asm.revcomp(head))], g, pos)["end_edits"] > 200
    tail = g[:-300] + junk[:300]
    assert asm.judge([("s0", tail)], g, pos)["end_edits"] > 100
    # a scaffold with no contig in it
    got = asm.judge([("s0", g), ("x", junk)], g, pos)
    assert got["unplaced_bases"] == 2000 and got["contig_errors"] == 0
