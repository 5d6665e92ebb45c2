"""Plain PyTorch reference of one Monte-Carlo walk dispatch, in blocks of walks.

The semantics are those of the reference scaffolder's all-MC walk section
(`_mc_fast_core` and `_resolve_mc_events`), written out here from scratch in
plain torch so that nothing of the program under test is imported:

  draw    step s of walk `uid` uses word s % 2 of Threefry-2x32 block s // 2
          under the key fold_in(key(seed), uid), as jax.random does with x64
          off: key(seed) = (0, seed), fold_in hashes the counter pair (0, uid),
          block b hashes the counters (2b, 2b + 1)
  scan    r = (bits & 0x7FFFFFFF) % max(total, 1), slot = min(#{j : cum[j] <= r},
          H - 1) on the packed row [nbr | cum | eid | adv | es_bits | os_bits];
          the walk moves to nbr[slot] when it is >= 0; five (W, S) records
          nxt, total, eid, adv, es_bits
  events  the first of dead row (total <= 0), revisit of any earlier node
          (start included) or anchor hit (nxt < 2 * n_anchors) ends the walk; a
          kill at the anchor's step wins; n_taken = t_anchor + 1 on success,
          else min(t_kill, S)
  sums    path_len in int32; score_sum in float32 over the taken steps' ES in
          XLA CPU's row-reduce order (windows of 32, pad // 2 zeros in front)

`walk_blocks` runs it over a call's walks a block at a time and yields the
seven WalkResult fields of each block (nodes, eids, steps, success, terminal,
path_len, score_sum), with the scan's records for the byte counts of
benchmark/roofline.py. `score_dtype` other than float32 gives the control: the
same walks with the step sum in a lower precision.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
FIELDS = ("nodes", "eids", "steps", "success", "terminal", "path_len", "score_sum")


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds; uint32 values held in int64 tensors."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in rotations[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def draw_bits(seed: int, uid: torch.Tensor, steps: int) -> torch.Tensor:
    """(W, S) int64 draw words in [0, 2**32) of walks `uid` under `seed`."""
    n_blocks = (steps + 1) // 2
    k0, k1 = threefry2x32(0, int(seed) & M32, 0, uid.to(torch.int64) & M32)
    b = torch.arange(n_blocks, dtype=torch.int64, device=uid.device)[None, :]
    y0, y1 = threefry2x32(k0[:, None], k1[:, None], 2 * b, 2 * b + 1)
    return torch.stack([y0, y1], dim=2).reshape(uid.shape[0], 2 * n_blocks)[:, :steps]


def scan(wide: torch.Tensor, start: torch.Tensor, bits: torch.Tensor, steps: int):
    """The five (W, S) int32 records and the (W, S) rows fetched at each step."""
    h = wide.shape[1] // 6
    w = start.shape[0]
    dev = start.device
    rec = torch.empty((5, w, steps), dtype=torch.int32, device=dev)
    rows = torch.empty((w, steps), dtype=torch.int64, device=dev)
    cols = torch.arange(h, device=dev)
    cur = start.long()
    for s in range(steps):
        rows[:, s] = cur
        cum = wide[cur[:, None], h + cols[None, :]]                  # (W, H)
        total = cum[:, h - 1]
        r = torch.remainder(bits[:, s] & 0x7FFFFFFF, torch.clamp_min(total, 1).long())
        slot = torch.clamp_max((cum.long() <= r[:, None]).sum(1), h - 1)
        nxt = wide[cur, slot]
        rec[0, :, s] = nxt
        rec[1, :, s] = total
        rec[2, :, s] = wide[cur, 2 * h + slot]
        rec[3, :, s] = wide[cur, 3 * h + slot]
        rec[4, :, s] = wide[cur, 4 * h + slot]
        cur = torch.where(nxt >= 0, nxt.long(), cur)
    return rec, rows


def sum_steps(x: torch.Tensor) -> torch.Tensor:
    """(W, S) -> (W,) in XLA CPU's row-reduce order, in x's dtype: up to 32
    steps one sequential sum from zero; above, zero-padded to windows of 32
    (pad // 2 in front), each window summed so, then the window sums alike."""
    w, s = x.shape
    if s > 32:
        n_win = -(-s // 32)
        pad = n_win * 32 - s
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2)).reshape(w, n_win, 32)
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
    return sum_steps(acc) if acc.dim() == 2 else acc


def _first(mask: torch.Tensor, big: int) -> torch.Tensor:
    idx = torch.arange(mask.shape[1], dtype=torch.int64, device=mask.device)[None, :]
    return torch.where(mask, idx, big).amin(dim=1)


def resolve(start, active, rec, n_anchors: int, steps: int, score_dtype=torch.float32):
    """The seven WalkResult fields from the scan's records."""
    nxt, total, eid, adv, es_bits = rec
    w = start.shape[0]
    big = steps + 1
    seq = torch.cat([start[:, None], nxt], dim=1)                    # (W, S+1)
    earlier = torch.ones(steps, steps + 1, dtype=torch.bool, device=start.device).tril()
    # nxt[t] equals one of start, nxt[0..t-1]: compared in blocks of steps
    dup = torch.zeros(w, steps, dtype=torch.bool, device=start.device)
    for t0 in range(0, steps, 8):
        t1 = min(t0 + 8, steps)
        eq = nxt[:, t0:t1, None] == seq[:, None, :]                  # (W, t, S+1)
        dup[:, t0:t1] = (eq & earlier[None, t0:t1]).any(-1)
    t_kill = torch.minimum(_first(dup, big), _first(total <= 0, big))
    t_kill = torch.where(active, t_kill, 0)
    t_anchor = _first(nxt < 2 * n_anchors, big)
    success = t_anchor < t_kill
    n_taken = torch.where(success, t_anchor + 1, torch.clamp_max(t_kill, steps))
    took = torch.arange(steps, device=start.device)[None, :] < n_taken[:, None]
    at = torch.clamp(t_anchor, 0, steps - 1)[:, None]
    terminal = torch.where(success, nxt.gather(1, at)[:, 0], -1)
    es = torch.where(took, es_bits.view(torch.float32), 0.0).to(score_dtype)
    return (torch.cat([start[:, None], torch.where(took, nxt, -1)], dim=1),
            torch.where(took, eid, -1),
            n_taken.to(torch.int32),
            success,
            terminal.to(torch.int32),
            torch.where(took, adv, 0).sum(dim=1, dtype=torch.int32),
            sum_steps(es).to(torch.float32))


def walk_blocks(wide, start, uid, active, seed: int, *, n_anchors: int, steps: int,
                block: int = 1 << 18, score_dtype=torch.float32):
    """Yield (lo, hi, fields, rec, rows) for each block [lo, hi) of the call's
    walks: the reference's seven fields, the scan's records and its rows."""
    w = start.shape[0]
    for lo in range(0, w, block):
        hi = min(lo + block, w)
        bits = draw_bits(seed, uid[lo:hi], steps)
        rec, rows = scan(wide, start[lo:hi], bits, steps)
        del bits
        fields = resolve(start[lo:hi], active[lo:hi], rec, n_anchors, steps, score_dtype)
        yield lo, hi, fields, rec, rows


def differing(program: tuple, reference: tuple) -> torch.Tensor:
    """(W,) bool: walks on which any field differs (score_sum by its bits)."""
    bad = torch.zeros(reference[2].shape[0], dtype=torch.bool, device=reference[2].device)
    for name, p, r in zip(FIELDS, program, reference):
        p = p.to(r.device)
        if name == "score_sum":
            p, r = p.view(torch.int32), r.view(torch.int32)
        if p.shape != r.shape:
            return torch.ones_like(bad)
        ne = p != r
        bad |= ne.any(dim=1) if ne.dim() == 2 else ne
    return bad
