"""Shape bucketing: bound the number of distinct table shapes across datasets.

Every dataset produces different edge/walk counts. Table row counts and plan
lengths are padded to a small geometric family of lengths (granularity = a
power-of-two multiple of the required divisor, ~n/8), which caps the waste at
~12.5% while giving at most ~8 distinct shapes per power of two. The reference
does so to reuse compiled programs; this package keeps the same family so that
graphs, plans and artifacts have the reference's shapes exactly. Results are
padding-invariant by construction.
"""

from __future__ import annotations


def bucket_len(n: int, multiple: int = 1) -> int:
    """Smallest padded length >= n from the bucket family; always a multiple of
    `multiple`; 0 stays 0 (empty sections skip their scan entirely)."""
    if n <= 0:
        return 0
    g = max(int(multiple), 1)
    while g * 16 < n:         # granularity in [n/16, n/8) -> waste < 12.5%
        g *= 2
    return -(-n // g) * g
