"""Assembly statistics (N50 etc.) — the numbers the reference's method is evaluated
with (HERA reports contiguity; SURVEY.md §5 "assess the scaffold against the known
genome (identity/N50)")."""

from __future__ import annotations

import numpy as np


def assembly_stats(lengths: list[int] | np.ndarray) -> dict:
    """Standard contiguity stats over sequence lengths."""
    ls = np.sort(np.asarray(lengths, dtype=np.int64))[::-1]
    if len(ls) == 0:
        return {"n_seqs": 0, "total_bp": 0, "max_len": 0, "n50": 0, "l50": 0,
                "n90": 0, "mean_len": 0.0}
    total = int(ls.sum())
    cum = np.cumsum(ls)

    def nx(frac: float) -> int:
        return int(ls[int(np.searchsorted(cum, frac * total))])

    return {
        "n_seqs": int(len(ls)),
        "total_bp": total,
        "max_len": int(ls[0]),
        "n50": nx(0.5),
        "l50": int(np.searchsorted(cum, 0.5 * total)) + 1,
        "n90": nx(0.9),
        "mean_len": float(total / len(ls)),
    }


def scaffold_vs_contig_stats(scaffold_lengths, contig_lengths) -> dict:
    """Before/after comparison for the pipeline's metrics output."""
    return {
        "contigs": assembly_stats(contig_lengths),
        "scaffolds": assembly_stats(scaffold_lengths),
    }
