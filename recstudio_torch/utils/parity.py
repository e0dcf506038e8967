"""Tie-aware comparison of two served top-k lists.

Two implementations of the same top-k may order items whose scores agree
within the arithmetic's error differently, or swap which of them falls off
the end of the list. A list pair agrees when the scores agree position by
position within ``tol``, and every item found in one list but not at the
same position of the other is explained by a tie: it sits in the other list
at a position whose score is within ``2 tol`` of its own, or its score is
within ``2 tol`` of the other list's last score (a tie at the cut).
"""
from __future__ import annotations

import numpy as np


def topk_mismatches(ids_a: np.ndarray, scores_a: np.ndarray, ids_b: np.ndarray,
                    scores_b: np.ndarray, tol: float) -> int:
    """Number of rows of ``[n, k]`` lists that do not agree (0 = agree)."""
    ids_a, ids_b = np.asarray(ids_a), np.asarray(ids_b)
    scores_a = np.asarray(scores_a, np.float64)
    scores_b = np.asarray(scores_b, np.float64)
    if ids_a.shape != ids_b.shape or scores_a.shape != scores_b.shape:
        return len(ids_a)
    bad = 0
    for ia, sa, ib, sb in zip(ids_a, scores_a, ids_b, scores_b):
        ok = bool(np.all(np.abs(sa - sb) <= tol))
        for src, s_src, dst, s_dst in ((ia, sa, ib, sb), (ib, sb, ia, sa)):
            for j in np.flatnonzero(src != dst):
                hit = np.flatnonzero(dst == src[j])
                if hit.size:
                    ok &= bool(abs(s_dst[hit[0]] - s_src[j]) <= 2 * tol)
                else:
                    ok &= bool(abs(s_src[j] - s_dst[-1]) <= 2 * tol)
        bad += not ok
    return bad
