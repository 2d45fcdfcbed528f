"""The comparison that decides ``correct``: a set the program returned,
fetched as it holds it, against the reference's sorted distinct array.

A set is wrong by the members the reference holds and it lacks, the
members it holds and the reference does not, and the places where it is
not in strictly ascending order (a set is sorted and distinct by
definition).  Every limit on these counts is 0: the comparison is exact.
"""

from __future__ import annotations

import numpy as np


def _present(ref: np.ndarray, values: np.ndarray) -> int:
    """How many of ``values`` the sorted distinct ``ref`` holds."""
    if ref.size == 0 or values.size == 0:
        return 0
    idx = np.minimum(np.searchsorted(ref, values), ref.size - 1)
    return int(np.count_nonzero(ref[idx] == values))


def members_wrong(got: np.ndarray, want: np.ndarray) -> int:
    got = np.asarray(got, np.uint64)
    want = np.asarray(want, np.uint64)
    if got.shape == want.shape and np.array_equal(got, want):
        return 0
    unordered = int(np.count_nonzero(got[1:] <= got[:-1]))
    held = np.unique(got) if unordered else got
    missing = want.size - _present(held, want)
    extra = held.size - _present(want, held)
    return int(missing + extra + unordered)
