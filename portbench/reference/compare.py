"""The comparison that decides ``correct``: a set the program returned,
fetched as it holds it, against the reference's sorted distinct array.

A set is wrong by the members the reference holds and it lacks, the
members it holds and the reference does not, and the places where it is
not in strictly ascending order (a set is sorted and distinct by
definition).  Where the sets carry taxids, a member that both hold is
wrong by its taxid.  Every limit on these counts is 0: the comparison is
exact.
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


def taxids_wrong(got: np.ndarray, got_taxids, want: np.ndarray,
                 want_taxids) -> int:
    """The members that the program's set and the reference's both hold
    whose taxids differ; each taxids array (or None, a set with no
    taxids) in its codes' order.  Where only one side carries taxids,
    every member both hold counts."""
    got = np.asarray(got, np.uint64)
    want = np.asarray(want, np.uint64)
    if got.shape == want.shape and np.array_equal(got, want):
        gi = wi = slice(None)
        both = got.size
    else:
        _, gi, wi = np.intersect1d(got, want, return_indices=True)
        both = gi.size
    if got_taxids is None and want_taxids is None:
        return 0
    if got_taxids is None or want_taxids is None:
        return int(both)
    got_t = np.asarray(got_taxids, np.uint32)[gi]
    want_t = np.asarray(want_taxids, np.uint32)[wi]
    return int(np.count_nonzero(got_t != want_t))
