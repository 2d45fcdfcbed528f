"""The yardstick's table of peaks and the bytes a kernel's work needs.

The peak is one NVIDIA H100 SXM's published HBM3 rate (NVIDIA's data
sheet, 80 GB at 3.35 TB/s), which assumes the full 700 W power limit.

A sort of u64 keys reads each key once and writes it once, 16 bytes a
key, whatever algorithm implements it: the passes a radix sort makes are
its own cost, and counting them would give a sort that needs fewer
passes an impossible share.  The keys counted are the members that enter
the sort, not the sentinel padding of a set's capacity.
"""

HBM_BYTES_PER_S = 3.35e12
SORT_KEY_BYTES = 16


def sort_bytes(keys: int) -> int:
    return keys * SORT_KEY_BYTES
