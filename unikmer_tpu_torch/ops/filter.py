"""Low-complexity k-mer filter on code tensors (the port of
unikmer_tpu/ops/filter.py, in plain PyTorch so that a set on the card is
filtered there).

Behavior contract (reference: unikmer/cmd/filter.go:181-221 filterCode):
walk the code's bases from the LAST base backwards; score[0] = penalty_d,
score[i] = penalty_s when base i equals the previous walked base else
penalty_d; slide a window over the scores with start i in
[0, max(k-window-1, 0)] and flag the k-mer low-complexity when any
window sum >= threshold.  (The reference's loop bound skips the final
window; reproduced bit-for-bit.)
"""

from __future__ import annotations

from .._lazy import torch

_EVEN = 0x5555555555555555  # bit 0 of every 2-bit field


def _popcount_even(v: torch.Tensor) -> torch.Tensor:
    """Set bits of non-negative int64 values whose set bits are all even:
    each 2-bit field holds 0 or 1, so the sum starts at the nibbles."""
    v = (v & 0x3333333333333333) + ((v >> 2) & 0x3333333333333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F0F0F0F0F
    v = v + (v >> 8)
    v = v + (v >> 16)
    v = v + (v >> 32)
    return v & 0x7F


def low_complexity_mask(
    codes: torch.Tensor,
    k: int,
    penalty_s: int = 3,
    penalty_d: int = 1,
    threshold: int = 15,
    window: int = 7,
) -> torch.Tensor:
    """True where the k-mer is low-complexity (to be filtered out), for
    an int64 tensor of u64 code bit patterns on any device.

    Bit-trick formulation: score position i >= 1 is penalty_s iff base i
    equals base i-1, i.e. bits 2(i-1)..2(i-1)+1 of ``code ^ (code >> 2)``
    are 00.  A window's score is then
    ``penalty_d * width + (penalty_s - penalty_d) * popcount(pairmask &
    window_bits)``: one int64 lane per code.  The shifts are arithmetic,
    which changes only bits 62-63, above every position read (2k - 3 at
    most)."""
    window = min(window, k)
    out = torch.zeros(codes.shape, dtype=torch.bool, device=codes.device)
    if codes.numel() == 0:
        return out
    if k > 1:
        x = codes ^ (codes >> 2)
        # positions 1..k-1 only
        z = ~(x | (x >> 1)) & (_EVEN & ((1 << (2 * (k - 1))) - 1))
    else:
        z = torch.zeros_like(codes)
    diff = penalty_s - penalty_d
    for s in range(max(k - window - 1, 0) + 1):
        w_eff = min(s + window, k) - s
        mask = 0
        for i in range(max(s, 1), s + w_eff):
            mask |= 1 << (2 * (i - 1))
        if mask:
            score = penalty_d * w_eff + diff * _popcount_even(z & mask)
            out |= score >= threshold
        elif penalty_d * w_eff >= threshold:
            out[:] = True
    return out
