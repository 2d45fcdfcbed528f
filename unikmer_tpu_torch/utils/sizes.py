"""Byte/element size parsing (the port's copy of
unikmer_tpu/utils/sizes.py) — exact ParseByteSize semantics
(reference unikmer/cmd/util.go:291-336): suffixes B/K/M/G (case
insensitive, last character only — "1Kb" is an ERROR there too), bare
numbers allowed, empty or bare-unit strings mean 0, negatives clamp
to 0."""

from __future__ import annotations

_UNITS = {"B": 1, "K": 1 << 10, "M": 1 << 20, "G": 1 << 30}


def parse_byte_size(s: str) -> int:
    t = s.strip(" \t\r\n")
    if not t:
        return 0
    unit = _UNITS.get(t[-1].upper())
    if unit is None:  # no unit suffix: plain float
        try:
            val = float(t)
        except ValueError as e:
            raise ValueError(f"invalid byte size: {s}") from e
        return int(val) if val > 0 else 0
    if len(t) == 1:  # bare unit, no value
        return 0
    try:
        val = float(t[:-1].strip(" \t\r\n"))
    except ValueError as e:
        raise ValueError(f"invalid byte size: {s}") from e
    if val < 0:
        val = 0.0
    return int(val * unit)


def humanize(n: int) -> str:
    """1234567 -> '1,234,567' (reference uses dustin/go-humanize)."""
    return f"{n:,}"
