"""Genome indexing for locate / map / view -g on PyTorch (port of
unikmer_tpu/models/locate.py): code -> locations.

Reference: unikmer/cmd/locate.go:143-231 (code -> [(seqIdx,pos)...]) and
util.go:344-393 loadHash2Loc (hash -> one (seqIdx,pos)).

The index is a sorted coordinate table, as in the JAX package: every
(canonical) window of every kept record, sorted by code, with the
record and the position of each.  On the device route the records are
joined into one buffer with separators, encoded piece by piece by K1
(2-bit) or H1 (ntHash) without leaving the device
(models/count.linear_codes_device), and the (code, window ordinal)
pairs are sorted by K3, which is stable, so each code's range keeps
genome order as the JAX package's ``host_argsort`` does.  The records
and positions are gathered through the ordinals and fetched; the codes
stay on the device, where :func:`lookup_ranges` searches them with
``torch.searchsorted`` over sign-flipped copies (unsigned order read as
signed).

Admission: past ``element_budget("genome_index", device)`` slots (a
slot is a base of the joined buffer; UNIKMER_TPU_MAX_ELEMS overrides
it) or past 2^32 of them (K3's u32 values), the windows are fetched
piece by piece (models/count.linear_codes_all) and sorted on the host
by ``native.host_argsort``; the index is the same, and its lookups run
in numpy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from .._device import get_device
from ..io.fastx import read_fastx
from ..ops import codec
from ..ops.codec import SIGN
from ..ops.device_sets import fits
from ..ops.radix_sort import radix_sort_kv_u64
from ..utils.stages import stage
from .count import CountConfig, linear_codes_all, linear_codes_device

MAX_ORDINALS = 1 << 32  # K3's values are u32 window ordinals


@dataclass
class GenomeIndex:
    codes: np.ndarray | torch.Tensor  # sorted u64 (int64 bit patterns on a device)
    seq_idx: np.ndarray  # int32, parallel to codes
    pos: np.ndarray  # int64, parallel to codes
    sequences: list[bytes]  # possibly circular-extended
    ids: list[bytes]
    seq_file: np.ndarray  # int32 genome-file index per sequence
    k: int
    _blob: np.ndarray | None = None
    _blob_offs: np.ndarray | None = None
    route: str = "device"  # device: sorted by K3; host: host_argsort
    _flipped: torch.Tensor | None = None

    def host_codes(self) -> np.ndarray:
        """The sorted codes as numpy uint64, wherever they are held."""
        if isinstance(self.codes, torch.Tensor):
            return self.codes.cpu().numpy().view(np.uint64)
        return self.codes

    def seq_blob(self):
        """(concatenated sequence bytes, per-sequence start offsets) for
        vectorized substring gathers (view -g bulk decode)."""
        if self._blob is None:
            self._blob = np.frombuffer(b"".join(self.sequences), np.uint8)
            lens = np.fromiter(
                (len(s) for s in self.sequences), np.int64,
                len(self.sequences),
            )
            offs = np.zeros(len(lens), np.int64)
            np.cumsum(lens[:-1], out=offs[1:])
            self._blob_offs = offs
        return self._blob, self._blob_offs

    def gather_kmers(self, seq_idx: np.ndarray, pos: np.ndarray) -> np.ndarray:
        """(n, k) ASCII matrix of the genome k-mers at (seq_idx, pos)."""
        blob, offs = self.seq_blob()
        start = offs[seq_idx] + pos
        return blob[start[:, None] + np.arange(self.k, dtype=np.int64)]


def read_genome_records(genome_files, k: int, circular: bool, name_filters,
                        doubled: bool = False):
    """[(file index, record, sequence)] of the records kept for an index
    or a map: not matched by a name filter, at least k bases; the
    sequence extended by its first k-1 bases under ``circular``, or
    doubled under ``doubled`` (map)."""
    kept = []
    for fi, gf in enumerate(genome_files):
        for rec in read_fastx(gf):
            if name_filters and any(r.search(rec.name) for r in name_filters):
                continue
            if len(rec.seq) < k:
                continue
            seq = rec.seq
            if doubled:
                seq = seq + seq
            elif circular:
                seq = seq + seq[: k - 1]
            kept.append((fi, rec, seq))
    return kept


def joined_bases(sequences: list[bytes]):
    """(bases, starts): the sequences joined with a ``\\n`` after each,
    through BASE_LUT (a separator is an invalid base, so no window
    crosses records), and each one's start in the buffer."""
    joined = b"\n".join(sequences) + b"\n"
    bases = codec.BASE_LUT[np.frombuffer(joined, dtype=np.uint8)]
    starts = np.zeros(len(sequences), np.int64)
    lens = np.fromiter((len(s) for s in sequences), np.int64, len(sequences))
    np.cumsum(lens[:-1] + 1, out=starts[1:])
    return bases, starts


def device_route(slots: int, device: torch.device) -> bool:
    """Does an index over ``slots`` bases sort on ``device`` (K3)?"""
    return slots <= MAX_ORDINALS and fits("genome_index", device, slots)


def build_genome_index(
    genome_files,
    k: int,
    hashed: bool,
    circular: bool = False,
    name_filters=None,
    device=None,
) -> GenomeIndex:
    """Index every (canonical) window of the genomes."""
    device = get_device(device)
    with stage("index read", "cpu"):
        kept = read_genome_records(genome_files, k, circular, name_filters)
        sequences = [seq for _, _, seq in kept]
        # one packed buffer, one encode for every window of every
        # sequence, separators masking cross-record windows
        bases, starts = joined_bases(sequences) if sequences else (None, None)
    route = "device"
    if sequences:
        cfg = CountConfig(k=k, canonical=True, hashed=hashed)
        if device_route(len(bases), device):
            codes, seq_idx, pos = _device_index(bases, starts, cfg, device)
        else:
            route = "host"
            codes, flat = linear_codes_all(bases, cfg, device=device)
            seq_idx = (
                np.searchsorted(starts, flat, side="right") - 1
            ).astype(np.int32)
            pos = flat - starts[seq_idx]
            codes, order = native.host_argsort(codes)
            seq_idx, pos = seq_idx[order], pos[order]
    else:
        codes = torch.zeros(0, dtype=torch.int64, device=device)
        seq_idx = np.zeros(0, np.int32)
        pos = np.zeros(0, np.int64)
    return GenomeIndex(
        codes=codes,
        seq_idx=seq_idx,
        pos=pos,
        sequences=sequences,
        ids=[rec.id for _, rec, _ in kept],
        seq_file=np.asarray([fi for fi, _, _ in kept], np.int32),
        k=k,
        route=route,
    )


def _device_index(bases: np.ndarray, starts: np.ndarray, cfg: CountConfig,
                  device: torch.device):
    """(sorted codes on the device, seq_idx, pos): K1/H1, then K3 over
    (code, window ordinal), the columns gathered through the ordinals."""
    with stage("index encode", device):
        codes, flat = linear_codes_device(bases, cfg, device=device)
    with stage("index sort", device):
        ordinal = torch.arange(codes.shape[0], dtype=torch.int64,
                               device=device).to(torch.int32)
        codes, ordinal = radix_sort_kv_u64(codes, ordinal, cfg.code_bits)
        flat = flat[ordinal.to(torch.int64) & 0xFFFFFFFF]
        del ordinal
        st = torch.from_numpy(starts).to(device)
        seq_idx = torch.searchsorted(st, flat, right=True) - 1
        pos = flat - st[seq_idx]
    with stage("index fetch", "cpu"):
        return (codes, seq_idx.to(torch.int32).cpu().numpy(),
                pos.cpu().numpy())


def lookup_ranges(index: GenomeIndex, queries: np.ndarray):
    """[start, end) range in the index for each query code."""
    if not isinstance(index.codes, torch.Tensor):
        start = np.searchsorted(index.codes, queries, side="left")
        end = np.searchsorted(index.codes, queries, side="right")
        return start, end
    dev = index.codes.device
    with stage("lookup", dev):
        if index._flipped is None:
            index._flipped = index.codes ^ SIGN
        q = torch.from_numpy(np.ascontiguousarray(queries, np.uint64).view(
            np.int64)).to(dev) ^ SIGN
        start = torch.searchsorted(index._flipped, q)
        end = torch.searchsorted(index._flipped, q, right=True)
        return start.cpu().numpy(), end.cpu().numpy()


def load_hash2loc(genome_files, k: int, device=None):
    """view -g support: hash -> one (seqIdx, pos).  Returns
    (sequences, GenomeIndex limited to first occurrence)."""
    idx = build_genome_index(genome_files, k, hashed=True, circular=False,
                             device=device)
    return idx.sequences, idx


def lookup_hashes(index: GenomeIndex, queries: np.ndarray):
    """(found, seq_idx, pos) per query hash (first genome occurrence)."""
    start, end = lookup_ranges(index, queries)
    found = start < end
    s = np.where(found, start, 0)
    return found, index.seq_idx[s], index.pos[s]
