"""External (beyond-RAM) sort/merge over `.unik` chunk files (the port's
copy of unikmer_tpu/pipeline/extsort.py): the count and grep spills and
``sort -m``, ``split`` and ``merge``.

Inputs are cut into chunks of exactly ``-m`` codes (ChunkAccumulator);
each chunk is sorted, collapsed within itself and dumped to
``chunk_NNN.unik``; the chunk files are then merged as a bulk
tournament: every open chunk keeps a buffered block, each round takes
everything <= the smallest buffer tail among the open readers, collapses
it vectorized and writes it out, cascading in rounds when more than
max-open-files chunks exist.

Collapse modes:
  'none'      keep duplicates
  'unique'    one copy per code (taxids LCA-merged)
  'repeated'  final round: codes with >= 2 occurrences, once;
              non-final rounds: write min(count, 2) copies so a later
              round can still detect duplicates
  'once'      final round: codes occurring EXACTLY once (count -u);
              non-final rounds as 'repeated' (the capped multiplicity
              keeps the ==1 vs >=2 distinction exact across rounds)
"""

from __future__ import annotations

import os

import numpy as np

from .. import native
from ..io import unik
from ..ops.sets import dedup_sorted
from ..utils.log import log


def chunk_file_name(out_dir: str, i: int) -> str:
    return os.path.join(out_dir, f"chunk_{i:03d}{unik.EXT}")


class ChunkAccumulator:
    """Accumulate (codes, taxids) arrays and emit exact chunk_size pieces
    (the reference dumps at exactly -m elements, sort.go:241-297); with
    taxids on, a block without them contributes zeros."""

    def __init__(self, chunk_size: int, has_taxid: bool, on_chunk):
        self.chunk_size = chunk_size
        self.has_taxid = has_taxid
        self.on_chunk = on_chunk
        self._c: list[np.ndarray] = []
        self._t: list[np.ndarray] = []
        self._n = 0

    def add(self, codes: np.ndarray, taxids: np.ndarray | None) -> None:
        off = 0
        while True:
            room = self.chunk_size - self._n if self.chunk_size else len(codes) - off
            take = min(len(codes) - off, room) if self.chunk_size else len(codes) - off
            if take > 0:
                self._c.append(codes[off : off + take])
                if self.has_taxid:
                    t = (
                        taxids[off : off + take]
                        if taxids is not None
                        else np.zeros(take, np.uint32)
                    )
                    self._t.append(t)
                self._n += take
                off += take
            if self.chunk_size and self._n >= self.chunk_size:
                self._emit()
            if off >= len(codes):
                return

    def _emit(self) -> None:
        if self._n == 0:
            return
        codes = np.concatenate(self._c)
        taxids = np.concatenate(self._t) if self.has_taxid else None
        self._c, self._t, self._n = [], [], 0
        self.on_chunk(codes, taxids)

    def flush(self) -> None:
        self._emit()


def collapse_batch(codes, taxids, mode, taxdb, final_round: bool):
    """Vectorized collapse of a sorted batch."""
    if mode == "none" or len(codes) == 0:
        return codes, taxids
    if taxids is not None:
        u_codes, u_tax = dedup_sorted(codes, taxids, taxdb)
        if mode == "unique":
            return u_codes, u_tax
    else:
        u_codes, u_tax = None, None
    first = np.ones(len(codes), bool)
    first[1:] = codes[1:] != codes[:-1]
    if u_codes is None:
        u_codes = codes[first]
    if mode == "unique":
        return u_codes, u_tax
    # repeated / once
    run_id = np.cumsum(first) - 1
    counts = np.bincount(run_id)
    if final_round:
        keep = counts == 1 if mode == "once" else counts >= 2
        return u_codes[keep], None if u_tax is None else u_tax[keep]
    reps = np.minimum(counts, 2)
    out_codes = np.repeat(u_codes, reps)
    out_tax = None if u_tax is None else np.repeat(u_tax, reps)
    return out_codes, out_tax


def dump_chunk(codes: np.ndarray, taxids: np.ndarray | None, path: str,
               k: int, flag: int, mode: str, taxdb, opt,
               compression_level: int | None = None) -> None:
    """Sort + within-chunk collapse + write one chunk file;
    ``compression_level`` overrides opt's (grep's temporary spill chunks
    take 1)."""
    if len(codes) > 1 and (codes[1:] < codes[:-1]).any():
        if taxids is None:
            codes = native.host_sort(codes)
        else:
            codes, taxids = native.host_sort_kv(codes, taxids)
    codes, taxids = collapse_batch(codes, taxids, mode, taxdb, final_round=False)
    flag |= unik.SORTED
    if taxids is not None:
        flag |= unik.INCLUDE_TAXID
    if compression_level is None:
        compression_level = opt.compression_level
    with unik.UnikWriter(path, k=k, flag=flag, number=len(codes),
                         max_taxid=opt.max_taxid, compress=opt.compress,
                         compression_level=compression_level,
                         threads=opt.threads) as w:
        w.write_codes(codes, taxids)


class _ChunkStream:
    """Buffered block reader over one sorted chunk file."""

    def __init__(self, path: str):
        self.reader = unik.UnikReader(path, stream=True)
        self._blocks = self.reader.iter_blocks()
        self.codes = np.zeros(0, np.uint64)
        self.taxids: np.ndarray | None = None
        self.exhausted = False
        self._fill()

    def _fill(self):
        while len(self.codes) == 0 and not self.exhausted:
            try:
                codes, taxids = next(self._blocks)
            except StopIteration:
                self.exhausted = True
                self.reader.close()
                return
            self.codes = codes
            self.taxids = taxids

    def take_upto(self, bound: np.uint64):
        """Remove and return entries <= bound from the buffer."""
        n = int(np.searchsorted(self.codes, bound, side="right"))
        out = (self.codes[:n], None if self.taxids is None else self.taxids[:n])
        self.codes = self.codes[n:]
        if self.taxids is not None:
            self.taxids = self.taxids[n:]
        self._fill()
        return out


def merge_sorted_files(in_files, write_batch, mode: str = "none", taxdb=None,
                       final_round: bool = True):
    """Bulk tournament merge of sorted .unik files.

    ``write_batch(codes, taxids)`` receives ascending, collapsed batches;
    consecutive batches never split a run of equal codes.
    Returns total records written.
    """
    streams = [_ChunkStream(f) for f in in_files]
    streams = [s for s in streams if not (s.exhausted and len(s.codes) == 0)]
    has_tax = any(s.taxids is not None for s in streams)
    carry_c = np.zeros(0, np.uint64)
    carry_t = np.zeros(0, np.uint32) if has_tax else None
    total = 0

    def flush(codes, taxids, last: bool):
        nonlocal carry_c, carry_t, total
        if len(codes) == 0 and not last:
            return
        codes = np.concatenate([carry_c, codes])
        if has_tax:
            taxids = np.concatenate(
                [carry_t, taxids if taxids is not None else np.zeros(0, np.uint32)]
            )
        if len(codes) == 0:
            return
        if not last:
            # hold back the final run (it may continue in the next batch)
            run_start = int(np.searchsorted(codes, codes[-1], side="left"))
            carry_c = codes[run_start:]
            codes = codes[:run_start]
            if has_tax:
                carry_t = taxids[run_start:]
                taxids = taxids[:run_start]
        else:
            carry_c = np.zeros(0, np.uint64)
            if has_tax:
                carry_t = np.zeros(0, np.uint32)
        if len(codes) == 0:
            return
        codes, taxids = collapse_batch(codes, taxids, mode, taxdb, final_round)
        write_batch(codes, taxids)
        total += len(codes)

    while streams:
        # bound: min over streams of their buffer tail
        bound = min(np.uint64(s.codes[-1]) for s in streams)
        parts_c, parts_t = [], []
        for s in streams:
            c, t = s.take_upto(bound)
            parts_c.append(c)
            if has_tax:
                parts_t.append(t if t is not None else np.zeros(len(c), np.uint32))
        codes = np.concatenate(parts_c)
        if has_tax:
            taxids = np.concatenate(parts_t)
            codes, taxids = native.host_sort_kv(codes, taxids)
        else:
            taxids = None
            codes = native.host_sort(codes)
        streams = [s for s in streams if len(s.codes) > 0]
        flush(codes, taxids, last=not streams)
    # final flush if everything was exhausted before any data
    if len(carry_c) > 0:
        flush(np.zeros(0, np.uint64), None, last=True)
    return total


def cascade_merge(chunk_files, out_writer_factory, tmp_dir: str, k: int,
                  flag: int, mode: str, taxdb, opt,
                  max_open_files: int = 400):
    """Merge with cascading rounds when #chunks > max_open_files."""
    round_idx = 0
    files = list(chunk_files)
    while len(files) > max_open_files:
        if opt.verbose:
            log.info(f"cascade round {round_idx}: merging {len(files)} chunks "
                     f"in groups of {max_open_files}")
        next_files = []
        for gi in range(0, len(files), max_open_files):
            group = files[gi : gi + max_open_files]
            path = os.path.join(tmp_dir, f"cascade_{round_idx:02d}_{gi:06d}{unik.EXT}")
            out_flag = flag | unik.SORTED
            # ANY member with taxids makes the intermediate carry them
            tmp_has_tax = False
            for g in group:
                with unik.UnikReader(g, stream=True) as r0:
                    if r0.header.is_include_taxid:
                        tmp_has_tax = True
                        break
            if tmp_has_tax:
                out_flag |= unik.INCLUDE_TAXID
            w = unik.UnikWriter(path, k=k, flag=out_flag,
                                max_taxid=opt.max_taxid, compress=opt.compress,
                                # cascade intermediates are temp files
                                compression_level=min(opt.compression_level, 1),
                                threads=opt.threads)
            merge_sorted_files(
                group,
                lambda c, t: w.write_codes(c, t if tmp_has_tax else None),
                mode=mode, taxdb=taxdb, final_round=False,
            )
            w.close()
            next_files.append(path)
        files = next_files
        round_idx += 1
    writer = out_writer_factory()
    return merge_sorted_files(files, writer, mode=mode, taxdb=taxdb,
                              final_round=True)
