"""locate: locate k-mers in genomes, output BED6 (port of
unikmer_tpu/cli/commands/locate.py).

Reference: unikmer/cmd/locate.go — build a code->locations index over the
genomes, then stream .unik files and print
``id  pos  pos+k  kmer  0  .`` for every location of every (not yet
seen) code; the k-mer column is the genome substring at that position.

The index is built, sorted and searched on the device
(models/locate.py); each block's lines are built as one byte buffer, as
utils/textout.py builds view's.
"""

from __future__ import annotations

import re
import sys

import numpy as np

from ...utils.log import die, log
from ...utils.stages import stage
from ...utils.textout import _MAX_U64_DIGITS, _decimal_digits, _scatter_digits
from ..opts import out_text_stream
from ._common import add_files_arg, new_command, open_reader, unik_inputs

HOST = "cpu"  # the device of the stages of host work alone


def register(subparsers):
    p = new_command(subparsers, "locate", "Locate k-mers in genome")
    add_files_arg(p)
    p.add_argument("-B", "--seq-name-filter", action="append", default=[],
                   help="regular expressions for filtering out sequences by header/name, case ignored")
    p.add_argument("-o", "--out-prefix", default="-",
                   help='out file prefix ("-" for stdout)')
    p.add_argument("-g", "--genome", action="append", default=[], required=False,
                   help="genomes in (gzipped) fasta file(s)")
    p.add_argument("--circular", action="store_true", help="circular genome")
    p.set_defaults(func=run)


def name_filters(patterns) -> list:
    """-B patterns compiled case-insensitively, as the reference adds
    ``(?i)`` to each that lacks it."""
    res = []
    for kw in patterns:
        if "(?i)" not in kw:
            kw = "(?i)" + kw
        res.append(re.compile(kw.encode()))
    return res


def run(args) -> int:
    opt, files = unik_inputs(args)
    if not args.genome:
        die("flag -g/--genome needed")
    name_res = name_filters(args.seq_name_filter)

    # pre-read headers: all must be canonical + compatible
    k = None
    hashed = False
    for f in files:
        with open_reader(f) as r:
            if k is None:
                k = r.header.k
                hashed = r.header.is_hashed
                if not r.header.is_canonical:
                    die(f"{f}: 'canonical' flag is needed")
            elif r.header.k != k:
                die(f"k mismatch: {f}")

    if opt.verbose:
        log.info(f"indexing {len(args.genome)} genome file(s)")
    from ...models.locate import build_genome_index, lookup_ranges

    index = build_genome_index(
        args.genome, k, hashed=hashed, circular=args.circular, name_filters=name_res
    )

    out, _ = out_text_stream(args.out_prefix, opt.compression_level)
    n_index = len(index.seq_idx)
    seen_runs = np.zeros(n_index, bool)  # mark consumed codes by run start
    try:
        for f in files:
            with open_reader(f) as r:
                for codes, _ in r.iter_blocks():
                    if n_index == 0:
                        continue
                    # duplicate codes within a block must print once
                    # (the reference deletes a code from its map at the
                    # first hit, locate.go:274-285); keep first
                    # occurrences in record order
                    _, first_idx = np.unique(codes, return_index=True)
                    if len(first_idx) != len(codes):
                        codes = codes[np.sort(first_idx)]
                    start, end = lookup_ranges(index, codes)
                    found = (start < end) & ~seen_runs[np.minimum(start, n_index - 1)]
                    if not found.any():
                        continue
                    seen_runs[start[found]] = True
                    # expand ranges, preserving .unik record order
                    f_start = start[found]
                    f_len = (end - start)[found]
                    total = int(f_len.sum())
                    # index positions: start_i, start_i+1, ..., end_i-1
                    base = np.repeat(f_start, f_len)
                    offs = np.arange(total) - np.repeat(
                        np.cumsum(f_len) - f_len, f_len
                    )
                    sel = base + offs
                    with stage("render", HOST):
                        out.write(bed6_lines(index, index.seq_idx[sel],
                                             index.pos[sel]).decode())
    finally:
        out.flush()
        if out is not sys.stdout:
            out.close()
    return 0


def bed6_lines(index, sidx: np.ndarray, pos: np.ndarray) -> bytes:
    """The lines ``id\\tpos\\tpos+k\\tkmer\\t0\\t.\\n`` of the hits at
    (sidx, pos), built as one byte buffer: each line's length from its
    id's and its two numbers' widths, offsets by one cumsum, then each
    column scattered."""
    k = index.k
    n = len(sidx)
    if n == 0:
        return b""
    ids = index.ids
    id_len = np.fromiter((len(i) for i in ids), np.int64, len(ids))
    id_off = np.zeros(len(ids), np.int64)
    np.cumsum(id_len[:-1], out=id_off[1:])
    id_blob = np.frombuffer(b"".join(ids), np.uint8)
    lid = id_len[sidx]
    dp, wp = _decimal_digits(pos, _MAX_U64_DIGITS)
    de, we = _decimal_digits(pos + k, _MAX_U64_DIGITS)
    tail = b"\t0\t.\n"
    lengths = lid + 1 + wp + 1 + we + 1 + k + len(tail)
    offsets = np.zeros(n, np.int64)
    np.cumsum(lengths[:-1], out=offsets[1:])
    buf = np.zeros(int(lengths.sum()), np.uint8)
    # the ids: line i's bytes j < lid[i] from id_blob[id_off + j]
    total = int(lid.sum())
    if total:
        within = np.arange(total) - np.repeat(np.cumsum(lid) - lid, lid)
        buf[np.repeat(offsets, lid) + within] = id_blob[
            np.repeat(id_off[sidx], lid) + within]
    o = offsets + lid
    buf[o] = ord("\t")
    _scatter_digits(buf, o + 1, dp, wp, _MAX_U64_DIGITS)
    o = o + 1 + wp
    buf[o] = ord("\t")
    _scatter_digits(buf, o + 1, de, we, _MAX_U64_DIGITS)
    o = o + 1 + we
    buf[o] = ord("\t")
    o = o + 1
    kmers = index.gather_kmers(sidx, pos)
    for j in range(k):
        buf[o + j] = kmers[:, j]
    o = o + k
    for j, ch in enumerate(tail):
        buf[o + j] = ch
    return buf.tobytes()
