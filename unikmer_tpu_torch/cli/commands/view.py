"""view: read and output binary format to plain text (port of
unikmer_tpu/cli/commands/view.py).

Reference: unikmer/cmd/view.go (output formats at view.go:187-217).
The plain text modes take the native renderer (native/host_native.cpp),
else vectorized numpy (utils/textout.py): whole blocks of lines built as
byte buffers.

``-g`` (decoding hashed k-mers through their genomes) needs
models/locate.py, which is not ported yet: where the JAX CLI would use
it, the command exits naming ROADMAP.md.
"""

from __future__ import annotations

import gzip
import sys

import numpy as np

from ... import native
from ...io.unik import check_compatibility
from ...ops.codec import decode_codes
from ...utils import textout
from ...utils.log import check_error, die, log
from ._common import (
    add_files_arg,
    check_taxid_info_match,
    effective_taxids,
    new_command,
    open_reader,
    unik_inputs,
)

GENOME_NOT_PORTED = ("-g/--genome (models/locate.py): ROADMAP.md queue 1 "
                     "group E")


def register(subparsers):
    p = new_command(subparsers, "view", "Read and output binary format to plain text")
    add_files_arg(p)
    p.add_argument("-o", "--out-file", default="-",
                   help='out file ("-" for stdout, suffix .gz for gzipped out)')
    p.add_argument("-n", "--show-code", action="store_true",
                   help="show encoded integer along with k-mer")
    p.add_argument("-N", "--show-code-only", action="store_true",
                   help="only show encoded integers")
    p.add_argument("-a", "--fasta", action="store_true",
                   help="output in FASTA format, with encoded integer as FASTA header")
    p.add_argument("-q", "--fastq", action="store_true",
                   help="output in FASTQ format, with encoded integer as FASTQ header")
    p.add_argument("-t", "--show-taxid", action="store_true", help="show taxid")
    p.add_argument("-T", "--show-taxid-only", action="store_true", help="show taxid only")
    p.add_argument("-g", "--genome", action="append", default=[],
                   help="genomes in (gzipped) fasta file(s) for decoding "
                        "hashed k-mers (not ported yet)")
    p.set_defaults(func=run)


def _out_binary(path: str, level: int):
    if path == "-":
        return sys.stdout.buffer, False
    if path.lower().endswith(".gz"):
        return gzip.open(path, "wb", compresslevel=level), True
    return open(path, "wb"), True


def run(args) -> int:
    opt, files = unik_inputs(args)
    show_taxid = args.show_taxid and not opt.ignore_taxid

    out, owns = _out_binary(args.out_file, opt.compression_level)
    h0 = None
    k = None
    try:
        for file in files:
            with open_reader(file) as r:
                h = r.header
                if h0 is not None:
                    # view.go:149-154: flag compat + taxid-info match
                    if not opt.skip_flag_check:
                        try:
                            check_compatibility(h0, h, file)
                        except ValueError as e:
                            check_error(e)
                    check_taxid_info_match(h0, h, file, opt)
                if h0 is None:
                    h0 = h
                    k = h.k
                    if show_taxid and not h.has_taxid_info:
                        log.warning(
                            "flag -t/--show-taxid ignored when no taxids found in input"
                        )
                        show_taxid = False
                    if args.genome:
                        if not h.is_hashed:
                            log.warning("-g/--genome ignored since k-mers not hashed")
                        elif not h.is_canonical:
                            log.warning(
                                "-g/--genome ignored since 'canonical' flag is off"
                            )
                        else:
                            die("not supported by unikmer_tpu_torch yet: "
                                + GENOME_NOT_PORTED)
                for codes, taxids in r.iter_blocks():
                    taxids = effective_taxids(r, len(codes), taxids, opt.ignore_taxid)
                    if taxids is None:
                        taxids = np.zeros(len(codes), np.uint32)
                    out.write(_render_block(args, show_taxid, h, k, codes,
                                            taxids))
    finally:
        out.flush()
        if owns:
            out.close()
    return 0


def _render_block(args, show_taxid, h, k, codes, taxids):
    if not (args.fasta or args.fastq):
        r = _render_native(args, show_taxid, h, k, codes, taxids)
        if r is not None:
            return r
    # (n, k) byte matrix of k-mer strings; None for hashed codes, which
    # print as integers
    arr = None if h.is_hashed else decode_codes(codes, k)
    if args.fasta or args.fastq:
        return _render_fastx(args, show_taxid, k, codes, taxids, arr)
    if show_taxid:
        if arr is None:
            return textout.lines_two_ints(codes, taxids)
        return textout.lines_fixed_plus_int(arr, taxids)
    if args.show_taxid_only:
        return textout.lines_fixed_plus_int(None, taxids)
    if args.show_code_only:
        return textout.lines_fixed_plus_int(None, codes)
    if args.show_code:
        if arr is None:
            return textout.lines_two_ints(codes, codes)
        return textout.lines_fixed_plus_int(arr, codes)
    if arr is None:
        return textout.lines_fixed_plus_int(None, codes)
    return textout.lines_fixed(arr)


def _render_native(args, show_taxid, h, k, codes, taxids):
    """Fused native decode and format for the plain text modes; None ->
    the numpy path."""
    dk = None if h.is_hashed else k  # hashed codes print as integers
    if show_taxid:
        return native.render_lines(codes, dk, taxids)
    if args.show_taxid_only:
        return native.render_lines(taxids.astype(np.uint64), None)
    if args.show_code_only:
        return native.render_lines(codes, None)
    if args.show_code:
        return native.render_lines(codes, dk, codes)
    return native.render_lines(codes, dk)


def _render_fastx(args, show_taxid, k, codes, taxids, arr):
    lead = b">" if args.fasta else b"@"
    if arr is None:
        # undecodable hashes: digits as the "sequence"
        parts = []
        quality = b"g" * k
        for i in range(len(codes)):
            head = f"{lead.decode()}{int(codes[i])}"
            if show_taxid:
                head += f" {int(taxids[i])}"
            km = str(int(codes[i]))
            if args.fasta:
                parts.append(f"{head}\n{km}\n")
            else:
                parts.append(f"{head}\n{km}\n+\n{quality.decode()}\n")
        return "".join(parts).encode()
    if args.fasta and not show_taxid:
        return textout.lines_int_plus_fixed(codes, arr, lead, b"\n", b"\n")
    if args.fastq and not show_taxid:
        quality = b"g" * k
        return textout.lines_int_plus_fixed(
            codes, arr, lead, b"\n", b"\n+\n" + quality + b"\n"
        )
    # with taxid in header: per-line loop (uncommon path)
    parts = []
    quality = "g" * k
    rows = np.ascontiguousarray(arr).view(f"S{k}")[:, 0]
    for i in range(len(codes)):
        km = rows[i].decode()
        if args.fasta:
            parts.append(f">{int(codes[i])} {int(taxids[i])}\n{km}\n")
        else:
            parts.append(f"@{int(codes[i])} {int(taxids[i])}\n{km}\n+\n{quality}\n")
    return "".join(parts).encode()
