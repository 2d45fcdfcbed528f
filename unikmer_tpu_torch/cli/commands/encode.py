"""encode: encode plain k-mer text to integer (port of
unikmer_tpu/cli/commands/encode.py).

Reference: unikmer/cmd/encode.go (per-line encode or ntHash; -a prints
original, parsed k-mer, integer and bits; -K canonical).
"""

from __future__ import annotations

import sys

from ...ops import codec
from ...ops.nthash import nthash_kmer
from ...utils.log import die
from ..opts import get_file_list, out_text_stream
from ._common import new_command


def register(subparsers):
    p = new_command(subparsers, "encode", "Encode plain k-mer text to integer")
    p.add_argument("files", nargs="*", default=[], help="input text file(s) with one k-mer per line")
    p.add_argument("-o", "--out-file", default="-",
                   help='out file ("-" for stdout, suffix .gz for gzipped out)')
    p.add_argument("-a", "--all", action="store_true",
                   help="output all data: original k-mer, parsed k-mer, encoded integer, encoded bits")
    p.add_argument("-K", "--canonical", action="store_true", help="keep the canonical k-mers")
    p.add_argument("-H", "--hash", action="store_true",
                   help="save hash of k-mer, automatically on for k>32")
    p.set_defaults(func=run)


def run(args) -> int:
    from ..opts import get_options

    opt = get_options(args)
    files = get_file_list(args, check_exists=not opt.skip_file_check)
    out, _ = out_text_stream(args.out_file, opt.compression_level)
    try:
        for file in files:
            stream = sys.stdin.buffer if file == "-" else open(file, "rb")
            with stream:
                for line in stream:
                    kmer = line.strip()
                    if not kmer:
                        continue
                    _encode_one(kmer, args, out)
    finally:
        out.flush()
        if out is not sys.stdout:
            out.close()
    return 0


def _encode_one(kmer: bytes, args, out) -> None:
    k = len(kmer)
    hashed = args.hash or k > codec.MAX_K_ENCODED
    if hashed:
        if k > codec.MAX_K_HASHED:
            die(f"k-mer longer than {codec.MAX_K_HASHED}: {kmer.decode()}")
        h = nthash_kmer(kmer, canonical=args.canonical)
        if args.all:
            out.write(f"{kmer.decode()}\t{kmer.decode().upper()}\t{h}\n")
        else:
            out.write(f"{h}\n")
        return
    try:
        code = codec.encode_kmer(kmer)
    except ValueError as e:
        die(str(e))
    parsed = kmer.decode().upper().replace("U", "T")
    if args.canonical:
        code = int(codec.canonical_np(code, k))
        parsed = codec.decode_kmer(code, k)
    if args.all:
        out.write(
            f"{kmer.decode()}\t{parsed}\t{code}\t{codec.bits_string(code, k)}\n"
        )
    else:
        out.write(f"{code}\n")
