"""decode: decode encoded integer to k-mer text (port of
unikmer_tpu/cli/commands/decode.py).

Reference: unikmer/cmd/decode.go (k<=32; overflow checked against
kmers.MaxCode[k], decode.go:99-106).
"""

from __future__ import annotations

import sys

from ...ops import codec
from ...utils.log import die
from ..opts import get_file_list, get_options, out_text_stream
from ._common import new_command


def register(subparsers):
    p = new_command(subparsers, "decode", "Decode encoded integer to k-mer text")
    p.add_argument("files", nargs="*", default=[], help="input text file(s) with one integer per line")
    p.add_argument("-o", "--out-file", default="-",
                   help='out file ("-" for stdout, suffix .gz for gzipped out)')
    p.add_argument("-k", "--kmer-len", type=int, required=True, help="k-mer length")
    p.add_argument("-a", "--all", action="store_true",
                   help="output all data: encoded integer, decoded k-mer")
    p.set_defaults(func=run)


def run(args) -> int:
    opt = get_options(args)
    k = args.kmer_len
    if not 0 < k <= codec.MAX_K_ENCODED:
        die(f"k ({k}) should be in range of [1, {codec.MAX_K_ENCODED}]")
    files = get_file_list(args, check_exists=not opt.skip_file_check)
    out, _ = out_text_stream(args.out_file, opt.compression_level)
    mc = codec.max_code(k)
    try:
        for file in files:
            stream = sys.stdin.buffer if file == "-" else open(file, "rb")
            with stream:
                for line in stream:
                    s = line.strip()
                    if not s:
                        continue
                    try:
                        code = int(s)
                    except ValueError:
                        die(f"invalid integer: {s.decode()}")
                    if code < 0 or code > mc:
                        die(f"code ({code}) overflows for k={k} (max: {mc})")
                    kmer = codec.decode_kmer(code, k)
                    if args.all:
                        out.write(f"{code}\t{kmer}\n")
                    else:
                        out.write(f"{kmer}\n")
    finally:
        out.flush()
        if out is not sys.stdout:
            out.close()
    return 0
