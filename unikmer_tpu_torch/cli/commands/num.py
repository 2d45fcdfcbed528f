"""num: quickly inspect the number of k-mers (port of
unikmer_tpu/cli/commands/num.py).

Reference: unikmer/cmd/num.go (-f forces a full scan when the header
Number is the unknown sentinel, num.go:93-107).
"""

from __future__ import annotations

import os
import sys

from ..opts import out_text_stream
from ._common import add_files_arg, new_command, open_reader, unik_inputs


def register(subparsers):
    p = new_command(subparsers, "num", "Quickly inspect the number of k-mers")
    add_files_arg(p)
    p.add_argument("-o", "--out-file", default="-",
                   help='out file ("-" for stdout, suffix .gz for gzipped out)')
    p.add_argument("-n", "--file-name", action="store_true", help="show file name")
    p.add_argument("-b", "--basename", action="store_true",
                   help="only output basename of files")
    p.add_argument("-f", "--force", action="store_true",
                   help="read the whole file and count k-mers")
    p.set_defaults(func=run)


def run(args) -> int:
    opt, files = unik_inputs(args)
    out, _ = out_text_stream(args.out_file, opt.compression_level)
    try:
        for file in files:
            with open_reader(file) as r:
                n = r.header.number
                if n < 0 or args.force:
                    n = sum(len(c) for c, _ in r.iter_blocks())
                name = os.path.basename(file) if args.basename else file
                if args.file_name:
                    # reference prints number first (num.go:110-115)
                    out.write(f"{n}\t{name}\n")
                else:
                    out.write(f"{n}\n")
    finally:
        out.flush()
        if out is not sys.stdout:
            out.close()
    return 0
