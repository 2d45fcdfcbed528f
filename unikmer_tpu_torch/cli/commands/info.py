"""info (alias stats): information of binary files (port of
unikmer_tpu/cli/commands/info.py).

Reference: unikmer/cmd/info.go (columns at info.go:403-421).
"""

from __future__ import annotations

import os
import sys
from concurrent.futures import ThreadPoolExecutor

from ...utils.log import log
from ...utils.sizes import humanize
from ..opts import out_text_stream
from ._common import add_files_arg, new_command, open_reader, unik_inputs

COLUMNS = [
    "file", "k", "canonical", "hashed", "scaled", "include-taxid",
    "global-taxid", "sorted", "compact", "gzipped", "version", "number",
    "description",
]


def register(subparsers):
    p = new_command(subparsers, "info", "Information of binary files", aliases=["stats"])
    add_files_arg(p)
    p.add_argument("-o", "--out-file", default="-",
                   help='out file ("-" for stdout, suffix .gz for gzipped out)')
    p.add_argument("-a", "--all", action="store_true",
                   help="all information, including number of k-mers")
    p.add_argument("-T", "--tabular", action="store_true",
                   help="output in machine-friendly tabular format")
    p.add_argument("-e", "--skip-err", action="store_true",
                   help="skip error, only show warning message")
    p.add_argument("--symbol-true", default="✓", help="symbol for true")
    p.add_argument("--symbol-false", default="✕", help="symbol for false")
    p.add_argument("-b", "--basename", action="store_true",
                   help="only output basename of files")
    p.set_defaults(func=run)


def _stat_one(file, args, opt):
    try:
        with open_reader(file, stream=True) as r:
            h = r.header
            n = h.number
            if n < 0 and args.all:
                n = sum(len(c) for c, _ in r.iter_blocks())
            name = os.path.basename(file) if args.basename else file
            return dict(
                file=name,
                k=h.k,
                canonical=h.is_canonical,
                hashed=h.is_hashed,
                scaled=h.is_scaled,
                include_taxid=h.is_include_taxid,
                global_taxid=str(h.global_taxid) if h.global_taxid > 0 else "",
                sorted=h.is_sorted,
                compact=h.is_compact,
                gzipped=r.gzipped,
                version=f"v{h.main_version}.{h.minor_version}",
                number=n,
                description=h.description.decode("utf-8", "replace"),
                err=None,
            )
    except Exception as e:  # pragma: no cover
        return dict(file=file, err=e)


def run(args) -> int:
    opt, files = unik_inputs(args)
    if args.symbol_true == args.symbol_false:
        from ...utils.log import die

        die("values of --symbol-true and --symbol-false should be different")

    with ThreadPoolExecutor(max_workers=opt.threads) as ex:
        infos = list(ex.map(lambda f: _stat_one(f, args, opt), files))

    rows = []
    for inf in infos:
        if inf.get("err") is not None:
            if args.skip_err:
                log.warning(f"{inf['file']}: {inf['err']}")
                continue
            from ...utils.log import check_error

            check_error(inf["err"], f"{inf['file']}: ")
        b = lambda v: args.symbol_true if v else args.symbol_false
        number = inf["number"]
        num_str = str(number) if args.tabular else (
            humanize(number) if number >= 0 else "-1"
        )
        rows.append([
            inf["file"], str(inf["k"]), b(inf["canonical"]), b(inf["hashed"]),
            b(inf["scaled"]), b(inf["include_taxid"]), inf["global_taxid"],
            b(inf["sorted"]), b(inf["compact"]), b(inf["gzipped"]),
            inf["version"], num_str, inf["description"],
        ])

    out, _ = out_text_stream(args.out_file, opt.compression_level)
    try:
        if args.tabular:
            out.write("\t".join(COLUMNS) + "\n")
            for row in rows:
                out.write("\t".join(row) + "\n")
        else:
            widths = [len(c) for c in COLUMNS]
            for row in rows:
                widths = [max(w, len(v)) for w, v in zip(widths, row)]
            # right-align numeric-ish columns like the reference table
            right = {1, 6, 11}
            def fmt(vals):
                parts = []
                for i, v in enumerate(vals):
                    parts.append(v.rjust(widths[i]) if i in right else v.ljust(widths[i]))
                return "  ".join(parts).rstrip()
            out.write(fmt(COLUMNS) + "\n")
            for row in rows:
                out.write(fmt(row) + "\n")
    finally:
        out.flush()
        if out is not sys.stdout:
            out.close()
    return 0
