"""split: split k-mers into sorted chunk files (port of
unikmer_tpu/cli/commands/split.py).

Reference: unikmer/cmd/split.go: the chunking half of `sort -m`; an
already-sorted input streams into size-limited chunks without a re-sort
(split.go:137,184-280).
"""

from __future__ import annotations

import os
import shutil

from ...io import unik
from ...pipeline import extsort
from ...utils.log import die, log
from ...utils.sizes import parse_byte_size
from ._common import (
    add_files_arg,
    check_taxid_info_match,
    effective_taxids,
    new_command,
    open_reader,
    unik_inputs,
)
from ._setops import maybe_taxonomy
from ...io.unik import check_compatibility
from ...utils.log import check_error


def register(subparsers):
    p = new_command(subparsers, "split", "Split k-mers into sorted chunk files")
    add_files_arg(p)
    p.add_argument("-O", "--out-dir", default="", help="output directory")
    p.add_argument("-m", "--chunk-size", default="",
                   help="split input into chunks of N k-mers, supports K/M/G suffix")
    p.add_argument("--force", action="store_true", help="overwrite output directory")
    p.add_argument("-u", "--unique", action="store_true",
                   help="split for further removing duplicate k-mers")
    p.add_argument("-d", "--repeated", action="store_true",
                   help="split for further printing duplicate k-mers")
    p.set_defaults(func=run)


def run(args) -> int:
    opt, files = unik_inputs(args)
    if args.unique and args.repeated:
        die("flag -u/--unique and -d/--repeated are not compatible")
    mode = "unique" if args.unique else "repeated" if args.repeated else "none"

    out_dir = args.out_dir
    if not out_dir:
        out_dir = ("stdin" if files[0] == "-" else files[0]) + ".split"
    if os.path.exists(out_dir):
        if args.force:
            shutil.rmtree(out_dir)
        elif os.listdir(out_dir):
            die(f"outdir not empty: {out_dir}, use --force to overwrite")
    os.makedirs(out_dir, exist_ok=True)

    chunk_size = parse_byte_size(args.chunk_size) if args.chunk_size else 0

    state = {"h0": None, "has_taxid": False, "taxdb": None, "idx": 0, "n": 0}

    def base_flag():
        f = 0
        if state["h0"].is_canonical:
            f |= unik.CANONICAL
        if state["h0"].is_hashed:
            f |= unik.HASHED
        return f

    def on_chunk(codes, taxids):
        path = extsort.chunk_file_name(out_dir, state["idx"])
        extsort.dump_chunk(
            codes, taxids, path, state["h0"].k, base_flag(), mode,
            state["taxdb"], opt,
        )
        if opt.verbose:
            log.info(f"chunk {state['idx']}: {len(codes)} k-mers saved to {path}")
        state["idx"] += 1
        state["n"] += len(codes)

    acc = None
    for f in files:
        with open_reader(f, stream=True) as r:
            if state["h0"] is None:
                state["h0"] = r.header
                state["has_taxid"] = (
                    not opt.ignore_taxid and r.header.has_taxid_info
                )
                if state["has_taxid"] and mode != "none":
                    state["taxdb"] = maybe_taxonomy(opt, True)
                acc = extsort.ChunkAccumulator(
                    chunk_size, state["has_taxid"], on_chunk
                )
            else:
                if not opt.skip_flag_check:
                    try:
                        check_compatibility(state["h0"], r.header, f)
                    except ValueError as e:
                        check_error(e)
                # split.go:228-233
                check_taxid_info_match(state["h0"], r.header, f, opt)
            for codes, taxids in r.iter_blocks():
                taxids = effective_taxids(r, len(codes), taxids, opt.ignore_taxid)
                acc.add(codes, taxids)
    if acc is not None:
        acc.flush()
    if opt.verbose:
        log.info(
            f"{state['n']} k-mers saved to {state['idx']} chunk files in {out_dir}"
        )
    return 0
