"""dump: convert plain k-mer text to binary format (port of
unikmer_tpu/cli/commands/dump.py).

Reference: unikmer/cmd/dump.go — per-line 2-bit encode / ntHash /
pre-hashed integers; optional tab-separated taxid column (k inferred
from the first line; --canonical-only drops non-canonical input;
-u keeps the first occurrence of each code).
"""

from __future__ import annotations

import sys

import numpy as np

from ...io import unik
from ...ops import codec
from ...ops.nthash import nthash_kmer, nthash_rows_np
from ...utils.log import die, log
from ..opts import ensure_unik_suffix, get_file_list, get_options, out_binary_stream
from ._common import new_command, log_saved


def register(subparsers):
    p = new_command(subparsers, "dump", "Convert plain k-mer text to binary format")
    p.add_argument("files", nargs="*", default=[], help="input text file(s), one k-mer per line")
    p.add_argument("-o", "--out-prefix", default="-",
                   help='out file prefix ("-" for stdout)')
    p.add_argument("-u", "--unique", action="store_true", help="remove duplicate k-mers")
    p.add_argument("-K", "--canonical", action="store_true", help="save the canonical k-mers")
    p.add_argument("-O", "--canonical-only", action="store_true",
                   help="only save the canonical k-mers. Overrides -K/--canonical")
    p.add_argument("-s", "--sorted", action="store_true", help="input k-mers are sorted")
    p.add_argument("-t", "--taxid", type=int, default=0, help="global taxid")
    p.add_argument("-H", "--hash", action="store_true",
                   help="save hash of k-mer, automatically on for k>32. Overrides -c/--compact")
    p.add_argument("--hashed", action="store_true",
                   help="giving hash values of k-mers. Overrides -c/--compact")
    p.add_argument("-k", "--kmer-len", type=int, default=0, help="k-mer length")
    p.set_defaults(func=run)


def run(args) -> int:
    opt = get_options(args)
    files = get_file_list(args, check_exists=not opt.skip_file_check)
    out_file = ensure_unik_suffix(args.out_prefix)
    hashed_already = args.hashed
    if hashed_already and args.kmer_len <= 0:
        die("flag -k/--kmer-len needed when --hashed given")
    hashed = args.hash
    canonical = args.canonical or args.canonical_only

    # buffer all input text once (the loop's memory is O(records) anyway)
    blobs = []
    for file in files:
        stream = sys.stdin.buffer if file == "-" else open(file, "rb")
        with stream:
            blobs.append(stream.read())
    data = blobs[0] if len(blobs) == 1 else b"".join(blobs)
    del blobs

    fast = _parse_fast(data, args, hashed, canonical)
    if fast is not None:
        codes_arr, taxids_arr, k, include_taxid, hashed = fast
        return _write_out(args, opt, out_file, codes_arr, taxids_arr, k,
                          include_taxid, hashed, hashed_already, canonical)

    include_taxid = None
    k = args.kmer_len if hashed_already else -1
    global_taxid = args.taxid
    codes_out: list[int] = []
    taxids_out: list[int] = []
    seen = set() if args.unique else None

    import io as _io

    with _io.BytesIO(data) as stream:
        for raw in stream:
                line = raw.strip()
                if not line:
                    continue
                taxid = 0
                if include_taxid is None:
                    include_taxid = b"\t" in line
                    if include_taxid and global_taxid > 0:
                        log.warning(
                            "since input has more than one column, global taxid is ignored"
                        )
                if include_taxid:
                    items = line.split(b"\t")
                    if len(items) < 2:
                        die("inconsistent two column tabular format")
                    line = items[0]
                    try:
                        taxid = int(items[1])
                        if not 0 <= taxid <= 0xFFFFFFFF:  # Go ParseUint(.., 32)
                            raise ValueError
                    except ValueError:
                        die(
                            "query taxid (2nd column) should be positive integer: "
                            + items[1].decode()
                        )

                if hashed_already:
                    try:
                        code = int(line)
                        if not 0 <= code < (1 << 64):
                            raise ValueError
                    except ValueError:
                        die(f"invalid hash value: {line.decode()}")
                else:
                    l = len(line)
                    if k == -1:
                        k = l
                        if k > codec.MAX_K_ENCODED and not hashed:
                            hashed = True
                            log.warning("flag -H/--hash is switched on for k > 32")
                    elif l != k:
                        die(
                            f"K-mer length mismatch, previous: {k}, current: {l}. "
                            + line.decode()
                        )
                    if hashed:
                        if k > codec.MAX_K_HASHED:
                            die(f"k-mer size ({k}) should be <=64")
                        code = nthash_kmer(line, canonical=canonical)
                    else:
                        try:
                            code = codec.encode_kmer(line)
                        except ValueError as e:
                            die(f"fail to encode '{line.decode()}': {e}")
                        if args.canonical_only:
                            canon = int(codec.canonical_np(code, k))
                            if canon != code:
                                continue
                            code = canon
                        elif args.canonical:
                            code = int(codec.canonical_np(code, k))

                if seen is not None:
                    if code in seen:
                        continue
                    seen.add(code)
                codes_out.append(code)
                if include_taxid:
                    taxids_out.append(taxid)

    return _write_out(
        args, opt, out_file, np.array(codes_out, np.uint64),
        np.array(taxids_out, np.uint32) if include_taxid else None,
        k, bool(include_taxid), hashed, hashed_already, canonical,
    )


def _parse_fast(data: bytes, args, hashed: bool, canonical: bool):
    """Native bulk parse of the whole input (native/unikit_native.cpp
    parse_code_lines) with vectorized canonical / ntHash / dedup.
    Returns (codes, taxids, k, include_taxid, hashed) or None to fall
    back to the per-line loop (exact reference error messages)."""
    from ... import native

    if native.get_lib() is None:
        return None
    stripped = data.strip()
    if not stripped:
        return np.zeros(0, np.uint64), None, args.kmer_len, False, hashed
    first = stripped.split(b"\n", 1)[0].strip()
    include_taxid = b"\t" in first
    warnings = []
    if include_taxid and args.taxid > 0:
        warnings.append("since input has more than one column, global taxid is ignored")
    hashed_already = args.hashed
    if hashed_already:
        k = args.kmer_len
        kmer_mode = False
    else:
        token = first.split(b"\t", 1)[0]
        k = len(token)
        kmer_mode = True
        if k > codec.MAX_K_ENCODED:
            # the bulk parser packs a k-mer token into one u64 (k <= 32);
            # longer tokens (auto -H) take the per-line path
            return None
    res = native.parse_code_lines(data, kmer_mode, k, include_taxid)
    if res is None or isinstance(res, int):
        return None  # unavailable or malformed: per-line loop reports
    for w in warnings:
        log.warning(w)
    codes, taxids = res
    if kmer_mode:
        if hashed:
            rows = _codes_to_base_rows(codes, k)
            codes = nthash_rows_np(rows, canonical)
        elif args.canonical_only:
            canon = codec.canonical_np(codes, k)
            keep = canon == codes
            codes = codes[keep]
            if taxids is not None:
                taxids = taxids[keep]
        elif args.canonical:
            codes = codec.canonical_np(codes, k)
    if args.unique:
        _, idx = np.unique(codes, return_index=True)
        idx.sort(kind="stable")  # first occurrence, input order
        codes = codes[idx]
        if taxids is not None:
            taxids = taxids[idx]
    return codes, taxids, k, include_taxid, hashed


def _codes_to_base_rows(codes: np.ndarray, k: int) -> np.ndarray:
    """(n, k) 2-bit base rows from packed codes (little-endian view)."""
    byte_view = np.ascontiguousarray(codes, np.uint64).view(np.uint8).reshape(-1, 8)
    out = np.empty((len(codes), k), np.uint8)
    for j in range(k):
        bit = 2 * (k - 1 - j)
        out[:, j] = (byte_view[:, bit >> 3] >> (bit & 7)) & 3
    return out


def _write_out(args, opt, out_file, codes_arr, taxids_arr, k, include_taxid,
               hashed, hashed_already, canonical) -> int:
    if k <= 0:
        k = 1
    flag = 0
    if args.sorted:
        flag |= unik.SORTED
    elif opt.compact and not (hashed or hashed_already):
        flag |= unik.COMPACT
    if canonical:
        flag |= unik.CANONICAL
    if include_taxid:
        flag |= unik.INCLUDE_TAXID
    if hashed or hashed_already:
        flag |= unik.HASHED
    out, _ = out_binary_stream(out_file)
    with unik.UnikWriter(
        out,
        k=k,
        flag=flag,
        number=len(codes_arr),
        global_taxid=args.taxid if (args.taxid > 0 and not include_taxid) else 0,
        max_taxid=opt.max_taxid,
        compress=opt.compress,
        compression_level=opt.compression_level,
        threads=opt.threads,
    ) as w:
        w.write_codes(codes_arr, taxids_arr if include_taxid else None)
    log_saved(opt, len(codes_arr), out_file)
    return 0
