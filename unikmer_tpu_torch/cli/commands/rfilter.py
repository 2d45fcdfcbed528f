"""rfilter: filter k-mers by taxonomic rank (port of
unikmer_tpu/cli/commands/rfilter.py).

Reference: unikmer/cmd/rfilter.go: ranks are ordered by a rank file
(default embedded ranks.txt written into the data dir, descending lines,
order numbers assigned bottom-up so smaller = lower rank); taxids pass
by lower-than/higher-than/equal-to tests, with no-rank handling
(including the "predictable norank" walk up the tree under -L -n),
black lists, and root discarding.
"""

from __future__ import annotations

import os

import numpy as np

from ...io import unik
from ...utils.log import die, log
from ..opts import ensure_unik_suffix, out_binary_stream
from ._common import (
    add_files_arg,
    effective_taxids,
    log_saved,
    new_command,
    open_reader,
    unik_inputs,
)

DEFAULT_RANKS_FILE = "ranks.txt"

DEFAULT_RANKS_TEXT = """\
# This file defines taxonomic rank order for unikmer-tpu (format-compatible
# with unikmer/taxonkit rank files).
#
# Rules:
#     1. Blank lines or lines starting with "#" are ignored.
#     2. Ranks are in descending order and case ignored.
#     3. Ranks with same order should be in one line separated with comma.
#     4. Ranks without order get a "!" prefix.

!no rank
!clade

life
domain,superkingdom,realm,empire
kingdom
subkingdom
infrakingdom
parvkingdom
superphylum,superdivision
phylum,division
subphylum,subdivision
infraphylum,infradivision
microphylum,microdivision
superclass
class
subclass
infraclass
parvclass
superlegion
legion
sublegion
infralegion
supercohort
cohort
subcohort
infracohort
gigaorder
magnorder,megaorder
grandorder,capaxorder
mirorder,hyperorder
superorder
order
nanorder
hypoorder
minorder
suborder
infraorder
parvorder
gigafamily
megafamily
grandfamily
hyperfamily
superfamily
epifamily
group
family
subfamily
infrafamily
supertribe
tribe
subtribe
infratribe
genus
subgenus
section
subsection
series
subseries
superspecies,species group
species subgroup
species
subspecies,forma specialis,pathovar
pathogroup,serogroup
biotype,serotype,genotype
variety,varietas,morph,aberration
subvariety,subvarietas,submorph,subaberration
form,forma
subform,subforma
strain
isolate
"""


def register(subparsers):
    p = new_command(subparsers, "rfilter", "Filter k-mers by taxonomic rank")
    add_files_arg(p)
    p.add_argument("-o", "--out-prefix", default="-",
                   help='out file prefix ("-" for stdout)')
    p.add_argument("-r", "--rank-file", default="",
                   help="user-defined ordered taxonomic ranks")
    p.add_argument("--list-order", action="store_true",
                   help="list defined ranks in order")
    p.add_argument("--list-ranks", action="store_true",
                   help="list ordered ranks in taxonomy database")
    p.add_argument("-N", "--discard-noranks", action="store_true",
                   help="discard ranks without order")
    p.add_argument("-n", "--save-predictable-norank", action="store_true",
                   help="with -L, keep no-rank taxids whose closest ranked "
                        "ancestor is still lower than the cutoff")
    p.add_argument("-B", "--black-list", action="append", default=[],
                   help="black list of ranks to discard")
    p.add_argument("-R", "--discard-root", action="store_true",
                   help="discard root taxid, defined by --root-taxid")
    p.add_argument("--root-taxid", type=int, default=1, help="root taxid")
    p.add_argument("-L", "--lower-than", default="",
                   help="output ranks lower than a rank, exclusive with --higher-than")
    p.add_argument("-H", "--higher-than", default="",
                   help="output ranks higher than a rank, exclusive with --lower-than")
    p.add_argument("-E", "--equal-to", action="append", default=[],
                   help="output taxids with rank equal to some ranks")
    p.set_defaults(func=run)


def read_rank_order(path: str):
    """Returns (rank -> order, set of no-order ranks)."""
    lines = []
    with open(path) as f:
        for raw in f:
            line = raw.strip().lower()
            if not line or line.startswith("#"):
                continue
            lines.append(line)
    noranks = set()
    ordered_lines = []
    for line in lines:
        if line.startswith("!"):
            noranks.add(line[1:].strip())
        else:
            ordered_lines.append([r.strip() for r in line.split(",")])
    rank_order = {}
    order = 1
    for group in reversed(ordered_lines):
        for rank in group:
            if rank in rank_order:
                die(f"duplicated rank: {rank}")
            rank_order[rank] = order
        order += 1
    if not rank_order:
        die(f"no ranks found in file: {path}")
    return rank_order, noranks


class RankFilter:
    def __init__(self, taxdb, rank_order, noranks, lower, higher, equals,
                 black_list, discard_norank, save_predictable):
        self.taxdb = taxdb
        self.rank_order = rank_order
        self.noranks = noranks
        self.black = {r.strip().lower() for r in black_list}
        self.discard_norank = discard_norank
        self.save_predictable = save_predictable
        db_ranks = {r.lower() for r in taxdb.ranks}

        def get_order(rank):
            rank = rank.lower()
            if rank not in rank_order:
                die(f"rank order not defined in rank file: {rank}")
            if rank not in db_ranks:
                die(f"rank order not found in taxonomy database: {rank}")
            return rank_order[rank]

        self.o_lower = get_order(lower) if lower else None
        self.o_higher = get_order(higher) if higher else None
        self.o_equals = {get_order(e) for e in equals} if equals else None
        self._cache: dict[int, bool] = {}

    def passes(self, taxid: int) -> bool:
        rank = self.taxdb.rank(taxid).lower()
        if not rank:
            return False
        if taxid in self._cache:
            return self._cache[taxid]
        res = self._passes_uncached(taxid, rank)
        self._cache[taxid] = res
        return res

    def _passes_uncached(self, taxid: int, rank: str) -> bool:
        if rank in self.black:
            return False
        is_norank = False
        if rank in self.noranks and self.discard_norank:
            is_norank = True
            if not self.save_predictable:
                return False
        if is_norank and self.o_lower is not None and self.save_predictable:
            parent = int(self.taxdb.parent[taxid])
            while True:
                if parent == 1:
                    return False
                prank = self.taxdb.rank(parent).lower()
                if prank in self.rank_order:
                    return self.rank_order[prank] <= self.o_lower
                parent = int(self.taxdb.parent[parent])
        order = self.rank_order.get(rank, 0)
        if self.o_equals is not None:
            if order in self.o_equals:
                return True
            if self.o_lower is not None:
                return order < self.o_lower
            if self.o_higher is not None:
                return order > self.o_higher
            return False
        if self.o_lower is not None:
            return order < self.o_lower
        if self.o_higher is not None:
            return order > self.o_higher
        return True


def run(args) -> int:
    opt, files = unik_inputs(args)
    if args.lower_than and args.higher_than:
        die("higher and lower can't be simultaneously given")

    rank_file = args.rank_file
    if not rank_file:
        os.makedirs(opt.data_dir, exist_ok=True)
        rank_file = os.path.join(opt.data_dir, DEFAULT_RANKS_FILE)
        if not os.path.exists(rank_file):
            if opt.verbose:
                log.info(f"write default rank order to: {rank_file}")
            with open(rank_file, "w") as f:
                f.write(DEFAULT_RANKS_TEXT)
    rank_order, noranks = read_rank_order(rank_file)

    if args.list_order:
        for rank, _ in sorted(rank_order.items(), key=lambda kv: -kv[1]):
            print(rank)
        return 0

    from ...taxonomy.taxdump import load_taxonomy

    taxdb = load_taxonomy(opt.data_dir, with_rank=True, verbose=opt.verbose)

    if args.list_ranks:
        db_ranks = {r.lower() for r in taxdb.ranks}
        for rank, _ in sorted(rank_order.items(), key=lambda kv: -kv[1]):
            if rank in db_ranks:
                print(rank)
        return 0

    filt = RankFilter(
        taxdb, rank_order, noranks,
        args.lower_than, args.higher_than,
        [e for arg in args.equal_to for e in arg.split(",") if e],
        args.black_list, args.discard_noranks, args.save_predictable_norank,
    )

    out_file = ensure_unik_suffix(args.out_prefix)
    writer = None
    n = 0
    for file in files:
        with open_reader(file) as r:
            h = r.header
            if not h.has_taxid_info or opt.ignore_taxid:
                die(f"input files should have taxid information: {file}")
            if writer is None:
                flag = h.flag | unik.INCLUDE_TAXID
                out, _ = out_binary_stream(out_file)
                writer = unik.UnikWriter(
                    out,
                    k=h.k,
                    flag=flag,
                    max_taxid=(1 << (8 * (h.taxid_bytes or 4))) - 1,
                    compress=opt.compress,
                    compression_level=opt.compression_level,
                    threads=opt.threads,
                )
            for codes, taxids in r.iter_blocks():
                taxids = effective_taxids(r, len(codes), taxids, False)
                uniq = np.unique(taxids)
                ok_taxids = np.array(
                    [t for t in uniq
                     if (not (args.discard_root and int(t) == args.root_taxid))
                     and filt.passes(int(t))],
                    dtype=np.uint32,
                )
                keep = np.isin(taxids, ok_taxids)
                kept = codes[keep]
                writer.write_codes(kept, taxids[keep])
                n += len(kept)
    if writer is not None:
        writer.close()
    log_saved(opt, n, out_file)
    return 0
