"""Peak device bytes a slot of each admitted set route (card only).

    python -m unikmer_tpu_torch.slot_bytes [--log2-codes 25]

For every key of ops/device_sets.SLOT_BYTES this builds the route's
inputs on the card (sets of about 2^25 codes, as chip_smoke.py's sets
path; from_fasta over 4 seeded records of 2^25 bases, 4 pieces), lets
the caching allocator start clean (``torch.cuda.empty_cache`` and
``reset_peak_memory_stats``), runs the route once through its public
entry (a KmerSet operator, ``KmerSet.from_fasta`` / ``from_codes``,
``union_taxids_device``, ``DeviceMembership``), and reads
``max_memory_allocated`` less what was allocated before: the inputs that
were already resident are not counted, the result is.  Dividing by the
route's slots (device_sets.SLOT_BYTES says which) gives the bytes a slot
that the element budget divides the free bytes by.

The taxid union runs over 2^24 slots, every code in 8 inputs so that
every slot merges, with taxids from a chain taxonomy (a paths table as
wide as the chain is deep), less the table it uploads: the table tier
over a 16-deep chain, the paths tier over 16- and 64-deep chains, whose
two peaks fit SLOT_BYTES["union_taxids_paths"] + Dp * PATH_COLUMN_BYTES.
Prints one JSON line a run, then the measured table and the fit beside
the constants, and exits 1 when a run measured above its constants.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

TAX_NODES = 100_000
TAX_CHAIN = 40


def synthetic_taxonomy(rng):
    """A port Taxonomy of TAX_NODES nodes: the parent of t uniform in
    [1, t), and a chain of TAX_CHAIN nodes under node 2 (chip_smoke.py's
    -T tree)."""
    from .taxonomy.taxdump import Taxonomy

    body = TAX_NODES - TAX_CHAIN
    parent = np.zeros(TAX_NODES + 1, np.int64)
    parent[1] = 1
    parent[2:body + 1] = rng.integers(1, np.arange(2, body + 1))
    chain = np.arange(body + 1, TAX_NODES + 1)
    parent[chain] = np.concatenate([[2], chain[:-1]])
    depth = np.full(TAX_NODES + 1, -1, np.int64)
    depth[1] = 0
    for t in range(2, TAX_NODES + 1):  # parents precede their children
        depth[t] = depth[parent[t]] + 1
    return Taxonomy.from_numpy(parent, depth, np.zeros(TAX_NODES + 1),
                               ["no rank"])


def peak_above(fn) -> int:
    """Peak bytes allocated while fn() runs, above what was allocated
    before it (its result included)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak


def measure(dev, log2_codes: int = 25, seed: int = 20261017) -> dict:
    """{route: (slots, peak bytes)} for every route of SLOT_BYTES, the
    taxid union's as taxid_union_peaks gives them."""
    from .api import KmerSet
    from .models.count import _padded_len
    from .ops import device_sets
    from .ops.device_sets import DeviceMembership

    rng = np.random.default_rng(seed)
    n = 1 << log2_codes
    taxdb = synthetic_taxonomy(rng)
    pool = rng.choice(np.flatnonzero(taxdb.depth > 0), 512,
                      replace=False).astype(np.uint32)

    def codes(m):
        return np.unique(rng.integers(0, 1 << 46, size=m, dtype=np.uint64))

    a_np = codes(n)
    b_np = np.unique(np.concatenate([a_np[: len(a_np) // 2],
                                     codes(n // 2)]))
    c_np = np.unique(np.concatenate([a_np[len(a_np) // 4:len(a_np) // 2],
                                     b_np[-len(b_np) // 4:], codes(n // 2)]))
    kw = dict(canonical=True, assume_sorted_unique=True, device=dev)
    a, b, c = (KmerSet.from_codes(x, 23, **kw) for x in (a_np, b_np, c_np))
    ta_np = rng.choice(pool, len(a_np)).astype(np.uint32)
    tb_np = rng.choice(pool, len(b_np)).astype(np.uint32)
    at = KmerSet.from_codes(a_np, 23, taxids=ta_np, taxdb=taxdb, **kw)
    bt = KmerSet.from_codes(b_np, 23, taxids=tb_np, taxdb=taxdb, **kw)
    pair = a.capacity + b.capacity
    out = {
        "union": (pair, peak_above(lambda: a | b)),
        "union_one_sided": (pair, peak_above(lambda: at | b)),
        "union_taxids": (pair, peak_above(lambda: at | bt)),
        "intersect": (pair, peak_above(lambda: a & b)),
        "intersect_one_sided": (pair, peak_above(lambda: at & b)),
        "intersect_taxids": (pair, peak_above(lambda: at & bt)),
        "subtract": (pair, peak_above(lambda: a - b)),
        "subtract_taxids": (pair, peak_above(lambda: at - bt)),
        "union_all": (a.capacity + b.capacity + c.capacity,
                      peak_above(lambda: KmerSet.union_all([a, b, c]))),
        "common": (3 * max(a.capacity, b.capacity, c.capacity),
                   peak_above(lambda: KmerSet.common([a, b, c], 2))),
    }
    del a, b, c, at, bt
    raw = rng.integers(0, 1 << 46, size=n, dtype=np.uint64)
    out["from_codes"] = (_padded_len(n), peak_above(
        lambda: KmerSet.from_codes(raw, 23, device=dev)))
    del raw
    out.update(taxid_union_peaks(dev, rng, 1 << (log2_codes - 1)))
    query = a_np[: len(a_np) // 2]
    block = np.sort(rng.choice(a_np, 1 << 20))

    def membership():
        m = DeviceMembership(query, device=dev)
        return m, m.lookup(block)

    out["membership"] = (_padded_len(len(query)), peak_above(membership))
    del a_np, b_np, c_np
    with tempfile.TemporaryDirectory(prefix="unikmer-slot-bytes-") as tmp:
        fa = os.path.join(tmp, "g.fa")
        with open(fa, "wb") as f:
            for r in range(4):
                seq = np.frombuffer(b"ACGT", np.uint8)[
                    rng.integers(0, 4, size=n, dtype=np.uint8)]
                f.write(b">r%d\n%s\n" % (r, seq.tobytes()))
        out["from_fasta"] = (4 * n, peak_above(
            lambda: KmerSet.from_fasta(fa, 23, canonical=True, device=dev)))
    missing = set(device_sets.SLOT_BYTES) - {
        key.split("@")[0] for key in out}
    assert not missing, missing
    return out


def chain_taxonomy(depth: int):
    """A port Taxonomy whose nodes 2..depth+1 make one chain under the
    root 1: taxids drawn from the chain have a meet-closure of the chain
    and a paths table ``depth`` columns wide."""
    from .taxonomy.taxdump import Taxonomy

    parent = np.arange(-1, depth + 1, dtype=np.int64)
    parent[:2] = (0, 1)
    levels = np.arange(-1, depth + 1, dtype=np.int64)
    return Taxonomy.from_numpy(parent, levels, np.zeros(depth + 2),
                               ["no rank"])


def taxid_union_peaks(dev, rng, slots: int) -> dict:
    """{key: (slots, peak bytes less the uploaded table, Dp)} of the
    taxid union: 'union_taxids_table' over a 16-deep chain and
    'union_taxids_paths@D' over D-deep chains (D 16 and 64); the inputs
    are 8 copies of slots / 8 codes, so every slot merges."""
    from .ops.device_sets import union_taxids_device
    from .taxonomy.lca import device_lca_plan

    codes = np.unique(rng.integers(0, 1 << 46, size=slots // 8,
                                   dtype=np.uint64))
    arrays = [codes] * 8
    out = {}
    for tier, depth in (("table", 16), ("paths", 16), ("paths", 64)):
        taxdb = chain_taxonomy(depth)
        taxids = [rng.integers(2, depth + 2, size=len(codes)).astype(
            np.uint32) for _ in arrays]
        key = (f"union_taxids_{tier}" if tier == "table"
               else f"union_taxids_paths@{depth}")
        if tier == "paths":
            os.environ["UNIKMER_TPU_TAXID_VOCAB_MAX"] = "0"
        try:
            kind, _, tab = device_lca_plan(taxdb, np.concatenate(taxids))
            assert kind == tier and (tier == "table"
                                     or tab.shape[1] == depth), tab.shape
            peak = peak_above(lambda: union_taxids_device(
                arrays, taxids, taxdb, 46, dev))
        finally:
            os.environ.pop("UNIKMER_TPU_TAXID_VOCAB_MAX", None)
        out[key] = (8 * len(codes), peak - tab.nbytes,
                    depth if tier == "paths" else 0)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--log2-codes", type=int, default=25)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("slot_bytes: needs a CUDA device", file=sys.stderr)
        return 2
    from .ops.device_sets import PATH_COLUMN_BYTES, SLOT_BYTES

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    dev = torch.device("cuda", 0)
    os.environ.pop("UNIKMER_TPU_MAX_ELEMS", None)
    res = measure(dev, args.log2_codes)
    over = []
    table = {}
    for key, (slots, peak, *cols) in res.items():
        route, columns = key.split("@")[0], (cols or [0])[0]
        per = peak / slots
        table[key] = round(per, 3)
        limit = SLOT_BYTES[route] + columns * PATH_COLUMN_BYTES
        print(json.dumps({"route": key, "slots": slots, "peak_bytes": peak,
                          "columns": columns, "bytes_per_slot": per,
                          "constant": limit}))
        if per > limit:
            over.append(key)
    (_, p16, d16), (_, p64, d64) = (
        (s, p / s, d) for s, p, d in (res["union_taxids_paths@16"],
                                      res["union_taxids_paths@64"]))
    rate = (p64 - p16) / (d64 - d16)
    fit = {"union_taxids_paths": p16 - d16 * rate, "path_column": rate}
    print(json.dumps({"measured": table, "paths_fit": fit,
                      "constants": SLOT_BYTES,
                      "path_column_constant": PATH_COLUMN_BYTES,
                      "above_constant": over}))
    return 1 if over else 0


if __name__ == "__main__":
    sys.exit(main())
