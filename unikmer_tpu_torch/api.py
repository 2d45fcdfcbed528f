"""Device-resident k-mer sets: chain set algebra without host round-trips
(the port of unikmer_tpu/api.py).

The CLI reads `.unik` files and writes one back for every operation.
`KmerSet` keeps each set on the card as a sorted, sentinel-padded
tensor of u64 bit patterns (ops/device_sets.py), so a pipeline of
unions, intersections and subtractions runs as device work with only
the 8-byte member count fetched between operations.  The set comes to
the host only at `.to_numpy()` and `.save()`.

Example::

    from unikmer_tpu_torch import KmerSet
    a = KmerSet.from_fasta("a.fa.gz", k=23, canonical=True)
    b = KmerSet.from_fasta("b.fa.gz", k=23, canonical=True)
    (a | b).save("union.unik")
    hits = (a & b).contains(query_codes)

Every constructor takes ``device=`` (default ``_device.get_device()``:
CUDA unless UNIKMER_TPU_TORCH_DEVICE says otherwise); an operation
between sets on different devices raises.  Capacities are padded to
``_padded_len`` (2^20 times a power of two, the JAX package's quantum
off the TPU), so ``capacity``, ``compact()`` and ``repr`` agree with it.
The sorts of ``|``, ``union_all`` and ``common`` take each set's members
(its first n slots, n a host int), not its padding; their results keep
the padded inputs' capacity until ``compact()``.  Each constructor and
operation admits its work by the device's element budget for its route
(ops/device_sets.fits: the free bytes over the route's measured bytes a
slot, or UNIKMER_TPU_MAX_ELEMS when set; none on the CPU).  The free
bytes are the process's kept reading of the card less what torch's
allocator has allocated since; the card itself is read only at the
first admission, near the budget, after an allocation failure, and after
the server's release between requests.  Past the budget a set stays on
the host and its operations take the host engine (ops/sets.py), as in
the JAX package past its cap.

Each public operation is a span of utils/stages.py (``KmerSet.<op>``), a
root where no open span called it, recorded only while a profiler or a
stage recorder listens.  The admission on a card, kept or read, is an
``admit`` child and every read of a result's size a ``readback`` child
(ops/device_sets.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ._device import get_device
from .models.count import (
    CountConfig, SpilledCount, _padded_len, _stream_chunk_bases,
    count_packed_dispatch, count_stream_packed, split_packed,
)
from .ops import device_sets
from .ops.codec import SENTINEL
from .ops.sort import collapse_sorted
from .utils import stages

_SENT = np.uint64((1 << 64) - 1)


def _op(fn):
    """A KmerSet operation as the span ``KmerSet.<name>`` while spans
    record."""
    name = f"KmerSet.{fn.__name__}"

    @functools.wraps(fn)
    def traced(*args, **kwargs):
        with stages.stage(name):
            return fn(*args, **kwargs)
    return traced


def _host_int(n) -> int:
    """A result's size as an int: read back from the device (a wait)
    when it is a tensor."""
    return device_sets.read_back(n) if isinstance(n, torch.Tensor) else int(n)


def _host_codes(codes) -> np.ndarray:
    if isinstance(codes, torch.Tensor):
        return codes.cpu().numpy().view(np.uint64)
    return np.asarray(codes, dtype=np.uint64)


def _fetch(t, n: int, dtype) -> np.ndarray:
    """The first n slots of a set's column as a numpy array of its own."""
    if isinstance(t, np.ndarray):
        return t[:n].copy()
    kept = t[:n]
    kept = kept.cpu() if kept.is_cuda else kept.clone()
    return kept.numpy().view(dtype)


def _code_width(k: int, hashed: bool) -> int:
    """A set's member width, which bounds K2's passes: 2k for 2-bit
    codes, 64 for hashes."""
    return 64 if hashed else min(2 * int(k), 64)


def _spilled(codes):
    """A count result as one array (a SpilledCount is read back)."""
    if not isinstance(codes, SpilledCount):
        return codes
    parts: list = []
    codes.write_to(parts.append)
    return np.concatenate(parts) if parts else np.zeros(0, np.uint64)


class KmerSet:
    """A sorted, deduplicated k-mer set resident in device memory.

    Attributes mirror the `.unik` header: ``k``, ``canonical``,
    ``hashed``, ``scale``; an optional u32 taxid column rides along and
    is LCA-merged on union when a taxonomy is attached.  ``device`` is
    the torch device holding the set.
    """

    def __init__(self, codes, n, k, *, canonical=False, hashed=False,
                 scale=1, taxids=None, taxdb=None, device=None):
        # codes: int64 tensor (u64 bit patterns) padded with the
        # sentinel, or a numpy array for a set kept on the host
        self._codes = codes
        self._n = _host_int(n)
        self.k = int(k)
        self.canonical = bool(canonical)
        self.hashed = bool(hashed)
        self.scale = int(scale)
        self._taxids = taxids  # int32 tensor of u32 (0 on padding) or None
        self._taxdb = taxdb
        if device is None:
            device = (codes.device if isinstance(codes, torch.Tensor)
                      else get_device())
        self.device = torch.device(device)

    @property
    def _code_bits(self) -> int:
        return _code_width(self.k, self.hashed)

    # ------------------------------------------------------------ build
    @classmethod
    @_op
    def from_codes(cls, codes, k, *, canonical=False, hashed=False, scale=1,
                   taxids=None, taxdb=None, assume_sorted_unique=False,
                   device=None):
        """Build from a host array (or a tensor) of u64 codes, sorted and
        deduplicated on the device unless ``assume_sorted_unique``.  An
        unhashed set's codes must fit in 2k bits, the width its sorts
        take (the JAX package does not check it)."""
        device = get_device(device)
        codes = _host_codes(codes)
        top = int(codes.max()) if len(codes) else 0
        if top == _SENT:
            # the all-ones value pads capacity and cannot be a member
            raise ValueError(
                "KmerSet cannot hold the reserved all-ones code "
                "(0xFFFFFFFFFFFFFFFF); use the CLI/ops pipelines for "
                "exact sentinel accounting"
            )
        bits = _code_width(k, hashed)
        if bits < 64 and top >> bits:
            raise ValueError(f"a code wider than 2k = {bits} bits in an "
                             f"unhashed set of k = {int(k)}")
        if taxids is not None:
            taxids = np.asarray(taxids, dtype=np.uint32)
            if len(taxids) != len(codes):
                raise ValueError("taxids length must match codes")
            if not assume_sorted_unique:
                if taxdb is None:
                    raise ValueError(
                        "deduplicating taxid-carrying codes needs taxdb for LCA"
                    )
                codes, taxids = taxdb.lca_reduce(codes, taxids)
                assume_sorted_unique = True
        flags = dict(canonical=canonical, hashed=hashed, scale=scale,
                     taxdb=taxdb, device=device)
        cap = _padded_len(max(len(codes), 1))
        if not device_sets.fits("from_codes", device, cap):
            # kept on the host: binary ops take the host engine (their
            # capacities add past the cap) and contains() runs numpy
            if not assume_sorted_unique:
                codes = np.unique(codes)
            return cls(codes, len(codes), k, taxids=taxids, **flags)
        pad = np.full(cap, _SENT, np.uint64)
        pad[: len(codes)] = codes
        dev = torch.from_numpy(pad.view(np.int64)).to(device)
        if assume_sorted_unique:
            n = len(codes)
        else:
            valid = torch.arange(cap, device=device) < len(codes)
            dev, n = collapse_sorted(dev, valid, mode="distinct",
                                     code_bits=bits)
            n = _host_int(n)
        dev_tax = None
        if taxids is not None:
            t = np.zeros(cap, np.uint32)
            t[: len(taxids)] = taxids
            dev_tax = torch.from_numpy(t.view(np.int32)).to(device)
        return cls(dev, n, k, taxids=dev_tax, **flags)

    @classmethod
    @_op
    def from_fasta(cls, paths, k, *, canonical=False, hashed=False, scale=1,
                   minimizer_w=0, syncmer_s=0, circular=False,
                   mode="distinct", taxdb=None, mesh=None, device=None):
        """Count the k-mers of FASTA/Q file(s) straight into a device set
        (models/count.py); only the 8-byte count comes to the host.
        ``mesh=N`` (N >= 2) counts through the N-device sharded build
        (parallel/sharded.mesh_count_stream, the CLI's count --mesh) and
        uploads the codes to ``device``."""
        from .io.fastx import pack_files

        device = get_device(device)
        if isinstance(paths, (str, bytes)):
            paths = [paths]
        cfg = CountConfig(k=k, canonical=canonical, hashed=hashed,
                          scale=scale, minimizer_w=minimizer_w,
                          syncmer_s=syncmer_s, circular=circular, mode=mode)
        flags = dict(canonical=cfg.canonical, hashed=cfg.hashed, scale=scale,
                     taxdb=taxdb, device=device)
        if mesh is not None and int(mesh) >= 2:
            from .io.fastx import read_fastx
            from .parallel.sharded import mesh_count_stream

            records = (rec for p in paths for rec in read_fastx(p))
            codes = _spilled(mesh_count_stream(records, cfg, int(mesh)))
            return cls.from_codes(codes, k, assume_sorted_unique=True,
                                  **flags)
        packed = pack_files(paths, cfg.k, circular)
        if packed.bases.size == 0:
            return cls.from_codes(np.zeros(0, np.uint64), k, **flags)
        chunk = _stream_chunk_bases(device)
        if len(packed.bases) <= chunk + cfg.k:
            return cls._from_token(count_packed_dispatch(packed, cfg, device),
                                   k, flags)
        fits = device_sets.fits("from_fasta", device, len(packed.bases))
        if cfg.mode == "distinct" and fits:
            # a device set a piece, merged by one device union
            pieces = [cls._from_token(count_packed_dispatch(p, cfg, device),
                                      k, flags)
                      for p in split_packed(packed, chunk,
                                            cfg.k if cfg.segmentable else 0)]
            return cls.union_all(pieces)
        # unique/repeated need multiplicities across pieces, and pieces
        # past the device's budget must not stay resident: the capped host
        # merge of the stream, then an upload (from_codes keeps a set past
        # its own budget on the host)
        codes = _spilled(count_stream_packed([packed], cfg, device=device))
        return cls.from_codes(codes, k, assume_sorted_unique=True, **flags)

    @classmethod
    def _from_token(cls, token, k, flags) -> "KmerSet":
        """A count_packed_dispatch token as a compacted set."""
        if token[0] == "empty":
            return cls.from_codes(np.zeros(0, np.uint64), k, **flags)
        out, n = token[2], token[3]
        return cls(out, n, k, **flags).compact()

    @classmethod
    def from_unik(cls, path, taxdb=None, device=None):
        """Load a `.unik` file into device memory."""
        from .io.unik import UnikReader

        with UnikReader(path) as r:
            codes, taxids = r.read_all()
            h = r.header
            if h.has_global_taxid and taxids is None:
                taxids = np.full(len(codes), h.global_taxid, np.uint32)
            # the SORTED flag does not imply distinct: check strictly
            # increasing before trusting the sorted-unique path
            sorted_unique = bool(h.is_sorted) and bool(
                np.all(codes[1:] > codes[:-1])
            )
            return cls.from_codes(
                codes, h.k, canonical=h.is_canonical, hashed=h.is_hashed,
                scale=h.scale if h.is_scaled else 1, taxids=taxids,
                taxdb=taxdb, assume_sorted_unique=sorted_unique,
                device=device,
            )

    @classmethod
    def from_reference(cls, obj, taxdb=None, device=None) -> "KmerSet":
        """A set with the members, taxids and flags of ``obj``, read
        duck-typed (``k``, ``canonical``, ``hashed``, ``scale``,
        ``to_numpy()``, ``taxids_to_numpy()``; e.g. a unikmer_tpu
        KmerSet).  Without ``taxdb``, obj's taxonomy (``_taxdb``) comes
        across through Taxonomy.from_numpy."""
        from .taxonomy.taxdump import Taxonomy

        ref_db = getattr(obj, "_taxdb", None)
        if taxdb is None and ref_db is not None:
            taxdb = Taxonomy.from_numpy(ref_db.parent, ref_db.depth,
                                        ref_db.rank_ids, ref_db.ranks,
                                        ref_db.merged, ref_db.root)
        return cls.from_codes(
            obj.to_numpy(), obj.k, canonical=obj.canonical,
            hashed=obj.hashed, scale=obj.scale, taxids=obj.taxids_to_numpy(),
            taxdb=taxdb, assume_sorted_unique=True, device=device)

    # ------------------------------------------------------- properties
    def __len__(self) -> int:
        return self._n

    @property
    def has_taxids(self) -> bool:
        return self._taxids is not None

    @property
    def capacity(self) -> int:
        return int(self._codes.shape[0])

    @property
    def _on_host(self) -> bool:
        return isinstance(self._codes, np.ndarray)

    def _check_compatible(self, other: "KmerSet"):
        """Equal k/canonical/hashed/scale across inputs, as the reference
        enforces, and one device."""
        if not isinstance(other, KmerSet):
            raise TypeError(f"expected KmerSet, got {type(other).__name__}")
        for attr in ("k", "canonical", "hashed", "scale"):
            if getattr(self, attr) != getattr(other, attr):
                raise ValueError(
                    f"incompatible sets: {attr} differs "
                    f"({getattr(self, attr)} vs {getattr(other, attr)})"
                )
        if self.device != other.device:
            raise ValueError(f"sets on different devices ({self.device} vs "
                             f"{other.device})")

    def _flags_kw(self):
        return dict(canonical=self.canonical, hashed=self.hashed,
                    scale=self.scale, device=self.device)

    def _new(self, codes, n, taxids=None, taxdb=None) -> "KmerSet":
        """A device result of an operation on this set, compacted."""
        return KmerSet(codes, n, self.k, taxids=taxids,
                       taxdb=taxdb or self._taxdb,
                       **self._flags_kw()).compact()

    # -------------------------------------------------------- set algebra
    def _np_taxids(self):
        return self.taxids_to_numpy() if self.has_taxids else None

    def _from_host(self, codes, taxids, taxdb=None) -> "KmerSet":
        return KmerSet.from_codes(
            codes, self.k, taxids=taxids, taxdb=taxdb or self._taxdb,
            assume_sorted_unique=True, **self._flags_kw(),
        )

    def _host_union(self, other: "KmerSet") -> "KmerSet":
        from .ops import sets as host_sets

        taxdb = self._taxdb or other._taxdb
        if self.has_taxids != other.has_taxids:
            with_t, plain = (self, other) if self.has_taxids else (other, self)
            c, t = host_sets.union(
                [with_t.to_numpy(), plain.to_numpy()],
                [with_t._np_taxids(), np.zeros(len(plain), np.uint32)],
                taxdb,
            )
            return self._from_host(c, t, taxdb)
        if self.has_taxids and other.has_taxids:
            if taxdb is None:
                raise ValueError("taxid-carrying union needs an attached taxdb")
            c, t = host_sets.union(
                [self.to_numpy(), other.to_numpy()],
                [self._np_taxids(), other._np_taxids()], taxdb,
            )
            return self._from_host(c, t, taxdb)
        c, _ = host_sets.union([self.to_numpy(), other.to_numpy()])
        return self._from_host(c, None)

    def _host_intersect(self, other: "KmerSet") -> "KmerSet":
        from .ops import sets as host_sets

        taxdb = self._taxdb or other._taxdb
        if self.has_taxids and other.has_taxids:
            if taxdb is None:
                raise ValueError(
                    "taxid-carrying intersection needs an attached taxdb"
                )
            c, t = host_sets.intersect(
                [self.to_numpy(), other.to_numpy()],
                [self._np_taxids(), other._np_taxids()], taxdb,
            )
            return self._from_host(c, t, taxdb)
        if self.has_taxids or other.has_taxids:
            # taxid-present side first: its values pass through on match
            wt = self if self.has_taxids else other
            wo = other if self.has_taxids else self
            c, t = host_sets.intersect(
                [wt.to_numpy(), wo.to_numpy()], [wt._np_taxids(), None],
                taxdb,
            )
            return self._from_host(c, t, taxdb)
        c, _ = host_sets.intersect([self.to_numpy(), other.to_numpy()])
        return self._from_host(c, None)

    def _host_subtract(self, other: "KmerSet") -> "KmerSet":
        from .ops import sets as host_sets

        c, t = host_sets.subtract(
            self.to_numpy(), self._np_taxids(), [other.to_numpy()],
        )
        return self._from_host(c, t)

    def _on_device_within(self, route: str, sets) -> bool:
        """Whether ``route`` over ``sets`` runs on the device: every set
        is there and their slots fit the route's element budget (the
        capacities' sum; for common, the largest times the count)."""
        if any(s._on_host for s in sets):
            return False
        caps = [s.capacity for s in sets]
        slots = max(caps) * len(caps) if route == "common" else sum(caps)
        return device_sets.fits(route, self.device, slots)

    def _tables(self, taxdb):
        from .taxonomy.lca import device_tables

        return device_tables(taxdb, self.device)

    @_op
    def union(self, other: "KmerSet") -> "KmerSet":
        """Union; colliding codes LCA-merge taxids when both sides carry
        them.  When only ONE side does, its taxids pass through (the
        missing side is taxid 0, the identity; a shared code whose taxid
        the attached taxonomy lacks merges to 0, as on the host)."""
        self._check_compatible(other)
        route = ("union" if not (self.has_taxids or other.has_taxids)
                 else "union_taxids" if self.has_taxids and other.has_taxids
                 else "union_one_sided")
        if not self._on_device_within(route, (self, other)):
            return self._host_union(other)
        bits = self._code_bits
        taxdb = self._taxdb or other._taxdb
        if self.has_taxids != other.has_taxids:
            with_t, plain = (self, other) if self.has_taxids else (other, self)
            depth = None if taxdb is None else torch.from_numpy(
                taxdb.depth.astype(np.int32)).to(self.device)
            c, t, n = device_sets.union_one_sided_taxids(
                with_t._codes, with_t._taxids, plain._codes, depth, bits)
            return self._new(c, n, t, taxdb)
        if self.has_taxids and other.has_taxids:
            if taxdb is None:
                raise ValueError("taxid-carrying union needs an attached taxdb")
            parent, depth, max_depth = self._tables(taxdb)
            c, t, n = device_sets.union_with_taxids(
                self._codes, self._taxids, other._codes, other._taxids,
                parent, depth, max_depth, 1, bits,
            )
            return self._new(c, n, t, taxdb)
        c, n = device_sets.union(self._codes, other._codes, code_bits=bits,
                                 lengths=(self._n, other._n))
        return self._new(c, n)

    def _zero_taxids(self):
        return torch.zeros(self.capacity, dtype=torch.int32,
                           device=self.device)

    @_op
    def intersect(self, other: "KmerSet") -> "KmerSet":
        """Intersection; matching codes LCA-merge their taxids when both
        sides carry them, and the present side passes through when only
        one does (--mix-taxid semantics)."""
        self._check_compatible(other)
        route = ("intersect" if not (self.has_taxids or other.has_taxids)
                 else "intersect_taxids"
                 if self.has_taxids and other.has_taxids
                 else "intersect_one_sided")
        if not self._on_device_within(route, (self, other)):
            return self._host_intersect(other)
        if self.has_taxids and other.has_taxids:
            taxdb = self._taxdb or other._taxdb
            if taxdb is None:
                raise ValueError(
                    "taxid-carrying intersection needs an attached taxdb"
                )
            parent, depth, max_depth = self._tables(taxdb)
            c, t, n = device_sets.intersect_with_taxids(
                self._codes, self._taxids, other._codes, other._taxids,
                parent, depth, max_depth,
            )
            return self._new(c, n, t, taxdb)
        if self.has_taxids or other.has_taxids:
            ta = self._taxids if self.has_taxids else self._zero_taxids()
            tb = other._taxids if other.has_taxids else other._zero_taxids()
            c, t, n = device_sets.intersect_one_sided_taxids(
                self._codes, ta, other._codes, tb)
            return self._new(c, n, t, self._taxdb or other._taxdb)
        c, n = device_sets.intersect(self._codes, other._codes)
        return self._new(c, n)

    @_op
    def subtract(self, other: "KmerSet") -> "KmerSet":
        """Difference; keeps this set's taxid column (diff keeps the
        query's taxids)."""
        self._check_compatible(other)
        route = "subtract_taxids" if self.has_taxids else "subtract"
        if not self._on_device_within(route, (self, other)):
            return self._host_subtract(other)
        if self.has_taxids:
            c, t, n = device_sets.subtract_with_taxids(
                self._codes, self._taxids, other._codes)
            return self._new(c, n, t)
        c, n = device_sets.subtract(self._codes, other._codes)
        return self._new(c, n)

    __or__ = union
    __and__ = intersect
    __sub__ = subtract

    @staticmethod
    @_op
    def union_all(sets) -> "KmerSet":
        """N-way union in one device pass (the members' concatenation, one
        K2 sort and the collapse), cheaper than a chain of pairwise
        unions."""
        sets = list(sets)
        if not sets:
            raise ValueError("union_all() needs at least one set")
        first = sets[0]
        for s in sets[1:]:
            first._check_compatible(s)
        if any(s.has_taxids for s in sets):
            # merges of more than two members need the log-rounds
            # collapse: chain pairwise unions, each LCA-exact
            out = sets[0]
            for s in sets[1:]:
                out = out.union(s)
            return out
        if not first._on_device_within("union_all", sets):
            from .ops import sets as host_sets

            c, _ = host_sets.union([s.to_numpy() for s in sets])
            return first._from_host(c, None)
        c, n = device_sets.union_many([s._codes for s in sets],
                                      first._code_bits,
                                      lengths=[s._n for s in sets])
        return first._new(c, n)

    @staticmethod
    @_op
    def common(sets, threshold: int) -> "KmerSet":
        """Codes present in >= threshold of the given sets (`unikmer
        common`); a threshold <= 0 means all of them."""
        sets = list(sets)
        if not sets:
            raise ValueError("common() needs at least one set")
        first = sets[0]
        for s in sets[1:]:
            first._check_compatible(s)
        if threshold <= 0:
            # the host engine reads <= 0 as "all files"; so does this
            threshold = len(sets)
        if not first._on_device_within("common", sets):
            from .ops import sets as host_sets

            c, _ = host_sets.common(
                [s.to_numpy() for s in sets], None, threshold)
            return first._from_host(c, None)
        c, n = device_sets.common([s._codes for s in sets], threshold,
                                  code_bits=first._code_bits,
                                  lengths=[s._n for s in sets])
        return first._new(c, n)

    # ------------------------------------------------------------ queries
    @_op
    def contains(self, queries) -> np.ndarray:
        """Vectorized membership: a binary search on the device (numpy's
        searchsorted for a set kept on the host)."""
        q = np.asarray(queries, dtype=np.uint64)
        if self._on_host:
            codes = self._codes[: self._n]
            if codes.size == 0:
                return np.zeros(q.shape, bool)
            idx = np.minimum(np.searchsorted(codes, q), codes.size - 1)
            return (codes[idx] == q) & (q != _SENT)
        qt = torch.from_numpy(np.array(q).view(np.int64)).to(self.device)
        # the sentinel pads capacity and is never a member
        _, hit = device_sets._lookup(self._codes, qt)
        return device_sets.read_back(hit & (qt != SENTINEL)).numpy()

    # -------------------------------------------------- per-set transforms
    def _keep(self, keep) -> "KmerSet":
        """The members where ``keep``, a bool tensor over the capacity
        (a numpy mask over the members for a set kept on the host)."""
        if self._on_host:
            return KmerSet.from_codes(
                self._codes[keep], self.k,
                taxids=None if self._taxids is None else self._taxids[keep],
                taxdb=self._taxdb, assume_sorted_unique=True,
                **self._flags_kw())
        keep = keep & (torch.arange(self.capacity, device=self.device)
                       < self._n)
        if self._taxids is None:
            c, n = device_sets._compact_mask(self._codes, keep)
            return self._new(c, n)
        c, t, n = device_sets._compact_mask_with(self._codes, self._taxids,
                                                 keep)
        return self._new(c, n, t)

    def _index(self):
        if self._on_host:
            return np.arange(self._n)
        return torch.arange(self.capacity, device=self.device)

    @_op
    def head(self, n: int) -> "KmerSet":
        """First n codes (cmd/head semantics on a sorted set)."""
        return self._keep(self._index() < max(0, int(n)))

    @_op
    def sample(self, start: int, window: int) -> "KmerSet":
        """Fixed-stride sampling: keep record j when j >= start and
        (j - start) % window == 0."""
        if window <= 0 or start < 0:
            raise ValueError("sample needs start >= 0 and window >= 1")
        idx = self._index()
        return self._keep((idx >= start) & ((idx - start) % window == 0))

    @_op
    def filter_low_complexity(self, penalty_s=3, penalty_d=1, threshold=15,
                              window=7, invert=False) -> "KmerSet":
        """Drop (or keep, with invert) low-complexity k-mers (the window
        score of cmd/filter; 2-bit encoded sets only), on the set's
        device."""
        if self.hashed:
            raise ValueError("low-complexity filter needs 2-bit encoded k-mers")
        from .ops.filter import low_complexity_mask

        codes = self._codes
        if self._on_host:
            codes = torch.from_numpy(codes[: self._n].view(np.int64))
        low = low_complexity_mask(codes, self.k, penalty_s, penalty_d,
                                  threshold, window)
        keep = low if invert else ~low
        return self._keep(keep.numpy() if self._on_host else keep)

    # ------------------------------------------------------- maintenance
    @_op
    def compact(self) -> "KmerSet":
        """Capacity re-bucketed to the smallest padded length holding n
        (padded up with the sentinel where the set is shorter)."""
        if self._on_host:
            return self  # host-kept sets stay unpadded
        want = _padded_len(max(self._n, 1))
        if want == self.capacity:
            return self
        if want < self.capacity:
            c = self._codes[:want]
            t = self._taxids[:want] if self._taxids is not None else None
        else:
            grow = want - self.capacity
            c = torch.cat([self._codes, self._codes.new_full((grow,),
                                                             SENTINEL)])
            t = None if self._taxids is None else torch.cat(
                [self._taxids, self._taxids.new_zeros(grow)])
        return KmerSet(c, self._n, self.k, taxids=t, taxdb=self._taxdb,
                       **self._flags_kw())

    # ----------------------------------------------------------- egress
    def to_numpy(self) -> np.ndarray:
        return _fetch(self._codes, self._n, np.uint64)

    def taxids_to_numpy(self) -> np.ndarray | None:
        if self._taxids is None:
            return None
        return _fetch(self._taxids, self._n, np.uint32)

    def save(self, path, *, compress=True, compression_level=5, threads=4,
             description=b"") -> None:
        """Write a sorted `.unik` file (io/unik.py layout)."""
        from .io import unik

        flag = unik.SORTED
        if self.canonical:
            flag |= unik.CANONICAL
        if self.hashed:
            flag |= unik.HASHED
        taxids = self.taxids_to_numpy()
        max_taxid = 0
        if taxids is not None:
            flag |= unik.INCLUDE_TAXID
            max_taxid = int(taxids.max(initial=0))
        with unik.UnikWriter(
            path, self.k, flag, number=self._n, description=description,
            scale=self.scale, max_taxid=max_taxid, compress=compress,
            compression_level=compression_level, threads=threads,
        ) as w:
            w.write_codes(self.to_numpy(), taxids)

    def __repr__(self) -> str:
        tax = "+taxids" if self.has_taxids else ""
        return (f"KmerSet(n={self._n}, k={self.k}, "
                f"{'hashed' if self.hashed else 'encoded'}"
                f"{', canonical' if self.canonical else ''}{tax}, "
                f"capacity={self.capacity})")
