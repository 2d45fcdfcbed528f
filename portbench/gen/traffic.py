"""The one traffic generator: it reads a mix's data file
(``portbench/traffic/<mix>.json``) and yields requests drawn from the
seed, and evaluates a request's operation tree on a backend (the
program's ``KmerSet``, the reference, or the control).

A mix file holds:

- ``deck``: the request kinds, each ``{"kind", "op"}`` with ``"count"``
  requests a deck, or ``"per_size"`` requests a deck for each of
  ``subset_sizes``;
- ``sample``: ``{"per_kind", "among_first"}``, how many answers of each
  kind the run compares with the reference, drawn among the first
  requests, the one over the most genomes of each kind among them;
- ``loop`` and ``clients``: "closed" and 1, the only load the harness
  drives.

An operation is a JSON list ``[op, args...]``:

- ``["union_all", L]``, ``["common", L, {"share": f}]`` (a member of at
  least ceil(f * len(L)) of the sets), ``["intersect", X, Y]``,
  ``["subtract", X, Y]``;
- a set ``X`` is ``"g"``, ``"a"`` or ``"b"`` (drawn genomes) or an
  operation;
- a list ``L`` is ``"S"`` (the drawn subset) or ``"S-g"``.

A deck holds every kind the number of times it gives, each a size; its
order is drawn so that each (kind, size) spreads evenly through it, with
a phase drawn from the seed, so that any run of requests holds the kinds
and sizes in about the deck's shares.  Each request then draws its
subset S of the size (uniformly, without replacement), g uniformly in S
where S is drawn, and two distinct genomes a and b.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .genomes import seed_sequence

LIST_OPS = ("union_all", "common")
PAIR_OPS = ("intersect", "subtract")


def load_mix(root: Path, name: str) -> dict:
    with open(Path(root) / "portbench" / "traffic" / f"{name}.json") as f:
        mix = json.load(f)
    if mix.get("loop", "closed") != "closed" or mix.get("clients", 1) != 1:
        raise ValueError(f"{name}: the harness drives a closed loop of one "
                         "client")
    return mix


@dataclass
class Request:
    ordinal: int
    kind: str
    size: int  # genomes in the drawn subset, 0 where none is drawn
    op: list
    S: list
    g: int | None
    a: int
    b: int


@dataclass
class Tally:
    """What one request asked of the program: the members of every input
    set of every operation, those entering a sort (union_all, common),
    and the membership operations (intersect, subtract)."""

    members: int = 0
    sort_members: int = 0
    lookups: int = 0


def deck_order(mix: dict, rng: np.random.Generator) -> list[tuple[str, int]]:
    """One deck as (kind, size) pairs, each class spread evenly."""
    keyed = []
    sizes = mix.get("subset_sizes", [])
    for entry in mix["deck"]:
        classes = ([(entry["kind"], s, entry["per_size"]) for s in sizes]
                   if "per_size" in entry
                   else [(entry["kind"], 0, entry["count"])])
        for kind, size, count in classes:
            phase = rng.random()
            for i in range(count):
                keyed.append(((i + phase) / count, rng.random(), kind, size))
    keyed.sort()
    return [(kind, size) for _, _, kind, size in keyed]


class RequestStream:
    """The seed's requests, in order, without end."""

    def __init__(self, mix: dict, cfg: dict, seed: int, stream: int = 0):
        self.mix, self.cfg = mix, cfg
        self.ops = {e["kind"]: e["op"] for e in mix["deck"]}
        # stream 0 is the window's, 1 the warm-up's
        self.rng = np.random.default_rng(seed_sequence(seed).spawn(2)[stream])
        self.ordinal = 0
        self._deck: list = []

    def __iter__(self):
        return self

    def __next__(self) -> Request:
        if not self._deck:
            self._deck = deck_order(self.mix, self.rng)
        kind, size = self._deck.pop(0)
        n, rng = self.cfg["genomes"], self.rng
        S = sorted(int(x) for x in rng.choice(n, size, replace=False)) \
            if size else []
        g = int(rng.choice(S)) if S else None
        a, b = (int(x) for x in rng.choice(n, 2, replace=False))
        req = Request(self.ordinal, kind, size, self.ops[kind], S, g, a, b)
        self.ordinal += 1
        return req


def classes(mix: dict) -> list[tuple[str, int]]:
    """Every (kind, size) the mix sends."""
    out = []
    for entry in mix["deck"]:
        if "per_size" in entry:
            out += [(entry["kind"], s) for s in mix.get("subset_sizes", [])]
        else:
            out.append((entry["kind"], 0))
    return out


def sample_ordinals(mix: dict, cfg: dict, seed: int) -> set[int]:
    """The ordinals whose answers a run keeps and compares: for each kind,
    among the first ``among_first`` requests of the window's stream, the
    one over the largest subset and ``per_kind - 1`` drawn from the seed."""
    rule = mix["sample"]
    stream = RequestStream(mix, cfg, seed)
    first = [next(stream) for _ in range(rule["among_first"])]
    rng = np.random.default_rng(seed_sequence(seed).spawn(3)[2])
    keep = set()
    for kind in sorted({r.kind for r in first}):
        mine = [r for r in first if r.kind == kind]
        top = max(mine, key=lambda r: (r.size, -r.ordinal))
        rest = [r.ordinal for r in mine if r is not top]
        pick = rng.choice(len(rest), min(len(rest), rule["per_kind"] - 1),
                          replace=False) if rest else []
        keep.add(top.ordinal)
        keep.update(rest[int(i)] for i in pick)
    return keep


class Evaluator:
    """Evaluates operation trees on a backend that has ``genome(i)``,
    ``union_all(list)``, ``common(list, t)``, ``intersect(x, y)``,
    ``subtract(x, y)`` and ``size(x)``."""

    def __init__(self, backend, cfg: dict):
        self.backend = backend
        self.genomes = [backend.genome(i) for i in range(cfg["genomes"])]

    def request(self, req: Request, tally: Tally | None = None):
        env = {"S": req.S, "g": req.g, "a": req.a, "b": req.b}
        return self.run(req.op, env, tally)

    def _list(self, expr, env):
        g = self.genomes
        if expr == "S":
            return [g[i] for i in env["S"]]
        if expr == "S-g":
            return [g[i] for i in env["S"] if i != env["g"]]
        raise ValueError(f"unknown set list {expr!r}")

    def _set(self, expr, env, tally):
        if expr in ("g", "a", "b"):
            return self.genomes[env[expr]]
        if isinstance(expr, list) and expr and expr[0] in LIST_OPS + PAIR_OPS:
            return self.run(expr, env, tally)
        raise ValueError(f"unknown set {expr!r}")

    def run(self, expr, env: dict, tally: Tally | None = None):
        op, be = expr[0], self.backend
        if op in LIST_OPS:
            items = self._list(expr[1], env)
            if tally is not None:
                n = sum(be.size(x) for x in items)
                tally.members += n
                tally.sort_members += n
            if op == "union_all":
                return be.union_all(items)
            return be.common(items, math.ceil(expr[2]["share"] * len(items)))
        if op in PAIR_OPS:
            x = self._set(expr[1], env, tally)
            y = self._set(expr[2], env, tally)
            if tally is not None:
                tally.members += be.size(x) + be.size(y)
                tally.lookups += 1
            return getattr(be, op)(x, y)
        raise ValueError(f"unknown operation {op!r}")
