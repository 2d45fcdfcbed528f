"""The traffic generator: its draws repeat by seed, decks keep their
shares in any run of requests, and the evaluator counts the work."""

import json
import sys
from collections import Counter
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.gen.traffic import (  # noqa: E402
    Evaluator, RequestStream, Tally, load_mix, sample_ordinals,
)

MIXES = sorted(p.stem for p in (ROOT / "portbench" / "traffic").glob("*.json"))


def config(name: str) -> dict:
    with open(ROOT / "portbench" / "configs" / f"{name}.json") as f:
        return json.load(f)


CFG = config("pangenome-k23")


def draws(mix, seed, n, stream=0):
    s = RequestStream(mix, CFG, seed, stream)
    return [(r.kind, r.size, r.S, r.g, r.a, r.b)
            for r in (next(s) for _ in range(n))]


@pytest.mark.parametrize("name", MIXES)
def test_draws_repeat_by_seed(name):
    mix = load_mix(ROOT, name)
    assert draws(mix, 2**31 + 5, 300) == draws(mix, 2**31 + 5, 300)
    assert draws(mix, 2**31 + 5, 300) != draws(mix, 2**31 + 6, 300)
    assert draws(mix, 9, 50, stream=1) != draws(mix, 9, 50)
    assert sample_ordinals(mix, CFG, 77) == sample_ordinals(mix, CFG, 77)


@pytest.mark.parametrize("name", MIXES)
def test_every_prefix_keeps_the_deck_shares(name):
    mix = load_mix(ROOT, name)
    sizes = len(mix.get("subset_sizes", []))
    count = {e["kind"]: e.get("count", 0) + e.get("per_size", 0) * sizes
             for e in mix["deck"]}
    deck = sum(count.values())
    share = {kind: n / deck for kind, n in count.items()}
    for seed in (1, 2, 3):
        got = draws(mix, seed, 3 * deck)
        for n in (deck // 2, deck, 2 * deck + deck // 3):
            kinds = Counter(k for k, *_ in got[:n])
            for kind, s in share.items():
                assert abs(kinds[kind] / n - s) <= 2.5 / n + 0.02, (kind, n)
        # a whole deck holds each (kind, size) its count of times
        assert Counter((k, m) for k, m, *_ in got[:deck]) == Counter(
            (k, m) for k, m, *_ in got[deck:2 * deck])


def test_merge_draws():
    mix = load_mix(ROOT, "merge")
    for kind, size, S, g, a, b in draws(mix, 4, 400):
        assert len(S) == size and len(set(S)) == size
        assert size in (0, 2, 4, 8, 16, 32, 64)
        assert (g in S) if S else g is None
        assert a != b and 0 <= min(a, b) and max(a, b) < 64


@pytest.mark.parametrize("name", MIXES)
def test_sample_holds_every_kind_and_its_largest(name):
    mix = load_mix(ROOT, name)
    keep = sample_ordinals(mix, CFG, 5)
    first = list(draws(mix, 5, mix["sample"]["among_first"]))
    kinds = Counter(first[i][0] for i in keep)
    assert set(kinds) == {e["kind"] for e in mix["deck"]}
    assert all(v == mix["sample"]["per_kind"] for v in kinds.values())
    for kind in kinds:
        biggest = max(size for k, size, *_ in first if k == kind)
        assert any(first[i][1] == biggest for i in keep if first[i][0] == kind)


class Sizes:
    """A backend whose sets are sizes: each genome holds 10 + its index."""

    def genome(self, i):
        return 10 + i

    def size(self, x):
        return x

    def union_all(self, items):
        return sum(items)

    def common(self, items, t):
        return t

    def intersect(self, a, b):
        return min(a, b)

    def subtract(self, a, b):
        return a


def test_evaluator_counts_the_members_of_every_input():
    mix = load_mix(ROOT, "merge")
    ev = Evaluator(Sizes(), CFG)
    s = RequestStream(mix, CFG, 3)
    seen = set()
    while len(seen) < 4:
        req = next(s)
        t = Tally()
        ev.request(req, t)
        members = sum(10 + i for i in req.S)
        if req.kind == "pan":
            assert (t.members, t.sort_members, t.lookups) == (
                members, members, 0)
        elif req.kind == "core":
            assert t.members == members and t.lookups == 0
        elif req.kind == "specific":
            rest = members - (10 + req.g)
            assert t.sort_members == rest and t.lookups == 1
            assert t.members == rest + (10 + req.g) + rest
        else:
            assert t.members == 20 + req.a + req.b and t.sort_members == 0
        seen.add(req.kind)


@pytest.mark.parametrize("op", [
    ["union_all", "all"], ["common", "S", 3], ["intersect", "a", ["g"]],
    ["subtract", ["set", "pan"], "g"], ["sort", "S"]])
def test_an_unknown_operation_is_refused(op):
    """The interpreter reads only what a mix may state (module docstring);
    anything else raises rather than running something else."""
    ev = Evaluator(Sizes(), CFG)
    req = next(RequestStream(load_mix(ROOT, "merge"), CFG, 3))
    req.op, req.S, req.g = op, [1, 2, 3], 1
    with pytest.raises((ValueError, TypeError)):
        ev.request(req)
