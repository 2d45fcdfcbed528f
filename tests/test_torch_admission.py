"""The admission's kept reading of the card (ops/device_sets.fits).

On the CPU a card is stubbed: ``torch.cuda.mem_get_info`` and the
caching allocator's stats snapshot read a FakeCard, whose allocator
moves bytes between the card's free bytes and its reserved pool as
torch's does, and which another process can take bytes from.  The card
test holds the kept free bytes to a fresh read on a real card.
"""

from collections import deque

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from unikmer_tpu_torch import server
from unikmer_tpu_torch.ops import device_sets
from unikmer_tpu_torch.ops.device_sets import (
    ADMIT_SHARE, SLOT_BYTES, element_budget, fits,
)
from unikmer_tpu_torch.utils import stages

GB = 1 << 30
CARD = torch.device("cuda", 0)


class FakeCard:
    """An 80 GB card and torch's caching allocator on it."""

    def __init__(self, free=78 * GB):
        self.free, self.reserved, self.allocated = free, 0, 0
        self.ooms = self.retries = self.reads = 0

    def mem_get_info(self, device=None):
        self.reads += 1
        return self.free, 80 * GB

    def stats(self, device=None):
        return {"reserved_bytes": {"all": {"current": self.reserved}},
                "allocated_bytes": {"all": {"current": self.allocated}},
                "num_ooms": self.ooms, "num_alloc_retries": self.retries}

    def alloc(self, n):
        """Allocate n bytes: from the pool, the rest from the card."""
        grow = max(self.allocated + n - self.reserved, 0)
        self.free -= grow
        self.reserved += grow
        self.allocated += n

    def release(self, n):
        self.allocated -= n

    def empty_cache(self):
        self.free += self.reserved - self.allocated
        self.reserved = self.allocated


@pytest.fixture
def card(monkeypatch):
    """A FakeCard behind torch.cuda, with no kept reading, counters and
    spans of the test's own."""
    fake = FakeCard()
    monkeypatch.setattr(torch.cuda, "mem_get_info", fake.mem_get_info)
    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict",
                        fake.stats)
    monkeypatch.setattr(device_sets, "_CEILINGS", {})
    monkeypatch.setattr(stages, "COUNTERS", {})
    monkeypatch.setattr(stages, "_SPANS", deque(maxlen=stages.MAX_SPANS))
    monkeypatch.delenv("UNIKMER_TPU_MAX_ELEMS", raising=False)
    return fake


def counts():
    c = stages.snapshot()["counters"]
    return c.get("admit.calls", 0), c.get("admit.reads", 0)


def slots_for(route, nbytes):
    """The slots of ``route`` that take ``nbytes``."""
    return nbytes // SLOT_BYTES[route]


def test_far_from_the_budget_the_card_is_read_once(card):
    """Many admissions far from the budget, each with work allocated
    and freed between them: one read of the card, every one counted,
    and each admits what a fresh read admits."""
    for i in range(200):
        slots = slots_for("union_all", (1 + i % 20) * GB)
        assert fits("union_all", CARD, slots)
        card.alloc(slots * 8)
        assert fits("intersect", CARD, slots)
        card.release(slots * 8)
    assert card.reads == 1
    assert counts() == (400, 1)


def test_past_half_the_free_bytes_the_card_is_read(card):
    """A route past half of the kept free bytes reads the card again; a
    second process that took the memory since sends it to the host,
    where the kept reading would have admitted it."""
    assert fits("union", CARD, slots_for("union", GB))
    free = 78 * GB
    near = slots_for("union", int(free * 0.6))
    assert fits("union", CARD, near)
    assert card.reads == 2 and counts() == (2, 2)
    card.free -= 40 * GB  # another process on the card
    assert fits("union", CARD, slots_for("union", GB))
    assert card.reads == 2  # far from the budget: the kept reading
    assert not fits("union", CARD, near)
    assert card.reads == 3 and counts() == (4, 3)


def test_the_table_counts_toward_half_the_free_bytes(card):
    """The bytes compared are the slots' and the uploaded table's."""
    assert fits("union_taxids_paths", CARD, 1)
    per = SLOT_BYTES["union_taxids_paths"] + 4 * device_sets.PATH_COLUMN_BYTES
    slots = (30 * GB) // per
    assert fits("union_taxids_paths", CARD, slots, 4, GB)
    assert card.reads == 1
    assert fits("union_taxids_paths", CARD, slots, 4, 10 * GB)
    assert card.reads == 2


@pytest.mark.parametrize("counter", ["ooms", "retries"])
def test_an_allocation_failure_forces_a_read(card, counter):
    assert fits("union", CARD, 1)
    setattr(card, counter, 1)
    assert fits("union", CARD, 1) and card.reads == 2
    assert fits("union", CARD, 1) and card.reads == 2


def test_element_budget_always_reads(card):
    """element_budget, which knows no slots, reads the card every time
    and keeps the reading for the admissions that do."""
    budgets = {element_budget("union", CARD) for _ in range(3)}
    assert budgets == {int(78 * GB * ADMIT_SHARE) // SLOT_BYTES["union"]}
    assert card.reads == 3
    assert fits("union", CARD, 1) and card.reads == 3


def test_the_servers_release_drops_the_reading(card, monkeypatch):
    """After the server's release between requests the next admission
    reads the card as it finds it."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "empty_cache", card.empty_cache)
    monkeypatch.setattr(torch._C, "_host_emptyCache", lambda: None,
                        raising=False)
    assert fits("union", CARD, 1)
    card.alloc(8 * GB)
    card.release(8 * GB)
    server._release_device_memory()
    card.free -= 75 * GB  # another process took the card between requests
    assert not fits("union", CARD, slots_for("union", 4 * GB))
    assert card.reads == 2 and counts() == (2, 2)


def test_kept_free_bytes_equal_a_fresh_read(card):
    """The invariant test_admission_counts_memory_the_allocator_keeps
    states: what this process allocates, frees and empties from torch's
    cache moves bytes between the card's free bytes and the pool, so the
    kept free bytes stay a fresh read's."""
    fits("union", CARD, 1)
    for n in (3 * GB, 10 * GB, 1 * GB):
        card.alloc(n)
        assert device_sets._free_bytes(CARD, 1) \
            == device_sets._device_free_bytes(CARD)
        card.release(n)
        assert device_sets._free_bytes(CARD, 1) \
            == device_sets._device_free_bytes(CARD)
        card.empty_cache()
        assert device_sets._free_bytes(CARD, 1) \
            == device_sets._device_free_bytes(CARD) == 78 * GB
    assert counts() == (10, 1)


def test_each_admission_is_one_admit_span(card):
    """Kept or read, an admission is one ``admit`` span under the
    operation that asked."""
    with profile(activities=[ProfilerActivity.CPU]):
        with stages.stage("KmerSet.union"):
            fits("union", CARD, 1)
            fits("union", CARD, 1)
            fits("union", CARD, slots_for("union", 60 * GB))
    spans = stages.snapshot()["spans"]
    assert [s["name"] for s in spans] == ["KmerSet.union"] + ["admit"] * 3
    assert all(s["parent"] == spans[0]["id"] for s in spans[1:])
    assert card.reads == 2


def test_max_elems_makes_no_read(card, monkeypatch):
    monkeypatch.setenv("UNIKMER_TPU_MAX_ELEMS", "1000")
    assert fits("union", CARD, 1000) and not fits("union", CARD, 1001)
    assert element_budget("union", CARD) == 1000
    assert card.reads == 0 and counts() == (0, 0)


def test_the_cpu_has_no_budget_and_keeps_no_reading(card, monkeypatch):
    """On the CPU nothing is counted or kept, and a stub of
    _device_free_bytes is asked every time."""
    assert fits("union", "cpu", 1 << 61)
    asked = []
    monkeypatch.setattr(device_sets, "_device_free_bytes",
                        lambda d: asked.append(d) or 1 << 16)
    assert not fits("union", "cpu", 1 << 20)
    assert not fits("union", "cpu", 1 << 20)
    assert len(asked) == 2 and device_sets._CEILINGS == {}
    assert counts() == (0, 0)


@pytest.mark.cuda
def test_kept_free_bytes_track_the_card(monkeypatch):
    """On a card, after torch allocates and frees a few GB and empties
    its cache, the kept free bytes stay within 64 MiB of a fresh read,
    from one read of the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(device_sets, "_CEILINGS", {})
    monkeypatch.setattr(stages, "COUNTERS", {})
    monkeypatch.delenv("UNIKMER_TPU_MAX_ELEMS", raising=False)
    card = torch.device("cuda", 0)

    def check(when):
        kept = device_sets._free_bytes(card, 1)
        assert abs(kept - device_sets._device_free_bytes(card)) \
            <= 64 << 20, when

    device_sets._free_bytes(card, None)
    for gb in (1, 4, 2):
        x = torch.empty(gb * GB, dtype=torch.uint8, device=card)
        check(("allocated", gb))
        del x
        check(("freed", gb))
        torch.cuda.empty_cache()
        check(("emptied", gb))
    assert counts() == (10, 1)
