"""Small sizes for the harness's CPU runs: the configurations' shapes on
8 genomes of 30 kbp, subsets that fit them, and a sample drawn among
the first requests, which a short window on a busy host completes."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SMALL = dict(genomes=8, clades=2, core_bp=30000, accessory_pool=200,
             accessory_bp=200, accessory_per_genome=30)
SAMPLE = {"sample": {"per_kind": 2, "among_first": 12}}
SMALL_MIX = {"pangenome-k23.merge": {"subset_sizes": [2, 4, 8], **SAMPLE}}


@pytest.fixture
def on_cpu(monkeypatch):
    """The port's plain versions: every device route runs on the CPU."""
    monkeypatch.setenv("UNIKMER_TPU_TORCH_DEVICE", "cpu")
