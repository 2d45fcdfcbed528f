"""One run of one cell: set-up, the measured window, the comparison with
the reference, and the result's line.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``; it names a
configuration (``configs``, whose ``file`` holds the sizes) and a mix
(``portbench/traffic/<traffic>.json``).  Its metrics are the entries of
``end_to_end`` (untraced run) or ``per_layer`` (traced run) that list
it, or list no cells; each is read by ``portbench/metrics/<name>.py``.
Nothing here names a cell, a configuration, a mix or a metric.

Set-up generates the seed's genomes as FASTA files under ``$TMPDIR``,
builds each genome's set with ``KmerSet.from_fasta``, and runs one
request of each (kind, size) of the mix.  The window is a closed loop of
one client: a request is one tree of ``KmerSet`` operations, complete
when its result is on the card (its length is on the host, and the
harness synchronises the device), and is timed by the host's clock from
its call to that synchronise; the window ends at the first completion
after ``seconds``.  Afterwards the answers of a sample of the window's
requests, and every set that set-up made, are fetched and compared with
the plain reference, which reads the same FASTA files and works
everything out again.

A configuration with a ``taxonomy`` block (gen/taxonomy.py names its
keys) carries taxids: set-up also writes the seed's ``nodes.dmp`` and
tags each genome's set with its genome's taxid, through the program's
own loader and ``KmerSet.from_codes``; the comparison then holds every
member's taxid to the reference's (reference/taxa.py), as
``taxids_wrong``.  A configuration without one takes none of this.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys
import tempfile
import time
import traceback
from pathlib import Path

from portbench.gen.genomes import write_genomes
from portbench.gen.traffic import (
    Evaluator, RequestStream, Tally, classes, load_mix, sample_ordinals,
)
from portbench.records import (
    RunRecords, Trace, breakdown, busy_us, host_calls,
)
from portbench.gen.taxonomy import write_taxonomy
from portbench.reference.compare import members_wrong, taxids_wrong
from portbench.reference.encode import genome_set
from portbench.reference.sets import ReferenceSets
from portbench.reference.taxa import TaxaSets

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "unikmer_tpu")
THREADS = 8


def forbidden_modules() -> list[str]:
    """Top-level names in sys.modules equal, whole, to a forbidden one."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def say(*parts) -> None:
    print("portbench:", *parts, file=sys.stderr, flush=True)


def load_cell(root: Path, workload: str):
    """(cell, configuration entry, configuration, mix, benchmark)."""
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(root / entry["file"]) as f:
        cfg = json.load(f)
    return cell, entry, cfg, load_mix(root, cell["traffic"]), bench


def metric_reader(root: Path, name: str):
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, traced: bool) -> list[dict]:
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


class ProgramSets:
    """The program as the evaluator's backend: the port's KmerSet."""

    def __init__(self, KmerSet, sets):
        self.KmerSet, self.sets = KmerSet, sets

    def genome(self, i):
        return self.sets[i]

    def union_all(self, items):
        return self.KmerSet.union_all(items)

    def common(self, items, threshold):
        return self.KmerSet.common(items, threshold)

    def intersect(self, a, b):
        return a.intersect(b)

    def subtract(self, a, b):
        return a.subtract(b)

    def size(self, x) -> int:
        return len(x)


def tag_sets(KmerSet, sets: list, taxa, cfg: dict, dev) -> None:
    """Replace each genome's set by the same members tagged with its
    genome's taxid, over the taxonomy loaded by the program's loader."""
    import numpy as np

    from unikmer_tpu_torch.taxonomy.taxdump import load_taxonomy

    taxdb = load_taxonomy(taxa.directory)
    for i, taxid in enumerate(taxa.genome_taxids):
        codes = sets[i].to_numpy()
        sets[i] = None
        sets[i] = KmerSet.from_codes(
            codes, cfg["k"], canonical=cfg["canonical"],
            hashed=cfg["hashed"], taxids=np.full(len(codes), taxid, np.uint32),
            taxdb=taxdb, assume_sorted_unique=True, device=dev)


def on_host(kset) -> bool:
    """Whether the program kept a set on the host (its admission refused
    the device route)."""
    return bool(kset._on_host)


class Device:
    """The torch device the run drives, and its synchronise."""

    def __init__(self, torch, dev):
        self.torch, self.dev = torch, dev
        self.cuda = dev.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize(self.dev)


def _span(torch, traced: bool, name: str):
    if not traced:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


def window(ev: Evaluator, stream: RequestStream, seconds: float,
           keep: set, device: Device, traced: bool):
    """The measured window: (requests, kept answers, window seconds,
    failures, results kept on the host)."""
    torch = device.torch
    requests, kept, failed, host_kept = [], {}, 0, 0
    t_start = time.perf_counter()
    deadline = t_start + seconds
    with _span(torch, traced, "portbench.window"):
        while True:
            req = next(stream)
            tally = Tally()
            with _span(torch, traced, f"portbench.req.{req.kind}"):
                t0 = time.perf_counter()
                try:
                    result = ev.request(req, tally)
                except (RuntimeError, MemoryError):
                    failed += 1
                    say(f"request {req.ordinal} ({req.kind}) failed:\n"
                        + traceback.format_exc())
                    result = None
            with _span(torch, traced, "portbench.sync"):
                device.sync()
            t1 = time.perf_counter()
            if result is not None:
                host_kept += on_host(result)
                if req.ordinal in keep:
                    kept[req.ordinal] = (req, result)
                requests.append(dict(
                    kind=req.kind, size=req.size, members=tally.members,
                    sort_members=tally.sort_members, lookups=tally.lookups,
                    latency_ms=(t1 - t0) * 1e3))
            result = None
            if t1 >= deadline:
                break
    return requests, kept, t1 - t_start, failed, host_kept


def allocator_counts(torch, device: Device) -> dict:
    """The caching allocator's device allocations, frees and retries so
    far (a window that allocates anew is still warming up)."""
    if not device.cuda:
        return {"cudaMalloc": 0, "cudaFree": 0, "retries": 0}
    st = torch.cuda.memory_stats(device.dev)
    return {"cudaMalloc": st.get("num_device_alloc", 0),
            "cudaFree": st.get("num_device_free", 0),
            "retries": st.get("num_alloc_retries", 0)}


def _trace_window(torch, traced: bool):
    if not traced:
        return None
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts, record_shapes=False, with_stack=False,
                   profile_memory=False)


def reference_sets(paths: list[str], cfg: dict, device, taxa=None):
    """The reference's backend over the genomes' FASTA files; with
    ``taxa`` (gen/taxonomy.py), each genome's members carry its taxid."""
    ref_genomes = [genome_set(p, cfg["k"], cfg["canonical"], cfg["hashed"],
                              device) for p in paths]
    if taxa is None:
        return ReferenceSets(ref_genomes)
    return TaxaSets.one_taxid_a_genome(ref_genomes, taxa.genome_taxids,
                                       taxa.nodes_dmp)


def check(cfg: dict, mix: dict, paths: list[str], program: dict,
          device, taxa=None) -> dict:
    """The comparison with the reference, run on ``device``.  ``program``
    holds the program's fetched arrays: ``genomes`` (a list) and
    ``answers`` (a list of (request, array)); with ``taxa``, also
    ``taxids``: ``{"genomes": [...], "answers": [...]}``, each set's
    taxids in the same order.  Returns the numbers compared, each with
    its limit."""
    ref = reference_sets(paths, cfg, device, taxa)
    rev = Evaluator(ref, cfg)
    out = {"genome_sets_wrong": sum(
        members_wrong(got, ref.codes(i))
        for i, got in enumerate(program["genomes"]))}
    if taxa is None:
        out["answers_wrong"] = sum(
            members_wrong(got, ref.codes(rev.request(req)))
            for req, got in program["answers"])
    else:
        tags = program["taxids"]
        out["answers_wrong"] = out["taxids_wrong"] = 0
        for i, (got, got_t) in enumerate(zip(program["genomes"],
                                             tags["genomes"])):
            out["taxids_wrong"] += taxids_wrong(got, got_t, ref.codes(i),
                                                ref.taxids(i))
        for (req, got), got_t in zip(program["answers"], tags["answers"]):
            want = rev.request(req)
            out["answers_wrong"] += members_wrong(got, ref.codes(want))
            out["taxids_wrong"] += taxids_wrong(got, got_t, ref.codes(want),
                                                ref.taxids(want))
    kinds = {e["kind"] for e in mix["deck"]}
    out["kinds_unchecked"] = len(kinds - {req.kind for req, _ in
                                          program["answers"]})
    return {name: {"value": v, "limit": 0} for name, v in out.items()}


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             root: Path = ROOT, started: float | None = None,
             threads: int = THREADS, sizes: dict | None = None,
             mix_keys: dict | None = None) -> dict:
    """One run; returns the result's line as a dict, ``checks`` last.
    ``sizes`` and ``mix_keys`` replace keys of the configuration and of
    the mix (the tests' small runs)."""
    started = time.perf_counter() if started is None else started
    root = Path(root)
    cell, _, cfg, mix, bench = load_cell(root, workload)
    cfg = {**cfg, **(sizes or {})}
    mix = {**mix, **(mix_keys or {})}
    setup: dict = {}

    import torch

    from unikmer_tpu_torch import native
    from unikmer_tpu_torch._device import get_device
    from unikmer_tpu_torch.api import KmerSet
    from unikmer_tpu_torch.ops.radix_sort import radix_sort_u64

    device = Device(torch, get_device())
    if device.cuda:
        from unikmer_tpu_torch import _kernels

        torch.zeros(1, device=device.dev)
        _kernels.load()
    native.get_lib()
    setup["init_s"] = time.perf_counter() - started

    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        t = time.perf_counter()
        paths = write_genomes(cfg, seed, tmp, threads)
        setup["generate_s"] = time.perf_counter() - t

        t = time.perf_counter()
        sets = [KmerSet.from_fasta(p, cfg["k"], canonical=cfg["canonical"],
                                   hashed=cfg["hashed"], device=device.dev)
                for p in paths]
        device.sync()
        setup["count_s"] = time.perf_counter() - t
        taxa = None
        if "taxonomy" in cfg:
            t = time.perf_counter()
            taxa = write_taxonomy(cfg, seed, os.path.join(tmp, "taxdump"))
            tag_sets(KmerSet, sets, taxa, cfg, device.dev)
            device.sync()
            setup["tag_s"] = time.perf_counter() - t
        if any(on_host(s) for s in sets):
            raise SystemExit("set-up: a genome's set was kept on the host")

        t = time.perf_counter()
        ev = Evaluator(ProgramSets(KmerSet, sets), cfg)
        warm = RequestStream(mix, cfg, seed, stream=1)
        todo = set(classes(mix))
        while todo:
            req = next(warm)
            if (req.kind, req.size) not in todo:
                continue
            todo.discard((req.kind, req.size))
            if on_host(ev.request(req)):
                raise SystemExit(f"set-up: {req.kind} over {req.size} "
                                 "genomes took the host route")
        device.sync()
        setup["warm_s"] = time.perf_counter() - t

        keep = sample_ordinals(mix, cfg, seed)
        stream = RequestStream(mix, cfg, seed)
        setup["setup_s"] = time.perf_counter() - started
        prof = _trace_window(torch, traced)
        if prof is not None:
            prof.start()
        launches = radix_sort_u64.launches
        alloc = allocator_counts(torch, device)
        requests, kept, window_s, failed, host_kept = window(
            ev, stream, seconds, keep, device, traced)
        k2_launches = radix_sort_u64.launches - launches
        alloc = {k: v - alloc[k] for k, v in
                 allocator_counts(torch, device).items()}
        t_after = time.perf_counter()
        trace = None
        if prof is not None:
            prof.stop()
            chrome = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(chrome)
            del prof
            trace = Trace.from_chrome(chrome)
            os.unlink(chrome)
        peak = (torch.cuda.max_memory_allocated(device.dev) if device.cuda
                else 0)

        program = {
            "genomes": [s.to_numpy() for s in sets],
            "answers": [(req, res.to_numpy())
                        for _, (req, res) in sorted(kept.items())],
        }
        if taxa is not None:
            program["taxids"] = {
                "genomes": [s.taxids_to_numpy() for s in sets],
                "answers": [res.taxids_to_numpy()
                            for _, (_, res) in sorted(kept.items())],
            }
        del sets, ev, kept
        if device.cuda:
            torch.cuda.empty_cache()
        print(f"portbench: {workload} seed {seed}: {len(requests)} requests "
              f"in {window_s:.3f} s, {failed} failed; K2 launches in the "
              f"window {k2_launches}; results kept on the host {host_kept}; "
              f"answers compared {len(program['answers'])}; allocator in "
              f"the window {json.dumps(alloc)}; set-up "
              + json.dumps({k: round(v, 4) for k, v in setup.items()}),
              flush=True)
        if trace is not None:
            print("portbench: host calls in the window [name, s, count]: "
                  + json.dumps(host_calls(trace)), flush=True)
        t = time.perf_counter()
        checks = check(cfg, mix, paths, program, device.dev, taxa)
        print(f"portbench: fetch {t - t_after:.3f} s, reference and "
              f"comparison {time.perf_counter() - t:.3f} s", flush=True)
    checks["requests_failed"] = {"value": failed, "limit": 0}

    run = RunRecords(requests=requests, window_s=window_s, setup=setup,
                     counters={"k2_launches": k2_launches},
                     trace=trace)
    metrics = {}
    for m in cell_metrics(bench, workload, traced):
        value = metric_reader(root, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if device.cuda:
        dev_info = {"platform": "gpu",
                    "kind": torch.cuda.get_device_name(device.dev),
                    "count": 1, "memory_peak_bytes": int(peak)}
    else:
        dev_info = {"platform": "cpu", "kind": "cpu", "count": 1,
                    "memory_peak_bytes": 0}
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": len(requests) + failed,
        "failed": failed,
        "metrics": metrics,
        "device": dev_info,
    }
    if traced:
        if trace is None:
            raise SystemExit("traced run: the trace holds no window")
        dev_info["busy_s"] = busy_us(trace) / 1e6
        dev_info["window_s"] = trace.seconds
        result["breakdown"] = breakdown(trace)
    result["checks"] = checks
    return result
