"""The control of the comparison that decides ``correct``: the reference
put in the program's place and computed one width down, its codes held
in 32 bits (each code's low 32 bits), where a configuration states
46-bit (2-bit k = 23) or 64-bit (hashed) codes.  (Float64, the next width a later change might
reach for, holds every 46-bit code exactly, so it could not fail the
2-bit configuration.)  The control must come out not correct.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed it makes the cell's genome sets with the control,
answers the requests that a run of that seed compares (the sample drawn
from the seed among the window's first requests), and prints the numbers that the run's comparison gives, one JSON line a
seed.  Where the configuration carries taxids, the control's sets carry
each genome's taxid, merged by the reference's own LCA.  The benchmark's
own runs never run it.
"""

from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.cell import check, load_cell  # noqa: E402
from portbench.gen.genomes import write_genomes  # noqa: E402
from portbench.gen.taxonomy import write_taxonomy  # noqa: E402
from portbench.gen.traffic import (  # noqa: E402
    Evaluator, RequestStream, sample_ordinals,
)
from portbench.reference.encode import SIGN, genome_set  # noqa: E402
from portbench.reference.sets import ReferenceSets  # noqa: E402
from portbench.reference.taxa import TaxaSets  # noqa: E402

LOW32 = (1 << 32) - 1


def narrowed(codes):
    """A flipped set's codes cut to their low 32 bits, distinct, flipped."""
    import torch

    return torch.unique(((codes ^ SIGN) & LOW32) ^ SIGN)


def control_run(workload: str, seed: int, device, root: Path = ROOT,
                sizes: dict | None = None,
                mix_keys: dict | None = None) -> dict:
    """The comparison's numbers, with the control as the program."""
    _, _, cfg, mix, _ = load_cell(Path(root), workload)
    cfg = {**cfg, **(sizes or {})}
    mix = {**mix, **(mix_keys or {})}
    with tempfile.TemporaryDirectory(prefix="portbench-control-") as tmp:
        paths = write_genomes(cfg, seed, tmp)
        sets = [narrowed(genome_set(p, cfg["k"], cfg["canonical"],
                                    cfg["hashed"], device)) for p in paths]
        # the reference over the 32-bit sets
        taxa = None
        if "taxonomy" in cfg:
            taxa = write_taxonomy(cfg, seed, f"{tmp}/taxdump")
            ctl = TaxaSets.one_taxid_a_genome(sets, taxa.genome_taxids,
                                              taxa.nodes_dmp)
        else:
            ctl = ReferenceSets(sets)
        ev = Evaluator(ctl, cfg)
        keep = sample_ordinals(mix, cfg, seed)
        stream = RequestStream(mix, cfg, seed)
        answers, answer_taxids = [], []
        while keep:
            req = next(stream)
            if req.ordinal in keep:
                keep.discard(req.ordinal)
                got = ev.request(req)
                answers.append((req, ctl.codes(got)))
                if taxa is not None:
                    answer_taxids.append(ctl.taxids(got))
        program = {
            "genomes": [ctl.codes(i) for i in range(len(sets))],
            "answers": answers,
        }
        if taxa is not None:
            program["taxids"] = {
                "genomes": [ctl.taxids(i) for i in range(len(sets))],
                "answers": answer_taxids}
        return check(cfg, mix, paths, program, device, taxa)


def main(argv=None) -> int:
    import argparse

    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in args.seeds:
        checks = control_run(args.workload, seed, device)
        print(json.dumps({
            "workload": args.workload, "seed": seed, "device": str(device),
            "correct": all(c["value"] <= c["limit"] for c in checks.values()),
            "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
