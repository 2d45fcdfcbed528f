"""The P1/P2 probe sequence on the port's kernels.

    python -m unikmer_tpu_torch.probes            # on the card
    UNIKMER_TPU_TORCH_DEVICE=cpu python -m unikmer_tpu_torch.probes

The counterpart of scripts/exp_pallas_dma.py and exp_pallas_dma2.py at
their sizes: P1a copy+increment of N = 2^23 u32 (32 MiB), P1b 64 row
compare-exchange stages at distance R/2 on (4096, 128) u32, P1c 32
transposes of (128, 128) tiles, P2a 4, 16 and 64 row stages of the
bitonic distance cycle, P2b seven lane stages via warp shuffles.  Each
line gives the median time of the kernel (CUDA events on the card, the
host clock on the CPU, where the plain versions run), whether it equals
the plain PyTorch version exactly, and the rate the scripts print.  Any
failure raises.
"""

from __future__ import annotations

import statistics
import sys
import time

import numpy as np
import torch

from ._device import get_device
from .ops import probes

N = 1 << 23  # u32 elements of P1a
ROWS = 4096  # rows of the (ROWS, 128) blocks of P1b, P1c, P2a, P2b
P2A_STAGES = (4, 16, 64)


def time_ms(fn, device: torch.device, reps: int = 10) -> float:
    """Median milliseconds of fn() over reps, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn()
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def probe_inputs(device: torch.device):
    """(P1a input, the (ROWS, 128) block) as int32 u32 bit patterns, made
    as the scripts make them: arange and numpy's default_rng(0)."""
    a = np.arange(N, dtype=np.uint32).reshape(N // 128, 128)
    b = np.random.default_rng(0).integers(0, 2**32, (ROWS, 128),
                                          dtype=np.uint32)
    return (torch.from_numpy(a.view(np.int32)).to(device),
            torch.from_numpy(b.view(np.int32)).to(device))


def probe_cases(x1, blk):
    """(name, kernel call, plain call, rate label, rate units per call)
    for every probe of the sequence."""
    cases = [("P1a copy+inc 32MB", lambda: probes.copy_inc_u32(x1),
              lambda: probes.copy_inc_u32_plain(x1), "GB/s",
              2 * x1.numel() * 4 / 1e9)]
    ds = probes.p1b_distances(ROWS)
    cases.append(("P1b 64 row cmpex stages on 2MB",
                  lambda: probes.row_cmpex_u32(blk, ds),
                  lambda: probes.row_cmpex_u32_plain(blk, ds), "G cmpex/s",
                  ROWS * 128 * len(ds) / 1e9))
    cases.append(("P1c 32x transpose128 (2MB)",
                  lambda: probes.transpose128_u32(blk),
                  lambda: probes.transpose128_u32_plain(blk), "GB/s",
                  2 * blk.numel() * 4 / 1e9))
    for s in P2A_STAGES:
        d = probes.p2a_distances(s, ROWS)
        cases.append((f"P2a {s} row-stages on (4096,128)",
                      lambda d=d: probes.row_cmpex_u32(blk, d),
                      lambda d=d: probes.row_cmpex_u32_plain(blk, d),
                      "G cmpex/s", ROWS * 128 * s / 1e9))
    cases.append(("P2b 7 lane-stages via shuffles (2MB)",
                  lambda: probes.lane_cmpex_u32(blk),
                  lambda: probes.lane_cmpex_u32_plain(blk), "G cmpex/s",
                  ROWS * 128 * 7 / 1e9))
    return cases


def main(argv=None) -> int:
    device = get_device()
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu (plain versions)")
    print(f"device: {where}", flush=True)
    x1, blk = probe_inputs(device)
    for name, kernel, plain, label, units in probe_cases(x1, blk):
        got, want = kernel(), plain()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if not torch.equal(got, want):
            raise RuntimeError(f"{name}: the kernel differs from its plain "
                               f"version")
        ms = time_ms(kernel, device)
        print(f"{name:40s} {ms:10.4f} ms  exact=True  "
              f"{units / (ms / 1e3):.1f} {label}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
