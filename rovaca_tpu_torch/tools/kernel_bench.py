"""PairHMM cell updates a second on the card, against a CPU baseline
measured on the card's host.

Counterpart of bench.py's measurement (bench.py:131-240), on this package's
kernels. The batch is bench.py's: for seeds 0 and 1, 2048 reads of 120-151
bases with quals 10-39 and 64 haplotypes of 300-379 bases, through
``prep.build_pair_batch`` (K2's dense batch: 16 read tiles x 8 hap tiles)
and ``compact.build_pair_batch_compact`` with every tile pair (K1's batch,
as the scheduler builds the main path's). Cells are effective cells, the
sum of read length x hap length over real pairs. Each kernel runs 16 passes
over both batches, 3 times; each repetition is timed with CUDA events
around the passes and with the host clock up to a final synchronise, and
the best repetition is kept. ``value`` is K2's rate by the events.

Each kernel's share of its bound: the larger of the bytes a pass moves
(each input read once, the output written once) over 3.35 TB/s and its
float operations (11 a cell) over 67 TFLOP/s, the H100 SXM's peaks at
700 W, as chip_smoke.py computes it.

The CPU baseline runs live on the host of the card: the reference's own
engine harness (.refbuild/bin/pairhmm_harness) when it exists, else
native/pairhmm_avx_bench.c (an AVX-512 reimplementation of the reference's
16-lane scheme) built with gcc into build/native/. It reports one core's
rate (best of 3 runs alone) and the host's, measured by running one copy a
core, all started together, and summing their rates; ``vs_baseline`` is
K2's rate over the host's, with the number of copies beside it. Where the
CPU lacks AVX-512 or the build fails both are "not measured". No recorded
number is read.

    python -m rovaca_tpu_torch.tools.kernel_bench

prints one JSON line; without a card it exits 1 and prints none.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

from ..ops.pairhmm import compact, prep
from ..ops.pairhmm.api import all_pairs

PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PAIRHMM_OPS = 11
PASSES = 16
REPS = 3
BASELINE_ITERS = 3000     # ~1 s a run on one core
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO = os.path.dirname(_PKG)


class _Read:
    def __init__(self, bases, quals, mapping_quality=60):
        self.bases = bases
        self.quals = quals
        self.mapping_quality = mapping_quality


def bench_inputs(seed):
    """bench.py's reads and haps for one seed."""
    r2 = np.random.default_rng(seed)
    reads = []
    for _ in range(16 * 128):
        L = int(r2.integers(120, 152))
        reads.append(_Read("".join(r2.choice(list("ACGT"), size=L)),
                           r2.integers(10, 40, size=L)))
    haps = ["".join(r2.choice(list("ACGT"), size=int(r2.integers(300, 380))))
            for _ in range(8 * 8)]
    return reads, haps


def bench_batches(seeds=(0, 1)):
    """([(dense PairBatch, compact batch)], effective cells of one pass)."""
    batches, cells = [], 0
    for seed in seeds:
        reads, haps = bench_inputs(seed)
        batches.append((prep.build_pair_batch(reads, haps),
                        compact.build_pair_batch_compact(reads, haps)))
        cells += sum(len(r.bases) * len(h) for r in reads for h in haps)
    return batches, cells


def bound_ms(n_bytes, cells):
    """(least ms, "bytes" or "operations") of a pass."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, PAIRHMM_OPS * cells / PEAK_F32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_passes(fn, args_list):
    """Best of REPS repetitions of PASSES passes over ``args_list``:
    (events ms, host-clock ms to the final synchronise) a pass."""
    import torch
    fn(*args_list[0])
    torch.cuda.synchronize()
    best_ev = best_host = float("inf")
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        for _ in range(PASSES):
            for args in args_list:
                fn(*args)
        b.record()
        torch.cuda.synchronize()
        best_host = min(best_host, (time.perf_counter() - t0) * 1e3)
        best_ev = min(best_ev, a.elapsed_time(b))
    return best_ev / PASSES, best_host / PASSES


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def avx512():
    try:
        with open("/proc/cpuinfo") as f:
            return " avx512f" in f.read()
    except OSError:
        return False


def _rates(cmd, copies):
    """The cells/s each of ``copies`` concurrent runs of ``cmd`` reports
    (the harness's BENCH line on stderr, or the bench's stdout)."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(copies)]
    rates = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        if p.returncode != 0:
            raise RuntimeError(f"{cmd[0]} exited {p.returncode}: {err[-300:]}")
        bench = [ln for ln in err.splitlines() if ln.startswith("BENCH")]
        rates.append(float(bench[-1].rsplit("gcups=", 1)[1]) * 1e9 if bench
                     else float(out))
    return rates


def cpu_baseline():
    """{"per_core_cells_per_s", "cells_per_s", "processes", "source"}
    measured on this host, or those rates "not measured" with "why"."""
    harness = os.path.join(_REPO, ".refbuild", "bin", "pairhmm_harness")
    cases = os.path.join(_REPO, "tests", "golden", "pairhmm_cases.txt")
    out_dir = os.path.join(_REPO, "build", "native")
    os.makedirs(out_dir, exist_ok=True)
    if os.path.exists(harness) and os.path.exists(cases):
        cmd = [harness, cases, os.path.join(out_dir, "harness_out.txt"), "3",
               "20"]
        source = "the reference engine's harness, single thread a copy"
    else:
        not_measured = {"per_core_cells_per_s": "not measured",
                        "cells_per_s": "not measured"}
        if not avx512():
            return {**not_measured, "why": "this CPU has no AVX-512"}
        src = os.path.join(_PKG, "native", "pairhmm_avx_bench.c")
        exe = os.path.join(out_dir, "pairhmm_avx_bench")
        build = subprocess.run(["gcc", "-O3", "-mavx512f", "-mavx512dq",
                                "-o", exe, src, "-lm"], capture_output=True,
                               text=True)
        if build.returncode != 0:
            return {**not_measured,
                    "why": f"gcc failed: {build.stderr.strip()[-300:]}"}
        cmd = [exe, "128", "384", str(BASELINE_ITERS)]
        source = ("native/pairhmm_avx_bench.c (AVX-512, 16 lanes, Lr 128 x "
                  f"Lh 384, {BASELINE_ITERS} iterations a run)")
    copies = len(os.sched_getaffinity(0))
    per_core = max(_rates(cmd, 1)[0] for _ in range(3))
    rates = _rates(cmd, copies)
    return {"per_core_cells_per_s": per_core, "cells_per_s": sum(rates),
            "processes": copies, "process_rates": rates,
            "source": source + f"; one core: best of 3 runs alone; the host: "
                               f"{copies} copies (one a core the process may "
                               f"use) started together, rates summed"}


def run():
    """Measure K2 and K1 on bench.py's batch on card 0 and the CPU
    baseline; returns the JSON line's dict. Raises SystemExit without a
    card."""
    import torch

    from ..ops.pairhmm import dense, indexed
    from ..utils.platform import card_info, require_card
    require_card("kernel_bench")
    dev = torch.device("cuda", 0)
    batches, cells = bench_batches()
    k2_args, k1_args = [], []
    for b, cb in batches:
        k2_args.append(tuple(torch.from_numpy(a).to(dev) for a in (
            b.trans, b.rbase, b.rlen, b.hbase, b.hlen)))
        k1_args.append(compact.to_device(cb.arrays() + all_pairs(cb), dev))
    res = {}
    for name, fn, args_list in (
            ("pairhmm_dense", dense.pairhmm_dense, k2_args),
            ("pairhmm_indexed", indexed.pairhmm_indexed_compact, k1_args)):
        ev_ms, host_ms = time_passes(fn, args_list)
        outs = [fn(*args) for args in args_list]
        b_ms, b_by = bound_ms(sum(_nbytes(a) + _nbytes([o]) for a, o in
                                  zip(args_list, outs)), cells)
        res[name] = {"ms": ev_ms, "host_clock_ms": host_ms,
                     "cells_per_s": cells / (ev_ms / 1e3),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "share_of_bound": b_ms / ev_ms}
    torch.cuda.synchronize()
    value = res["pairhmm_dense"]["cells_per_s"]
    card = card_info() or {}
    base = cpu_baseline()
    out = {"metric": "pairhmm_cell_updates_per_sec", "value": value,
           "unit": "cells/s",
           "device": torch.cuda.get_device_name(dev),
           "power_limit_w": card.get("power_limit"),
           "nvidia_smi_name": card.get("name"),
           "effective_cells_per_pass": cells, "passes": PASSES,
           "repetitions": REPS, "timing": "best repetition, CUDA events "
                                          "(host clock beside it)",
           "kernels": res, "cpu_baseline": base}
    out["vs_baseline"] = (value / base["cells_per_s"]
                          if isinstance(base["cells_per_s"], float)
                          else "not measured")
    return out


def main(argv=None):
    try:
        out = run()
    except SystemExit as exc:
        print(f"kernel_bench: {exc}", file=sys.stderr)
        return 1
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
