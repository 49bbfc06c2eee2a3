#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (rovaca_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper: the kernels are built for sm_90a) and the CUDA
toolkit. Phases, each printing its own lines and its seconds; any failure
exits non-zero:

0. card: name and power limit from nvidia-smi.
1. build: nvcc builds the three kernel sources from the checkout (K1, K2,
   and K3's DP and traceback in one library), one nvcc each, all started
   together; ptxas registers and spills for each kernel.
2. K1 (indexed PairHMM) against its plain torch version on the card, on
   numpy-seeded compact batches at main-path shapes (ragged lengths, N
   bases, padding lanes and haps, repeated pair indices): rtol 2e-5 on pairs
   at or above MIN_ACCEPTED_F32, the same set of pairs below it (the float64
   rescue set), exact zeros on padding. Median times over 5 runs (CUDA
   events; the plain version once at G 1024) and effective Gcells/s (sum of
   rlen*hlen over real pairs).
3. K2 (dense PairHMM) against its plain version on dense 8 x 8 tile grids at
   Lr 128/256 x Lh 256/512, held to K1's checks.
4. K3 (banded SW) against its plain version on numpy-seeded realignment
   batches (haps as refs, noisy read fragments as alts, diagonals from the
   read's offset, a few placed off the band) at Ln 256/512/1024 x B
   64/1024: bt, colm, lastrow and edge bit-identical; the traceback
   kernel's packed slots equal to its plain version's; the cigars and
   offsets of sw_align_banded_batch on the card equal to the exact host
   SW's (the native SW for all, the python oracle for the first few); the
   fallback count. Times: the DP, the traceback, the slots' copy to pinned
   host memory (and its bytes), and, for the record, the copy of the whole
   backtrack band that the slots replaced.
5. main path: a 1 Mb / 30x diploid corpus (the port's
   tools.golden_e2e.generate, seed 424242, run as ``golden_e2e gen`` in a
   child process, see below; its ref.fa and BAM payload hashes must equal
   tests/golden_torch/MANIFEST.json's, so a stale corpus is told apart
   from a port that diverges) through ``rovaca_tpu_torch.cli
   HaplotypeCaller`` with ``--pairhmm-engine cuda``, then ``native`` on the
   same inputs. The cuda run must launch K1, as often as its scheduler
   counted. Its VCF is held to the native run's, and both to rovaca_tpu's
   xla VCF of the corpus committed in tests/golden_torch/ (``1mb.vcf.xz``):
   (CHROM, POS, REF, ALT, GT) identical, the other fields within
   golden_e2e's tolerances. Each K1 launch's (G, Lr, Lh, real cells) and
   its bound are printed.
6. realignment path: the same corpus with ROVACA_BANDED_REALIGN=1 and the
   cuda engine. K3's DP and traceback kernels must each launch as often as
   ``stats["sw_launches"]`` counts, at least once; its VCF must match the
   native run's; its fallbacks to the host SW are printed. Each launch's
   (B, Ln, A, band cells) and its DP and traceback bounds, summed against
   the K3 card time: after the counts are read, each launch replayed on its
   recorded inputs, CUDA events around DP + traceback + slot copy, and
   around each alone.
7. region path: the port's ``RegionCaller.call_region`` (K2) over the first
   200+ active regions of the corpus, engine cuda then native: the same
   (pos, alleles, GT, GQ), PL within golden_e2e's PL_TOL, and K2 launched.
8. device-list path: every visible card named twice. A PairHMMScheduler
   over that list against a one-card scheduler on the same jobs (lik and
   kept array-equal); ``sharded_pipeline_step`` (K1) and
   ``sharded_pairhmm_step`` (K2) at S = 4 shards against their plain
   versions, held to K1's checks, and the global best within rtol 2e-5;
   ``pipeline_dryrun(4)`` through the card.
9. ``--shards 2`` on the corpus, cuda engine: each shard launches K1 and the
   merged VCF passes tools.race_e2e.depth_masked_diff against phase 5's
   cuda VCF (the bar of tests/test_shard_confinement.py).
10. ``-t 2`` on the corpus, cuda engine: K1 launched as often as the
   scheduler counted, the VCF byte-identical to phase 5's.
11. two torch.distributed ranks (gloo, torchrun's environment) on the card,
   cuda engine: both exit 0 and launch K1, rank 0's merged VCF passes
   depth_masked_diff against phase 5's.
12. GVCF path: the corpus with ``-e GVCF`` on the cuda engine. K1 must
   launch, as often as the scheduler counted; the GVCF is held to
   rovaca_tpu's committed ``1mb.g.vcf.xz`` (golden_e2e.diff with gvcf:
   variant rows as above, every band row's END, GT, GQ, DP, MIN_DP and PL
   exactly). Wall, card share, rows and band rows are printed.
13. flows: every flow of tools.golden_flows.FLOWS (VCF, GVCF, banded VCF
   and GVCF, BQSR, BED, dbSNP, --resume, two BAMs, -L, --pcr-indel-model
   NONE, --gq-bands) on the 50 kb corpus committed in tests/golden_torch/
   (its files' hashes equal to the manifest's), cuda engine, in this
   process through ``cli.main``, each held to rovaca_tpu's committed output
   for it (IDs included). Every run launches K1, as often as the scheduler
   counted; the banded flows launch K3's DP and traceback as often as
   ``stats["sw_launches"]`` counts, at least once, the others never; each
   flow did what it is for (golden_flows.effect_problems: BED and -L calls
   inside their spans, dbSNP IDs on the truth sites and not the decoy's
   or the filtered record's, BQSR records not the plain run's, --resume the
   straight run's records ending in the BGZF EOF block). BuildBamIndex and
   IndexFeatureFile on the committed BAM and dbSNP VCF give the committed
   .bai and .tbi byte for byte.
14. measure, on phase 5's corpus (not generated again):
   (a) tools.race_e2e.run_race with the contenders cuda, native and
   cuda_gvcf, one unrecorded warm-up run and RACE_ROUNDS rounds of
   ``python -m rovaca_tpu_torch.cli`` processes (RACE_MIN_ROUNDS when, at
   the pace of this run's phases 5 and 12, more would end after
   RACE_END_BY_S): each contender's runs, median, (max - min) / median,
   own walls, card share and reads/s, every output ``RESULT: MATCH``
   against rovaca_tpu's committed 1 Mb VCF or GVCF, K1 launched in every
   cuda run and in no native one; (b) tools.host_profile on the cuda
   engine for the VCF and the GVCF (seconds by layer, the profiled wall
   against (a)'s median), and a torch.profiler run of the VCF (kernel time
   by name, the card's busy share); (c) tools.kernel_bench's JSON line (K2
   and K1 on bench.py's batch; the CPU baseline of one core and of every
   core at once, measured on this host); (d) tools.accuracy_eval.score_calls
   of (a)'s cuda VCF against the corpus's truth.txt (379 variants), the
   native VCF scoring the same.

Order: the corpus of phase 5 is generated by a child process started after
phase 0. Beside it run only work that reports no time the kernels' line or
a measurement takes: phase 1, phase 2 at K1's untimed G 1024 shapes (their
own lines mark their times as taken on a shared host), phase 8 and phase 13.
The script then waits for the corpus and runs the rest of phase 2 and
phases 3-7, 9-12 and 14 with the host to itself.

Every kernel's counter is set to 0 just before each of phases 5-8, 10, 12,
each flow of 13 and each in-process run of 14 (b), and read just after;
phases 9, 11 and 14 (a) run in child processes, whose schedulers' launch
counts their summary lines print. The
line before the last is the kernels' JSON summary: each kernel's launches on
its path (and on the GVCF path and the flows, summed), its time and its
plain version's at the timed shape (CUDA events on a stream held until the
host has queued the call, so the card's time alone), and its bound there,
the larger of its bytes over 3.35 TB/s and its operations over the peak rate
of their type (PEAK_*), counting the work this run's data needs; no single
PyTorch call computes any of the four functions, so ``library_ms`` is null.
The last line is ``{"ok": true, "device": {...}}``. Nothing of jax or
rovaca_tpu is imported.
"""

import concurrent.futures
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
RTOL = 2e-5           # the bar tests/test_pairhmm.py sets native vs XLA
RUNS = 5
HOLD_CYCLES = 2_000_000   # ~1 ms at 1.98 GHz: longer than a wrapper's enqueue
# (Lr, Lh, G): the main path's read and hap length buckets and a small and a
# full launch (scheduler.G_MAX); the plain version's time grows with
# Lr * Lh * G
SHAPES = tuple(itertools.product((128, 256), (256, 512, 1024), (64, 1024)))
TIMED_SHAPE = (128, 256, 1024)   # the shape reported in the JSON summary
# the plain version takes 4-35 s a call at the full launches: one run
PLAIN_ONCE = {s for s in SHAPES if s[2] == 1024}
# K1's shapes held while the corpus is generated: the untimed G 1024 ones
BESIDE_CORPUS = tuple(s for s in SHAPES
                      if s in PLAIN_ONCE and s != TIMED_SHAPE)
# K2: (Lr, Lh) at a dense 8 x 8 grid of tiles, as call_region's regions give
DENSE_SHAPES = tuple(itertools.product((128, 256), (256, 512)))
DENSE_TILES = 8
DENSE_TIMED = (128, 256)
# K3: (Ln, B); Ln is the realigned haplotypes' length rounded up to 128
SW_SHAPES = tuple(itertools.product((256, 512, 1024), (64, 1024)))
SW_TIMED = (512, 1024)
SW_ORACLE = 8          # alignments per shape also held to the python SW
KERNELS = ("pairhmm_indexed", "pairhmm_dense", "sw_banded")
# rovaca_tpu's xla outputs of the 1 Mb corpus (golden_flows.CORPUS_1MB),
# committed in tests/golden_torch/
REF_1MB_VCF, REF_1MB_GVCF = "1mb.vcf.xz", "1mb.g.vcf.xz"
MIN_REGIONS = 200
SHARDS = 4             # shards of the sharded steps and the dryrun
# phase 14: the race's contenders and rounds after its warm-up. A round is
# predicted to take the in-process walls of phases 5 and 12 plus
# CLI_START_S a process (torch's start-up, 8-13 s on the H100's host),
# and what follows the race REST_ROUNDS rounds (1.1-1.7 on one H100 80GB
# HBM3 at 700 W). If RACE_ROUNDS would end the script after RACE_END_BY_S
# (it must end within 1200 s), RACE_MIN_ROUNDS are run. The 1 Mb corpus's
# truth variants.
RACE_CONTENDERS = ("cuda", "native", "cuda_gvcf")
RACE_ROUNDS = 3
RACE_MIN_ROUNDS = 2
RACE_END_BY_S = 1150
CLI_START_S = 10
REST_ROUNDS = 1.75
TRUTH_1MB = 379
STARTED = time.perf_counter()
# The H100 SXM's peaks (NVIDIA's data sheet at 700 W): HBM 3.35 TB/s, FP32
# outside the tensor cores 67 TFLOP/s; int32 64 ops a clock an SM (CUDA
# C++ Programming Guide, arithmetic throughput for compute capability 9.0)
# x 132 SMs x 1.98 GHz
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_I32 = 64 * 132 * 1.98e9
# float ops a PairHMM cell (M: 2 mul, 1 add, 1 FMA; I and D: 1 mul, 1 FMA
# each; an FMA counts 2) and int32 ops a banded-SW band cell (diagonal:
# compare, select, add; vertical: 2 adds, max; in-row gap scan: add, max,
# compare, select; the cell: 2 max and the cutoff max; backtrack code:
# compare, 2 selects); int32 ops a traceback walk step (band index, 2
# range compares, the load's address, the sign test, 2 position updates, the
# run-length compare)
PAIRHMM_OPS = 11
SW_OPS = 16
TB_STEP_OPS = 8


class PhaseError(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def check_imports():
    """Neither jax nor rovaca_tpu (nor a module of it) was imported."""
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "rovaca_tpu"))
    check(not bad, f"imported {bad[:5]}")


def phase_card():
    import torch
    from rovaca_tpu_torch.utils import platform
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    print(res.stdout.strip().splitlines()[0], flush=True)   # as printed
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {platform.device_name()} "
          f"count {torch.cuda.device_count()}", flush=True)


def phase_build():
    from rovaca_tpu_torch.ops import build

    def one(name):
        t0 = time.perf_counter()
        path = build.shared_lib(name)
        return path, time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        done = dict(zip(KERNELS, pool.map(one, KERNELS)))
    for name in KERNELS:
        path, dt = done[name]
        print(f"[build] {name}.cu -> {os.path.relpath(path, REPO)} in "
              f"{dt:.2f}s", flush=True)
        for line in build.build_log(name).splitlines():
            if "ptxas info" in line and ("registers" in line
                                         or "Used" in line):
                print(f"[build] {name}: {line.strip()}", flush=True)
            elif "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)
    return time.perf_counter() - t0


def make_batch(rng, Lr, Lh, G):
    """Compact tile stacks whose reads are fragments of one sequence and
    whose haps are mutated, truncated copies of it, so most pairs score in
    float32 range and haps cut short leave some below it."""
    import numpy as np
    NR = NH = max(4, G // 16)
    seq_len = Lh + Lr
    codes = np.array([1, 2, 4, 8], dtype=np.int8)
    base = codes[rng.integers(0, 4, seq_len)]

    hlen = rng.integers(Lh // 2, Lh + 1, size=(NH, 8)).astype(np.int32)
    hlen[rng.random((NH, 8)) < 0.15] = 0                   # padding haps
    hcode = np.broadcast_to(base[:Lh, None], (NH, Lh, 8)).copy()
    snp = rng.random(hcode.shape) < 0.01
    hcode[snp] = codes[rng.integers(0, 4, int(snp.sum()))]
    hcode[rng.random(hcode.shape) < 0.002] = 15            # N
    hcode[np.arange(Lh)[None, :, None] >= hlen[:, None, :]] = 0

    rlen = rng.integers(Lr // 2, Lr + 1, size=(NR, 128)).astype(np.int32)
    rlen[rng.random((NR, 128)) < 0.15] = 0                 # padding lanes
    start = rng.integers(0, Lh - Lr // 2, size=(NR, 128))
    pos = np.minimum(start[:, None, :] + np.arange(Lr)[None, :, None],
                     seq_len - 1)
    rbase = base[pos]
    err = rng.random(rbase.shape) < 0.01
    rbase[err] = codes[rng.integers(0, 4, int(err.sum()))]
    rbase[rng.random(rbase.shape) < 0.002] = 15            # N
    valid = np.arange(Lr)[None, :, None] < rlen[:, None, :]
    rbase = np.where(valid, rbase, 0).astype(np.int8)
    q = np.where(valid, rng.integers(6, 41, rbase.shape), 0).astype(np.uint8)
    gi = np.where(valid, rng.integers(20, 46, rbase.shape), 0).astype(np.uint8)
    gc = np.where(valid, 10, 0).astype(np.uint8)

    hidx = rng.integers(0, NH, G).astype(np.int32)
    ridx = rng.integers(0, NR, G).astype(np.int32)
    hidx[G // 2:G // 2 + 4] = hidx[:4]                     # repeated pairs
    ridx[G // 2:G // 2 + 4] = ridx[:4]
    arrays = (q, gi, gc, rbase, rlen[:, None, :], hcode, hlen[..., None],
              hidx, ridx)
    cells = int((rlen[ridx][:, None, :].astype(np.int64)
                 * hlen[hidx][:, :, None]).sum())
    return arrays, cells


def bound(n_bytes, n_ops, peak_ops):
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / peak_ops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def pairhmm_bound(tensors, cells):
    """bound() of a PairHMM launch: every input read once, the output
    written once, PAIRHMM_OPS float ops a real cell."""
    n_bytes = sum(t.numel() * t.element_size() for t in tensors)
    return bound(n_bytes, PAIRHMM_OPS * cells, PEAK_F32)


def k1_cells(rlen, hlen, hidx, ridx, Lr, Lh):
    """Real cells of a K1 launch: sum over its pairs of rlen x hlen."""
    rl = rlen.reshape(-1, 128)[ridx.long()].clamp(0, Lr).long()
    hl = hlen.reshape(-1, 8)[hidx.long()].clamp(0, Lh).long()
    return int((hl[:, :, None] * rl[:, None, :]).sum())


def time_ms(fn, runs=RUNS, hold=True):
    """Median of ``runs`` CUDA-event timings (after one warm-up call when
    runs > 1); returns (median ms, output of the first call). With ``hold``
    the stream first spins for HOLD_CYCLES, so the host has queued the start
    event, ``fn``'s launches and the end event before the card reaches them:
    the time is the card's alone, not the host's enqueue (which a launch of
    tens of microseconds would otherwise mostly measure)."""
    import torch
    out = fn() if runs > 1 else None
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if hold:
            torch.cuda._sleep(HOLD_CYCLES)
        a.record()
        res = fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
        out = res if out is None else out
    times.sort()
    return times[len(times) // 2], out


def compare(got, want):
    """(max rel err on kept pairs, max abs log10 err on kept pairs,
    rescue sets equal, padding exact) of two (G, 8, 128) raw outputs."""
    import numpy as np
    from rovaca_tpu_torch import constants as C
    thr = np.float32(C.MIN_ACCEPTED_F32)
    pad = want == 0
    kept = want >= thr
    same_rescue = np.array_equal(got < thr, want < thr)
    rel = np.abs(got[kept] - want[kept]) / want[kept]
    log_err = np.abs(np.log10(got[kept].astype(np.float64))
                     - np.log10(want[kept].astype(np.float64)))
    return (float(rel.max(initial=0.0)), float(log_err.max(initial=0.0)),
            bool(same_rescue), bool(np.all(got[pad] == 0)))


def phase_kernels(shapes=SHAPES, note=""):
    """K1 against its plain version at ``shapes``, a subset of SHAPES
    (every shape's batch is drawn in SHAPES' order from one seed, so a
    shape's batch is the same whichever subset is run); ``note`` ends each
    shape's line."""
    import numpy as np
    from rovaca_tpu_torch.ops.pairhmm import compact, indexed
    from rovaca_tpu_torch.utils import platform
    dev = platform.device()
    rng = np.random.default_rng(20261016)
    summary = {"max_abs_err": 0.0}
    for Lr, Lh, G in SHAPES:
        arrays, cells = make_batch(rng, Lr, Lh, G)
        if (Lr, Lh, G) not in shapes:
            continue
        t = compact.to_device(arrays, dev)
        k_ms, k_out = time_ms(lambda: indexed.pairhmm_indexed_compact(*t))
        p_runs = 1 if (Lr, Lh, G) in PLAIN_ONCE else RUNS
        p_ms, p_out = time_ms(
            lambda: indexed.pairhmm_indexed_compact_torch(*t), p_runs)
        log_err = _check_forward(k_out, p_out, f"K1 {(Lr, Lh, G)}",
                                 f"[K1] Lr={Lr} Lh={Lh} G={G}{note}", k_ms,
                                 p_ms, p_runs, cells)
        summary["max_abs_err"] = max(summary["max_abs_err"], log_err)
        if (Lr, Lh, G) == TIMED_SHAPE:
            bound_ms, bound_by = pairhmm_bound((*t, k_out), cells)
            summary.update(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms,
                           bound_by=bound_by)
            print(f"[K1] timed shape {TIMED_SHAPE}: bound_ms={bound_ms:.4f} "
                  f"({bound_by}; {PAIRHMM_OPS} float ops x {cells} cells at "
                  f"{PEAK_F32:.3g}/s) share={bound_ms / k_ms:.3f}",
                  flush=True)
    return summary


def _hold(k_out, p_out, where, label=None, timing=""):
    """Hold a PairHMM kernel's raw output to its plain version's: finite,
    rtol RTOL on pairs at or above MIN_ACCEPTED_F32, the same set below it,
    exact zeros on padding. Prints one line when given a label; returns the
    largest log10 error on kept pairs."""
    import numpy as np
    got, want = k_out.cpu().numpy(), p_out.cpu().numpy()
    check(np.all(np.isfinite(got)), f"non-finite kernel output at {where}")
    rel, log_err, same_rescue, pad_ok = compare(got, want)
    if label:
        n_resc = int(((want < 1e-28) & (want > 0)).sum())
        print(f"{label}: max_rel={rel:.3e} max_abs_log10={log_err:.3e} "
              f"rescue_set_equal={same_rescue} ({n_resc} below 1e-28) "
              f"padding_zero={pad_ok}{timing}", flush=True)
    check(rel <= RTOL, f"kernel vs plain max rel {rel} > {RTOL} at {where}")
    check(same_rescue, f"rescue sets differ at {where}")
    check(pad_ok, f"padding not exactly 0 at {where}")
    return log_err


def _check_forward(k_out, p_out, where, label, k_ms, p_ms, p_runs, cells):
    """_hold with the kernel's and the plain version's times on the line."""
    return _hold(k_out, p_out, where, label,
                 f" kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} (plain runs "
                 f"{p_runs}) kernel_gcells_s={cells / k_ms / 1e6:.2f} "
                 f"plain_gcells_s={cells / p_ms / 1e6:.2f}")


def phase_dense(shapes=DENSE_SHAPES):
    """K2 against its plain version on dense tile grids."""
    import numpy as np
    from rovaca_tpu_torch.ops.pairhmm import compact, dense
    from rovaca_tpu_torch.utils import platform
    dev = platform.device()
    rng = np.random.default_rng(20261017)
    summary = {"max_abs_err": 0.0}
    for Lr, Lh in shapes:
        # make_batch gives max(4, G // 16) read and hap tiles
        arrays, _ = make_batch(rng, Lr, Lh, 16 * DENSE_TILES)
        q, gi, gc, rbase, rlen, hcode, hlen = compact.to_device(arrays[:7],
                                                                dev)
        t = (compact.materialize_channels(q, gi, gc).contiguous(),
             rbase.int(), rlen,
             compact.broadcast_haps(hcode).contiguous(), hlen)
        cells = int(rlen.sum()) * int(hlen.sum())
        k_ms, k_out = time_ms(lambda: dense.pairhmm_dense(*t))
        p_ms, p_out = time_ms(lambda: dense.pairhmm_dense_torch(*t))
        log_err = _check_forward(
            k_out, p_out, f"K2 {(Lr, Lh)}",
            f"[K2] Lr={Lr} Lh={Lh} GHxGR={DENSE_TILES}x{DENSE_TILES}", k_ms,
            p_ms, RUNS, cells)
        summary["max_abs_err"] = max(summary["max_abs_err"], log_err)
        if (Lr, Lh) == DENSE_TIMED:
            bound_ms, bound_by = pairhmm_bound((*t, k_out), cells)
            summary.update(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms,
                           bound_by=bound_by)
            print(f"[K2] timed shape {DENSE_TIMED}: bound_ms={bound_ms:.4f} "
                  f"({bound_by}; {PAIRHMM_OPS} float ops x {cells} cells at "
                  f"{PEAK_F32:.3g}/s) share={bound_ms / k_ms:.3f}",
                  flush=True)
    return summary


def make_sw_batch(rng, Ln, B):
    """Realignment-like pairs: haps (refs) of length Ln - 127 .. Ln, reads
    (alts) of 60-150 bases (20 fewer than the hap at most) cut from them with ~1% substitutions and a short
    insertion or deletion in a third of them, diagonals from the cut's
    offset. Every 64th pair gets a diagonal far left of the band, which the
    guard must send to the host SW."""
    import numpy as np
    acgt = np.frombuffer(b"ACGT", np.uint8)
    pairs, diags = [], []
    for k in range(B):
        hap = rng.choice(acgt, int(rng.integers(Ln - 127, Ln + 1)))
        rl = int(rng.integers(60, min(151, len(hap) - 20)))
        off = int(rng.integers(0, len(hap) - rl))
        read = hap[off:off + rl].copy()
        sub = rng.random(rl) < 0.01
        read[sub] = rng.choice(acgt, int(sub.sum()))
        cut = int(rng.integers(15, rl - 15))
        if k % 3 == 1:
            read = np.concatenate([read[:cut], read[cut + 1 + k % 2:]])
        elif k % 3 == 2:
            read = np.concatenate([read[:cut], rng.choice(acgt, 1 + k % 2),
                                   read[cut:]])
        pairs.append((hap.tobytes(), read.tobytes()))
        diags.append(-(len(read) + 200) if k % 64 == 63 else off)
    return pairs, diags


def sw_dp_bound(t, outs):
    """bound() of a K3 DP launch on this data, both sides counting the rows
    that need computing: rows 1..n whose band reaches columns 0..m (the
    others are fill, which the traceback never reads). Bytes: the inputs
    read once, those rows of bt and colm, row n's band and edge written once;
    operations: SW_OPS int32 ops for each of those rows' 128 band cells.
    Returns (ms, by, band cells, bytes, and for the record the bound with
    every output byte, fill included, and over the band cells of all rows
    1..n, skipped or not)."""
    import torch
    B, Ln = t[0].shape
    n, m, off = (t[2][:, k].long() for k in range(3))
    n = n.clamp(0, Ln)
    first = torch.clamp(off - 127 + 64, min=1)
    last = torch.minimum(n, m + off + 64)
    rows = int((last - first + 1).clamp(min=0).sum())
    cells = rows * 128
    in_bytes = sum(x.numel() * x.element_size() for x in t)
    n_bytes = in_bytes + rows * (128 * 2 + 4) + B * (128 * 4 + 4)
    all_bytes = in_bytes + sum(x.numel() * x.element_size() for x in outs)
    all_cells = int(n.sum()) * 128
    return (*bound(n_bytes, SW_OPS * cells, PEAK_I32), cells, n_bytes,
            bound(all_bytes, SW_OPS * cells, PEAK_I32)[0],
            bound(all_bytes, SW_OPS * all_cells, PEAK_I32)[0])


def sw_tb_bound(meta, decoded):
    """bound() of a K3 traceback launch on this data: each alignment reads
    meta, edge, row n's band and colm's rows 1..n, and every traced one the
    bt cell of each walk step (an M base, or a whole I or D run) and writes
    its header and elements; TB_STEP_OPS int32 ops a step. Returns (ms, by,
    walk steps)."""
    from rovaca_tpu_torch.reads.cigar import CigarOp
    n = [int(x) for x in meta[:, 0].cpu()]
    n_bytes = sum(4 * k + 4 * (3 + 1 + 128) for k in n)
    ops = sum(2 * k + 4 * 128 for k in n)
    steps = 0
    for d in decoded:
        if d is None:
            n_bytes += 4 * 3
            continue
        walk = sum(length if op == CigarOp.M else 1 for op, length in d[1]
                   if op != CigarOp.S)
        steps += walk
        n_bytes += 2 * walk + 4 * (3 + len(d[1]))
        ops += TB_STEP_OPS * walk
    return (*bound(n_bytes, ops, PEAK_I32), steps)


def hold_traceback(got, want, where):
    """The traceback kernel's slots against the plain version's: headers
    equal and the decoded elements equal, slot for slot."""
    from rovaca_tpu_torch.ops.sw import banded
    import numpy as np
    got, want = got.cpu().numpy(), want.cpu().numpy()
    check(got.shape == want.shape, f"K3 traceback slots {got.shape}, plain "
          f"{want.shape} at {where}")
    H = banded.HEADER
    err = int(np.abs(got[:, :H] - want[:, :H]).max(initial=0))
    for g, w in zip(got, want):
        if err == 0 and w[0] == 1:
            err = int(np.abs(g[H:H + w[2]] - w[H:H + w[2]]).max(initial=0))
    decoded = banded.unpack_slots(got)
    check(err == 0 and decoded == banded.unpack_slots(want),
          f"K3 traceback slots differ from the plain version's at {where}")
    return decoded, err


def phase_sw(shapes=SW_SHAPES):
    """K3 (DP and traceback) against its plain versions, and its cigars
    against the host SW."""
    import numpy as np
    import torch
    from rovaca_tpu_torch.assembly.sw import (READ_TO_HAPLOTYPE_PARAMS,
                                              OverhangStrategy,
                                              _sw_align_python)
    from rovaca_tpu_torch.native import sw_native
    from rovaca_tpu_torch.ops.sw import banded
    from rovaca_tpu_torch.reads.cigar import Cigar
    from rovaca_tpu_torch.utils import platform
    dev = platform.device()
    P = READ_TO_HAPLOTYPE_PARAMS
    params = (P.match, P.mismatch, P.gap_open, P.gap_extend)
    soft = OverhangStrategy.SOFTCLIP
    check(sw_native.available(), "native SW unavailable (g++ build failed?)")
    rng = np.random.default_rng(20261018)
    summary = {"max_abs_err": 0, "tb_err": 0}
    for Ln, B in shapes:
        pairs, diags = make_sw_batch(rng, Ln, B)
        refs, alts = [r for r, _ in pairs], [a for _, a in pairs]
        *arrays, C = banded.pack_batch(refs, alts, diags)
        check(arrays[0].shape == (B, Ln), f"K3 packing gave "
              f"{arrays[0].shape} for {(Ln, B)}")
        t = [torch.from_numpy(a).to(dev) for a in arrays]
        k_ms, k_out = time_ms(lambda: banded.banded_sw(*t, params=params,
                                                       C=C))
        p_runs = 1 if B > 64 else RUNS
        p_ms, p_out = time_ms(lambda: banded.banded_sw_torch(
            *t, params=params, C=C, indel_init=False), p_runs)
        equal = [bool(torch.equal(k, p)) for k, p in zip(k_out, p_out)]
        err = max(int((k.long() - p.long()).abs().max())
                  for k, p in zip(k_out, p_out))
        # the traceback kernel on the DP's outputs, against its plain version
        S = banded.slot_width(refs, alts)
        tb_ms, tb_out = time_ms(lambda: banded.sw_traceback(
            *k_out, t[2], overhang=soft, S=S))
        tbp_ms, tb_plain = time_ms(lambda: banded.sw_traceback_torch(
            *k_out, t[2], overhang=soft, S=S), 1)
        decoded, tb_err = hold_traceback(tb_out, tb_plain, (Ln, B))
        summary["tb_err"] = max(summary["tb_err"], tb_err)
        # the slots' copy to pinned host memory, and for the record the
        # whole backtrack band's, which the slots replaced
        slots_host = torch.empty(tb_out.shape, dtype=tb_out.dtype,
                                 pin_memory=True)
        res_ms, _ = time_ms(lambda: slots_host.copy_(tb_out,
                                                     non_blocking=True))
        res_bytes = tb_out.numel() * tb_out.element_size()
        bt = k_out[0]
        host = torch.empty(bt.shape, dtype=bt.dtype, pin_memory=True)
        copy_ms, _ = time_ms(lambda: host.copy_(bt, non_blocking=True))
        bt_bytes = bt.numel() * bt.element_size()

        res = banded.sw_align_banded_batch(
            pairs, P, overhang=soft, diagonals=diags, device=dev)
        native = sw_native.align_batch(pairs, P, int(soft))
        bad = [k for k, (r, nat) in enumerate(zip(res, native))
               if nat is None or (str(r.result.cigar), r.result.alignment_offset)
               != (str(Cigar(zip(nat[0], nat[1]))), nat[2])]
        for k in range(SW_ORACLE):
            want = _sw_align_python(*pairs[k], P, soft)
            if (str(res[k].result.cigar), res[k].result.alignment_offset) != (
                    str(want.cigar), want.alignment_offset):
                bad.append(k)
        fallbacks = sum(r.fell_back for r in res)
        forced = sum(d < 0 for d in diags)
        print(f"[K3] Ln={Ln} B={B}: outputs_bit_equal={all(equal)} "
              f"(bt, colm, lastrow, edge: {equal}) max_abs_err={err} "
              f"traceback_slots_equal=True cigars_equal_host_sw={not bad} "
              f"fallbacks={fallbacks} (forced {forced}) dp_ms={k_ms:.4f} "
              f"plain_ms={p_ms:.4f} (plain "
              f"runs {p_runs}) traceback_ms={tb_ms:.4f} traceback_plain_ms="
              f"{tbp_ms:.4f} result_copy_ms={res_ms:.4f} result_bytes="
              f"{res_bytes} (S={S}) band_copy_ms={copy_ms:.4f} band_bytes="
              f"{bt_bytes} ({bt_bytes / res_bytes:.1f}x the slots)",
              flush=True)
        check(all(equal) and err == 0, f"K3 outputs differ from the plain "
              f"version's at {(Ln, B)}: {equal}")
        summary["max_abs_err"] = max(summary["max_abs_err"], err)
        check(not bad, f"K3 cigars differ from the host SW's at {(Ln, B)} "
              f"for pairs {bad[:10]}")
        check(fallbacks >= forced, f"{forced} off-band pairs but "
              f"{fallbacks} fallbacks at {(Ln, B)}")
        if (Ln, B) == SW_TIMED:
            bound_ms, bound_by, cells, n_bytes, fill_ms, all_ms = sw_dp_bound(
                t, k_out)
            tb_bound_ms, tb_by, steps = sw_tb_bound(t[2], decoded)
            # unheld, the host's enqueue included, as earlier versions timed
            enq_ms, _ = time_ms(lambda: banded.banded_sw(*t, params=params,
                                                         C=C), hold=False)
            summary.update(ms=k_ms, plain_ms=p_ms, copy_ms=copy_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           tb_ms=tb_ms, tb_plain_ms=tbp_ms,
                           tb_bound_ms=tb_bound_ms, tb_bound_by=tb_by,
                           res_ms=res_ms, res_bytes=res_bytes,
                           bt_bytes=bt_bytes, enq_ms=enq_ms)
            print(f"[K3] timed shape {SW_TIMED}: bound_ms={bound_ms:.4f} "
                  f"({bound_by}; {n_bytes} bytes at {PEAK_BYTES:.3g}/s, "
                  f"{SW_OPS} int32 ops x {cells} cells at {PEAK_I32:.3g}/s) "
                  f"share={bound_ms / k_ms:.3f}; with every output byte, "
                  f"fill included, bound_ms={fill_ms:.4f} share="
                  f"{fill_ms / k_ms:.3f}; over all rows 1..n, skipped or not, "
                  f"bound_ms={all_ms:.4f} share={all_ms / k_ms:.3f}; dp_ms "
                  f"with the host's enqueue (unheld stream)={enq_ms:.4f} "
                  f"share={all_ms / enq_ms:.3f}; traceback bound_ms="
                  f"{tb_bound_ms:.5f} ({tb_by}; {steps} walk steps) share="
                  f"{tb_bound_ms / tb_ms:.3f}", flush=True)
    return summary


def _records(path):
    with open(path) as f:
        return [line for line in f if not line.startswith("#")]


def reset_counts():
    """Set every kernel's launch counter to 0."""
    from rovaca_tpu_torch.ops.pairhmm import dense, indexed
    from rovaca_tpu_torch.ops.sw import banded
    indexed.LAUNCHES = dense.LAUNCHES = banded.LAUNCHES = 0
    banded.TB_LAUNCHES = 0


def read_counts():
    from rovaca_tpu_torch.ops.pairhmm import dense, indexed
    from rovaca_tpu_torch.ops.sw import banded
    return {"pairhmm_indexed": indexed.LAUNCHES,
            "pairhmm_dense": dense.LAUNCHES, "sw_banded": banded.LAUNCHES,
            "sw_traceback": banded.TB_LAUNCHES}


def _hc(bam, ref, out, engine, stats, *extra):
    from rovaca_tpu_torch import cli
    return cli.main(["HaplotypeCaller", "-i", bam, "-r", ref, "-o", out,
                     "--pairhmm-engine", engine, "--log-level", "WARNING",
                     *extra], stats=stats)


def _print_run(tag, engine, stats):
    share = stats["device_ms"] / 1e3 / stats["wall_s"]
    print(f"[{tag}] engine={engine} wall_s={stats['wall_s']:.3f} "
          f"reads={stats['reads']} regions={stats['regions']} "
          f"records={stats['calls']} launches={stats['launches']} "
          f"card_s={stats['device_ms'] / 1e3:.3f} card_share={share:.4f} "
          f"sw_launches={stats['sw_launches']} "
          f"sw_fallbacks={stats['sw_fallbacks']}", flush=True)


def start_corpus(workdir):
    """Start generating the 1 Mb corpus into ``workdir`` in a child process
    (``golden_e2e gen``): (the process, its start time)."""
    from rovaca_tpu_torch.tools import golden_flows
    c = golden_flows.CORPUS_1MB
    cmd = [sys.executable, "-m", "rovaca_tpu_torch.tools.golden_e2e", "gen",
           workdir, str(c["genome_len"]), str(c["coverage"]), str(c["seed"])]
    with open(os.path.join(workdir, "corpus_gen.log"), "w") as log:
        return (subprocess.Popen(cmd, env=_cli_env(), stdout=log,
                                 stderr=subprocess.STDOUT),
                time.perf_counter())


def phase_corpus(workdir, gen):
    """Wait for start_corpus's child ``gen`` and check the corpus's hashes
    against the manifest's."""
    from rovaca_tpu_torch.tools import golden_flows
    proc, started = gen
    t0 = time.perf_counter()
    proc.wait(timeout=900)
    with open(os.path.join(workdir, "corpus_gen.log")) as log:
        check(proc.returncode == 0, f"corpus generation exited "
              f"{proc.returncode}: {log.read()[-2000:]}")
    print(f"[e2e] corpus {golden_flows.CORPUS_1MB} generated in a child "
          f"process in {time.perf_counter() - started:.1f}s; waited "
          f"{time.perf_counter() - t0:.1f}s for it here", flush=True)
    stale = golden_flows.corpus_1mb_problems(workdir)
    check(not stale, f"the generated corpus is not the one the committed "
          f"rovaca_tpu references were made from: {stale}")
    print("[e2e] corpus hashes (ref.fa, BAM payload) equal the manifest's",
          flush=True)


def phase_main_path(workdir):
    """The default VCF run on the cuda engine (K1), then the native engine's
    on the same inputs, which the later paths are held to as well."""
    import torch
    from rovaca_tpu_torch.pipeline import scheduler
    from rovaca_tpu_torch.tools import golden_e2e, golden_flows

    # warm-up on a small corpus: the host's native libraries build at
    # first use, and no timed run should pay for that
    warm = os.path.join(workdir, "warmup")
    golden_e2e.generate(warm, genome_len=20_000, coverage=30, seed=7)
    check(_hc(os.path.join(warm, "sample.bam"), os.path.join(warm, "ref.fa"),
              os.path.join(warm, "out.vcf"), "cuda", {}) == 0,
          "warm-up run failed")

    bam = os.path.join(workdir, "sample.bam")
    ref = os.path.join(workdir, "ref.fa")
    runs = {}
    # the K1 launches' inputs, kept to print their shapes after the run
    launched = []
    kernel = scheduler.pairhmm_indexed_compact

    def recording(*t):
        launched.append(t)
        return kernel(*t)

    for engine, out in (("cuda", "ours.vcf"), ("native", "ref.vcf")):
        stats = {}
        torch.cuda.synchronize()
        reset_counts()
        scheduler.pairhmm_indexed_compact = recording
        try:
            rc = _hc(bam, ref, os.path.join(workdir, out), engine, stats)
            torch.cuda.synchronize()
        finally:
            scheduler.pairhmm_indexed_compact = kernel
        counts = read_counts()
        check(rc == 0, f"{engine} run exited {rc}")
        runs[engine] = (stats, counts)
        _print_run("e2e", engine, stats)
    cu, launches = runs["cuda"][0], runs["cuda"][1]["pairhmm_indexed"]
    check(launches > 0, "main path made no kernel launch")
    check(launches == cu["launches"], f"kernel counted {launches} launches, "
          f"the scheduler {cu['launches']}")
    check(runs["native"][1]["pairhmm_indexed"] == 0, "native run launched K1")
    check(cu["regions"] > 0 and cu["calls"] > 0, "no regions or records")
    check(cu["sw_launches"] == 0, "the default path ran the banded SW")
    check(len(launched) == launches, f"{len(launched)} launches recorded")
    total = 0.0
    for k, t in enumerate(launched):
        q, rlen, hcode, hlen, hidx, ridx = t[0], t[4], t[5], t[6], t[7], t[8]
        G, Lr, Lh = hidx.shape[0], q.shape[1], hcode.shape[1]
        cells = k1_cells(rlen, hlen, hidx, ridx, Lr, Lh)
        out = torch.empty((G, 8, 128), dtype=torch.float32)
        bound_ms, bound_by = pairhmm_bound((*t, out), cells)
        total += bound_ms
        print(f"[e2e] K1 launch {k}: G={G} Lr={Lr} Lh={Lh} cells={cells} "
              f"bound_ms={bound_ms:.4f} ({bound_by})", flush=True)
    print(f"[e2e] K1 launches' bound summed: {total:.4f} ms against "
          f"{cu['device_ms']:.4f} ms of card time (uploads and copies "
          f"included)", flush=True)
    a = _records(os.path.join(workdir, "ours.vcf"))
    b = _records(os.path.join(workdir, "ref.vcf"))
    identical = sum(x == y for x, y in zip(a, b))
    print(f"[e2e] records cuda={len(a)} native={len(b)} byte-identical="
          f"{identical}", flush=True)
    rc = golden_e2e.diff(workdir)   # ours = cuda, ref = native
    check(rc == 0, "cuda VCF diverges from the native engine's")
    for engine, out in (("cuda", "ours.vcf"), ("native", "ref.vcf")):
        print(f"[e2e] {engine} VCF against rovaca_tpu's committed "
              f"{REF_1MB_VCF}:", flush=True)
        rc = golden_flows.diff_against(
            os.path.join(workdir, out), REF_1MB_VCF,
            os.path.join(workdir, f"rovaca_{engine}"), gvcf=False)
        check(rc == 0, f"the {engine} VCF diverges from rovaca_tpu's")
    check_imports()
    return {"launches": launches, "wall_s": cu["wall_s"],
            "native_wall_s": runs["native"][0]["wall_s"]}


def _band_rows(path):
    with open(path) as f:
        return sum(line.split("\t", 5)[4] == "<NON_REF>" for line in f
                   if not line.startswith("#"))


def phase_gvcf_path(workdir):
    """The 1 Mb corpus with ``-e GVCF`` on the cuda engine, held to
    rovaca_tpu's committed GVCF, band rows included."""
    import torch
    from rovaca_tpu_torch.tools import golden_flows
    out = os.path.join(workdir, "gvcf", "ours.g.vcf")
    os.makedirs(os.path.dirname(out))
    stats = {}
    torch.cuda.synchronize()
    reset_counts()
    rc = _hc(os.path.join(workdir, "sample.bam"),
             os.path.join(workdir, "ref.fa"), out, "cuda", stats,
             "-e", "GVCF")
    torch.cuda.synchronize()
    counts = read_counts()
    check(rc == 0, f"GVCF run exited {rc}")
    _print_run("gvcf", "cuda", stats)
    rows, bands = len(_records(out)), _band_rows(out)
    print(f"[gvcf] rows={rows} band_rows={bands} K1 launches="
          f"{counts['pairhmm_indexed']}; against rovaca_tpu's committed "
          f"{REF_1MB_GVCF}:", flush=True)
    check(counts["pairhmm_indexed"] == stats["launches"] > 0,
          f"K1 counted {counts['pairhmm_indexed']} launches, the scheduler "
          f"{stats['launches']}")
    check(counts["sw_banded"] == 0, "the GVCF path ran the banded SW")
    rc = golden_flows.diff_against(out, REF_1MB_GVCF,
                                   os.path.dirname(out), gvcf=True)
    check(rc == 0, "the cuda GVCF diverges from rovaca_tpu's")
    check_imports()
    return {"launches": stats["launches"], "wall_s": stats["wall_s"]}


def phase_flows(workdir):
    """Every flow of tools.golden_flows on the committed 50 kb corpus, cuda
    engine, in this process, held to rovaca_tpu's committed output; the
    index tools held to the committed .bai and .tbi byte for byte."""
    import torch
    from rovaca_tpu_torch import cli
    from rovaca_tpu_torch.tools import golden_flows
    bad = golden_flows.manifest_problems()
    check(not bad, f"committed files differ from MANIFEST.json: {bad}")
    golden = golden_flows.GOLDEN_DIR
    workdir = os.path.join(workdir, "flows")
    os.makedirs(workdir)
    for tool, src, committed in (
            ("BuildBamIndex", "sample.bam", "sample.bam.bai"),
            ("IndexFeatureFile", "dbsnp.vcf.gz", "dbsnp.vcf.gz.tbi")):
        out = os.path.join(workdir, committed)
        check(cli.main([tool, "-i", os.path.join(golden, src), "-o", out])
              == 0, f"{tool} failed")
        with open(out, "rb") as a, open(os.path.join(golden, committed),
                                        "rb") as b:
            check(a.read() == b.read(), f"{tool}'s {committed} differs from "
                  "the committed one")
        print(f"[flows] {tool}: {committed} byte-identical to the "
              "committed one", flush=True)
    totals = dict.fromkeys(("pairhmm_indexed", "sw_banded", "sw_traceback"),
                           0)
    for name, flow in golden_flows.FLOWS.items():
        runs = []

        def run(argv):
            stats = {}
            runs.append(stats)
            return cli.main(argv, stats=stats)

        torch.cuda.synchronize()
        reset_counts()
        try:
            result = golden_flows.run_flow(run, name,
                                           os.path.join(workdir, name),
                                           "cuda")
        except RuntimeError as exc:
            raise PhaseError(str(exc)) from exc
        torch.cuda.synchronize()
        counts = read_counts()
        k1 = [s["launches"] for s in runs]
        sw = sum(s["sw_launches"] for s in runs)
        print(f"[flows] {name}: runs={len(runs)} wall_s="
              f"{sum(s['wall_s'] for s in runs):.3f} records="
              f"{len(_records(result['output']))} K1 launches={k1} "
              f"(counted {counts['pairhmm_indexed']}) K3 DP/traceback="
              f"{counts['sw_banded']}/{counts['sw_traceback']} sw_launches="
              f"{sw} sw_fallbacks={sum(s['sw_fallbacks'] for s in runs)}",
              flush=True)
        check(all(k > 0 for k in k1) and sum(k1) == counts["pairhmm_indexed"],
              f"flow {name}: K1 launches {k1}, counted "
              f"{counts['pairhmm_indexed']}")
        banded = dict(flow.env).get("ROVACA_BANDED_REALIGN") == "1"
        check(counts["sw_banded"] == counts["sw_traceback"] == sw
              and (sw > 0) == banded,
              f"flow {name}: K3 counted {counts['sw_banded']} DP and "
              f"{counts['sw_traceback']} traceback launches, the caller {sw}")
        check(golden_flows.diff_flow(name, result["output"],
                                     os.path.join(workdir, name, "diff"))
              == 0, f"flow {name} diverges from rovaca_tpu's output")
        problems = golden_flows.effect_problems(name, result)
        check(not problems, f"flow {name}: {problems}")
        for key in totals:
            totals[key] += counts[key]
    check_imports()
    return totals


def phase_realign_path(workdir, default_wall_s):
    """The same corpus with ROVACA_BANDED_REALIGN=1 on the cuda engine: the
    realignment runs K3 (DP, then traceback) on the card."""
    import torch
    from rovaca_tpu_torch.assembly.sw import OverhangStrategy
    from rovaca_tpu_torch.ops.sw import banded
    from rovaca_tpu_torch.tools import golden_e2e
    out_dir = os.path.join(workdir, "banded")
    os.makedirs(out_dir)
    shutil.copy(os.path.join(workdir, "ref.vcf"), out_dir)   # native run's
    stats = {}
    # the DP launches' inputs, kept to print and replay them after the run
    launched = []
    kernel = banded.banded_sw

    def recording(refs, alts, meta, *, params, C, **kw):
        launched.append((refs, alts, meta, C, params))
        return kernel(refs, alts, meta, params=params, C=C, **kw)

    os.environ["ROVACA_BANDED_REALIGN"] = "1"
    try:
        torch.cuda.synchronize()
        reset_counts()
        banded.banded_sw = recording
        rc = _hc(os.path.join(workdir, "sample.bam"),
                 os.path.join(workdir, "ref.fa"),
                 os.path.join(out_dir, "ours.vcf"), "cuda", stats)
        torch.cuda.synchronize()
        counts = read_counts()
    finally:
        banded.banded_sw = kernel
        del os.environ["ROVACA_BANDED_REALIGN"]
    check(rc == 0, f"banded realignment run exited {rc}")
    _print_run("realign", "cuda", stats)
    launches, tb_launches = counts["sw_banded"], counts["sw_traceback"]
    print(f"[realign] K3 launches: DP={launches} traceback={tb_launches} "
          f"sw_launches={stats['sw_launches']} sw_fallbacks="
          f"{stats['sw_fallbacks']} wall_s={stats['wall_s']:.3f} "
          f"default_path_wall_s={default_wall_s:.3f}", flush=True)
    check(launches > 0, "the realignment path made no K3 launch")
    check(launches == tb_launches == stats["sw_launches"] == len(launched),
          f"K3 counted {launches} DP and {tb_launches} traceback launches, "
          f"the caller {stats['sw_launches']}, recorded {len(launched)}")
    check(counts["pairhmm_indexed"] == stats["launches"] > 0,
          "the realignment path's K1 launches do not add up")
    rc = golden_e2e.diff(out_dir)   # ours = banded cuda, ref = native
    check(rc == 0, "the banded realignment VCF diverges from the native "
          "engine's")
    check_imports()

    # every launch's shape and bounds (the traceback's from its replayed
    # slots), and its card time: DP + traceback + slot copy, and each alone
    params = launched[0][4]
    soft = OverhangStrategy.SOFTCLIP
    dp_total = tb_total = 0.0
    ms = dict.fromkeys(("k3", "dp", "tb", "copy", "band"), 0.0)
    shapes, steps_total, slot_bytes, band_bytes = [], 0, 0, 0
    for refs, alts, meta, C, _ in launched:
        B, Ln = refs.shape
        S = int((meta[:, 0] + meta[:, 1]).max()) + banded.HEADER
        slots = banded.sw_traceback(*kernel(refs, alts, meta, params=params,
                                            C=C), meta, overhang=soft, S=S)
        host = torch.empty(slots.shape, dtype=slots.dtype, pin_memory=True)

        def k3():
            out = banded.sw_traceback(*kernel(refs, alts, meta,
                                              params=params, C=C),
                                      meta, overhang=soft, S=S)
            host.copy_(out, non_blocking=True)

        k3_ms, _ = time_ms(k3)
        dp_ms, outs = time_ms(lambda: kernel(refs, alts, meta,
                                             params=params, C=C))
        tb_ms, _ = time_ms(lambda: banded.sw_traceback(
            *outs, meta, overhang=soft, S=S))
        c_ms, _ = time_ms(lambda: host.copy_(slots, non_blocking=True))
        # for the record: the band's copy, which the slots replaced
        band = torch.empty(outs[0].shape, dtype=outs[0].dtype,
                           pin_memory=True)
        b_ms, _ = time_ms(lambda: band.copy_(outs[0], non_blocking=True))
        dp_b, _, cells, _, _, _ = sw_dp_bound((refs, alts, meta), outs)
        tb_b, _, steps = sw_tb_bound(
            meta, banded.unpack_slots(slots.cpu().numpy()))
        dp_total += dp_b
        tb_total += tb_b
        for key, v in zip(ms, (k3_ms, dp_ms, tb_ms, c_ms, b_ms)):
            ms[key] += v
        slot_bytes += slots.numel() * slots.element_size()
        band_bytes += outs[0].numel() * outs[0].element_size()
        steps_total += steps
        shapes.append(f"{B}/{Ln}/{alts.shape[1]}/{cells}/"
                      f"{dp_b * 1e3:.3f}/{tb_b * 1e3:.3f}")
    print(f"[realign] K3 launches as B/Ln/A/band cells/DP bound us/"
          f"traceback bound us: {' '.join(shapes)}", flush=True)
    Bs = sorted(x[0].shape[0] for x in launched)
    Lns = sorted(x[0].shape[1] for x in launched)
    print(f"[realign] K3 launch B min/median/max {Bs[0]}/{Bs[len(Bs) // 2]}/"
          f"{Bs[-1]}, Ln min/median/max {Lns[0]}/{Lns[len(Lns) // 2]}/"
          f"{Lns[-1]}; bounds summed: DP {dp_total:.4f} ms + traceback "
          f"{tb_total:.4f} ms ({steps_total} walk steps) against "
          f"{ms['k3']:.4f} ms of K3 card time (the {launches} launches "
          f"replayed, events around DP + traceback + slot copy); alone, "
          f"summed: DP {ms['dp']:.4f} (bound share "
          f"{dp_total / ms['dp']:.4f}), traceback {ms['tb']:.4f}, slot copy "
          f"{ms['copy']:.4f} ({slot_bytes} bytes; the band's copy "
          f"{ms['band']:.4f}, {band_bytes} bytes)", flush=True)
    return {"launches": launches, "tb_launches": tb_launches,
            "fallbacks": stats["sw_fallbacks"], "wall_s": stats["wall_s"],
            "card_ms": ms["k3"], "dp_ms": ms["dp"], "tb_ms": ms["tb"],
            "copy_ms": ms["copy"], "slot_bytes": slot_bytes,
            "band_copy_ms": ms["band"], "band_bytes": band_bytes,
            "dp_bound_ms": dp_total, "tb_bound_ms": tb_total}


def region_tasks(workdir, n_min=MIN_REGIONS):
    """The corpus's first active regions, with their reads, found window by
    window as the caller's _call_contig does: [(region, reads)], ref, contig,
    contig lengths."""
    import numpy as np
    from rovaca_tpu_torch import constants as C
    from rovaca_tpu_torch.io.bamcols import BamColumns
    from rovaca_tpu_torch.pipeline import activity
    from rovaca_tpu_torch.pipeline.caller import (WINDOW_MARGIN, WINDOW_SIZE,
                                                  HaplotypeCaller, HCArgs)
    hc = HaplotypeCaller(HCArgs(
        bam_paths=[os.path.join(workdir, "sample.bam")],
        reference_path=os.path.join(workdir, "ref.fa"),
        output_path=os.path.join(workdir, "unused.vcf"),
        pairhmm_engine="native"))
    contig, reads = next(hc._read_stream(hc._open_reader(None), None))
    ref = hc.fasta.fetch(contig)
    cols = isinstance(reads, BamColumns)
    if cols:
        pos, end = reads.pos, reads.end
    else:
        pos = np.array([r.pos for r in reads])
        end = np.array([r.end for r in reads])

    def overlapping(p, e, start, stop):
        return np.nonzero((p < stop) & (e > start))[0]

    tasks = []
    for win_start in range(0, len(ref), WINDOW_SIZE):
        win_end = min(len(ref), win_start + WINDOW_SIZE + WINDOW_MARGIN)
        win_sel = overlapping(pos, end, win_start, win_end)
        if win_sel.size == 0:
            continue
        items = (reads.select(win_sel) if cols
                 else [reads[i] for i in win_sel])
        win_pos, win_end_arr = pos[win_sel], end[win_sel]
        for region in activity.find_active_regions(items, ref, contig,
                                                   win_start, win_end):
            if region.start >= win_start + WINDOW_SIZE or \
                    not region.is_active:
                continue
            sel = overlapping(win_pos, win_end_arr,
                              max(0, region.start - C.REGION_PADDING),
                              region.end + 1 + C.REGION_PADDING)
            tasks.append((region, ("cols", items, sel) if cols
                          else [items[i] for i in sel]))
        if len(tasks) >= n_min:
            break
    return tasks, ref, contig, hc.fasta.contig_dict


def _calls(calls):
    out = []
    for c in calls:
        g = c.genotypes[0]
        out.append(((c.start, tuple(a.bases for a in c.alleles),
                     tuple(sorted(a.bases for a in g.alleles)), g.gq),
                    tuple(g.pl or ())))
    return out


def phase_region_path(workdir):
    """RegionCaller.call_region (compute_likelihoods -> pairhmm_raw -> K2)
    on the cuda engine against the native engine."""
    import torch
    from rovaca_tpu_torch.pipeline.hc_engine import CallerConfig, RegionCaller
    from rovaca_tpu_torch.tools import golden_e2e
    tasks, ref, contig, lengths = region_tasks(workdir)
    check(len(tasks) >= MIN_REGIONS, f"only {len(tasks)} active regions")
    results = {}
    for engine in ("cuda", "native"):
        caller = RegionCaller(CallerConfig(pairhmm_engine=engine), lengths)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        results[engine] = [_calls(caller.call_region(region, rr, ref, contig))
                           for region, rr in tasks]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_counts()
        print(f"[region] engine={engine} regions={len(tasks)} calls="
              f"{sum(map(len, results[engine]))} wall_s={dt:.3f} "
              f"K2 launches={counts['pairhmm_dense']}", flush=True)
        if engine == "cuda":
            launches = counts["pairhmm_dense"]
    check(launches > 0, "the region path made no K2 launch")
    diffs = 0
    for got, want in zip(results["cuda"], results["native"]):
        same = [g[0] for g in got] == [w[0] for w in want] and all(
            len(g[1]) == len(w[1]) and all(
                abs(a - b) <= golden_e2e.PL_TOL for a, b in zip(g[1], w[1]))
            for g, w in zip(got, want))
        diffs += not same
    n_calls = sum(map(len, results["cuda"]))
    print(f"[region] regions differing cuda vs native: {diffs} of "
          f"{len(tasks)} ({n_calls} calls)", flush=True)
    check(n_calls > 0, "the region path made no call")
    check(diffs == 0, f"{diffs} regions' calls differ between cuda and "
          "native")
    return {"launches": launches}


class _Read:
    def __init__(self, bases, quals, mapping_quality):
        self.bases = bases
        self.quals = quals
        self.mapping_quality = mapping_quality


def make_jobs(rng, n_jobs):
    """Scheduler jobs shaped like the main path's regions: noisy fragments
    of a random reference (1-260 reads of 30-150 bases) against 2-17
    mutated, ragged haplotypes of 150-400 bases."""
    import numpy as np
    acgt = np.frombuffer(b"ACGT", np.uint8)
    jobs = []
    for key in range(n_jobs):
        L = int(rng.integers(150, 400))
        ref = rng.choice(acgt, L)
        haps = []
        for _ in range(int(rng.integers(2, 18))):
            h = ref.copy()
            snp = rng.random(L) < 0.01
            h[snp] = rng.choice(acgt, int(snp.sum()))
            haps.append(h[:int(rng.integers(L // 2, L + 1))].tobytes())
        reads = []
        for _ in range(int(rng.integers(1, 261))):
            rl = int(rng.integers(30, 151))
            s = int(rng.integers(0, L - 30))
            frag = ref[s:s + rl].copy()
            err = rng.random(len(frag)) < 0.01
            frag[err] = rng.choice(acgt, int(err.sum()))
            reads.append(_Read(frag.tobytes(),
                               rng.integers(5, 41, len(frag)).astype(np.uint8),
                               int(rng.integers(20, 61))))
        jobs.append((key, reads, haps))
    return jobs


def phase_device_list():
    """The launches spread over a device list: every visible card named
    twice. The scheduler against a one-card scheduler (array-equal), the
    sharded K1 and K2 steps at S = 4 against their plain versions, and the
    multi-device dryrun through the card. Returns the path's launches."""
    import numpy as np
    import torch
    from rovaca_tpu_torch.ops.pairhmm import compact, dense, indexed
    from rovaca_tpu_torch.parallel.pipeline_shard import (
        pipeline_dryrun, sharded_pipeline_step)
    from rovaca_tpu_torch.parallel.sharding import sharded_pairhmm_step
    from rovaca_tpu_torch.pipeline.scheduler import PairHMMScheduler
    from rovaca_tpu_torch.utils import platform
    devices = platform.devices() * 2
    rng = np.random.default_rng(20261019)
    jobs = make_jobs(rng, 120)
    k1 = make_batch(rng, *TIMED_SHAPE)[0]
    k1_shards = [np.stack(parts) for parts in
                 zip(k1, *(make_batch(rng, *TIMED_SHAPE)[0]
                           for _ in range(SHARDS - 1)))]
    k2_shards = []
    for _ in range(SHARDS):
        arrays = compact.to_device(make_batch(rng, *DENSE_TIMED,
                                              16 * DENSE_TILES)[0][:7],
                                   devices[0])
        q, gi, gc, rbase, rlen, hcode, hlen = arrays
        k2_shards.append((compact.materialize_channels(q, gi, gc), rbase.int(),
                          rlen, compact.broadcast_haps(hcode), hlen))
    k2_shards = [torch.stack(parts) for parts in zip(*k2_shards)]

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    results, launches = {}, {}
    for name, devs in (("list", devices), ("one", devices[:1])):
        sched = PairHMMScheduler(engine="cuda", devices=devs)
        for key, reads, haps in jobs:
            sched.submit(key, reads, haps)
        results[name] = sched.run()
        launches[name] = sched.launches
    k1_out = sharded_pipeline_step(devices, *(torch.from_numpy(x)
                                              for x in k1_shards))
    k2_out, k2_best = sharded_pairhmm_step(devices, *k2_shards)
    n_records = pipeline_dryrun(SHARDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    print(f"[devices] {len(devices)} devices {[str(d) for d in devices]}: "
          f"scheduler launches list={launches['list']} one={launches['one']}"
          f", dryrun records={n_records}, K1 launches="
          f"{counts['pairhmm_indexed']} K2 launches={counts['pairhmm_dense']}"
          f" wall_s={wall:.3f}", flush=True)
    check(launches["list"] == launches["one"] > 1,
          f"scheduler launches {launches}")
    check(counts["pairhmm_indexed"] == 2 * launches["one"] + 2 * SHARDS,
          f"K1 counted {counts['pairhmm_indexed']} launches")
    check(counts["pairhmm_dense"] > SHARDS,
          f"K2 counted {counts['pairhmm_dense']} launches")
    for key, _, _ in jobs:
        (lik_l, kept_l), (lik_o, kept_o) = (results["list"][key],
                                            results["one"][key])
        check(np.array_equal(kept_l, kept_o) and np.array_equal(lik_l, lik_o),
              f"device-list scheduler differs from one device at job {key}")

    errs = {"K1": 0.0, "K2": 0.0}
    best = 0.0
    for s in range(SHARDS):
        want = indexed.pairhmm_indexed_compact_torch(
            *compact.to_device([x[s] for x in k1_shards], devices[0]))
        errs["K1"] = max(errs["K1"], _hold(k1_out[s], want,
                                           f"sharded K1 shard {s}"))
        want = dense.pairhmm_dense_torch(*(x[s] for x in k2_shards))
        best = max(best, float(want.max()))
        errs["K2"] = max(errs["K2"], _hold(k2_out[s], want,
                                           f"sharded K2 shard {s}"))
    print(f"[devices] sharded steps at S={SHARDS} against the plain "
          f"versions: K1 max_abs_log10={errs['K1']:.3e} K2 max_abs_log10="
          f"{errs['K2']:.3e} K2 global_best={float(k2_best):.6e} "
          f"(plain {best:.6e})", flush=True)
    check(abs(float(k2_best) - best) <= RTOL * best,
          f"sharded K2 global best {float(k2_best)} vs plain {best}")
    check_imports()
    return {"pairhmm_indexed": counts["pairhmm_indexed"],
            "pairhmm_dense": counts["pairhmm_dense"], "sw_banded":
            counts["sw_banded"], "sw_traceback": counts["sw_traceback"],
            "wall_s": wall}


_SUMMARY = re.compile(r"\[rovaca_tpu_torch\] (\d+) reads, (\d+) regions, "
                      r"(\d+) records in ([\d.]+)s \((\d+) launches")


def _summaries(stderr):
    """(reads, regions, records, wall_s, K1 launches) of every HaplotypeCaller
    summary line a CLI process and the processes it started printed."""
    return [(int(a), int(b), int(c), float(d), int(e))
            for a, b, c, d, e in _SUMMARY.findall(stderr)]


def _cli_env():
    """This environment with the checkout importable by child processes."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    return env


def _cli_cmd(workdir, out, *extra):
    return [sys.executable, "-m", "rovaca_tpu_torch.cli", "HaplotypeCaller",
            "-i", os.path.join(workdir, "sample.bam"),
            "-r", os.path.join(workdir, "ref.fa"), "-o", out,
            "--pairhmm-engine", "cuda", "--log-level", "WARNING", *extra]


def _masked_diff(workdir, path, tag):
    """Hold a split run's VCF to phase 5's unsharded cuda VCF by
    tests/test_shard_confinement.py's bar (tools.race_e2e)."""
    from rovaca_tpu_torch.tools import race_e2e
    ok, detail = race_e2e.depth_masked_diff(
        os.path.join(workdir, "ours.vcf"), path,
        bam_path=os.path.join(workdir, "sample.bam"))
    print(f"[{tag}] records={len(_records(path))} against the unsharded "
          f"cuda run ({len(_records(os.path.join(workdir, 'ours.vcf')))}): "
          f"{detail}", flush=True)
    check(ok, f"{tag} VCF diverges beyond the depth mask: {detail}")


def phase_shards(workdir):
    """``--shards 2`` on the corpus, cuda engine: two shard processes on the
    card, their VCFs merged in genome order."""
    out = os.path.join(workdir, "shards.vcf")
    t0 = time.perf_counter()
    res = subprocess.run(_cli_cmd(workdir, out, "--shards", "2"),
                         env=_cli_env(), capture_output=True, text=True,
                         timeout=600)
    wall = time.perf_counter() - t0
    check(res.returncode == 0, f"--shards 2 exited {res.returncode}: "
          f"{res.stderr[-2000:]}")
    shards = _summaries(res.stderr)
    merged = re.findall(r"sharded x2: .*", res.stderr)
    print(f"[shards] wall_s={wall:.3f} ({merged}) shard (reads, regions, "
          f"records, wall_s, K1 launches)={shards}", flush=True)
    check(len(shards) == 2 and all(s[4] > 0 for s in shards),
          f"expected two shards that launch K1: {shards}")
    _masked_diff(workdir, out, "shards")
    return {"wall_s": wall, "launches": sum(s[4] for s in shards)}


def phase_host_workers(workdir):
    """``-t 2`` on the corpus, cuda engine, in this process: two worker
    processes prepare the regions, this one launches K1."""
    import torch
    out = os.path.join(workdir, "t2.vcf")
    stats = {}
    torch.cuda.synchronize()
    reset_counts()
    rc = _hc(os.path.join(workdir, "sample.bam"),
             os.path.join(workdir, "ref.fa"), out, "cuda", stats, "-t", "2")
    torch.cuda.synchronize()
    counts = read_counts()
    check(rc == 0, f"-t 2 run exited {rc}")
    _print_run("workers", "cuda", stats)
    check(counts["pairhmm_indexed"] == stats["launches"] > 0,
          f"K1 counted {counts['pairhmm_indexed']} launches, the scheduler "
          f"{stats['launches']}")
    with open(out, "rb") as a, \
            open(os.path.join(workdir, "ours.vcf"), "rb") as b:
        check(a.read() == b.read(), "-t 2 VCF differs from the -t 1 VCF")
    print("[workers] VCF byte-identical to the -t 1 cuda run", flush=True)
    check_imports()
    return {"wall_s": stats["wall_s"], "launches": stats["launches"]}


def phase_ranks(workdir):
    """Two torch.distributed ranks (gloo, torchrun's environment) on the
    one card, cuda engine; rank 0 merges."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = os.path.join(workdir, "ranks.vcf")
    t0 = time.perf_counter()
    procs = []
    for rank in range(2):
        env = _cli_env()
        env.update(WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(_cli_cmd(workdir, out), env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))

    def finish(p):
        try:
            _, err = p.communicate(timeout=600)
        finally:
            p.kill()
        return p.returncode, err, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        ends = list(pool.map(finish, procs))
    for rank, (rc, err, wall) in enumerate(ends):
        ranks = _summaries(err)
        print(f"[ranks] rank {rank} exit={rc} wall_s={wall:.3f} (reads, "
              f"regions, records, wall_s, K1 launches)={ranks}", flush=True)
        check(rc == 0, f"rank {rank} exited {rc}: {err[-2000:]}")
        check(ranks and all(r[4] > 0 for r in ranks),
              f"rank {rank} made no K1 launch")
    _masked_diff(workdir, out, "ranks")
    check(not [f for f in os.listdir(workdir) if ".rank" in f],
          "rank shard files left behind")
    check_imports()
    print("[ranks] neither jax nor rovaca_tpu was imported by this process",
          flush=True)
    return {"wall_s": [e[2] for e in ends]}


def _print_race(race):
    """One line a contender of a race_e2e.run_race result."""
    for name, c in race["contenders"].items():
        print(f"[measure] race {name}: runs_s="
              f"{[round(x, 3) for x in c['runs_s']]} median_s="
              f"{c['wall_s']:.3f} spread=(max-min)/median="
              f"{c['spread_rel']:.4f} own_s={c['own_s']} own_median_s="
              f"{c['own_median_s']:.3f} cpu_s="
              f"{[round(x, 3) for x in c['cpu_s']]} card_s={c['card_s']} "
              f"card_share={c['card_share']:.6f} K1 launches="
              f"{c['launches']} reads_per_s={c['reads_per_s']:.1f}; "
              f"against {race['held_to']}: {c['diff']}", flush=True)


def _profile(workdir, gvcf, race):
    """host_profile.profile_run of the corpus on the cuda engine, the
    counts set to 0 just before it and read just after."""
    import torch
    from rovaca_tpu_torch.tools import host_profile
    mode = "GVCF" if gvcf else "VCF"
    torch.cuda.synchronize()
    reset_counts()
    res = host_profile.profile_run(
        os.path.join(workdir, "sample.bam"), os.path.join(workdir, "ref.fa"),
        os.path.join(workdir, "race", f"profile_{mode}.vcf"), "cuda", gvcf,
        unprofiled=False)
    torch.cuda.synchronize()
    counts = read_counts()
    for line in host_profile.report_lines(res):
        print(line.replace("[profile]", f"[measure] profile {mode}"),
              flush=True)
    c = race["contenders"]["cuda_gvcf" if gvcf else "cuda"]
    print(f"[measure] profile {mode}: profiled wall {res['wall_s']:.3f}s "
          f"against the race's median own wall {c['own_median_s']:.3f}s "
          f"({res['wall_s'] / c['own_median_s']:.3f}x: the profiler's "
          f"overhead, with one prep thread against two); K1 launches "
          f"counted {counts['pairhmm_indexed']} over its warm-up and "
          f"profiled runs, {res['stats']['launches']} in the profiled one",
          flush=True)
    check(res["stats"]["launches"] > 0
          and counts["pairhmm_indexed"] >= res["stats"]["launches"],
          f"profile {mode}: K1 counted {counts['pairhmm_indexed']}, the "
          f"profiled run {res['stats']['launches']}")
    named = sum(v for k, v in res["rows"].items() if k != "other")
    check(named >= 0.9 * res["profiled_s"], f"profile {mode}: the layers "
          f"take {named:.3f} of {res['profiled_s']:.3f}s")
    return res


def race_rounds(walls):
    """RACE_ROUNDS, or RACE_MIN_ROUNDS when the race at the pace of
    ``walls`` (the in-process walls of the contenders' runs earlier in this
    script) and what follows it would end after RACE_END_BY_S."""
    rnd = sum(walls.values()) + CLI_START_S * len(walls)
    warm = walls[RACE_CONTENDERS[0]] + CLI_START_S
    end = (time.perf_counter() - STARTED + warm
           + (RACE_ROUNDS + REST_ROUNDS) * rnd)
    n = RACE_ROUNDS if end <= RACE_END_BY_S else RACE_MIN_ROUNDS
    print(f"[measure] race rounds: {n} (a round predicted at {rnd:.1f}s; "
          f"{RACE_ROUNDS} would end the script at ~{end:.0f}s of "
          f"{RACE_END_BY_S}s)", flush=True)
    return n


def phase_measure(workdir, walls):
    """(a) race_e2e on the 1 Mb corpus, (b) host_profile of its VCF and
    GVCF runs and a torch.profiler run, (c) kernel_bench, (d)
    accuracy_eval.score_calls of the race's outputs. ``walls``: see
    race_rounds."""
    import torch
    from rovaca_tpu_torch.tools import (accuracy_eval, host_profile,
                                        kernel_bench, race_e2e)
    race = race_e2e.run_race(
        workdir, os.path.join(workdir, "race"), RACE_CONTENDERS,
        race_rounds(walls),
        log=lambda line: print(line.replace("[race]", "[measure] race"),
                               flush=True))
    _print_race(race)
    check(race["held_to"] == "rovaca_tpu's committed output",
          f"the race's outputs were held to {race['held_to']}")
    for name, c in race["contenders"].items():
        check(c["ok"] and c["diff"] == "RESULT: MATCH",
              f"race {name}: {c['diff']}")
        cuda = race_e2e.CONTENDERS[name][0] == "cuda"
        check(all((n > 0) == cuda for n in c["launches"]),
              f"race {name}: K1 launches {c['launches']}")

    profiles = {gvcf: _profile(workdir, gvcf, race) for gvcf in (False,
                                                                  True)}
    torch.cuda.synchronize()
    reset_counts()
    tp = host_profile.torch_profile_run(
        os.path.join(workdir, "sample.bam"), os.path.join(workdir, "ref.fa"),
        os.path.join(workdir, "race", "torch_profile.vcf"), "cuda", False)
    torch.cuda.synchronize()
    counts = read_counts()
    busy = tp["card_busy_s"]
    print(f"[measure] torch.profiler VCF run: wall {tp['wall_s']:.3f}s "
          f"({tp['wall_s'] / race['contenders']['cuda']['own_median_s']:.3f}"
          f"x the race's median own wall), card busy "
          f"{busy if isinstance(busy, str) else f'{busy:.6f}s'}, share "
          f"{tp['card_busy_share']}; K1 launches "
          f"{counts['pairhmm_indexed']} (the run's {tp['stats']['launches']})",
          flush=True)
    for name, k in sorted(tp["kernels"].items(), key=lambda kv: -kv[1]["ms"]):
        print(f"[measure]   {k['ms']:10.4f} ms x{k['count']:<5} {name}",
              flush=True)
    check(counts["pairhmm_indexed"] == tp["stats"]["launches"] > 0,
          f"torch.profiler run: K1 counted {counts['pairhmm_indexed']}, the "
          f"scheduler {tp['stats']['launches']}")

    kb = kernel_bench.run()
    print(json.dumps(kb), flush=True)
    check(kb["value"] > 0 and kb["device"] == torch.cuda.get_device_name(0),
          f"kernel_bench gave {kb['value']} on {kb['device']}")

    scores = {}
    for name in ("cuda", "native"):
        scores[name] = accuracy_eval.score_calls(
            os.path.join(workdir, "race", f"{name}.vcf"),
            os.path.join(workdir, "truth.txt"),
            os.path.join(workdir, "ref.fa"))
        sc = scores[name]
        print(f"[measure] accuracy {name}: recall={sc['recall']:.4f} "
              f"({sc['tp']}/{sc['truth']}) precision={sc['precision']:.4f} "
              f"(FP={sc['fp']}) genotype_concordance="
              f"{sc['genotype_concordance']:.4f}", flush=True)
    check(scores["cuda"]["truth"] == TRUTH_1MB,
          f"{scores['cuda']['truth']} truth variants, not {TRUTH_1MB}")
    check(scores["cuda"] == scores["native"],
          "the cuda VCF scores differently from the native VCF")
    check_imports()
    return {"race": race, "profiles": profiles, "torch_profiler": tp,
            "kernel_bench": kb, "accuracy": scores}


def timed(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[phase] {name} passed in {time.perf_counter() - t0:.1f}s",
          flush=True)
    return out


def main():
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "rovaca_tpu_torch")):
        print("FAIL: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        timed("card", phase_card)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
            gen = start_corpus(workdir)
            try:
                # beside the corpus's generation: nothing that times what
                # the kernels' line or phase 14 reports
                timed("build", phase_build)
                k1_beside = timed(
                    "K1 vs plain, untimed G 1024 shapes", phase_kernels,
                    BESIDE_CORPUS, " (beside the corpus generation: times "
                    "taken on a shared host)")
                device_list = timed("device-list path", phase_device_list)
                flows = timed("flows", phase_flows, workdir)
                timed("corpus", phase_corpus, workdir, gen)
            finally:
                if gen[0].poll() is None:    # a phase before it failed
                    gen[0].kill()
                    gen[0].wait()
            k1 = timed("K1 vs plain", phase_kernels,
                       [s for s in SHAPES if s not in BESIDE_CORPUS])
            k1["max_abs_err"] = max(k1["max_abs_err"],
                                    k1_beside["max_abs_err"])
            k2 = timed("K2 vs plain", phase_dense)
            k3 = timed("K3 vs plain", phase_sw)
            main_path = timed("main path", phase_main_path, workdir)
            realign = timed("realignment path", phase_realign_path, workdir,
                            main_path["wall_s"])
            region = timed("region path", phase_region_path, workdir)
            timed("--shards 2", phase_shards, workdir)
            timed("-t 2", phase_host_workers, workdir)
            timed("two ranks", phase_ranks, workdir)
            gvcf = timed("GVCF path", phase_gvcf_path, workdir)
            timed("measure", phase_measure, workdir, {
                "cuda": main_path["wall_s"],
                "native": main_path["native_wall_s"],
                "cuda_gvcf": gvcf["wall_s"]})
    except PhaseError as exc:
        print(f"FAIL: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [
        {"name": "pairhmm_indexed", "route": "cuda",
         "source": "rovaca_tpu_torch/csrc/pairhmm_indexed.cu",
         "replaces": "rovaca_tpu/ops/pairhmm/indexed.py:74",
         "launches": main_path["launches"],
         "gvcf_launches": gvcf["launches"],
         "flows_launches": flows["pairhmm_indexed"],
         "device_list_launches": device_list["pairhmm_indexed"],
         "max_abs_err": k1["max_abs_err"],
         "err_of": "log10 likelihood of pairs at or above 1e-28",
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": None,
         "shape": dict(zip(("Lr", "Lh", "G"), TIMED_SHAPE))},
        {"name": "pairhmm_dense", "route": "cuda",
         "source": "rovaca_tpu_torch/csrc/pairhmm_dense.cu",
         "replaces": "rovaca_tpu/ops/pairhmm/kernel.py:175",
         "launches": region["launches"],
         "device_list_launches": device_list["pairhmm_dense"],
         "max_abs_err": k2["max_abs_err"],
         "err_of": "log10 likelihood of pairs at or above 1e-28",
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": None,
         "shape": {"Lr": DENSE_TIMED[0], "Lh": DENSE_TIMED[1],
                   "GH": DENSE_TILES, "GR": DENSE_TILES}},
        {"name": "sw_banded", "route": "cuda",
         "source": "rovaca_tpu_torch/csrc/sw_banded.cu",
         "replaces": "rovaca_tpu/ops/sw/banded.py:242",
         "launches": realign["launches"],
         "flows_launches": flows["sw_banded"],
         "device_list_launches": device_list["sw_banded"],
         "max_abs_err": k3["max_abs_err"],
         "err_of": "bt, colm, lastrow and edge (integers, bit-equal)",
         "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
         "library_ms": None, "ms_with_enqueue": k3["enq_ms"],
         "path_ms": realign["dp_ms"], "path_bound_ms": realign["dp_bound_ms"],
         "band_copy_ms": k3["copy_ms"], "band_bytes": k3["bt_bytes"],
         "fallbacks": realign["fallbacks"],
         "path_card_ms": realign["card_ms"],
         "shape": {"Ln": SW_TIMED[0], "B": SW_TIMED[1]}},
        {"name": "sw_traceback", "route": "cuda",
         "source": "rovaca_tpu_torch/csrc/sw_banded.cu",
         "replaces": "rovaca_tpu/ops/sw/banded.py:286",
         "replaces_what": "_traceback_band, host code run on _banded_call's "
                          "outputs (not a Pallas kernel)",
         "launches": realign["tb_launches"],
         "flows_launches": flows["sw_traceback"],
         "device_list_launches": device_list["sw_traceback"],
         "max_abs_err": k3["tb_err"],
         "err_of": "packed slots (integers, equal slot for slot)",
         "ms": k3["tb_ms"], "plain_ms": k3["tb_plain_ms"],
         "bound_ms": k3["tb_bound_ms"], "bound_by": k3["tb_bound_by"],
         "library_ms": None, "result_copy_ms": k3["res_ms"],
         "result_bytes": k3["res_bytes"],
         "path_ms": realign["tb_ms"],
         "path_bound_ms": realign["tb_bound_ms"],
         "path_copy_ms": realign["copy_ms"],
         "path_result_bytes": realign["slot_bytes"],
         "path_band_copy_ms": realign["band_copy_ms"],
         "path_band_bytes": realign["band_bytes"],
         "shape": {"Ln": SW_TIMED[0], "B": SW_TIMED[1]}}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
