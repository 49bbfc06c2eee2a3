#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (rovaca_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper: the kernels are built for sm_90a) and the CUDA
toolkit. Phases, each printing its own lines and its seconds; any failure
exits non-zero:

0. card: name and power limit from nvidia-smi.
1. build: nvcc builds the three kernels from the checkout, one nvcc each, all
   started together; ptxas registers and spills for each.
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
   64/1024: bt, colm, lastrow and edge bit-identical; the traced-back cigars
   and offsets equal to the exact host SW's (the native SW for all, the
   python oracle for the first few); the fallback count, and the time of the
   backtrack band's copy to pinned host memory.
5. main path: a 1 Mb / 30x diploid corpus (scripts/golden_e2e.generate,
   seed 424242) through ``rovaca_tpu_torch.cli HaplotypeCaller`` with
   ``--pairhmm-engine cuda``, then ``native`` on the same inputs. The cuda
   run must launch K1, as often as its scheduler counted, and its VCF must
   match the native run's on (CHROM, POS, REF, ALT, GT) with the other
   fields within golden_e2e's tolerances.
6. realignment path: the same corpus with ROVACA_BANDED_REALIGN=1 and the
   cuda engine. K3 must launch as often as ``stats["sw_launches"]`` counts,
   at least once; its VCF must match the native run's; its fallbacks to the
   host SW are printed.
7. region path: the port's ``RegionCaller.call_region`` (K2) over the first
   200+ active regions of the corpus, engine cuda then native: the same
   (pos, alleles, GT, GQ), PL within golden_e2e's PL_TOL, and K2 launched.

Every kernel's counter is set to 0 just before each of phases 5-7 and read
just after. The line before the last is the kernels' JSON summary; the last
line is ``{"ok": true, "device": {...}}``. Nothing of jax is imported.
"""

import concurrent.futures
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
RTOL = 2e-5           # the bar tests/test_pairhmm.py sets native vs XLA
RUNS = 5
# (Lr, Lh, G): the main path's read and hap length buckets and a small and a
# full launch (scheduler.G_MAX); the plain version's time grows with
# Lr * Lh * G
SHAPES = tuple(itertools.product((128, 256), (256, 512, 1024), (64, 1024)))
TIMED_SHAPE = (128, 256, 1024)   # the shape reported in the JSON summary
# the plain version takes 4-35 s a call at the full launches: one run
PLAIN_ONCE = {s for s in SHAPES if s[2] == 1024}
# K2: (Lr, Lh) at a dense 8 x 8 grid of tiles, as call_region's regions give
DENSE_SHAPES = tuple(itertools.product((128, 256), (256, 512)))
DENSE_TILES = 8
DENSE_TIMED = (128, 256)
# K3: (Ln, B); Ln is the realigned haplotypes' length rounded up to 128
SW_SHAPES = tuple(itertools.product((256, 512, 1024), (64, 1024)))
SW_TIMED = (512, 1024)
SW_ORACLE = 8          # alignments per shape also held to the python SW
CORPUS = dict(genome_len=1_000_000, coverage=30, seed=424242)
KERNELS = ("pairhmm_indexed", "pairhmm_dense", "sw_banded")
MIN_REGIONS = 200


class PhaseError(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


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


def time_ms(fn, runs=RUNS):
    """Median of ``runs`` CUDA-event timings (after one warm-up call when
    runs > 1); returns (median ms, output of the first call)."""
    import torch
    out = fn() if runs > 1 else None
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
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
    from rovaca_tpu import constants as C
    thr = np.float32(C.MIN_ACCEPTED_F32)
    pad = want == 0
    kept = want >= thr
    same_rescue = np.array_equal(got < thr, want < thr)
    rel = np.abs(got[kept] - want[kept]) / want[kept]
    log_err = np.abs(np.log10(got[kept].astype(np.float64))
                     - np.log10(want[kept].astype(np.float64)))
    return (float(rel.max(initial=0.0)), float(log_err.max(initial=0.0)),
            bool(same_rescue), bool(np.all(got[pad] == 0)))


def phase_kernels(shapes=SHAPES):
    """K1 against its plain version."""
    import numpy as np
    from rovaca_tpu_torch.ops.pairhmm import compact, indexed
    from rovaca_tpu_torch.utils import platform
    dev = platform.device()
    rng = np.random.default_rng(20261016)
    summary = {"max_abs_err": 0.0}
    for Lr, Lh, G in shapes:
        arrays, cells = make_batch(rng, Lr, Lh, G)
        t = compact.to_device(arrays, dev)
        k_ms, k_out = time_ms(lambda: indexed.pairhmm_indexed_compact(*t))
        p_runs = 1 if (Lr, Lh, G) in PLAIN_ONCE else RUNS
        p_ms, p_out = time_ms(
            lambda: indexed.pairhmm_indexed_compact_torch(*t), p_runs)
        log_err = _check_forward(k_out, p_out, f"K1 {(Lr, Lh, G)}",
                                 f"[K1] Lr={Lr} Lh={Lh} G={G}", k_ms, p_ms,
                                 p_runs, cells)
        summary["max_abs_err"] = max(summary["max_abs_err"], log_err)
        if (Lr, Lh, G) == TIMED_SHAPE:
            summary.update(ms=k_ms, plain_ms=p_ms)
    return summary


def _check_forward(k_out, p_out, where, label, k_ms, p_ms, p_runs, cells):
    """Hold a PairHMM kernel's raw output to its plain version's; prints one
    line and returns the largest log10 error on kept pairs."""
    import numpy as np
    got, want = k_out.cpu().numpy(), p_out.cpu().numpy()
    check(np.all(np.isfinite(got)), f"non-finite kernel output at {where}")
    rel, log_err, same_rescue, pad_ok = compare(got, want)
    n_resc = int(((want < 1e-28) & (want > 0)).sum())
    print(f"{label}: max_rel={rel:.3e} max_abs_log10={log_err:.3e} "
          f"rescue_set_equal={same_rescue} ({n_resc} below 1e-28) "
          f"padding_zero={pad_ok} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
          f"(plain runs {p_runs}) kernel_gcells_s={cells / k_ms / 1e6:.2f} "
          f"plain_gcells_s={cells / p_ms / 1e6:.2f}", flush=True)
    check(rel <= RTOL, f"kernel vs plain max rel {rel} > {RTOL} at {where}")
    check(same_rescue, f"rescue sets differ at {where}")
    check(pad_ok, f"padding not exactly 0 at {where}")
    return log_err


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
            summary.update(ms=k_ms, plain_ms=p_ms)
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


def phase_sw(shapes=SW_SHAPES):
    """K3 against its plain version, and its traceback against host SW."""
    import numpy as np
    import torch
    from rovaca_tpu.assembly.sw import (READ_TO_HAPLOTYPE_PARAMS,
                                        OverhangStrategy, _sw_align_python)
    from rovaca_tpu.native import sw_native
    from rovaca_tpu.reads.cigar import Cigar
    from rovaca_tpu_torch.ops.sw import banded
    from rovaca_tpu_torch.utils import platform
    dev = platform.device()
    P = READ_TO_HAPLOTYPE_PARAMS
    params = (P.match, P.mismatch, P.gap_open, P.gap_extend)
    check(sw_native.available(), "native SW unavailable (g++ build failed?)")
    rng = np.random.default_rng(20261018)
    summary = {"max_abs_err": 0}
    for Ln, B in shapes:
        pairs, diags = make_sw_batch(rng, Ln, B)
        *arrays, C = banded.pack_batch([r for r, _ in pairs],
                                       [a for _, a in pairs], diags)
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
        # the backtrack band's copy to pinned host memory, alone
        bt = k_out[0]
        host = torch.empty(bt.shape, dtype=bt.dtype, pin_memory=True)
        copy_ms, _ = time_ms(lambda: host.copy_(bt, non_blocking=True))

        res = banded.sw_align_banded_batch(
            pairs, P, overhang=OverhangStrategy.SOFTCLIP, diagonals=diags,
            device=dev)
        native = sw_native.align_batch(pairs, P,
                                       int(OverhangStrategy.SOFTCLIP))
        bad = [k for k, (r, nat) in enumerate(zip(res, native))
               if nat is None or (str(r.result.cigar), r.result.alignment_offset)
               != (str(Cigar(zip(nat[0], nat[1]))), nat[2])]
        for k in range(SW_ORACLE):
            want = _sw_align_python(*pairs[k], P, OverhangStrategy.SOFTCLIP)
            if (str(res[k].result.cigar), res[k].result.alignment_offset) != (
                    str(want.cigar), want.alignment_offset):
                bad.append(k)
        fallbacks = sum(r.fell_back for r in res)
        forced = sum(d < 0 for d in diags)
        print(f"[K3] Ln={Ln} B={B}: outputs_bit_equal={all(equal)} "
              f"(bt, colm, lastrow, edge: {equal}) max_abs_err={err} "
              f"cigars_equal_host_sw="
              f"{not bad} fallbacks={fallbacks} (forced {forced}) "
              f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} (plain runs "
              f"{p_runs}) bt_copy_ms={copy_ms:.4f} "
              f"bt_mb={bt.numel() * 2 / 2**20:.2f}", flush=True)
        check(all(equal) and err == 0, f"K3 outputs differ from the plain "
              f"version's at {(Ln, B)}: {equal}")
        summary["max_abs_err"] = max(summary["max_abs_err"], err)
        check(not bad, f"K3 cigars differ from the host SW's at {(Ln, B)} "
              f"for pairs {bad[:10]}")
        check(fallbacks >= forced, f"{forced} off-band pairs but "
              f"{fallbacks} fallbacks at {(Ln, B)}")
        if (Ln, B) == SW_TIMED:
            summary.update(ms=k_ms, plain_ms=p_ms, copy_ms=copy_ms)
    return summary


def _records(path):
    with open(path) as f:
        return [line for line in f if not line.startswith("#")]


def reset_counts():
    """Set every kernel's launch counter to 0."""
    from rovaca_tpu_torch.ops.pairhmm import dense, indexed
    from rovaca_tpu_torch.ops.sw import banded
    indexed.LAUNCHES = dense.LAUNCHES = banded.LAUNCHES = 0


def read_counts():
    from rovaca_tpu_torch.ops.pairhmm import dense, indexed
    from rovaca_tpu_torch.ops.sw import banded
    return {"pairhmm_indexed": indexed.LAUNCHES,
            "pairhmm_dense": dense.LAUNCHES, "sw_banded": banded.LAUNCHES}


def _hc(bam, ref, out, engine, stats):
    from rovaca_tpu_torch import cli
    return cli.main(["HaplotypeCaller", "-i", bam, "-r", ref, "-o", out,
                     "--pairhmm-engine", engine, "--log-level", "WARNING"],
                    stats=stats)


def _print_run(tag, engine, stats):
    share = stats["device_ms"] / 1e3 / stats["wall_s"]
    print(f"[{tag}] engine={engine} wall_s={stats['wall_s']:.3f} "
          f"reads={stats['reads']} regions={stats['regions']} "
          f"records={stats['calls']} launches={stats['launches']} "
          f"card_s={stats['device_ms'] / 1e3:.3f} card_share={share:.4f} "
          f"sw_launches={stats['sw_launches']} "
          f"sw_fallbacks={stats['sw_fallbacks']}", flush=True)


def phase_main_path(workdir):
    """The default VCF run on the cuda engine (K1), then the native engine's
    on the same inputs, which the later paths are held to as well."""
    import torch
    import golden_e2e

    # warm-up on a small corpus: the host's native libraries build at
    # first use, and no timed run should pay for that
    warm = os.path.join(workdir, "warmup")
    golden_e2e.generate(warm, genome_len=20_000, coverage=30, seed=7)
    check(_hc(os.path.join(warm, "sample.bam"), os.path.join(warm, "ref.fa"),
              os.path.join(warm, "out.vcf"), "cuda", {}) == 0,
          "warm-up run failed")

    t0 = time.perf_counter()
    golden_e2e.generate(workdir, **CORPUS)
    print(f"[e2e] corpus {CORPUS} generated in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    bam = os.path.join(workdir, "sample.bam")
    ref = os.path.join(workdir, "ref.fa")
    runs = {}
    for engine, out in (("cuda", "ours.vcf"), ("native", "ref.vcf")):
        stats = {}
        torch.cuda.synchronize()
        reset_counts()
        rc = _hc(bam, ref, os.path.join(workdir, out), engine, stats)
        torch.cuda.synchronize()
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
    a = _records(os.path.join(workdir, "ours.vcf"))
    b = _records(os.path.join(workdir, "ref.vcf"))
    identical = sum(x == y for x, y in zip(a, b))
    print(f"[e2e] records cuda={len(a)} native={len(b)} byte-identical="
          f"{identical}", flush=True)
    rc = golden_e2e.diff(workdir)   # ours = cuda, ref = native
    check(rc == 0, "cuda VCF diverges from the native engine's")
    check("jax" not in sys.modules, "jax was imported")
    return {"launches": launches, "wall_s": cu["wall_s"]}


def phase_realign_path(workdir, default_wall_s):
    """The same corpus with ROVACA_BANDED_REALIGN=1 on the cuda engine: the
    realignment runs K3 on the card."""
    import torch
    import golden_e2e
    out_dir = os.path.join(workdir, "banded")
    os.makedirs(out_dir)
    shutil.copy(os.path.join(workdir, "ref.vcf"), out_dir)   # native run's
    stats = {}
    os.environ["ROVACA_BANDED_REALIGN"] = "1"
    try:
        torch.cuda.synchronize()
        reset_counts()
        rc = _hc(os.path.join(workdir, "sample.bam"),
                 os.path.join(workdir, "ref.fa"),
                 os.path.join(out_dir, "ours.vcf"), "cuda", stats)
        torch.cuda.synchronize()
        counts = read_counts()
    finally:
        del os.environ["ROVACA_BANDED_REALIGN"]
    check(rc == 0, f"banded realignment run exited {rc}")
    _print_run("realign", "cuda", stats)
    launches = counts["sw_banded"]
    print(f"[realign] K3 launches={launches} sw_launches="
          f"{stats['sw_launches']} sw_fallbacks={stats['sw_fallbacks']} "
          f"wall_s={stats['wall_s']:.3f} default_path_wall_s="
          f"{default_wall_s:.3f}", flush=True)
    check(launches > 0, "the realignment path made no K3 launch")
    check(launches == stats["sw_launches"], f"K3 counted {launches} "
          f"launches, the caller {stats['sw_launches']}")
    check(counts["pairhmm_indexed"] == stats["launches"] > 0,
          "the realignment path's K1 launches do not add up")
    rc = golden_e2e.diff(out_dir)   # ours = banded cuda, ref = native
    check(rc == 0, "the banded realignment VCF diverges from the native "
          "engine's")
    check("jax" not in sys.modules, "jax was imported")
    return {"launches": launches, "fallbacks": stats["sw_fallbacks"],
            "wall_s": stats["wall_s"]}


def region_tasks(workdir, n_min=MIN_REGIONS):
    """The corpus's first active regions, with their reads, found window by
    window as the caller's _call_contig does: [(region, reads)], ref, contig,
    contig lengths."""
    import numpy as np
    from rovaca_tpu import constants as C
    from rovaca_tpu.io.bamcols import BamColumns
    from rovaca_tpu.pipeline import activity
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
    import golden_e2e
    from rovaca_tpu_torch.pipeline.hc_engine import CallerConfig, RegionCaller
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
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        timed("card", phase_card)
        timed("build", phase_build)
        k1 = timed("K1 vs plain", phase_kernels)
        k2 = timed("K2 vs plain", phase_dense)
        k3 = timed("K3 vs plain", phase_sw)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
            main_path = timed("main path", phase_main_path, workdir)
            realign = timed("realignment path", phase_realign_path, workdir,
                            main_path["wall_s"])
            region = timed("region path", phase_region_path, workdir)
    except PhaseError as exc:
        print(f"FAIL: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [
        {"name": "pairhmm_indexed", "route": "cuda",
         "source": "rovaca_tpu_torch/csrc/pairhmm_indexed.cu",
         "replaces": "rovaca_tpu/ops/pairhmm/indexed.py:74",
         "launches": main_path["launches"],
         "max_abs_err": k1["max_abs_err"],
         "err_of": "log10 likelihood of pairs at or above 1e-28",
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "shape": dict(zip(("Lr", "Lh", "G"), TIMED_SHAPE))},
        {"name": "pairhmm_dense", "route": "cuda",
         "source": "rovaca_tpu_torch/csrc/pairhmm_dense.cu",
         "replaces": "rovaca_tpu/ops/pairhmm/kernel.py:175",
         "launches": region["launches"],
         "max_abs_err": k2["max_abs_err"],
         "err_of": "log10 likelihood of pairs at or above 1e-28",
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "shape": {"Lr": DENSE_TIMED[0], "Lh": DENSE_TIMED[1],
                   "GH": DENSE_TILES, "GR": DENSE_TILES}},
        {"name": "sw_banded", "route": "cuda",
         "source": "rovaca_tpu_torch/csrc/sw_banded.cu",
         "replaces": "rovaca_tpu/ops/sw/banded.py:242",
         "launches": realign["launches"],
         "max_abs_err": k3["max_abs_err"],
         "err_of": "bt, colm, lastrow and edge (integers, bit-equal)",
         "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bt_copy_ms": k3["copy_ms"], "fallbacks": realign["fallbacks"],
         "shape": {"Ln": SW_TIMED[0], "B": SW_TIMED[1]}}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
