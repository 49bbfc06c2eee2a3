"""Host profile of one HaplotypeCaller run of this package, by layer.

Counterpart of scripts/host_profile.py. One run (VCF or GVCF, any engine)
over a corpus, in this process, under cProfile; the main thread's time is
grouped by the layers of PERF.md section 3 through ``LAYERS``: a function
of this package goes to the first row whose pattern matches its module path
(``path`` or ``path:function``, relative to the package); time of code
outside the package (builtins, numpy, the standard library, torch) and of
the modules shared by several layers (records, cigars, alleles, math
tables: rows ``None``) goes to the rows of the functions that called it,
split by the cumulative time each caller spent in it. What no row takes is ``other``,
with its top functions listed. Before the profiled run every module of the
package is imported and one unprofiled run over the contig's first 20 kb
builds the native libraries and kernels and starts the card, so neither
import nor build time is in the profile. cProfile on Python 3.12 follows
every thread on one stack, so the profiled run prepares regions on the
main thread (ROVACA_PREP_THREADS=1, where a default run uses two prep
threads), and by default one unprofiled run with that setting comes
first: the ratio of the two walls is the profiler's overhead.

    python -m rovaca_tpu_torch.tools.host_profile [<dir>] [--gvcf]
        [--engine auto|cuda|torch|native] [--torch-profiler] [--out JSON]
        [--length N --coverage N]

``<dir>`` holds sample.bam and ref.fa (a golden_e2e corpus); without it
``make_data`` simulates one (``--length``, ``--coverage``). ``cuda`` (and
``auto``) needs the card and stops without one; ``native`` and ``torch``
run on the CPU. ``--torch-profiler`` runs a second, unprofiled-by-cProfile
run under torch.profiler (CPU and CUDA activities) and reports kernel time
by name and the card's busy share of that run's wall; when the trace holds
no device time it says "not measured". The result is one JSON file
(default ``<dir>/host_profile[_gvcf].json``) and readable lines.
"""

import argparse
import contextlib
import cProfile
import importlib
import json
import os
import pkgutil
import pstats
import sys
import time

import numpy as np

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (pattern, row): the first match wins; a row "layer/sub" is a sub-row of
# "layer"; None passes the time to the callers' rows
LAYERS = (
    ("pipeline/hc_engine.py:finish_region", "genotyping_write"),
    ("pipeline/hc_engine.py:_reference_confidence_only", "ref_confidence"),
    ("pipeline/hc_engine.py:_merge_with_ref_confidence", "ref_confidence"),
    ("pipeline/hc_engine.py", "host_prep/rest"),
    ("pipeline/activity.py", "host_prep/activity"),
    ("native/activity_native.py:pileup_gls", None),   # activity and GVCF
    ("native/activity_native.py", "host_prep/activity"),
    ("assembly/sw.py", None),
    ("assembly/", "host_prep/assembly"),
    ("native/assemble_native.py", "host_prep/assembly"),
    ("native/prepare_native.py", "host_prep/assembly"),
    ("pipeline/trimming.py", "host_prep/assembly"),
    ("io/vcf.py", "genotyping_write"),
    ("io/", "host_prep/rest"),
    ("reads/cigar.py", None),
    ("reads/record.py", None),
    ("reads/", "host_prep/rest"),
    ("native/bamscan_native.py", "host_prep/rest"),
    # the packed finalize feeds only GVCF's reference confidence
    ("native/finalize_native.py:finalize_region_packed", "ref_confidence"),
    ("native/finalize_native.py", "host_prep/rest"),
    ("pipeline/caller.py", "host_prep/rest"),
    ("pipeline/scheduler.py", "pairhmm_launch"),
    ("ops/pairhmm/api.py", "host_scoring"),
    ("ops/pairhmm/golden.py", "host_scoring"),
    ("ops/pairhmm/", "pairhmm_launch"),
    ("ops/build.py", "pairhmm_launch"),
    ("native/pcr_native.py", "pairhmm_launch"),
    ("native/pairhmm_native.py", "pairhmm_launch"),
    ("genotype/alignment_utils.py", "realignment"),
    ("ops/sw/", "realignment"),
    ("native/sw_native.py", "realignment"),
    ("genotype/variant.py", None),
    ("genotype/", "genotyping_write"),
    ("pipeline/ref_confidence.py", "ref_confidence"),
    ("native/posobs_native.py", "ref_confidence"),
    ("pipeline/block_combiner.py", "block_combiner"),
    ("parallel/", "parallel"),
    ("ops/gatk_math.py", None),
    ("utils/refwindow.py", None),
    ("constants.py", None),
)
ROWS = ("host_prep/activity", "host_prep/assembly", "host_prep/rest",
        "pairhmm_launch", "host_scoring", "realignment", "genotyping_write",
        "ref_confidence", "block_combiner", "parallel", "other")


def make_data(length, coverage, outdir):
    """A simulated diploid corpus (SNPs, 2-base deletions and insertions
    every 400-1200 bases) of ``length`` bases at ``coverage`` in
    ``outdir``, as scripts/host_profile.py makes it; kept when present.
    Returns (fasta, bam)."""
    from ..io.bai import build_index
    from . import simdata
    fasta = os.path.join(outdir, "ref.fa")
    bam = os.path.join(outdir, "sample.bam")
    if os.path.exists(fasta) and os.path.exists(bam):
        return fasta, bam
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(5)
    ref = simdata.random_ref(rng, length)
    variants = []
    pos = 500
    while pos < length - 1000:
        t = int(rng.integers(0, 3))
        if t == 0:
            variants.append((pos, ref[pos],
                             "ACGT"[("ACGT".index(ref[pos]) + 1) % 4]))
        elif t == 1:
            variants.append((pos, ref[pos:pos + 3], ref[pos]))
        else:
            variants.append((pos, ref[pos], ref[pos] + "TG"))
        pos += int(rng.integers(400, 1200))
    hap2 = simdata.apply_variants(ref, variants)
    n = coverage * length // 100 // 2
    reads = (simdata.simulate_reads(rng, ref, ref, "chr1", n,
                                    name_prefix="h1_")
             + simdata.simulate_reads(rng, ref, hap2, "chr1", n,
                                      name_prefix="h2_"))
    simdata.write_fasta(fasta, {"chr1": ref})
    simdata.write_test_bam(bam, reads, "chr1", length)
    build_index(bam)
    return fasta, bam


def _row(func):
    """LAYERS row of one of this package's functions, "other" when no
    pattern matches; False for code outside the package."""
    path = os.path.abspath(func[0])
    if not path.startswith(PKG + os.sep):
        return False
    rel = os.path.relpath(path, PKG).replace(os.sep, "/")
    for pattern, row in LAYERS:
        where, _, name = pattern.partition(":")
        if rel.startswith(where) and (not name or name == func[2]):
            return row
    return "other"


def attribute(stats):
    """{row: seconds} of a pstats ``stats`` dict, and the functions whose
    own time went to "other" [(seconds, label)], largest first."""
    memo = {}

    def shares(func, stack):
        """{row: fraction} of func's own time."""
        if func in memo:
            return memo[func]
        row = _row(func)
        if row:
            out = {row: 1.0}
        else:
            callers = {c: v for c, v in stats[func][4].items()
                       if c not in stack and c in stats}
            weight = {c: v[3] or v[2] or v[0] for c, v in callers.items()}
            total = sum(weight.values())
            if not total:
                out = {"other": 1.0}
            else:
                out = {}
                for c, w in weight.items():
                    for r, f in shares(c, stack | {func}).items():
                        out[r] = out.get(r, 0.0) + f * w / total
        memo[func] = out
        return out

    rows = dict.fromkeys(ROWS, 0.0)
    other = []
    for func, (_, _, tt, _, _) in stats.items():
        for r, f in shares(func, frozenset()).items():
            rows[r] += tt * f
            if r == "other" and tt * f > 0:
                other.append((tt * f, pstats.func_std_string(func)))
    other.sort(reverse=True)
    return rows, other


def _layers(rows):
    """The layer totals of the rows (host_prep = its three sub-rows)."""
    out = {}
    for r, s in rows.items():
        layer = r.split("/")[0]
        out[layer] = out.get(layer, 0.0) + s
    return out


def _preload():
    """Import every module of the package but the tools, so the profiled
    run imports nothing."""
    import rovaca_tpu_torch
    for mod in pkgutil.walk_packages(rovaca_tpu_torch.__path__,
                                     "rovaca_tpu_torch."):
        if not mod.name.startswith("rovaca_tpu_torch.tools"):
            importlib.import_module(mod.name)


def _args(bam, ref, out, engine, gvcf, span=None):
    from ..pipeline.caller import HCArgs
    return HCArgs(bam_paths=[bam], reference_path=ref, output_path=out,
                  gvcf_mode=gvcf, pairhmm_engine=engine,
                  log_level="WARNING", target_span=span)


def warm_up(bam, ref, out, engine, gvcf):
    """Import the package and run the contig's first 20 kb unprofiled (the
    native libraries and kernels build at first use, the card starts)."""
    from ..io.fasta import FastaFile
    from ..pipeline.caller import HaplotypeCaller
    _preload()
    contig = next(iter(FastaFile(ref).contig_dict))
    HaplotypeCaller(_args(bam, ref, out, engine, gvcf,
                          f"{contig}:1-20000")).run()


@contextlib.contextmanager
def one_prep_thread():
    """Regions prepared on the calling thread (ROVACA_PREP_THREADS=1):
    cProfile on Python 3.12 follows every thread on one stack, so the
    profiled run keeps the host work on one thread."""
    old = os.environ.get("ROVACA_PREP_THREADS")
    os.environ["ROVACA_PREP_THREADS"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["ROVACA_PREP_THREADS"]
        else:
            os.environ["ROVACA_PREP_THREADS"] = old


def profile_run(bam, ref, out, engine="native", gvcf=False, top=25,
                unprofiled=True):
    """After ``warm_up``, one run unprofiled (unless ``unprofiled`` is
    False) and one under cProfile, both with one prep thread. Returns
    {"unprofiled_wall_s" (None when not run), "wall_s", "profiled_s",
    "rows", "layers", "other_top", "top_cumulative", "stats"}."""
    from ..pipeline.caller import HaplotypeCaller
    warm_up(bam, ref, out, engine, gvcf)
    with one_prep_thread():
        t0 = time.perf_counter()
        if unprofiled:
            HaplotypeCaller(_args(bam, ref, out, engine, gvcf)).run()
        unprofiled = time.perf_counter() - t0 if unprofiled else None
        hc = HaplotypeCaller(_args(bam, ref, out, engine, gvcf))
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        try:
            stats = hc.run()
        finally:
            prof.disable()
        wall = time.perf_counter() - t0
    ps = pstats.Stats(prof)
    rows, other = attribute(ps.stats)
    cum = sorted(ps.stats.items(), key=lambda kv: kv[1][3], reverse=True)
    return {"unprofiled_wall_s": unprofiled, "wall_s": wall,
            "profiled_s": sum(v[2] for v in ps.stats.values()),
            "rows": rows, "layers": _layers(rows),
            "other_top": [{"function": f, "s": s} for s, f in other[:top]],
            "top_cumulative": [
                {"function": pstats.func_std_string(f), "cumulative_s": v[3],
                 "own_s": v[2], "calls": v[1]} for f, v in cum[:top]],
            "stats": dict(stats)}


def torch_profile_run(bam, ref, out, engine="cuda", gvcf=False):
    """One run under torch.profiler (CPU, and CUDA when a card is
    visible). Returns {"wall_s", "card_busy_s", "card_busy_share",
    "kernels": {name: {"ms", "count"}}}, the card numbers "not measured"
    when the trace holds no device time."""
    import torch

    from ..pipeline.caller import HaplotypeCaller
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    hc = HaplotypeCaller(_args(bam, ref, out, engine, gvcf))
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        stats = hc.run()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for ev in prof.key_averages():
        # the card's own events (kernels, copies, sets); a host op such as
        # aten::copy_ carries its copy's time again
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            kernels[ev.key] = {"ms": us / 1e3, "count": ev.count}
    busy = sum(k["ms"] for k in kernels.values()) / 1e3
    res = {"wall_s": wall, "stats": dict(stats), "kernels": kernels}
    if busy > 0:
        res.update(card_busy_s=busy, card_busy_share=busy / wall)
    else:
        res.update(card_busy_s="not measured",
                   card_busy_share="not measured")
    return res


def report_lines(res):
    """Readable lines of a profile_run result."""
    total = res["profiled_s"]
    base = res["unprofiled_wall_s"]
    lines = [f"[profile] wall {res['wall_s']:.3f}s under cProfile (one prep "
             f"thread)"
             + (f" against {base:.3f}s unprofiled ({res['wall_s'] / base:.3f}"
                f"x)" if base else "")
             + f", profiled {total:.3f}s; "
             f"{res['stats'].get('regions')} regions, "
             f"{res['stats'].get('calls')} records, "
             f"{res['stats'].get('launches')} K1 launches"]
    for r in ROWS:
        s = res["rows"][r]
        lines.append(f"[profile]   {r:<20} {s:9.3f}s {100 * s / total:6.2f}%")
    for layer, s in res["layers"].items():
        if layer == "host_prep":
            lines.append(f"[profile]   host_prep total      {s:9.3f}s "
                         f"{100 * s / total:6.2f}%")
    for o in res["other_top"][:5]:
        lines.append(f"[profile]   other: {o['s']:.3f}s {o['function']}")
    return lines


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m rovaca_tpu_torch.tools.host_profile",
        description="cProfile of one HaplotypeCaller run grouped by layer")
    p.add_argument("dir", nargs="?", default=None,
                   help="corpus directory with sample.bam and ref.fa")
    p.add_argument("--gvcf", action="store_true")
    p.add_argument("--engine", default="cuda",
                   choices=["auto", "cuda", "torch", "native"])
    p.add_argument("--torch-profiler", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--length", type=int, default=20_000)
    p.add_argument("--coverage", type=int, default=20)
    a = p.parse_args(argv)
    if a.engine in ("auto", "cuda"):
        from ..utils.platform import card_info, require_card
        require_card("the cuda engine's profile")
    corpus = a.dir or f"host_profile_{a.length}_{a.coverage}"
    if a.dir is None:
        make_data(a.length, a.coverage, corpus)
    bam = os.path.join(corpus, "sample.bam")
    ref = os.path.join(corpus, "ref.fa")
    suffix = "_gvcf" if a.gvcf else ""
    vcf = os.path.join(corpus, f"host_profile{suffix}.vcf")
    res = profile_run(bam, ref, vcf, a.engine, a.gvcf)
    res.update(corpus=os.path.abspath(corpus), engine=a.engine,
               mode="GVCF" if a.gvcf else "VCF")
    if a.engine in ("auto", "cuda"):
        res["device"] = card_info()
    for line in report_lines(res):
        print(line)
    print("[profile] top functions by cumulative time:")
    for t in res["top_cumulative"]:
        print(f"[profile]   {t['cumulative_s']:9.3f}s cum {t['own_s']:9.3f}s "
              f"own {t['calls']:>9} calls  {t['function']}")
    if a.torch_profiler:
        tp = torch_profile_run(bam, ref, vcf, a.engine, a.gvcf)
        res["torch_profiler"] = tp
        busy = tp["card_busy_s"]
        print(f"[profile] torch.profiler run: wall {tp['wall_s']:.3f}s, card "
              f"busy {busy if isinstance(busy, str) else f'{busy:.4f}s'}"
              f", share {tp['card_busy_share']}")
        for name, k in sorted(tp["kernels"].items(),
                              key=lambda kv: -kv[1]["ms"]):
            print(f"[profile]   {k['ms']:10.4f} ms x{k['count']:<6} {name}")
    out = a.out or os.path.join(corpus, f"host_profile{suffix}.json")
    with open(out, "w") as f:
        json.dump(res, f, indent=1)
    print("->", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
