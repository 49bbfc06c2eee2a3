"""End-to-end race: this package's CLI in several configurations, and the
reference binary where it exists.

Counterpart of scripts/race_e2e.py, with the same protocol: one unrecorded
warm-up run (of the first contender, after the g++ libraries of every mode
are built here: a fresh checkout builds them and the kernels at first use),
then N rounds (default 5), each running every contender once
in the same order, so that slow drift of the host hits all contenders alike.
Runs are strictly sequential. A contender is a subprocess of ``python -m
rovaca_tpu_torch.cli HaplotypeCaller``; its process wall is timed here, and
its own HaplotypeCaller wall, K1 launches and card seconds are read from the
summary line it prints (for ``--shards``, one line a shard). The process
wall minus the own wall is the process's start-up (torch's import above
all). Beside each run go the CPU seconds the process and its children
used: when the wall moves and the CPU seconds do not, something else held
the host's cores. RACE.json
records each contender's runs, median, spread and reads/s.

    python -m rovaca_tpu_torch.tools.race_e2e <dir> [genome_len] [coverage]
        [seed] [n_runs] [--contenders cuda,native,...] [--out DIR]

``<dir>`` holds the corpus (sample.bam, ref.fa); golden_e2e.generate makes
it there when it is missing. Contenders whose engine is cuda need the card:
without one the race stops before any run and measures nothing on the CPU.
The ``native`` contenders run on the CPU.

Each output is held once, after the rounds: to rovaca_tpu's output committed
in tests/golden_torch/ when the corpus is one the manifest pins (the 50 kb
corpus or the 1 Mb one), else to the reference binary's, else to the native
engine's; the sharded contender by ``depth_masked_diff`` (below). A contender
that fails its check makes ``main`` exit 1.

Reservoir downsampling consumes a Java-LCG stream in traversal order
(reference: src/common/downsampler_hc.h:94-210), so an interval-split run
picks different survivors at >50-deep alignment starts than a whole-contig
run, exactly as the reference binary does under -L interval splits: a
sharded run may differ from an unsharded one only at such pileups, which
``depth_masked_diff`` checks.
"""

import argparse
import contextlib
import io
import json
import os
import re
import resource
import shutil
import subprocess
import sys
import time

from ..utils.platform import card_info, require_card
from . import golden_e2e, golden_flows

# name: (engine, GVCF, extra CLI flags, extra environment); the reference
# binary's contenders are REFERENCE's. The cuda contenders realign on the
# banded SW kernel; cuda_native_sw keeps realignment on the native SW batch
CONTENDERS = {
    "cuda": ("cuda", False, (), ()),
    "cuda_native_sw": ("cuda", False, (),
                       (("ROVACA_BANDED_REALIGN", "0"),)),
    "native": ("native", False, (), ()),
    "cuda_gvcf": ("cuda", True, (), ()),
    "native_gvcf": ("native", True, (), ()),
    "cuda_2shard": ("cuda", False, ("--shards", "2"),
                    (("ROVACA_NATIVE_THREADS", "1"),)),
    "cuda_workers2": ("cuda", False, ("-t", "2"),
                      (("ROVACA_NATIVE_THREADS", "1"),)),
}
REFERENCE = {"reference_avx": False, "reference_avx_gvcf": True}

SUMMARY = re.compile(r"\[rovaca_tpu_torch\] (\d+) reads, (\d+) regions, "
                     r"(\d+) records in ([\d.]+)s \((\d+) launches, "
                     r"([\d.]+)s on the card")


def parse_vcf_records(path):
    """{(contig, pos, ref, alts): (line_fields, DP)} over a VCF file."""
    out = {}
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            key = (f[0], int(f[1]), f[3], f[4])
            dp = 0
            for kv in f[7].split(";"):
                if kv.startswith("DP="):
                    dp = int(kv[3:])
            out[key] = (f, dp)
    return out


def _downsampled_hotspots(bam_path, target=50):
    """{contig: sorted positions whose raw alignment-start count exceeds
    the positional-downsampler reservoir} — the places where a traversal
    split reseeds the LCG stream and survivor sets legitimately differ."""
    from collections import Counter
    from ..io.bam import BamReader
    counts = {}
    for r in BamReader(bam_path):
        counts.setdefault(r.contig, Counter())[r.pos] += 1
    return {c: sorted(p for p, n in cnt.items() if n > target)
            for c, cnt in counts.items()}


def depth_masked_diff(unsharded_path, sharded_path, bam_path=None,
                      max_depth=50, reach=400):
    """Verify the sharded-vs-unsharded divergence is CONFINED to
    reservoir-downsampled pileups: records may differ only at sites where
    either side reports DP >= max_depth, or (when the BAM is given) within
    `reach` bp of a raw alignment-start hotspot the positional downsampler
    truncated — a site's own output DP can be small while its active
    region still contains reads whose survivor set depends on the LCG
    stream (read span + region padding; the traversal-split stream picks
    different survivors there, exactly as the reference does under -L
    splits; see module docstring). Returns (ok, detail)."""
    import bisect
    a = parse_vcf_records(unsharded_path)
    b = parse_vcf_records(sharded_path)
    hot = (_downsampled_hotspots(bam_path, max_depth)
           if bam_path else {})

    def near_hotspot(contig, pos1):
        ps = hot.get(contig)
        if not ps:
            return False
        p0 = pos1 - 1
        i = bisect.bisect_left(ps, p0 - reach)
        return i < len(ps) and ps[i] <= p0 + reach

    bad = []
    for key in sorted(set(a) | set(b)):
        ra, rb = a.get(key), b.get(key)
        if ra is not None and rb is not None and ra[0] == rb[0]:
            continue
        dp = max(ra[1] if ra else 0, rb[1] if rb else 0)
        if dp < max_depth and not near_hotspot(key[0], key[1]):
            bad.append((key, "missing" if ra is None or rb is None
                        else "fields", dp))
    if bad:
        return False, f"DIVERGENT beyond depth mask: {bad[:5]}"
    n_deep = sum(1 for key in set(a) & set(b) if a[key][0] != b[key][0])
    return True, f"MATCH (depth-masked; {n_deep} deep-pileup sites differ)"


def median(xs):
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def build_native():
    """Build every g++ library of the package now (each builds at its first
    use otherwise), so no recorded run of any mode pays for a build."""
    from ..native import (activity_native, assemble_native, bamscan_native,
                          finalize_native, pairhmm_native, pcr_native,
                          posobs_native, sw_native)
    for mod in (activity_native, assemble_native, bamscan_native,
                finalize_native, pcr_native, posobs_native, sw_native,
                pairhmm_native):
        mod.available()
    pairhmm_native.rescue_available()


def cli_env(extra=()):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (golden_e2e.REPO, env.get("PYTHONPATH")) if p)
    env.update(dict(extra))
    return env


def contenders(corpus, out_dir, names):
    """[(name, argv, env, gvcf, output path)] for ``names`` in order."""
    bam = os.path.join(corpus, "sample.bam")
    fa = os.path.join(corpus, "ref.fa")
    out = []
    for name in names:
        if name in REFERENCE:
            gvcf = REFERENCE[name]
            path = os.path.join(out_dir, name + (".g.vcf" if gvcf
                                                 else ".vcf"))
            cmd, env = golden_e2e.ref_command(corpus, path, gvcf)
            out.append((name, cmd, env, gvcf, path))
            continue
        engine, gvcf, flags, extra_env = CONTENDERS[name]
        path = os.path.join(out_dir, name + (".g.vcf" if gvcf else ".vcf"))
        cmd = [sys.executable, "-m", "rovaca_tpu_torch.cli",
               "HaplotypeCaller", "-i", bam, "-r", fa, "-o", path,
               "--pairhmm-engine", engine, "--log-level", "WARNING",
               *flags]
        if gvcf:
            cmd += ["-e", "GVCF"]
        out.append((name, cmd, cli_env(extra_env), gvcf, path))
    return out


def _cpu_s():
    """CPU seconds (user + system) of this process's waited-for children."""
    ru = resource.getrusage(resource.RUSAGE_CHILDREN)
    return ru.ru_utime + ru.ru_stime


def _run(name, cmd, env):
    """(process wall s, [(reads, regions, records, own wall s, K1
    launches, card s)] from its summary lines, the CPU seconds it and its
    children used)."""
    cpu0 = _cpu_s()
    t0 = time.perf_counter()
    r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                       timeout=3600)
    dt = time.perf_counter() - t0
    cpu_s = _cpu_s() - cpu0
    if r.returncode != 0:
        sys.stderr.write(r.stderr[-3000:])
        raise SystemExit(f"{name} failed rc={r.returncode}")
    lines = [(int(a), int(b), int(c), float(d), int(e), float(f))
             for a, b, c, d, e, f in SUMMARY.findall(r.stderr)]
    return dt, lines, cpu_s


def count_reads(bam):
    from ..io.bam import BamReader
    reader = BamReader(bam)
    try:
        return sum(1 for _ in reader)
    finally:
        reader.close()


def pinned_references(corpus):
    """{gvcf: name of the committed rovaca_tpu reference} when the manifest
    pins this corpus (the committed 50 kb one or the 1 Mb one), else
    None."""
    ref_fa = os.path.join(corpus, "ref.fa")
    bam = os.path.join(corpus, "sample.bam")
    golden = golden_flows.GOLDEN_DIR
    if (golden_flows.sha256_file(ref_fa) == golden_flows.sha256_file(
            os.path.join(golden, "ref.fa"))
            and golden_flows.sha256_bam_payload(bam)
            == golden_flows.sha256_bam_payload(
                os.path.join(golden, "sample.bam"))):
        return {False: golden_flows.reference_name("vcf"),
                True: golden_flows.reference_name("gvcf")}
    if not golden_flows.corpus_problems(corpus, "corpus_1mb"):
        return {False: "1mb.vcf.xz", True: "1mb.g.vcf.xz"}
    return None


def _reference_outputs(corpus, out_dir, outputs, modes):
    """({gvcf: path of the output each contender is held to} for the
    ``modes`` (gvcf flags) needed, what it is): rovaca_tpu's committed
    output for a pinned corpus, else the reference binary's, else the
    native engine's (run here once, unrecorded, if no such contender
    ran)."""
    pinned = pinned_references(corpus)
    if pinned is not None:
        return ({gvcf: golden_flows.unpack_reference(
            pinned[gvcf], os.path.join(out_dir,
                                       "rovaca_tpu_" + pinned[gvcf][:-3]))
            for gvcf in modes}, "rovaca_tpu's committed output")
    if os.path.exists(golden_e2e.REF_BIN):
        names, held_to = REFERENCE, "the reference binary's output"
    else:
        names = {"native": False, "native_gvcf": True}
        held_to = "the native engine's output"
    refs = {}
    for name, gvcf in names.items():
        if gvcf not in modes:
            continue
        refs[gvcf] = outputs.get(name)
        if refs[gvcf] is None:
            (_, cmd, env, _, refs[gvcf]), = contenders(corpus, out_dir,
                                                       [name])
            _run(name, cmd, env)
    return refs, held_to


def _diff(path, want, gvcf, work):
    """golden_e2e.diff of ``path`` against ``want``: (ok, its last line)."""
    os.makedirs(work, exist_ok=True)
    suffix = ".g.vcf" if gvcf else ".vcf"
    shutil.copyfile(path, os.path.join(work, "ours" + suffix))
    shutil.copyfile(want, os.path.join(work, "ref" + suffix))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = golden_e2e.diff(work, gvcf=gvcf)
    lines = buf.getvalue().strip().splitlines()
    return rc == 0, lines[-1] if lines else f"diff rc={rc}"


def run_race(corpus, out_dir=None, names=tuple(CONTENDERS), n_runs=5,
             log=print):
    """Race ``names`` on ``corpus``; writes and returns RACE.json's dict.
    Reference-binary contenders run when REF_BIN exists and are listed under
    ``skipped`` otherwise. Raises SystemExit before any run when a cuda
    contender finds no card."""
    out_dir = out_dir or corpus
    os.makedirs(out_dir, exist_ok=True)
    unknown = [n for n in names if n not in CONTENDERS and n not in REFERENCE]
    if unknown:
        raise SystemExit(f"unknown contenders {unknown}; choose from "
                         f"{list(CONTENDERS) + list(REFERENCE)}")
    cuda = [n for n in names if n in CONTENDERS and CONTENDERS[n][0] == "cuda"]
    if cuda:
        require_card(f"the race of {cuda}")
    skipped = {}
    if not os.path.exists(golden_e2e.REF_BIN):
        skipped = {n: f"reference binary missing: {golden_e2e.REF_BIN}"
                   for n in names if n in REFERENCE}
    names = [n for n in names if n not in skipped]
    runs = contenders(corpus, out_dir, names)
    n_reads = count_reads(os.path.join(corpus, "sample.bam"))

    build_native()
    name, cmd, env, _, _ = next(
        (r for r in runs if r[0] in CONTENDERS), runs[0])
    warmup_s = _run(name, cmd, env)[0]
    log(f"[race] warm-up {name}: {warmup_s:.3f}s (not recorded)")
    walls = {n: [] for n in names}
    own = {n: [] for n in names}
    cpu = {n: [] for n in names}
    sequence = []
    for rnd in range(n_runs):
        for name, cmd, env, _, _ in runs:
            dt, lines, cpu_s = _run(name, cmd, env)
            walls[name].append(dt)
            own[name].append(lines)
            cpu[name].append(cpu_s)
            sequence.append(name)
            log(f"[race] round {rnd + 1}/{n_runs} {name}: {dt:.3f}s")

    refs, held_to = _reference_outputs(
        corpus, out_dir, {n: p for n, _, _, _, p in runs},
        {gvcf for _, _, _, gvcf, _ in runs})
    results = {"corpus": os.path.abspath(corpus), "n_reads": n_reads,
               "n_runs": n_runs,
               "protocol": "one unrecorded warm-up run of the first "
                           "contender, then n_runs rounds in order; "
                           "median of each contender's runs",
               "warmup_s": warmup_s, "sequence": sequence,
               "held_to": held_to, "skipped": skipped, "contenders": {}}
    if cuda:
        results["device"] = card_info()
    for name, _, _, gvcf, path in runs:
        med = median(walls[name])
        # a run's own wall: the slowest of its summary lines (a shard each
        # for --shards); launches and card seconds summed over them
        own_s = [max(x[3] for x in lines) for lines in own[name] if lines]
        launches = [sum(x[4] for x in lines) for lines in own[name]]
        card_s = [sum(x[5] for x in lines) for lines in own[name]]
        share = [c / o for c, o in zip(card_s, own_s) if o]
        c = {"wall_s": med, "runs_s": walls[name],
             "spread_s": [min(walls[name]), max(walls[name])],
             "spread_rel": (max(walls[name]) - min(walls[name])) / med,
             "own_s": own_s,
             "own_median_s": median(own_s) if own_s else None,
             "cpu_s": cpu[name],
             "launches": launches, "card_s": card_s,
             "card_share": median(share) if share else None,
             "reads_per_s": n_reads / med}
        if name in CONTENDERS and "--shards" in CONTENDERS[name][2]:
            ok, detail = depth_masked_diff(
                refs[False], path, bam_path=os.path.join(corpus,
                                                         "sample.bam"))
        elif refs[gvcf] == path:
            ok, detail = True, "the reference itself"
        else:
            ok, detail = _diff(path, refs[gvcf], gvcf,
                               os.path.join(out_dir, "diff_" + name))
        c.update(ok=ok, diff=detail)
        results["contenders"][name] = c
    ref_wall = {gvcf: results["contenders"][n]["wall_s"]
                for n, gvcf in REFERENCE.items()
                if n in results["contenders"]}
    for name, c in results["contenders"].items():
        gvcf = next(g for n, _, _, g, _ in runs if n == name)
        c["vs_reference"] = (ref_wall[gvcf] / c["wall_s"]
                             if gvcf in ref_wall else None)
    path = os.path.join(out_dir, "RACE.json")
    with open(path, "w") as f:
        json.dump(results, f, indent=1)
    results["path"] = path
    return results


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m rovaca_tpu_torch.tools.race_e2e",
        description="interleaved repeated runs of the port's CLI (and the "
                    "reference binary where it exists); writes RACE.json")
    p.add_argument("dir", help="corpus directory (generated if missing)")
    p.add_argument("numbers", nargs="*", type=int,
                   help="genome_len coverage seed n_runs")
    p.add_argument("--contenders", default=None,
                   help="comma-separated; default every contender less "
                        "those in ROVACA_RACE_SKIP")
    p.add_argument("--out", default=None, help="output directory")
    a = p.parse_args(argv)
    genome_len, coverage, seed, n_runs = (a.numbers + [
        1_000_000, 30, 424242, 5][len(a.numbers):])[:4]
    if a.contenders:
        names = a.contenders.split(",")
    else:
        skip = set(filter(None, os.environ.get("ROVACA_RACE_SKIP",
                                               "").split(",")))
        names = [n for n in list(REFERENCE) + list(CONTENDERS)
                 if n not in skip]
    if not os.path.exists(os.path.join(a.dir, "sample.bam")):
        golden_e2e.generate(a.dir, genome_len, coverage, seed)
    res = run_race(a.dir, a.out, names, n_runs)
    print(json.dumps(res["contenders"], indent=1))
    for name, why in res["skipped"].items():
        print(f"skipped {name}: {why}")
    print("->", res["path"])
    bad = [n for n, c in res["contenders"].items() if not c["ok"]]
    if bad:
        print(f"FAIL: {bad} differ from {res['held_to']}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
