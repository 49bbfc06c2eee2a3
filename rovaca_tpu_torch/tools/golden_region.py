"""Single-region golden diff: the reference's per-region calling chain
(refshim/region_harness.cpp driving local_assemble -> trim -> filters ->
call_pairhmm -> realign -> assign_genotype_likelihoods) against this
package's RegionCaller, on the same post-stream read set.

Counterpart of scripts/golden_region.py. ``region_reads`` gives the reads
of one active region as the caller's stream hands them over;
``ours_report`` runs ``RegionCaller.prepare_region``, the package's
``compute_likelihoods`` (on the card: the dense PairHMM kernel) and
``finish_region`` (on the card: the banded realignment) on them and
returns the trimmed span, the PairHMM read list and the final variants, in
the script's lines; ``ref_report`` runs the reference's region harness and
stops with one line without it. ``golden`` holds ``ours_report`` on the
regions of tests/golden_torch/region_report.txt, which rovaca_tpu's chain
(``--pairhmm-engine xla``) made on the committed 50 kb corpus, to that
file: the same trimmed span and read list, the same variants with QUAL
within golden_e2e's QUAL_TOL, AD, DP and GQ equal and PL within PL_TOL.

    python -m rovaca_tpu_torch.tools.golden_region <bam> <fasta> <contig>
        <start0> <end0> [workdir] [--engine auto|cuda|torch|native]
    python -m rovaca_tpu_torch.tools.golden_region golden [--engine ...]

start0/end0 are the 0-based ACTIVE region bounds (our convention); the
harness gets them 1-based. The first form prints the reference's section,
then ours.
"""

import argparse
import os
import subprocess
import sys

from . import golden_e2e, golden_flows

HARNESS = os.path.join(golden_e2e.REPO, ".refbuild", "bin", "region_harness")
LIBDIR = os.path.join(golden_e2e.REPO, ".refbuild", "ref", "build-dev", "bin")
REPORT = os.path.join(golden_flows.GOLDEN_DIR, "region_report.txt")
HEADER = "==== region "


def region_reads(bam, fasta, contig, start0, end0):
    """The reads of ``contig`` that overlap the region padded by 100 on
    each side, as the caller's stream (filters, downsampler) hands them
    over."""
    from ..pipeline.caller import HaplotypeCaller, HCArgs
    hc = HaplotypeCaller(HCArgs(bam_paths=[bam], reference_path=fasta,
                                output_path=os.devnull,
                                pairhmm_engine="native"))
    pad_s, pad_e = start0 - 100, end0 + 1 + 100
    for c, reads in hc._reads_by_contig(hc._open_reader(None), None):
        if c == contig:
            out = [x for x in reads if x.pos < pad_e and x.end > pad_s]
            if not out:
                raise ValueError("no reads overlap the region")
            return out
    raise ValueError(f"no reads on {contig}")


def ours_report(bam, fasta, contig, start0, end0, engine="auto",
                stats=None):
    """This package's chain on one region, as the script's "ours" section:
    the trimmed span, the PairHMM reads and the variants, one line each.
    ``stats`` receives ``likelihood_calls`` (compute_likelihoods calls:
    0 or 1) and the realignment's ``sw_launches`` and ``sw_fallbacks``."""
    from ..io.fasta import FastaFile
    from ..ops.pairhmm.api import compute_likelihoods
    from ..pipeline.hc_engine import CallerConfig, RegionCaller
    reads = region_reads(bam, fasta, contig, start0, end0)
    ref = FastaFile(fasta).fetch(contig)

    class R:
        start, end, is_active = start0, end0, True
    caller = RegionCaller(CallerConfig(pairhmm_engine=engine),
                          {contig: len(ref)})
    p = caller.prepare_region(R, reads, ref, contig)
    if stats is not None:
        stats.update(likelihood_calls=0, sw_launches=0, sw_fallbacks=0)
    if isinstance(p, list):
        return "trimmed: none\n"
    lines = [f"trimmed: {p.variant_span[0] + 1}-{p.variant_span[1] + 1} "
             f"padded: {p.span[0] + 1}-{p.span[1] + 1}",
             f"pairhmm_reads: {len(p.call_reads)}"]
    for r in sorted(p.call_reads, key=lambda r: (r.name, r.pos)):
        q = "".join(chr(x + 33) for x in r.quals)
        lines.append(f"  {r.name}\t{r.pos + 1}\t{r.cigar}\t"
                     f"{r.bases.decode()}\t{q}")
    lik, kept = compute_likelihoods(p.call_reads, [h.bases for h in p.haps],
                                    engine=engine)
    calls = caller.finish_region(p, lik, kept)
    for c in calls:
        g = c.genotypes[0]
        ad = ",".join(str(x) for x in (g.ad or []))
        pl = ",".join(str(x) for x in (g.pl or []))
        alts = ",".join(a.bases.decode() for a in c.alleles)
        lines.append(f"variant: {c.start + 1} {alts} QUAL={c.qual:.2f} "
                     f"AD={ad} DP={g.dp} GQ={g.gq} PL={pl}")
    if stats is not None:
        stats.update(likelihood_calls=1, sw_launches=caller.sw_launches,
                     sw_fallbacks=caller.sw_fallbacks)
    return "\n".join(lines) + "\n"


def ref_report(bam, fasta, contig, start0, end0, workdir):
    """The reference's region harness on the same reads; stops with one
    line without it."""
    golden_e2e.require_binary(HARNESS)
    from ..io.fasta import FastaFile
    from .golden_assembly import sam_line
    os.makedirs(workdir, exist_ok=True)
    reads = region_reads(bam, fasta, contig, start0, end0)
    cases = os.path.join(workdir, "cases.txt")
    reftxt = os.path.join(workdir, "ref.txt")
    with open(cases, "w") as f:
        f.write(f"chr1\t{start0 + 1}\t{end0 + 1}\t{len(reads)}\n")
        for r in reads:
            f.write(sam_line(r, "chr1") + "\n")
        f.write("\n")
    with open(reftxt, "w") as f:
        f.write(bytes(FastaFile(fasta).fetch(contig)).decode() + "\n")
    out = os.path.join(workdir, "ref_region.txt")
    subprocess.run([HARNESS, cases, reftxt, out],
                   env=dict(os.environ, LD_LIBRARY_PATH=LIBDIR),
                   timeout=600, stderr=subprocess.DEVNULL)
    with open(out) as f:
        return f.read()


def read_report(path=REPORT):
    """{(contig, start0, end0): section text} of a report file."""
    out, key = {}, None
    with open(path) as f:
        for line in f:
            if line.startswith(HEADER):
                c, s, e = line[len(HEADER):].split()[:3]
                key = (c, int(s), int(e))
                out[key] = ""
            else:
                out[key] += line
    return out


def _variants(section):
    rows = {}
    for line in section.splitlines():
        if line.startswith("variant: "):
            pos, alts, *fields = line[len("variant: "):].split(" ")
            rows[(pos, alts)] = dict(f.split("=", 1) for f in fields)
    return rows


def report_problems(got, want):
    """Why section ``got`` is not ``want``: the trimmed span and the read
    list must be equal, every variant present on both sides with QUAL
    within QUAL_TOL, AD, DP and GQ equal and PL within PL_TOL."""
    def head(s):
        return [ln for ln in s.splitlines() if not ln.startswith("variant: ")]
    problems = []
    if head(got) != head(want):
        problems.append("trimmed span or PairHMM read list differs")
    gv, wv = _variants(got), _variants(want)
    if set(gv) != set(wv):
        problems.append(f"variants {sorted(gv)} against {sorted(wv)}")
    for key in sorted(set(gv) & set(wv)):
        a, b = gv[key], wv[key]
        if abs(float(a["QUAL"]) - float(b["QUAL"])) > golden_e2e.QUAL_TOL:
            problems.append(f"{key}: QUAL {a['QUAL']} vs {b['QUAL']}")
        for f in ("AD", "DP", "GQ"):
            if a[f] != b[f]:
                problems.append(f"{key}: {f} {a[f]} vs {b[f]}")
        pa, pb = a["PL"].split(","), b["PL"].split(",")
        if len(pa) != len(pb) or any(abs(int(x) - int(y)) >
                                     golden_e2e.PL_TOL
                                     for x, y in zip(pa, pb)):
            problems.append(f"{key}: PL {a['PL']} vs {b['PL']}")
    return problems


def golden(engine="auto", stats=None):
    """``ours_report`` on every region of the committed report, on the
    committed 50 kb corpus, held to it. Returns {region: problems};
    ``stats`` sums the realignment's counters."""
    bam = os.path.join(golden_flows.GOLDEN_DIR, "sample.bam")
    fasta = os.path.join(golden_flows.GOLDEN_DIR, "ref.fa")
    out = {}
    for (contig, s, e), want in read_report().items():
        st = {}
        got = ours_report(bam, fasta, contig, s, e, engine, st)
        out[(contig, s, e)] = report_problems(got, want)
        if stats is not None:
            for k, v in st.items():
                stats[k] = stats.get(k, 0) + v
    return out


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "golden":
        p = argparse.ArgumentParser(
            prog="python -m rovaca_tpu_torch.tools.golden_region golden")
        p.add_argument("--engine", default="auto",
                       choices=["auto", "cuda", "torch", "native"])
        a = p.parse_args(argv[1:])
        res = golden(a.engine)
        for (c, s, e), problems in res.items():
            print(f"{c}:{s}-{e}: " + ("; ".join(problems) if problems
                                      else "equal"))
        ok = not any(res.values())
        print("REGIONS:", "MATCH" if ok else "DIVERGENT")
        return 0 if ok else 1
    p = argparse.ArgumentParser(
        prog="python -m rovaca_tpu_torch.tools.golden_region",
        description="one active region through the reference's region "
                    "harness and through this package")
    p.add_argument("bam")
    p.add_argument("fasta")
    p.add_argument("contig")
    p.add_argument("start0", type=int)
    p.add_argument("end0", type=int)
    p.add_argument("workdir", nargs="?", default="golden_region")
    p.add_argument("--engine", default="auto",
                   choices=["auto", "cuda", "torch", "native"])
    a = p.parse_args(argv)
    region = (a.bam, a.fasta, a.contig, a.start0, a.end0)
    ref = ref_report(*region, a.workdir)
    print("==== reference region chain:")
    print(ref)
    print("==== ours:")
    print(ours_report(*region, engine=a.engine), end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
