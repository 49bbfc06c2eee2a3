"""Accuracy of the calls against a synthetic diploid truth set.

Counterpart of scripts/accuracy_eval.py. ``make_truth`` draws het/hom SNPs,
deletions and insertions of 1-6 bases along a reference (a copy of the
script's); ``make_corpus`` writes that genome's reference, its simulated
reads (error-free, 100 bases) as a BAM and the truth list; ``score_calls``
holds a VCF to a truth list (``make_corpus``'s or a golden_e2e corpus's
truth.txt, which share one format) and gives recall, precision and genotype
concordance, alleles left-aligned and trimmed as ``_norm`` does.

    python -m rovaca_tpu_torch.tools.accuracy_eval [length] [coverage]
        [n_variants] [--engine cuda|native|torch] [--dir DIR]
    python -m rovaca_tpu_torch.tools.accuracy_eval --score VCF TRUTH REF_FA

The cuda engine (the default) needs the card and stops without one;
``native`` and ``torch`` run on the CPU. Scoring alone runs anywhere.
"""

import argparse
import json
import os
import sys
import time

import numpy as np


def make_truth(rng, ref, n_variants):
    """[(pos, ref_allele, alt_allele, genotype)] with genotype het/hom."""
    truth = []
    pos = 400
    step = (len(ref) - 800) // n_variants
    for _ in range(n_variants):
        t = int(rng.integers(0, 4))
        gt = "hom" if rng.random() < 0.3 else "het"
        if t <= 1:  # SNP
            alt = "ACGT"[("ACGT".index(ref[pos]) + 1 + int(rng.integers(0, 3))) % 4]
            if alt == ref[pos]:
                alt = "ACGT"[("ACGT".index(ref[pos]) + 1) % 4]
            truth.append((pos, ref[pos], alt, gt))
        elif t == 2:  # deletion 1-6bp
            n = int(rng.integers(1, 7))
            truth.append((pos, ref[pos:pos + n + 1], ref[pos], gt))
        else:  # insertion 1-6bp
            ins = "".join(rng.choice(list("ACGT"), size=int(rng.integers(1, 7))))
            truth.append((pos, ref[pos], ref[pos] + ins, gt))
        pos += step + int(rng.integers(-step // 4, step // 4))
        if pos >= len(ref) - 400:
            break
    return truth


def make_corpus(outdir, length=200_000, coverage=20, n_variants=150,
                seed=42, contig="chr1"):
    """scripts/accuracy_eval.py's genome, truth and reads for ``seed`` in
    ``outdir`` (ref.fa, sample.bam with its .bai, truth.txt). Returns the
    number of reads."""
    from ..io.bai import build_index
    from . import simdata
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    ref = simdata.random_ref(rng, length)
    truth = make_truth(rng, ref, n_variants)
    hom = [(p, r, a) for p, r, a, g in truth if g == "hom"]
    het = [(p, r, a) for p, r, a, g in truth if g == "het"]
    hap1 = simdata.apply_variants(ref, sorted(hom))
    hap2 = simdata.apply_variants(ref, sorted(hom + het))
    n_per_hap = coverage * length // 100 // 2
    reads = (simdata.simulate_reads(rng, ref, hap1, contig, n_per_hap,
                                    name_prefix="h1_")
             + simdata.simulate_reads(rng, ref, hap2, contig, n_per_hap,
                                      name_prefix="h2_"))
    simdata.write_fasta(os.path.join(outdir, "ref.fa"), {contig: ref})
    bam = os.path.join(outdir, "sample.bam")
    simdata.write_test_bam(bam, reads, contig, length)
    build_index(bam)
    with open(os.path.join(outdir, "truth.txt"), "w") as f:
        for pos, r, a, g in truth:
            f.write(f"{contig}\t{pos + 1}\t{r}\t{a}\t{g}\n")
    return len(reads)


def read_truth(path):
    """[(contig, pos0, ref, alt, "het" or "hom")] of a truth.txt."""
    out = []
    with open(path) as f:
        for line in f:
            contig, pos1, r, a, zyg = line.split()[:5]
            out.append((contig, int(pos1) - 1, r, a, zyg))
    return out


def _norm(pos, ref, alt, seq):
    """VCF-normalize an allele pair: trim shared suffix, left-align through
    repeat context (the same indel has many representations), trim prefix."""
    r, a = ref, alt

    def trim_suffix(pos, r, a):
        while len(r) > 1 and len(a) > 1 and r[-1] == a[-1]:
            r, a = r[:-1], a[:-1]
        return r, a

    r, a = trim_suffix(pos, r, a)
    # left shift: while both alleles end in the same base, rotate it out
    while len(r) != len(a) and r[-1] == a[-1] and pos > 0:
        prev = seq[pos - 1]
        r, a = prev + r[:-1], prev + a[:-1]
        pos -= 1
        r, a = trim_suffix(pos, r, a)
    while len(r) > 1 and len(a) > 1 and r[0] == a[0]:
        r, a = r[1:], a[1:]
        pos += 1
    return (pos, r, a)


def score_calls(vcf, truth, ref):
    """Recall, precision and genotype concordance of ``vcf``'s calls
    against ``truth`` (a truth.txt path, or [(contig, pos0, ref, alt,
    zyg)]) on the reference FASTA ``ref``. A truth site is found when a
    call's allele pair normalizes to it; its genotype is right when a hom
    site is called 1/1 and a het site 0/1 (phased or not)."""
    from ..io.fasta import FastaFile
    if isinstance(truth, str):
        truth = read_truth(truth)
    fasta = FastaFile(ref)
    seqs = {}

    def seq(contig):
        if contig not in seqs:
            seqs[contig] = bytes(fasta.fetch(contig)).decode()
        return seqs[contig]

    calls = {}
    with open(vcf) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            gt = f[9].split(":")[0].replace("|", "/")
            for alt in f[4].split(","):
                if alt in ("*", "<NON_REF>"):
                    continue
                calls[(f[0],) + _norm(int(f[1]) - 1, f[3], alt,
                                      seq(f[0]))] = gt
    want = {(c,) + _norm(p, r, a, seq(c)): z for c, p, r, a, z in truth}
    tp = [k for k in want if k in calls]
    fn = [k for k in want if k not in calls]
    fp = [k for k in calls if k not in want]
    gt_ok = sum(calls[k] == "1/1" if want[k] == "hom"
                else calls[k] in ("0/1", "1/0") for k in tp)
    return {"truth": len(want), "calls": len(calls), "tp": len(tp),
            "fn": len(fn), "fp": len(fp),
            "recall": len(tp) / max(1, len(want)),
            "precision": len(tp) / max(1, len(tp) + len(fp)),
            "genotype_concordance": gt_ok / max(1, len(tp)),
            "missed": fn[:8], "spurious": fp[:8]}


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m rovaca_tpu_torch.tools.accuracy_eval",
        description="recall, precision and genotype concordance on a "
                    "simulated truth set")
    p.add_argument("numbers", nargs="*", type=int,
                   help="length coverage n_variants")
    p.add_argument("--engine", default="cuda",
                   choices=["auto", "cuda", "native", "torch"])
    p.add_argument("--dir", default="accuracy_eval")
    p.add_argument("--score", nargs=3, metavar=("VCF", "TRUTH", "REF"),
                   help="only score VCF against TRUTH on REF")
    a = p.parse_args(argv)
    if a.score:
        print(json.dumps(score_calls(*a.score)))
        return 0
    if a.engine in ("auto", "cuda"):
        from ..utils.platform import require_card
        require_card("the cuda engine's accuracy run")
    length, coverage, n_variants = (a.numbers + [200_000, 20, 150][
        len(a.numbers):])[:3]
    n_reads = make_corpus(a.dir, length, coverage, n_variants)
    print(f"[gen] {n_reads} reads -> {a.dir}")
    from .. import cli
    out = os.path.join(a.dir, "out.vcf")
    t0 = time.perf_counter()
    rc = cli.main(["HaplotypeCaller", "-i", os.path.join(a.dir, "sample.bam"),
                   "-r", os.path.join(a.dir, "ref.fa"), "-o", out,
                   "--pairhmm-engine", a.engine, "--log-level", "WARNING"])
    if rc != 0:
        return rc
    res = score_calls(out, os.path.join(a.dir, "truth.txt"),
                      os.path.join(a.dir, "ref.fa"))
    print(f"[acc] recall={res['recall']:.3f} ({res['tp']}/{res['truth']}) "
          f"precision={res['precision']:.3f} (FP={res['fp']}) "
          f"genotype_concordance={res['genotype_concordance']:.3f} "
          f"wall={time.perf_counter() - t0:.3f}s engine={a.engine}")
    if res["missed"]:
        print("[acc] missed:", res["missed"])
    if res["spurious"]:
        print("[acc] spurious:", res["spurious"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
