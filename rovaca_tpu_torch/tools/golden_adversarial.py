"""Adversarial golden corpus: sequence contexts that break naive callers.

Counterpart of scripts/golden_adversarial.py, on this package's simdata,
BAM writer, BAI indexer and FASTA writer: ``generate`` gives the same
``ref.fa``, BAM payload and ``truth.txt`` as ``scripts/golden_adversarial.py
gen`` for the same seed. Every earlier corpus draws its reference uniformly
at random, which under-represents the contexts the PCR indel model and the
assembler exist for. This one plants, on three contigs of 150 kb at 30x:

  - homopolymer runs of 10-24 bp with het/hom stutter indels inside them
  - short-tandem-repeat expansions (2-6 bp unit x 5-15 copies) with
    +/- one-unit indel variants
  - SNP clusters within 20 bp of indels
  - reference N-gaps (50-300 bp) with variants near their edges
  - variants near the contig edges

rovaca_tpu's ``--pairhmm-engine xla`` VCF and GVCF of the seed-20260505
corpus are committed in tests/golden_torch/ (``adversarial.vcf.xz``,
``adversarial.g.vcf.xz``); the corpus itself is not, only its hashes
(``MANIFEST.json``'s ``corpus_adversarial``).

    python -m rovaca_tpu_torch.tools.golden_adversarial gen  <dir> [seed]
    python -m rovaca_tpu_torch.tools.golden_adversarial ours <dir> [--gvcf]
        [--engine auto|cuda|torch|native]
    python -m rovaca_tpu_torch.tools.golden_adversarial diff <dir> [--gvcf]
    python -m rovaca_tpu_torch.tools.golden_adversarial run  <dir>
    python -m rovaca_tpu_torch.tools.golden_adversarial all  <dir> [seed]

``gen`` writes the corpus and says whether its hashes are the manifest's;
``ours`` runs this package's HaplotypeCaller into ``ours.vcf`` (or
``ours.g.vcf``; on the card by default, ``--engine native`` or ``torch``
on the CPU); ``diff`` holds that output to the committed reference with
``golden_e2e.diff``, GVCF band rows exactly. ``run`` (ref, ours and diff in
both modes) and ``all`` (gen, then run) hold this package to the reference
binary under ``.refbuild/``, and stop with one line without it.
"""

import argparse
import os
import sys

import numpy as np

from . import golden_e2e, golden_flows

CONTIGS = ("chr20", "chr21", "chr22")
CONTIG_LEN = 150_000
COVERAGE = 30
SEED = golden_flows.CORPUS_ADVERSARIAL["seed"]
REFERENCES = {False: "adversarial.vcf.xz", True: "adversarial.g.vcf.xz"}


def _plant_adversarial_ref(rng, length):
    """Reference with homopolymers, STRs, and N-gaps planted on a random
    backbone. Returns (ref_string, feature list [(kind, start, end, unit)])."""
    from . import simdata
    ref = list(simdata.random_ref(rng, length))
    feats = []
    cursor = 2000
    while cursor < length - 3000:
        kind = rng.choice(["homopoly", "str", "ngap", "plain"],
                          p=[0.3, 0.35, 0.1, 0.25])
        if kind == "homopoly":
            run = int(rng.integers(10, 25))
            base = rng.choice(list("ACGT"))
            ref[cursor:cursor + run] = base * run
            feats.append(("homopoly", cursor, cursor + run, base))
            cursor += run
        elif kind == "str":
            unit = "".join(rng.choice(list("ACGT"),
                                      size=int(rng.integers(2, 7))))
            reps = int(rng.integers(5, 16))
            s = unit * reps
            ref[cursor:cursor + len(s)] = s
            feats.append(("str", cursor, cursor + len(s), unit))
            cursor += len(s)
        elif kind == "ngap":
            run = int(rng.integers(50, 300))
            ref[cursor:cursor + run] = "N" * run
            feats.append(("ngap", cursor, cursor + run, "N"))
            cursor += run
        cursor += int(rng.integers(800, 2500))
    return "".join(ref[:length]), feats


def _truth_for(rng, ref, feats):
    """Truth variants targeting the planted features + SNP clusters near
    indels. Returns sorted [(pos, ref_allele, alt_allele, zyg)]."""
    truth = []
    used = []

    def clashes(pos, span=150):
        return any(abs(pos - u) < span for u in used)

    def addvar(pos, ra, aa, zyg):
        if ra == aa or "N" in ra or "N" in aa or not ra or not aa:
            return False
        if clashes(pos):
            return False
        truth.append((pos, ra, aa, zyg))
        used.append(pos)
        return True

    for kind, s, e, unit in feats:
        zyg = rng.choice(["het", "hom"])
        if kind == "homopoly" and rng.random() < 0.75:
            # stutter: +/-1 base inside the run (anchored at run start - 1)
            a = s - 1
            if rng.random() < 0.5:
                addvar(a, ref[a], ref[a] + unit, zyg)          # insertion
            else:
                addvar(a, ref[a:a + 2], ref[a], zyg)           # deletion
        elif kind == "str" and rng.random() < 0.75:
            a = s - 1
            if rng.random() < 0.5:
                addvar(a, ref[a], ref[a] + unit, zyg)          # +1 unit
            else:
                addvar(a, ref[a:a + len(unit) + 1], ref[a], zyg)  # -1 unit
        elif kind == "ngap" and rng.random() < 0.6:
            # SNP just outside the N-gap edge
            for edge in (s - int(rng.integers(3, 20)),
                         e + int(rng.integers(2, 20))):
                base = ref[edge]
                if base != "N":
                    alt = "ACGT"[("ACGT".index(base) + 1) % 4]
                    addvar(edge, base, alt, rng.choice(["het", "hom"]))
                    break

    # SNP clusters within 20bp of a fresh indel, in plain sequence
    for _ in range(len(ref) // 12_000):
        p = int(rng.integers(1500, len(ref) - 1500))
        if clashes(p, 250) or "N" in ref[p - 30:p + 30]:
            continue
        zyg = rng.choice(["het", "hom"])
        dlen = int(rng.integers(1, 5))
        if not addvar(p, ref[p:p + dlen + 1], ref[p], zyg):
            continue
        # cluster SNPs on the same haplotype within 20bp
        for off in (-int(rng.integers(5, 20)), int(rng.integers(dlen + 2,
                                                                20))):
            q = p + off
            base = ref[q]
            if base != "N":
                alt = "ACGT"[("ACGT".index(base) + 2) % 4]
                if not any(abs(q - u) < max(2, dlen + 1) for u in used):
                    truth.append((q, base, alt, zyg))
                    used.append(q)

    # near-contig-edge variants (first/last 600bp)
    for p in (int(rng.integers(150, 450)),
              int(len(ref) - rng.integers(150, 450))):
        base = ref[p]
        if base != "N" and not clashes(p):
            addvar(p, base, "ACGT"[("ACGT".index(base) + 3) % 4],
                   rng.choice(["het", "hom"]))

    # drop overlapping truth (sort + sweep)
    truth.sort()
    out = []
    prev_end = -10
    for pos, ra, aa, zyg in truth:
        if pos <= prev_end + 1:
            continue
        out.append((pos, ra, aa, zyg))
        prev_end = pos + len(ra)
    return out


def generate(outdir, seed=SEED):
    """Write ref.fa (+ .fai), sample.bam (+ .bai) and truth.txt of the
    corpus of ``seed`` into ``outdir``."""
    from ..io.bai import build_index
    from ..io.bam import BamHeader, BamWriter
    from ..io.fasta import write_fasta
    from . import simdata

    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    refs = {}
    all_reads = []
    truth_lines = []
    read_groups = ("rg1", "rg2")
    for ci, contig in enumerate(CONTIGS):
        ref, feats = _plant_adversarial_ref(rng, CONTIG_LEN)
        truth = _truth_for(rng, ref, feats)
        refs[contig] = ref
        hom = sorted((p, r, a) for p, r, a, z in truth if z == "hom")
        al = sorted((p, r, a) for p, r, a, z in truth)
        hap1 = simdata.apply_variants(ref, hom)
        hap2 = simdata.apply_variants(ref, al)
        n_frags = COVERAGE * CONTIG_LEN // (2 * 100) // 2
        for hap, pref in ((hap1, "h1_"), (hap2, "h2_")):
            reads = simdata.simulate_fragments(
                rng, ref, hap, contig, n_frags,
                name_prefix=f"{contig}_{pref}", read_groups=read_groups)
            # the reference binary's overlapping-pair qname cache compares
            # names with the assembly graph's fixed-width kmer equality, so
            # long shared name prefixes collide it: the unique fragment id
            # goes first
            rename = {}
            for r in reads:
                if r.name not in rename:
                    rename[r.name] = f"f{len(rename)}c{ci}{pref}"
                r.name = rename[r.name]
            for r in reads:
                r.ref_id = ci
                if r.mate_ref_id == 0:      # the mate stays on this contig
                    r.mate_ref_id = ci
            all_reads.extend(reads)
        for p, r, a, z in truth:
            truth_lines.append(f"{contig}\t{p + 1}\t{r}\t{a}\t{z}\n")

    write_fasta(os.path.join(outdir, "ref.fa"), refs)
    rg = "".join(f"@RG\tID:{g}\tSM:NA12878\n" for g in read_groups)
    sq = "".join(f"@SQ\tSN:{c}\tLN:{CONTIG_LEN}\n" for c in CONTIGS)
    header = BamHeader("@HD\tVN:1.6\tSO:coordinate\n" + sq + rg,
                       list(CONTIGS), [CONTIG_LEN] * len(CONTIGS))
    all_reads.sort(key=lambda r: (r.ref_id, r.pos))
    bam = os.path.join(outdir, "sample.bam")
    with BamWriter(bam, header) as w:
        for r in all_reads:
            r.tags.setdefault("RG", read_groups[0])
            w.write(r)
    build_index(bam)
    with open(os.path.join(outdir, "truth.txt"), "w") as f:
        f.writelines(truth_lines)
    print(f"adversarial corpus: {len(CONTIGS)} contigs x {CONTIG_LEN}bp, "
          f"{len(all_reads)} reads, {len(truth_lines)} truth variants "
          f"-> {outdir}")


def diff(outdir, gvcf=False):
    """``outdir``'s ours.vcf (or ours.g.vcf) against rovaca_tpu's committed
    reference, in ``outdir``; 0 when they match."""
    ours = os.path.join(outdir, "ours.g.vcf" if gvcf else "ours.vcf")
    return golden_flows.diff_against(ours, REFERENCES[gvcf], outdir, gvcf)


def run_gates(outdir):
    """The reference binary and this package on ``outdir``'s corpus in VCF
    and GVCF mode, each pair diffed; True when both match."""
    ok = True
    for gvcf in (False, True):
        golden_e2e.run_ref(outdir, gvcf)
        golden_e2e.run_ours(outdir, gvcf)
        ok = golden_e2e.diff(outdir, gvcf) == 0 and ok
    print("ADVERSARIAL:", "ALL MATCH" if ok else "DIVERGENT")
    return ok


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m rovaca_tpu_torch.tools.golden_adversarial",
        description="generate the adversarial corpus, run this package on "
                    "it, hold it to rovaca_tpu's committed outputs or to "
                    "the reference binary")
    p.add_argument("command", choices=["gen", "ours", "diff", "run", "all"])
    p.add_argument("dir")
    p.add_argument("seed", nargs="?", type=int, default=SEED)
    p.add_argument("--gvcf", action="store_true")
    p.add_argument("--engine", default="auto",
                   choices=["auto", "cuda", "torch", "native"])
    a = p.parse_args(argv)
    if a.command in ("run", "all"):
        golden_e2e.require_binary()
    if a.command in ("gen", "all"):
        generate(a.dir, a.seed)
        if a.seed == SEED:
            stale = golden_flows.corpus_problems(a.dir, "corpus_adversarial")
            print("hashes: " + ("; ".join(stale) if stale else
                                "ref.fa, BAM payload and truth.txt equal "
                                "MANIFEST.json's"))
    if a.command == "ours":
        golden_e2e.run_ours(a.dir, a.gvcf, a.engine)
    elif a.command == "diff":
        return diff(a.dir, a.gvcf)
    elif a.command in ("run", "all"):
        return 0 if run_gates(a.dir) else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
