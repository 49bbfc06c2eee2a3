"""Golden gates for the remaining input modes.

Counterpart of scripts/golden_modes.py, on this package's simdata, BAM
writer, BAI indexer, BGZF writer and tabix indexer. Each mode generates a
corpus that exercises one input path:

  multicontig  three contigs of different lengths in one FASTA + BAM
  multibam     reads split across two BAMs (k-way merge input)
  dbsnp        tabix-indexed dbSNP VCF wired to the ID column (--check-id)
  bed          BED targets with -P padding (WES mode)

``generate`` writes the same ``ref.fa``, BAM payloads, ``dbsnp.vcf`` and
``targets.bed`` as the script for the same seed, except multibam's split
(see ``_gen_multibam``). ``run_ours`` runs this package's HaplotypeCaller
into ``ours.vcf`` (on the card by default, ``--engine native`` or ``torch``
on the CPU); ``run_ref`` runs the reference binary into ``ref.vcf`` and
stops with one line without it; ``diff`` holds the two with
``golden_e2e.diff`` (IDs too for dbsnp). ``golden`` holds ``ours.vcf`` to
rovaca_tpu's xla VCF of the same corpus, committed in tests/golden_torch/
(``modes_<mode>.vcf.xz``), and for multibam also checks the merge property:
this package over {a.bam, b.bam} gives the records it gives over the
pre-merged sample.bam.

    python -m rovaca_tpu_torch.tools.golden_modes <mode|all> <workdir> [seed]
    python -m rovaca_tpu_torch.tools.golden_modes gen|ours|ref|diff|golden
        <mode|all> <workdir> [seed] [--engine auto|cuda|torch|native]

The first form is the script's: gen, ref, ours and diff for each mode in
``<workdir>/<mode>``; it needs the reference binary, as ``ref`` does.
"""

import argparse
import os
import sys
import zlib

import numpy as np

from . import golden_e2e, golden_flows

SEED = 20260821
MODES = ("multicontig", "multibam", "dbsnp", "bed")
REFERENCES = {m: f"modes_{m}.vcf.xz" for m in MODES}
MULTICONTIG = (("chrA", 90_000), ("chrB", 60_000), ("chrC", 40_000))
CONTIG_LEN = {"multibam": 120_000, "dbsnp": 120_000, "bed": 150_000}
BED_PADDING = 50


def _gen_contig(rng, length, contig, name_prefix):
    """(ref_str, reads, truth) for one contig (golden_e2e.generate model)."""
    from . import simdata
    ref = simdata.random_ref(rng, length)
    n_var = max(6, length // 2500)
    positions = np.sort(rng.choice(np.arange(500, length - 500),
                                   size=n_var, replace=False))
    keep = [positions[0]]
    for p in positions[1:]:
        if p - keep[-1] > 120:
            keep.append(p)
    truth = []
    for pos in keep:
        base = ref[pos]
        zyg = "het" if rng.random() < 0.6 else "hom"
        r = rng.random()
        if r < 0.65:
            alt = rng.choice([b for b in "ACGT" if b != base])
            var = (pos, base, str(alt))
        elif r < 0.85:
            ins = "".join(rng.choice(list("ACGT"),
                                     size=int(rng.integers(1, 7))))
            var = (pos, base, base + ins)
        else:
            dlen = int(rng.integers(1, 9))
            var = (pos, ref[pos:pos + dlen + 1], base)
        truth.append((var, zyg))
    hom_vars = sorted(v for v, z in truth if z == "hom")
    all_vars = sorted(v for v, z in truth)
    hap1 = simdata.apply_variants(ref, hom_vars)
    hap2 = simdata.apply_variants(ref, all_vars)
    n_frags = 30 * length // (2 * 100) // 2
    reads = (simdata.simulate_fragments(rng, ref, hap1, contig, n_frags,
                                        name_prefix=f"{name_prefix}h1_")
             + simdata.simulate_fragments(rng, ref, hap2, contig, n_frags,
                                          name_prefix=f"{name_prefix}h2_"))
    return ref, reads, truth


def _write_multi_bam(path, reads_by_contig, sample="NA12878",
                     read_groups=("rg1",), presorted=False):
    """Coordinate-sorted BAM over several contigs."""
    from ..io.bai import build_index
    from ..io.bam import BamHeader, BamWriter
    names = [c for c, _, _ in reads_by_contig]
    lens = [ln for _, ln, _ in reads_by_contig]
    rg_lines = "".join(f"@RG\tID:{rg}\tSM:{sample}\n" for rg in read_groups)
    sq = "".join(f"@SQ\tSN:{c}\tLN:{ln}\n" for c, ln in zip(names, lens))
    header = BamHeader(f"@HD\tVN:1.6\tSO:coordinate\n{sq}{rg_lines}",
                       names, lens)
    all_reads = []
    for tid, (contig, _ln, reads) in enumerate(reads_by_contig):
        for r in reads:
            r.ref_id = tid
            r.contig = contig
            if r.mate_ref_id != -1:
                r.mate_ref_id = tid
            r.tags.setdefault("RG", read_groups[0])
            all_reads.append(r)
    if not presorted:
        all_reads.sort(key=lambda r: (r.ref_id, r.pos))
    with BamWriter(path, header) as w:
        for r in all_reads:
            w.write(r)
    build_index(path)


def _write_fasta(path, contigs):
    with open(path, "w") as f:
        for name, seq in contigs:
            f.write(f">{name}\n")
            for i in range(0, len(seq), 70):
                f.write(seq[i:i + 70] + "\n")
    fai = []
    off = 0
    for name, seq in contigs:
        off += len(name) + 2
        n = len(seq)
        nl = -(-n // 70)
        fai.append(f"{name}\t{n}\t{off}\t70\t71\n")
        off += n + nl
    with open(path + ".fai", "w") as f:
        f.writelines(fai)


def _one_contig(workdir, rng, mode):
    """ref.fa and the generated (ref, reads, truth) of a one-contig mode;
    sample.bam is left to the mode."""
    length = CONTIG_LEN[mode]
    ref, reads, truth = _gen_contig(rng, length, "chr20", "")
    _write_fasta(os.path.join(workdir, "ref.fa"), [("chr20", ref)])
    return ref, reads, truth


def _gen_multicontig(workdir, rng):
    contigs, per_contig = [], []
    for name, ln in MULTICONTIG:
        ref, reads, _truth = _gen_contig(rng, ln, name, f"{name}_")
        contigs.append((name, ref))
        per_contig.append((name, ln, reads))
    _write_fasta(os.path.join(workdir, "ref.fa"), contigs)
    _write_multi_bam(os.path.join(workdir, "sample.bam"), per_contig)


def _gen_multibam(workdir, rng):
    """Fragments (both mates of a pair together, like per-lane BAMs) split
    over a.bam and b.bam, and sample.bam holding the same reads in the
    loader's merge order (pos, reverse, source file), which the reference
    binary reads: it opens only the first -I BAM (rovaca_tool.hpp:165-166).

    The split is the parity of the name's CRC-32. The script's
    ``hash(r.name) % 2`` is salted per process unless PYTHONHASHSEED is
    set, so its split, and every output made on it, changes from run to
    run; this one is the same in every process."""
    ln = CONTIG_LEN["multibam"]
    _ref, reads, _truth = _one_contig(workdir, rng, "multibam")
    a, b = [], []
    for r in reads:
        (b if zlib.crc32(r.name.encode()) % 2 else a).append(r)
    _write_multi_bam(os.path.join(workdir, "a.bam"), [("chr20", ln, a)])
    _write_multi_bam(os.path.join(workdir, "b.bam"), [("chr20", ln, b)])
    merged = sorted([(r, 0) for r in a] + [(r, 1) for r in b],
                    key=lambda t: (t[0].pos, t[0].is_reverse, t[1]))
    _write_multi_bam(os.path.join(workdir, "sample.bam"),
                     [("chr20", ln, [r for r, _ in merged])],
                     presorted=True)


def _gen_dbsnp(workdir, rng):
    """dbSNP rows at ~60% of truth sites (matching alleles), rows at the
    same position with another allele, and 40 decoys away from variants;
    bgzipped and tabix-indexed."""
    from ..io import bgzf, tabix
    ln = CONTIG_LEN["dbsnp"]
    ref, reads, truth = _one_contig(workdir, rng, "dbsnp")
    _write_multi_bam(os.path.join(workdir, "sample.bam"),
                     [("chr20", ln, reads)])
    lines = ["##fileformat=VCFv4.2",
             f"##contig=<ID=chr20,length={ln}>",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"]
    entries = []
    for i, ((pos, r_a, a_a), _zyg) in enumerate(truth):
        if rng.random() < 0.6:
            entries.append((pos + 1, f"rs{1000 + i}", r_a, a_a))
        if rng.random() < 0.3:
            alt2 = "ACGT"[(("ACGT".index(r_a[0]) + 2) % 4)]
            if alt2 != a_a:
                entries.append((pos + 1, f"rsX{i}", r_a[0], alt2))
    for k in range(40):
        p = int(rng.integers(1000, ln - 1000))
        entries.append((p, f"rsD{k}", ref[p - 1], "ACGT"[k % 4]))
    entries.sort()
    for pos1, rsid, r_a, a_a in entries:
        lines.append(f"chr20\t{pos1}\t{rsid}\t{r_a}\t{a_a}\t.\t.\t.")
    plain = os.path.join(workdir, "dbsnp.vcf")
    with open(plain, "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(plain, "rb") as fin, bgzf.Writer(plain + ".gz") as w:
        w.write(fin.read())
    tabix.build_index(plain + ".gz")


def _gen_bed(workdir, rng):
    """WES-style targets: a window around every other truth site, with
    random flanks that overlap once padded, and one empty target."""
    ln = CONTIG_LEN["bed"]
    _ref, reads, truth = _one_contig(workdir, rng, "bed")
    _write_multi_bam(os.path.join(workdir, "sample.bam"),
                     [("chr20", ln, reads)])
    ivals = [(5000, 5400)]
    for (pos, _r, _a), _zyg in truth[::2]:
        lo = max(0, pos - int(rng.integers(20, 120)))
        hi = min(ln, pos + int(rng.integers(20, 120)))
        ivals.append((lo, hi))
    ivals.sort()               # the reference requires sorted intervals
    with open(os.path.join(workdir, "targets.bed"), "w") as f:
        for lo, hi in ivals:
            f.write(f"chr20\t{lo}\t{hi}\n")


_GENERATORS = {"multicontig": _gen_multicontig, "multibam": _gen_multibam,
               "dbsnp": _gen_dbsnp, "bed": _gen_bed}


def generate(mode, workdir, seed=SEED):
    """Write ``mode``'s corpus for ``seed`` into ``workdir``."""
    os.makedirs(workdir, exist_ok=True)
    _GENERATORS[mode](workdir, np.random.default_rng(seed))
    print(f"generated mode {mode} (seed {seed}) -> {workdir}")


def bams(mode, workdir):
    """The BAMs this package reads for ``mode``."""
    names = ("a.bam", "b.bam") if mode == "multibam" else ("sample.bam",)
    return [os.path.join(workdir, n) for n in names]


def ours_flags(mode, workdir):
    """This package's flags of ``mode`` (besides -i, -r and -o)."""
    if mode == "dbsnp":
        return ["-d", os.path.join(workdir, "dbsnp.vcf.gz")]
    if mode == "bed":
        return ["-b", os.path.join(workdir, "targets.bed"),
                "-P", str(BED_PADDING)]
    return []


def ref_flags(mode, workdir):
    """The reference binary's flags of ``mode`` (it reads sample.bam)."""
    if mode == "dbsnp":
        return ["--dbsnp", os.path.join(workdir, "dbsnp.vcf.gz")]
    if mode == "bed":
        return ["-L", os.path.join(workdir, "targets.bed"),
                "-P", str(BED_PADDING)]
    return []


def run_ours(mode, workdir, engine="auto", out="ours.vcf", bam_paths=None,
             stats=None):
    """This package's HaplotypeCaller on ``mode``'s corpus (its BAMs, or
    ``bam_paths``) into ``workdir``/``out``, in process; ``stats`` receives
    the run's counters. Returns the output's path."""
    from .. import cli
    path = os.path.join(workdir, out)
    argv = (["HaplotypeCaller"]
            + [x for b in (bam_paths or bams(mode, workdir))
               for x in ("-i", b)]
            + ["-r", os.path.join(workdir, "ref.fa"), "-o", path,
               "--pairhmm-engine", engine, "--log-level", "WARNING"]
            + ours_flags(mode, workdir))
    rc = cli.main(argv, stats=stats)
    if rc not in (0, None):
        raise SystemExit(f"our CLI failed on mode {mode}: {rc}")
    return path


def run_ref(mode, workdir):
    """The reference binary on ``mode``'s corpus into ref.vcf; stops with
    one line without it."""
    golden_e2e.run_ref(workdir, extra=ref_flags(mode, workdir))


def diff(mode, workdir):
    """ours.vcf against ref.vcf in ``workdir`` (IDs too for dbsnp); 0 when
    they match."""
    return golden_e2e.diff(workdir, check_id=mode == "dbsnp")


def diff_committed(mode, workdir, ours="ours.vcf"):
    """``workdir``/``ours`` against rovaca_tpu's committed VCF of the mode,
    in ``workdir``/golden (IDs included); 0 when they match."""
    return golden_flows.diff_against(os.path.join(workdir, ours),
                                     REFERENCES[mode],
                                     os.path.join(workdir, "golden"), False)


def merge_problems(workdir, engine="auto", stats=None):
    """The merge property of multibam: this package over the pre-merged
    sample.bam into merged.vcf gives ours.vcf's records. [] when it
    holds."""
    merged = run_ours("multibam", workdir, engine, out="merged.vcf",
                      bam_paths=[os.path.join(workdir, "sample.bam")],
                      stats=stats)
    a = golden_flows._records(os.path.join(workdir, "ours.vcf"))
    b = golden_flows._records(merged)
    if a == b:
        return []
    return [f"multibam: {len(a)} records over a.bam + b.bam, {len(b)} over "
            f"sample.bam, {sum(x != y for x, y in zip(a, b))} differ"]


def corpus_key(mode):
    """MANIFEST.json's entry that pins ``mode``'s corpus."""
    return f"corpus_modes_{mode}"


def golden(mode, workdir, engine="auto"):
    """gen (unless ``workdir`` holds the corpus), the corpus's hashes
    against the manifest's, ours, and ours held to the committed reference
    (multibam: and the merge property). Returns the problems, [] when all
    hold."""
    if not os.path.exists(os.path.join(workdir, "ref.fa")):
        generate(mode, workdir)
    problems = golden_flows.corpus_problems(workdir, corpus_key(mode))
    if problems:
        return [f"{mode}: stale corpus: {problems}"]
    run_ours(mode, workdir, engine)
    if diff_committed(mode, workdir) != 0:
        problems.append(f"{mode}: diverges from {REFERENCES[mode]}")
    if mode == "multibam":
        problems += merge_problems(workdir, engine)
    return problems


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    script_form = bool(argv) and argv[0] in MODES + ("all",)
    if script_form:
        argv.insert(0, "all-steps")
    p = argparse.ArgumentParser(
        prog="python -m rovaca_tpu_torch.tools.golden_modes",
        description="corpora of the remaining input modes: generate, run "
                    "this package or the reference binary, diff; golden: "
                    "hold this package to rovaca_tpu's committed VCFs")
    p.add_argument("command", choices=["all-steps", "gen", "ours", "ref",
                                       "diff", "golden"])
    p.add_argument("mode", choices=MODES + ("all",))
    p.add_argument("workdir")
    p.add_argument("seed", nargs="?", type=int, default=SEED)
    p.add_argument("--engine", default="auto",
                   choices=["auto", "cuda", "torch", "native"])
    a = p.parse_args(argv)
    if a.command == "golden" and a.seed != SEED:
        p.error(f"the committed references are of seed {SEED}")
    names = list(MODES) if a.mode == "all" else [a.mode]
    if a.command in ("all-steps", "ref"):
        golden_e2e.require_binary()
    results = {}
    for name in names:
        d = os.path.join(a.workdir, name)
        if a.command in ("all-steps", "gen"):
            print(f"==== mode {name} ====", flush=True)
            generate(name, d, a.seed)
        if a.command in ("all-steps", "ref"):
            run_ref(name, d)
        if a.command in ("all-steps", "ours"):
            run_ours(name, d, a.engine)
        if a.command in ("all-steps", "diff"):
            results[name] = diff(name, d) == 0
        if a.command == "golden":
            problems = golden(name, d, a.engine)
            for line in problems:
                print(" ", line)
            results[name] = not problems
    if not results:
        return 0
    print({k: ("MATCH" if v else "DIVERGENT") for k, v in results.items()})
    return 0 if all(results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
