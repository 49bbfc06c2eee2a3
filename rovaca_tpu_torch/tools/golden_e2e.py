"""Corpus generation, the two callers' runs and the record-level VCF diff.

Counterpart of scripts/golden_e2e.py: ``generate`` writes a synthetic
diploid genome, a coordinate-sorted paired-end BAM with its .bai and the
truth list, byte for byte as scripts/golden_e2e.py does for the same seed;
``run_ours`` runs this package's CLI into ``ours.vcf`` (or ``ours.g.vcf``);
``run_ref`` runs the reference binary (REF_BIN, built by
refshim/build_harness.sh) into ``ref.vcf`` when it exists, and otherwise
stops with one line; ``diff`` holds ``ours.vcf`` to ``ref.vcf`` (or the
.g.vcf pair) in one directory.

    python -m rovaca_tpu_torch.tools.golden_e2e gen  <dir> [len] [cov] [seed]
    python -m rovaca_tpu_torch.tools.golden_e2e ours <dir> [--gvcf]
        [--engine auto|cuda|torch|native]
    python -m rovaca_tpu_torch.tools.golden_e2e ref  <dir> [--gvcf]
    python -m rovaca_tpu_torch.tools.golden_e2e diff <dir> [--gvcf]
        [--check-id]

``ours`` runs on the card by default (auto = cuda, which fails without
one); ``--engine native`` or ``torch`` runs on the CPU.

Comparison semantics (reference record model:
src/haplotypecaller/genotype/utils/adapter_utils.cpp:253-312):
  - keys: (contig, pos, ref, alts)
  - per shared key: GT (allele multiset), QUAL within tolerance, selected
    INFO (DP, MLEAC, MLEAF, MQ, QD, FS, SOR, rank sums) and FORMAT
    (GT:AD:DP:GQ:PL) values within numeric tolerance.
"""

import argparse
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REF_BIN = os.path.join(REPO, ".refbuild", "ref", "build-dev", "bin", "rovaca")

QUAL_TOL = 0.51          # QUAL is GATK-rounded to 2dp; allow rounding skew
FLOAT_TOL = 0.051        # INFO floats printed with %.3f-ish precision
PL_TOL = 1               # PLs are integers; allow off-by-one from rounding


# --------------------------------------------------------------------------
def generate(outdir, genome_len=200_000, coverage=30, seed=20260819):
    os.makedirs(outdir, exist_ok=True)
    from ..io.bai import build_index
    from . import simdata

    rng = np.random.default_rng(seed)
    contig = "chr20"
    ref = simdata.random_ref(rng, genome_len)

    # truth set: SNPs + indels, het/hom mix, spread over the genome
    n_var = max(8, genome_len // 2500)
    positions = np.sort(rng.choice(
        np.arange(500, genome_len - 500), size=n_var, replace=False))
    # enforce spacing so variants don't overlap
    keep = [positions[0]]
    for p in positions[1:]:
        if p - keep[-1] > 120:
            keep.append(p)
    truth = []
    for pos in keep:
        pos = int(pos)
        kind = rng.choice(["snp", "snp", "snp", "ins", "del"])
        zyg = rng.choice(["het", "hom"])
        base = ref[pos]
        if kind == "snp":
            alt = "ACGT"[("ACGT".index(base) + int(rng.integers(1, 4))) % 4]
            var = (pos, base, alt)
        elif kind == "ins":
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

    # paired-end error-model corpus: qual-correlated mismatches, indel
    # errors, low-qual tails, adapter read-through soft clips, duplicates,
    # secondary alignments, 2 read groups, MQ variation, downsampler
    # hotspots (see simdata.simulate_fragments)
    n_frags = coverage * genome_len // (2 * 100) // 2
    read_groups = ("rg1", "rg2")
    reads = (simdata.simulate_fragments(rng, ref, hap1, contig, n_frags,
                                        name_prefix="h1_",
                                        read_groups=read_groups)
             + simdata.simulate_fragments(rng, ref, hap2, contig, n_frags,
                                          name_prefix="h2_",
                                          read_groups=read_groups))

    fasta = os.path.join(outdir, "ref.fa")
    bam = os.path.join(outdir, "sample.bam")
    simdata.write_fasta(fasta, {contig: ref})
    simdata.write_test_bam(bam, reads, contig, genome_len,
                           read_groups=read_groups)
    build_index(bam)
    with open(os.path.join(outdir, "truth.txt"), "w") as f:
        for (pos, r, a), zyg in truth:
            f.write(f"{contig}\t{pos + 1}\t{r}\t{a}\t{zyg}\n")
    print(f"generated {genome_len}bp / {len(reads)} reads"
          f" / {len(truth)} truth variants -> {outdir}")


# --------------------------------------------------------------------------
def run_ours(outdir, gvcf=False, engine="auto"):
    """This package's HaplotypeCaller on ``outdir``'s corpus, in process."""
    from .. import cli
    out = os.path.join(outdir, "ours.g.vcf" if gvcf else "ours.vcf")
    argv = ["HaplotypeCaller",
            "-i", os.path.join(outdir, "sample.bam"),
            "-r", os.path.join(outdir, "ref.fa"),
            "-o", out, "--pairhmm-engine", engine]
    if gvcf:
        argv += ["-e", "GVCF"]
    rc = cli.main(argv)
    if rc not in (0, None):
        raise SystemExit(f"our CLI failed: {rc}")
    print("ours ->", out)


def ref_command(outdir, out, gvcf=False, extra=()):
    """(argv, env) of the reference binary on ``outdir``'s corpus, with the
    binary's flags ``extra`` appended."""
    cmd = [REF_BIN, "HaplotypeCaller",
           "-I", os.path.join(outdir, "sample.bam"),
           "-R", os.path.join(outdir, "ref.fa"),
           "-O", out,
           "--nthreads", "2"]
    if gvcf:
        cmd += ["--emit-ref-confidence", "GVCF"]
    cmd += list(extra)
    env = dict(os.environ)
    env["LD_LIBRARY_PATH"] = os.path.dirname(REF_BIN)
    return cmd, env


def require_binary(path=REF_BIN):
    """Stop with one line when a binary of .refbuild/ is missing: nothing
    else stands in for the reference."""
    if not os.path.exists(path):
        raise SystemExit(f"reference binary missing: {path} (build it with "
                         "refshim/build_harness.sh)")


def run_ref(outdir, gvcf=False, extra=()):
    """The reference binary on ``outdir``'s corpus into ref.vcf (or
    ref.g.vcf), with its flags ``extra``. Without the binary it stops with
    one line."""
    require_binary()
    out = os.path.join(outdir, "ref.g.vcf" if gvcf else "ref.vcf")
    cmd, env = ref_command(outdir, out, gvcf, extra)
    r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                       timeout=3600)
    sys.stderr.write(r.stderr[-4000:] if r.stderr else "")
    if r.returncode != 0:
        raise SystemExit(f"reference binary failed rc={r.returncode}\n"
                         f"{r.stdout[-2000:]}")
    print("ref ->", out)


# --------------------------------------------------------------------------
def parse_vcf(path):
    """-> dict key -> record dict."""
    records = {}
    order = []
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            cols = line.rstrip("\n").split("\t")
            chrom, pos, _id, ref, alt, qual, _flt, info = cols[:8]
            rec = {"chrom": chrom, "pos": int(pos), "ref": ref,
                   "alts": alt.split(","), "id": _id,
                   "qual": None if qual == "." else float(qual),
                   "info": {}, "fmt": {}}
            for kv in info.split(";"):
                if "=" in kv:
                    k, v = kv.split("=", 1)
                    rec["info"][k] = v
                elif kv and kv != ".":
                    rec["info"][kv] = True
            if len(cols) > 9:
                keys = cols[8].split(":")
                vals = cols[9].split(":")
                rec["fmt"] = dict(zip(keys, vals))
            key = (chrom, rec["pos"], ref, tuple(rec["alts"]))
            records[key] = rec
            order.append(key)
    return records, order


def _gt_multiset(gt, alts):
    if not gt or gt == ".":
        return None
    sep = "|" if "|" in gt else "/"
    return tuple(sorted(gt.split(sep)))


def _close(a, b, tol):
    try:
        return abs(float(a) - float(b)) <= tol
    except (TypeError, ValueError):
        return a == b


def _num_list_close(a, b, tol):
    xa, xb = str(a).split(","), str(b).split(",")
    if len(xa) != len(xb):
        return False
    return all(_close(u, v, tol) for u, v in zip(xa, xb))


def diff(outdir, gvcf=False, check_id=False):
    ours_path = os.path.join(outdir, "ours.g.vcf" if gvcf else "ours.vcf")
    ref_path = os.path.join(outdir, "ref.g.vcf" if gvcf else "ref.vcf")
    ours, ours_order = parse_vcf(ours_path)
    ref, ref_order = parse_vcf(ref_path)

    # GVCF: variant rows compared field-exactly; hom-ref band rows compared
    # EXACTLY on (pos, END, GT, GQ, DP, MIN_DP, PL) — block_combiner.cpp
    # semantics. No rows are filtered.
    def is_variant_row(rec):
        return rec["alts"][0] != "<NON_REF>"

    band_mismatches = []
    if gvcf:
        ours_v = {k: v for k, v in ours.items() if is_variant_row(v)}
        ref_v = {k: v for k, v in ref.items() if is_variant_row(v)}
        ours_b = {(v["chrom"], v["pos"]): v
                  for v in ours.values() if not is_variant_row(v)}
        ref_b = {(v["chrom"], v["pos"]): v
                 for v in ref.values() if not is_variant_row(v)}
        for k in sorted(set(ours_b) - set(ref_b)):
            band_mismatches.append((k, ["band row only in OURS"]))
        for k in sorted(set(ref_b) - set(ours_b)):
            band_mismatches.append((k, ["band row only in REF"]))
        for k in sorted(set(ours_b) & set(ref_b)):
            a, b = ours_b[k], ref_b[k]
            msgs = []
            if a["ref"] != b["ref"]:
                msgs.append(f"band REF {a['ref']} vs {b['ref']}")
            ea = a["info"].get("END", str(a["pos"]))
            eb = b["info"].get("END", str(b["pos"]))
            if str(ea) != str(eb):
                msgs.append(f"band END {ea} vs {eb}")
            for f in ("GT", "GQ", "DP", "MIN_DP", "PL"):
                va, vb = a["fmt"].get(f), b["fmt"].get(f)
                if va != vb:
                    msgs.append(f"band FMT/{f} {va} vs {vb}")
            if msgs:
                band_mismatches.append((k, msgs))
    else:
        ours_v, ref_v = ours, ref

    only_ours = sorted(set(ours_v) - set(ref_v))
    only_ref = sorted(set(ref_v) - set(ours_v))
    mismatches = []
    info_checked = ["DP", "MLEAC", "MLEAF", "MQ", "QD", "FS", "SOR",
                    "MQRankSum", "ReadPosRankSum", "BaseQRankSum",
                    "ExcessHet", "AC", "AF", "AN"]
    for key in sorted(set(ours_v) & set(ref_v)):
        a, b = ours_v[key], ref_v[key]
        msgs = []
        ga = _gt_multiset(a["fmt"].get("GT"), a["alts"])
        gb = _gt_multiset(b["fmt"].get("GT"), b["alts"])
        if ga != gb:
            msgs.append(f"GT {ga} vs {gb}")
        if check_id and a.get("id") != b.get("id"):
            msgs.append(f"ID {a.get('id')} vs {b.get('id')}")
        if a["qual"] is not None and b["qual"] is not None and \
                not _close(a["qual"], b["qual"], QUAL_TOL):
            msgs.append(f"QUAL {a['qual']} vs {b['qual']}")
        for k in info_checked:
            va, vb = a["info"].get(k), b["info"].get(k)
            if va is None and vb is None:
                continue
            if va is None or vb is None or \
                    not _num_list_close(va, vb, FLOAT_TOL):
                msgs.append(f"INFO/{k} {va} vs {vb}")
        for k in ("AD", "DP", "GQ"):
            va, vb = a["fmt"].get(k), b["fmt"].get(k)
            if va != vb and not (va and vb and _num_list_close(va, vb, 0)):
                msgs.append(f"FMT/{k} {va} vs {vb}")
        va, vb = a["fmt"].get("PL"), b["fmt"].get("PL")
        if va != vb and not (va and vb and _num_list_close(va, vb, PL_TOL)):
            msgs.append(f"FMT/PL {va} vs {vb}")
        if msgs:
            mismatches.append((key, msgs))

    n_shared = len(set(ours_v) & set(ref_v))
    print(f"shared sites: {n_shared}; ours-only: {len(only_ours)}; "
          f"ref-only: {len(only_ref)}; field mismatches: {len(mismatches)}")
    if gvcf:
        print(f"band rows: ours={sum(not is_variant_row(v) for v in ours.values())} "
              f"ref={sum(not is_variant_row(v) for v in ref.values())}; "
              f"band mismatches: {len(band_mismatches)}")
    for key in only_ours[:20]:
        print("  OURS-ONLY", key)
    for key in only_ref[:20]:
        print("  REF-ONLY ", key)
    for key, msgs in mismatches[:40]:
        print("  DIFF", key, "; ".join(msgs))
    for key, msgs in band_mismatches[:40]:
        print("  BAND-DIFF", key, "; ".join(msgs))
    ok = (not only_ours and not only_ref and not mismatches
          and not band_mismatches)
    print("RESULT:", "MATCH" if ok else "DIVERGENT")
    return 0 if ok else 1


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m rovaca_tpu_torch.tools.golden_e2e",
        description="generate a corpus, run either caller on it, diff "
                    "their outputs")
    p.add_argument("command", choices=["gen", "ours", "ref", "diff"])
    p.add_argument("dir")
    p.add_argument("numbers", nargs="*", type=int,
                   help="gen: genome_len coverage seed")
    p.add_argument("--gvcf", action="store_true")
    p.add_argument("--engine", default="auto",
                   choices=["auto", "cuda", "torch", "native"])
    p.add_argument("--check-id", action="store_true")
    a = p.parse_args(argv)
    if a.command == "gen":
        generate(a.dir, *a.numbers)
    elif a.command == "ours":
        run_ours(a.dir, a.gvcf, a.engine)
    elif a.command == "ref":
        run_ref(a.dir, a.gvcf)
    else:
        return diff(a.dir, a.gvcf, check_id=a.check_id)
    return 0


if __name__ == "__main__":
    sys.exit(main())
