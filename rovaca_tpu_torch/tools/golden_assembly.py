"""Cross-implementation assembly golden diff.

Counterpart of scripts/golden_assembly.py on this package's records and
assembler. ``build_corpus`` makes a diverse corpus of active-region test
cases in the reference's serialized format
(apply/test/assemble_testcase_iterator.h: a ``contig\\tbeg\\tend\\tn`` line,
n SAM read lines, one region-reference line); ``assemble_ours`` runs this
package's assembly path over one (finalize -> overlapping-pair quals ->
read-threading graph over kmers {10,25} -> K-best -> SW cigar) and
``run_ours`` writes the results in the reference FakeAssembler's output
format (apply/test/fake_assembler.cpp:80-92): per case
``chr1:beg-end\\treads: N``, ``haplotypes: K``, K lexicographically sorted
haplotype strings, blank line. ``golden`` holds ``assemble_ours`` to the
reference binary's committed output on tests/golden/'s 80 regions.

    python -m rovaca_tpu_torch.tools.golden_assembly gen  <dir>
    python -m rovaca_tpu_torch.tools.golden_assembly ours <dir>
    python -m rovaca_tpu_torch.tools.golden_assembly ref  <dir>
    python -m rovaca_tpu_torch.tools.golden_assembly diff <dir>
    python -m rovaca_tpu_torch.tools.golden_assembly golden

``gen`` writes cases.txt and ref.txt (the files scripts/golden_assembly.py
gen writes, byte for byte; the committed tests/golden/assembly_cases.txt
was frozen from an earlier version of the generator and is not rewritten);
``ours`` writes result_ours.txt; ``ref`` runs the reference harness
(REF_BIN, built by refshim/build_harness.sh) into result_ref.txt, and
without it stops with one line; ``diff`` compares the two results.
"""

import argparse
import os
import subprocess
import sys

import numpy as np

from ..assembly import assembler
from ..reads.record import ReadRecord

REGION_PAD = 100  # k_default_region_padding, fake_assembler.cpp:22
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GOLDEN = os.path.join(REPO, "tests", "golden")
REF_BIN = os.path.join(REPO, ".refbuild", "bin", "assembler_test")


# --------------------------------------------------------------------------
# corpus generation
# --------------------------------------------------------------------------

def _rand_seq(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


def _plant(rng, ref, pos, kind):
    """Return (variant_tuple, human_label) for the given kind at pos."""
    base = ref[pos]
    if kind == "snp":
        alt = rng.choice([b for b in "ACGT" if b != base])
        return (pos, base, alt)
    if kind == "ins":
        ins = _rand_seq(rng, int(rng.integers(1, 16)))
        return (pos, base, base + ins)
    if kind == "del":
        dlen = int(rng.integers(1, 21))
        return (pos, ref[pos:pos + dlen + 1], base)
    raise ValueError(kind)


def _pair_reads(rng, hap, hap2ref_off, contig, n_pairs, read_len, qual_lo,
                qual_hi, lo, hi, prefix):
    """FR read pairs sampled from hap; positions mapped by simple offset
    (haplotype == ref shifted), so CIGARs come from our SW like simdata."""
    from . import simdata
    reads = []
    for i in range(n_pairs):
        frag = int(rng.integers(read_len + 10, read_len * 2 + 60))
        s = int(rng.integers(lo, max(lo + 1, hi - frag)))
        r1 = simdata.simulate_reads(
            rng, hap2ref_off, hap, contig, 1, read_len=read_len,
            qual=int(rng.integers(qual_lo, qual_hi)),
            name_prefix=f"{prefix}p{i}_", start=s, end=s + read_len + 1)
        r2 = simdata.simulate_reads(
            rng, hap2ref_off, hap, contig, 1, read_len=read_len,
            qual=int(rng.integers(qual_lo, qual_hi)),
            name_prefix=f"{prefix}p{i}_", start=max(lo, s + frag - read_len),
            end=min(hi, s + frag - read_len + read_len + 1))
        if not r1 or not r2:
            continue
        a, b = r1[0], r2[0]
        b = b.copy(name=a.name, flag=0x1 | 0x2 | 0x10 | 0x80,
                   mate_pos=a.pos, tlen=-(b.end - a.pos))
        a = a.copy(flag=0x1 | 0x2 | 0x20 | 0x40, mate_pos=b.pos,
                   tlen=b.end - a.pos)
        reads.extend([a, b])
    return reads


def build_corpus(seed=20260818, contig="chr1", ref_len=125000):
    """Returns (ref_string, list[(beg, end, reads)]) with ~80 varied cases."""
    from . import simdata
    rng = np.random.default_rng(seed)
    ref = _rand_seq(rng, ref_len)

    # plant STR tracts so indel cases land in repeats sometimes
    refl = list(ref)
    for _ in range(30):
        unit = _rand_seq(rng, int(rng.integers(1, 5)))
        reps = int(rng.integers(4, 10))
        at = int(rng.integers(500, ref_len - 500))
        tract = (unit * reps)[:40]
        refl[at:at + len(tract)] = tract
    ref = "".join(refl)

    cases = []
    center = 1000
    ci = 0
    while center < ref_len - 1000 and len(cases) < 80:
        ci += 1
        scenario = ci % 14
        span = int(rng.integers(60, 301))
        beg = center - span // 2
        end = beg + span - 1
        lo, hi = beg - 250, end + 250
        n_extra_unpaired = 3

        variants = []
        if scenario == 0:       # isolated het SNP
            variants = [_plant(rng, ref, center, "snp")]
        elif scenario == 1:     # hom SNP
            variants = [_plant(rng, ref, center, "snp")]
        elif scenario == 2:     # het insertion
            variants = [_plant(rng, ref, center, "ins")]
        elif scenario == 3:     # het deletion
            variants = [_plant(rng, ref, center, "del")]
        elif scenario == 4:     # dense SNP cluster
            variants = [_plant(rng, ref, center + off, "snp")
                        for off in (0, 7, 15, 40)]
        elif scenario == 5:     # SNP + nearby indel
            variants = sorted(
                [_plant(rng, ref, center, "snp"),
                 _plant(rng, ref, center + 30,
                        "del" if ci % 2 else "ins")])
        elif scenario == 6:     # ref-only (no variant): 1-hap case
            variants = []
        # scenario 7: multi-allelic site (built below)
        elif scenario == 8:     # variant at the active-span edge
            variants = [_plant(rng, ref, beg + (0 if ci % 2 else span - 1),
                               "snp")]
        elif scenario == 9:     # STR contraction: delete one unit of a
            # planted tract right at center
            unit = _rand_seq(rng, int(rng.integers(2, 5)))
            tract = unit * 8
            ref = ref[:center] + tract + ref[center + len(tract):]
            variants = [(center - 1, ref[center - 1] + unit,
                         ref[center - 1])]
        elif scenario == 10:    # STR expansion: insert one unit
            unit = _rand_seq(rng, int(rng.integers(2, 5)))
            tract = unit * 8
            ref = ref[:center] + tract + ref[center + len(tract):]
            variants = [(center - 1, ref[center - 1],
                         ref[center - 1] + unit)]
        elif scenario == 11:    # ultra-low coverage het SNP
            variants = [_plant(rng, ref, center, "snp")]
        elif scenario == 12:    # haplotype explosion: 8 het SNPs -> 2^8
            # graph paths; exercises the collect-129 dijkstra cap
            variants = [_plant(rng, ref, center + off, "snp")
                        for off in range(0, 96, 12)]
            span = max(span, 140)
            end = beg + span - 1
        elif scenario == 13:    # long repeat -> non-unique kmers, retries
            unit = _rand_seq(rng, 6)
            tract = (unit * 12)[:60]
            ref = ref[:center - 30] + tract + ref[center - 30 + len(tract):]
            variants = [_plant(rng, ref, center + 50, "snp")]

        alt1 = simdata.apply_variants(ref, variants)
        if scenario == 7:
            v1 = _plant(rng, ref, center, "snp")
            alts = [b for b in "ACGT" if b != ref[center] and b != v1[2]]
            v2 = (center, ref[center], alts[0])
            alt1 = simdata.apply_variants(ref, [v1])
            alt2 = simdata.apply_variants(ref, [v2])
        elif scenario == 12:
            # second haplotype carries a random subset of the SNP cluster,
            # and reads sampled from both sprinkle partial support
            sub = [v for v in variants if rng.random() < 0.5]
            alt2 = simdata.apply_variants(ref, sub)
        else:
            alt2 = ref if scenario != 1 else alt1  # hom: both copies alt

        cov_pairs = (2 if scenario == 11
                     else int(rng.integers(20, 35)) if scenario == 12
                     else int(rng.integers(8, 22)))
        qual_band = (30, 40) if ci % 3 else (12, 38)  # some low-qual tails
        reads = []
        reads += _pair_reads(rng, alt1, ref, contig, cov_pairs, 100,
                             *qual_band, lo, hi, prefix=f"c{ci}a")
        reads += _pair_reads(rng, alt2, ref, contig, cov_pairs, 100,
                             *qual_band, lo, hi, prefix=f"c{ci}b")
        # sprinkle a couple of unpaired reads too
        reads += simdata.simulate_reads(
            rng, ref, alt1, contig, n_extra_unpaired, read_len=100, qual=35,
            name_prefix=f"c{ci}s", start=lo, end=hi)
        if scenario == 4:
            # N bases with qual 2 in a few reads (kmer-skip path)
            for r in reads[:4]:
                b = bytearray(r.bases if isinstance(r.bases, bytes)
                              else r.bases.encode())
                q = np.array(r.quals)
                at = len(b) // 2
                b[at] = ord("N")
                q[at] = 2
                reads[reads.index(r)] = r.copy(bases=bytes(b), quals=q)
        # keep only reads overlapping the padded span, coordinate-sorted
        ps, pe = beg - REGION_PAD, end + REGION_PAD
        reads = [r for r in reads if r.pos <= pe and r.end - 1 >= ps]
        reads.sort(key=lambda r: r.pos)
        if len(reads) >= 4:
            cases.append((beg, end, reads))
        center += int(rng.integers(1200, 1700))
    return ref, cases


# --------------------------------------------------------------------------
# serialization (the reference harness's case format)
# --------------------------------------------------------------------------

def sam_line(r, contig):
    qual = "".join(chr(int(q) + 33) for q in r.quals)
    bases = r.bases.decode() if isinstance(r.bases, bytes) else r.bases
    rnext = "=" if r.mate_pos >= 0 else "*"
    pnext = r.mate_pos + 1 if r.mate_pos >= 0 else 0
    return (f"{r.name}\t{r.flag}\t{contig}\t{r.pos + 1}\t"
            f"{r.mapping_quality}\t{r.cigar}\t{rnext}\t{pnext}\t{r.tlen}\t"
            f"{bases}\t{qual}")


def parse_sam_line(line, contig="chr1"):
    """One SAM line of a case file -> this package's ReadRecord (a
    rovaca_tpu record would fail here: class identity)."""
    f = line.rstrip("\n").split("\t")
    quals = np.frombuffer(f[10].encode(), dtype=np.uint8).astype(np.int64) \
        - 33
    mate_pos = int(f[7]) - 1 if f[6] != "*" else -1
    return ReadRecord(name=f[0], flag=int(f[1]), ref_id=0, pos=int(f[3]) - 1,
                      mapping_quality=int(f[4]), cigar=f[5], bases=f[9],
                      quals=quals, mate_pos=mate_pos, tlen=int(f[8]),
                      mate_ref_id=0 if f[6] != "*" else -1,
                      contig=contig)


def write_cases(outdir, ref, cases, contig="chr1"):
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "ref.txt"), "w") as fh:
        fh.write(ref + "\n")
    with open(os.path.join(outdir, "cases.txt"), "w") as fh:
        for beg, end, reads in cases:
            fh.write(f"{contig}\t{beg}\t{end}\t{len(reads)}\n")
            for r in reads:
                fh.write(sam_line(r, contig) + "\n")
            fh.write(ref[beg - REGION_PAD:end + REGION_PAD + 1] + "\n")


def read_case_files(cases_path, ref_path):
    """(ref, [(beg, end, reads)]) of a case file and its reference file."""
    with open(ref_path) as fh:
        ref = fh.readline().rstrip("\n")
    cases = []
    with open(cases_path) as fh:
        while True:
            head = fh.readline()
            if not head.strip():
                break
            c, beg, end, n = head.split("\t")
            reads = [parse_sam_line(fh.readline(), c) for _ in range(int(n))]
            fh.readline()  # region ref slice (unused, like FakeAssembler)
            cases.append((int(beg), int(end), reads))
    return ref, cases


def read_cases(outdir):
    return read_case_files(os.path.join(outdir, "cases.txt"),
                           os.path.join(outdir, "ref.txt"))


def golden_cases():
    """The committed 80-region corpus of tests/golden/."""
    return read_case_files(os.path.join(GOLDEN, "assembly_cases.txt"),
                           os.path.join(GOLDEN, "assembly_ref.txt"))


# --------------------------------------------------------------------------
# our side
# --------------------------------------------------------------------------

def finalize_case(beg, end, reads):
    """FakeAssembler's read preparation: (padded span start, end, reads
    finalized to it with overlapping-pair quals adjusted).

    Case-file beg/end are 1-based inclusive (GATK convention: the
    reference binary's padded window for beg B starts at 0-based
    B-100-1); our pipeline is 0-based throughout."""
    ps, pe = (beg - 1) - REGION_PAD, (end - 1) + REGION_PAD
    fin = assembler.finalize_region_reads(reads, ps, pe)
    assembler.adjust_overlapping_pair_quals(fin)
    return ps, pe, fin


def assemble_case(ref, beg, end, reads):
    """(finalized reads, haplotypes) of one case, as FakeAssembler::run
    assembles it: kmers {10,25} (+10 retries) on the padded window."""
    ps, pe, fin = finalize_case(beg, end, reads)
    return fin, assembler.assemble_region(fin, ref[ps:pe + 1].encode(), ps)


def assemble_ours(ref, beg, end, reads):
    """(n_reads_after_finalize, sorted haplotype strings) of one case."""
    fin, haps = assemble_case(ref, beg, end, reads)
    return len(fin), sorted(h.bases.decode() for h in haps)


def run_ours(outdir, contig="chr1"):
    ref, cases = read_cases(outdir)
    with open(os.path.join(outdir, "result_ours.txt"), "w") as fh:
        for beg, end, reads in cases:
            n, seqs = assemble_ours(ref, beg, end, reads)
            fh.write(f"{contig}:{beg}-{end}\treads: {n}\n")
            fh.write(f"haplotypes: {len(seqs)}\n")
            for s in seqs:
                fh.write(s + "\n")
            fh.write("\n")


def run_ref(outdir):
    """The reference's FakeAssembler harness on ``outdir``'s cases into
    result_ref.txt. Without the binary it stops with one line: nothing
    else stands in for it."""
    if not os.path.exists(REF_BIN):
        raise SystemExit(f"reference binary missing: {REF_BIN} (build it "
                         "with refshim/build_harness.sh)")
    r = subprocess.run([REF_BIN, os.path.join(outdir, "cases.txt"),
                        os.path.join(outdir, "ref.txt"),
                        os.path.join(outdir, "result_ref.txt")],
                       capture_output=True, text=True, timeout=3600)
    if r.returncode != 0:
        raise SystemExit(f"reference binary failed rc={r.returncode}: "
                         f"{r.stderr.strip()[-2000:]}")


# --------------------------------------------------------------------------
# diff
# --------------------------------------------------------------------------

def parse_result(path):
    out = {}
    with open(path) as fh:
        lines = [line.rstrip("\n") for line in fh]
    i = 0
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        loc, reads_s = lines[i].split("\t")
        n_reads = int(reads_s.split(":")[1])
        n_haps = int(lines[i + 1].split(":")[1])
        haps = lines[i + 2:i + 2 + n_haps]
        out[loc] = (n_reads, haps)
        i += 2 + n_haps
    return out


def diff(outdir, strict_reads=True):
    ours = parse_result(os.path.join(outdir, "result_ours.txt"))
    ref = parse_result(os.path.join(outdir, "result_ref.txt"))
    n_match = n_hapdiff = n_readdiff = n_saturated = 0
    msgs = []
    for loc in ref:
        if loc not in ours:
            msgs.append(f"{loc}: MISSING in ours")
            n_hapdiff += 1
            continue
        (rn, rh), (on, oh) = ref[loc], ours[loc]
        if rh != oh:
            only_ref = [h for h in rh if h not in oh]
            only_ours = [h for h in oh if h not in rh]
            # cap-saturated regions (>=128 haps on both sides): WHICH
            # marginal path survives the reference's per-vertex call cap is
            # an artifact of its exact seq-graph vertex granularity (the
            # 129th result observed from the binary is the globally
            # worst-scoring path, admitted only because better ones needed
            # saturated vertices). Tolerate a tiny symmetric difference
            # there; everywhere else require byte-identity.
            if (len(rh) >= 128 and len(oh) >= 128
                    and len(only_ref) + len(only_ours) <= 4):
                n_saturated += 1
                msgs.append(f"{loc}: saturated-cap tolerance "
                            f"(ref={len(rh)} ours={len(oh)}, "
                            f"symdiff={len(only_ref) + len(only_ours)})")
            else:
                n_hapdiff += 1
                msgs.append(
                    f"{loc}: haps ref={len(rh)} ours={len(oh)} "
                    f"only_ref={len(only_ref)} only_ours={len(only_ours)}")
        elif strict_reads and rn != on:
            n_readdiff += 1
            msgs.append(f"{loc}: read count ref={rn} ours={on}")
        else:
            n_match += 1
    print(f"regions: {len(ref)}  identical: {n_match}  "
          f"saturated-ok: {n_saturated}  hap-diff: {n_hapdiff}  "
          f"readcount-diff: {n_readdiff}")
    for m in msgs[:40]:
        print(" ", m)
    return n_match, n_hapdiff, n_readdiff, msgs


def golden():
    """``assemble_ours`` on every region of tests/golden/assembly_cases.txt
    held to the reference binary's assembly_result_ref.txt at the bar of
    tests/test_golden_assembly.py: the read count and the sorted haplotype
    set identical (the 128-cap-saturated regions too). Returns (regions,
    mismatch lines)."""
    ref, cases = golden_cases()
    want = parse_result(os.path.join(GOLDEN, "assembly_result_ref.txt"))
    mismatches = []
    for beg, end, reads in cases:
        loc = f"chr1:{beg}-{end}"
        if loc not in want:
            mismatches.append(f"{loc}: not in the reference's result")
            continue
        want_n, want_haps = want[loc]
        got_n, got_haps = assemble_ours(ref, beg, end, reads)
        if got_n == want_n and got_haps == want_haps:
            continue
        sym = (len([h for h in want_haps if h not in got_haps])
               + len([h for h in got_haps if h not in want_haps]))
        mismatches.append(
            f"{loc}: reads {want_n}/{got_n} haps {len(want_haps)}/"
            f"{len(got_haps)} symdiff {sym}")
    if len(cases) != len(want):
        mismatches.append(f"{len(cases)} cases, {len(want)} reference "
                          "results")
    return len(cases), mismatches


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m rovaca_tpu_torch.tools.golden_assembly",
        description="assembly cases in the reference harness's format: "
                    "generate, assemble with either side, diff; golden: "
                    "hold this package to tests/golden/'s reference output")
    p.add_argument("command", choices=["gen", "ours", "ref", "diff",
                                       "golden"])
    p.add_argument("dir", nargs="?")
    a = p.parse_args(argv)
    if a.command == "golden":
        n, bad = golden()
        print(f"regions: {n}  identical: {n - len(bad)}  differ: "
              f"{len(bad)}")
        for m in bad[:40]:
            print(" ", m)
        return 1 if bad else 0
    if a.dir is None:
        p.error(f"{a.command} needs a directory")
    if a.command == "gen":
        ref, cases = build_corpus()
        write_cases(a.dir, ref, cases)
        print(f"wrote {len(cases)} cases to {a.dir}")
    elif a.command == "ours":
        run_ours(a.dir)
        print("wrote result_ours.txt")
    elif a.command == "ref":
        run_ref(a.dir)
        print("wrote result_ref.txt")
    else:
        _, hd, rd, _ = diff(a.dir)
        return 0 if (hd == 0 and rd == 0) else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
