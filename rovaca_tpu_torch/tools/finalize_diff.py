"""Read-level finalize diff against the reference binary.

Counterpart of scripts/finalize_diff.py. Compares this package's region
finalizer (``assembler.finalize_and_adjust``) with the reference's
finalized-read dump (.refbuild/bin/assemble_harness, which prints
AssembleResult::get_reads() per case: name, 1-based start, cigar, seq,
quals) over the frozen 80-region golden corpus of tests/golden/. Both
sides are normalized to sorted (pos, name, cigar, seq, quals) tuples per
region: the harness's (start, qname) std::sort is unstable for mate pairs
that clip to the same start, so ordering beyond the key is not meaningful.
The dump is not committed; without the harness there is nothing to compare
with.

    LD_LIBRARY_PATH=.refbuild/ref/build-dev/bin \\
        .refbuild/bin/assemble_harness tests/golden/assembly_cases.txt \\
        tests/golden/assembly_ref.txt DUMP
    python -m rovaca_tpu_torch.tools.finalize_diff DUMP
"""

import os
import re
import sys

from ..assembly import assembler
from . import golden_e2e
from .golden_assembly import REGION_PAD, golden_cases

HARNESS = os.path.join(golden_e2e.REPO, ".refbuild", "bin", "assemble_harness")


def strip_hard_clips(cigar):
    """Drop H ops: they carry no bases and our records don't retain them."""
    return re.sub(r"\d+H", "", cigar)


def load_cases():
    """[(beg, end, reads)] of tests/golden/assembly_cases.txt, as this
    package's records."""
    return golden_cases()[1]


def load_ref_dump(path):
    """-> {(beg, end): sorted [(pos, name, cigar, seq, quals)]}"""
    out = {}
    cur = None
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith("chr1:") and "\treads: " in line:
                span = line.split("\t")[0][len("chr1:"):]
                b, e = span.split("-")
                cur = out.setdefault((int(b), int(e)), [])
            elif line.startswith("haplotypes: "):
                cur = None
            elif cur is not None and line:
                f = line.split("\t")
                cur.append((int(f[1]), f[0], strip_hard_clips(f[2]),
                            f[3], f[4]))
    for v in out.values():
        v.sort()
    return out


def ours_tuples(beg, end, reads):
    ps, pe = (beg - 1) - REGION_PAD, (end - 1) + REGION_PAD
    fin = assembler.finalize_and_adjust(list(reads), ps, pe)
    rows = []
    for r in fin:
        bases = r.bases.decode() if isinstance(r.bases, bytes) else r.bases
        q = "".join(chr(int(x) + 33) for x in r.quals)
        rows.append((r.pos + 1, r.name, strip_hard_clips(str(r.cigar)),
                     bases, q))
    rows.sort()
    return rows


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        raise SystemExit("usage: python -m rovaca_tpu_torch.tools."
                         "finalize_diff DUMP")
    if not os.path.exists(argv[0]):
        golden_e2e.require_binary(HARNESS)
        raise SystemExit(f"no dump at {argv[0]}: make it with {HARNESS}")
    ref = load_ref_dump(argv[0])
    cases = load_cases()
    bad = 0
    for beg, end, reads in cases:
        want = ref.get((beg, end))
        got = ours_tuples(beg, end, reads)
        if want == got:
            continue
        bad += 1
        print(f"REGION chr1:{beg}-{end}  ref={len(want or [])} "
              f"ours={len(got)}")
        wset, gset = set(want or []), set(got)
        for t in sorted(wset - gset)[:6]:
            print("  ref-only :", t[:3], t[3][:30])
        for t in sorted(gset - wset)[:6]:
            print("  ours-only:", t[:3], t[3][:30])
    print(f"{len(cases) - bad}/{len(cases)} regions read-level identical")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
