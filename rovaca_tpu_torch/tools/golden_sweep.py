"""Multi-seed golden sweep: gen -> ref -> ours -> diff for VCF and GVCF.

Counterpart of scripts/golden_sweep.py, on this package's
``tools.golden_e2e``: for each seed a fresh 400 kb / 30x corpus, the
reference binary's VCF and GVCF of it (``golden_e2e.run_ref``), this
package's (``golden_e2e.run_ours``, on the card by default) and
``golden_e2e.diff`` of each pair, then a summary table and one ``SWEEP:``
line. It proves bit-equivalence on seeds nobody tuned against. The
reference leg needs .refbuild/'s binary, so without it the sweep stops
with one line before generating anything.

    python -m rovaca_tpu_torch.tools.golden_sweep [outroot] [seed ...]
        [--engine auto|cuda|torch|native]
"""

import argparse
import contextlib
import io
import os
import sys

from . import golden_e2e

DEFAULT_SEEDS = [98172435, 5550123, 31337, 777000777, 20260821, 424243]
GENOME_LEN = 400_000
COVERAGE = 30


def sweep(outroot, seeds, genome_len=GENOME_LEN, coverage=COVERAGE,
          engine="auto", ref=golden_e2e.run_ref):
    """Rows (seed, vcf result, gvcf result), each result MATCH or
    DIVERGENT; ``ref(outdir, gvcf)`` writes the reference's output."""
    rows = []
    for seed in seeds:
        d = os.path.join(outroot, "s%d" % seed)
        quiet = io.StringIO()
        with contextlib.redirect_stdout(quiet):
            golden_e2e.generate(d, genome_len, coverage, seed)
        res = {}
        for mode, gvcf in (("vcf", False), ("gvcf", True)):
            with contextlib.redirect_stdout(quiet):
                ref(d, gvcf)
                golden_e2e.run_ours(d, gvcf, engine)
                rc = golden_e2e.diff(d, gvcf)
            res[mode] = "MATCH" if rc == 0 else "DIVERGENT"
        rows.append((seed, res["vcf"], res["gvcf"]))
        print("seed %-10d  vcf=%-8s gvcf=%s" % rows[-1], flush=True)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m rovaca_tpu_torch.tools.golden_sweep",
        description="gen, ref, ours and diff in VCF and GVCF mode over "
                    "several seeds")
    p.add_argument("outroot", nargs="?", default="golden_sweep")
    p.add_argument("seeds", nargs="*", type=int)
    p.add_argument("--engine", default="auto",
                   choices=["auto", "cuda", "torch", "native"])
    a = p.parse_args(argv)
    golden_e2e.require_binary()
    os.makedirs(a.outroot, exist_ok=True)
    return report(sweep(a.outroot, a.seeds or DEFAULT_SEEDS,
                        engine=a.engine))


def report(rows):
    """Print the SWEEP: line of ``rows``; 0 when every row matches."""
    ok = all(r[1] == "MATCH" and r[2] == "MATCH" for r in rows)
    print("SWEEP:", "ALL MATCH" if ok else "DIVERGENT")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
