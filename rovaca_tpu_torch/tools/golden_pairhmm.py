"""Cross-implementation PairHMM golden diff.

Counterpart of scripts/golden_pairhmm.py: feeds identical (haplotypes,
reads) cases to the reference's AVX-512 PairHMM (REF_BIN, the harness that
drives rovaca::call_pairhmm exactly like haplotypecaller_engine.cpp:238-250)
and to this package's engines, then compares the post-normalization log10
likelihood matrices column-aligned by read name. ``golden`` holds an engine
to the reference's committed output on tests/golden/'s 64 cases.

Case format (shared with the harness):
  ``H R`` line, H haplotype lines (first = ref), R SAM read lines.
Result format: surviving read names line, H matrix rows, blank line.

    python -m rovaca_tpu_torch.tools.golden_pairhmm gen  <dir>
    python -m rovaca_tpu_torch.tools.golden_pairhmm ours <dir> [--engine E]
        [--scheduler]
    python -m rovaca_tpu_torch.tools.golden_pairhmm ref  <dir>
    python -m rovaca_tpu_torch.tools.golden_pairhmm diff <dir>
    python -m rovaca_tpu_torch.tools.golden_pairhmm golden [--engine E]
        [--scheduler]

``gen`` writes cases.txt from tests/golden/'s assembly corpus through this
package's assembler: the file scripts/golden_pairhmm.py gen writes today,
byte for byte. The committed tests/golden/pairhmm_cases.txt, frozen before
the overlapping-pair qual adjustment changed, differs from it in the quals
of a few overlapping mates; ``golden`` reads the committed file, which is
what the reference's output was made from.

Engines: ``cuda`` (or ``auto``) scores on the card and stops without one;
``torch`` runs the kernels' plain versions and ``native`` the host C++
engine, both on the CPU. Without ``--scheduler`` each case goes through
``ops.pairhmm.api.compute_likelihoods`` (the dense kernel, K2, on the card);
with it every case is submitted to one ``pipeline.scheduler.
PairHMMScheduler`` flush group (compact batches, the indexed kernel, K1).
"""

import argparse
import os
import subprocess
import sys

import numpy as np

from . import golden_assembly as ga
from . import golden_e2e

GOLDEN = ga.GOLDEN
REF_BIN = os.path.join(ga.REPO, ".refbuild", "bin", "pairhmm_harness")
GOLDEN_ATOL = 4e-3   # tests/test_golden_pairhmm.py: fp32 rounding noise
MAX_HAPS = 48


def gen_from_golden(outdir):
    os.makedirs(outdir, exist_ok=True)
    ref, cases = ga.golden_cases()
    n_cases = 0
    with open(os.path.join(outdir, "cases.txt"), "w") as out:
        for beg, end, reads in cases:
            fin, haps = ga.assemble_case(ref, beg, end, reads)
            if len(haps) < 2 or len(haps) > MAX_HAPS or not fin:
                continue
            # uniquify names post-adjust (mates share names otherwise)
            fin = [r.copy(name=f"{r.name}_{i}") for i, r in enumerate(fin)]
            out.write(f"{len(haps)} {len(fin)}\n")
            for h in haps:
                out.write(h.bases.decode() + "\n")
            for r in fin:
                out.write(ga.sam_line(r, "chr1") + "\n")
            n_cases += 1
    print(f"wrote {n_cases} pairhmm cases to {outdir}")


def read_pairhmm_case_file(path):
    """[(haps, reads)] of a case file."""
    cases = []
    with open(path) as fh:
        while True:
            head = fh.readline()
            if not head.strip():
                break
            h, r = map(int, head.split())
            haps = [fh.readline().rstrip("\n") for _ in range(h)]
            reads = [ga.parse_sam_line(fh.readline()) for _ in range(r)]
            cases.append((haps, reads))
    return cases


def read_pairhmm_cases(outdir):
    return read_pairhmm_case_file(os.path.join(outdir, "cases.txt"))


def score_cases(cases, engine="auto", scheduler=False):
    """[(lik, kept)] of each (haps, reads) case, PCR model CONSERVATIVE:
    one ``compute_likelihoods`` call a case, or with ``scheduler`` every
    case in one PairHMMScheduler flush group. Returns (results, the
    scheduler's launches or None)."""
    if not scheduler:
        from ..ops.pairhmm import api
        return [api.compute_likelihoods(
            reads, [h.encode() for h in haps], pcr_model="CONSERVATIVE",
            engine=engine) for haps, reads in cases], None
    from ..pipeline.scheduler import PairHMMScheduler
    sched = PairHMMScheduler(engine=engine)
    for ci, (haps, reads) in enumerate(cases):
        sched.submit(ci, reads, [h.encode() for h in haps],
                     pcr_model="CONSERVATIVE")
    out = sched.run()
    return [out[ci] for ci in range(len(cases))], sched.launches


def write_result(path, cases, results):
    with open(path, "w") as out:
        for (_, reads), (lik, kept) in zip(cases, results):
            out.write("\t".join(reads[i].name for i in kept) + "\n")
            for row in lik:
                out.write("\t".join(f"{v:.12e}" for v in row) + "\n")
            out.write("\n")


def run_ours(outdir, engine="auto", scheduler=False):
    cases = read_pairhmm_cases(outdir)
    results, _ = score_cases(cases, engine, scheduler)
    write_result(os.path.join(outdir, "result_ours.txt"), cases, results)
    print("wrote result_ours.txt")


def run_ref(outdir):
    """The reference engine's harness on ``outdir``'s cases into
    result_ref.txt. Without the binary it stops with one line: nothing
    else stands in for it."""
    golden_e2e.require_binary(REF_BIN)
    r = subprocess.run([REF_BIN, os.path.join(outdir, "cases.txt"),
                        os.path.join(outdir, "result_ref.txt")],
                       capture_output=True, text=True, timeout=3600)
    if r.returncode != 0:
        raise SystemExit(f"reference binary failed rc={r.returncode}: "
                         f"{r.stderr.strip()[-2000:]}")


def parse_matrix_result(path):
    blocks = []
    with open(path) as fh:
        lines = [line.rstrip("\n") for line in fh]
    i = 0
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        names = lines[i].split("\t")
        rows = []
        i += 1
        while i < len(lines) and lines[i].strip():
            rows.append([float(x) for x in lines[i].split("\t")])
            i += 1
        blocks.append((names, np.array(rows)))
    return blocks


def compare_block(ref_block, ours_block, rtol=5e-5, atol=1e-4):
    """(kept sets equal, max abs difference, cells outside rtol AND atol)
    of one case's two results, columns aligned by read name.

    The reference's call_pairhmm pre-sizes its output to the original read
    count; columns past the surviving reads are unwritten (NaN) and ignored
    downstream, so both matrices are cut to their emitted name counts."""
    (rn, rm), (on, om) = ref_block, ours_block
    rm = rm[:, :len(rn)]
    om = om[:, :len(on)]
    if set(rn) != set(on):
        return False, None, None
    om_aligned = om[:, [on.index(x) for x in rn]]
    ad = np.abs(om_aligned - rm)
    rel = ad / np.maximum(np.abs(rm), 1e-30)
    return True, float(ad.max(initial=0.0)), int(((ad > atol)
                                                  & (rel > rtol)).sum())


def diff(outdir, rtol=5e-5, atol=1e-4):
    ours = parse_matrix_result(os.path.join(outdir, "result_ours.txt"))
    ref = parse_matrix_result(os.path.join(outdir, "result_ref.txt"))
    assert len(ours) == len(ref), (len(ours), len(ref))
    n_ok = n_filter_diff = n_value_diff = 0
    worst = 0.0
    msgs = []
    for ci, (rb, ob) in enumerate(zip(ref, ours)):
        same, d, k = compare_block(rb, ob, rtol, atol)
        if not same:
            n_filter_diff += 1
            msgs.append(f"case {ci}: poorly-modelled filter differs: "
                        f"only_ref={set(rb[0]) - set(ob[0])} "
                        f"only_ours={set(ob[0]) - set(rb[0])}")
            continue
        worst = max(worst, d)
        if k:
            n_value_diff += 1
            msgs.append(f"case {ci}: {k} cells differ (max abs {d:.3e})")
        else:
            n_ok += 1
    print(f"cases: {len(ref)}  ok: {n_ok}  filter-diff: {n_filter_diff}  "
          f"value-diff: {n_value_diff}  worst-abs: {worst:.3e}")
    for m in msgs[:30]:
        print(" ", m)
    return n_ok, n_filter_diff, n_value_diff


def _counts():
    from ..ops.pairhmm import dense, indexed
    return {"pairhmm_indexed": indexed.LAUNCHES,
            "pairhmm_dense": dense.LAUNCHES}


def golden(engine="auto", scheduler=False, cases=None):
    """Score tests/golden/pairhmm_cases.txt (all 64 cases, or the indices
    ``cases``) and hold each to the reference engine's
    pairhmm_result_ref.txt at tests/test_golden_pairhmm.py's bar: the same
    kept read set and every cell within GOLDEN_ATOL. Returns {"cases",
    "worst_abs", "outside_tight" (cases with a cell outside diff's rtol 5e-5
    and atol 1e-4), "mismatches" (lines), "launches" (K1's and K2's counters
    over the run), "scheduler_launches" (the flush group's calls of the
    indexed forward, or None)}."""
    all_cases = read_pairhmm_case_file(
        os.path.join(GOLDEN, "pairhmm_cases.txt"))
    want = parse_matrix_result(os.path.join(GOLDEN, "pairhmm_result_ref.txt"))
    if len(all_cases) != len(want):
        raise ValueError(f"{len(all_cases)} cases, {len(want)} reference "
                         "results")
    idx = list(range(len(all_cases)) if cases is None else cases)
    before = _counts()
    results, sched_launches = score_cases([all_cases[i] for i in idx],
                                          engine, scheduler)
    after = _counts()
    worst, outside, mismatches = 0.0, 0, []
    for ci, (lik, kept) in zip(idx, results):
        reads = all_cases[ci][1]
        ours = ([reads[i].name for i in kept], lik)
        same, d, k = compare_block(want[ci], ours)
        if not same:
            rn, on = set(want[ci][0]), set(ours[0])
            mismatches.append(f"case {ci}: poorly-modelled filter differs: "
                              f"only_ref={sorted(rn - on)} "
                              f"only_ours={sorted(on - rn)}")
            continue
        worst = max(worst, d)
        outside += k > 0
        if not d <= GOLDEN_ATOL:
            mismatches.append(f"case {ci}: max abs diff {d:.3e} > "
                              f"{GOLDEN_ATOL}")
    return {"cases": len(idx), "worst_abs": worst, "outside_tight": outside,
            "mismatches": mismatches,
            "launches": {k: after[k] - before[k] for k in after},
            "scheduler_launches": sched_launches}


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m rovaca_tpu_torch.tools.golden_pairhmm",
        description="PairHMM cases in the reference harness's format: "
                    "generate, score with either side, diff; golden: hold "
                    "an engine to tests/golden/'s reference output")
    p.add_argument("command", choices=["gen", "ours", "ref", "diff",
                                       "golden"])
    p.add_argument("dir", nargs="?")
    p.add_argument("--engine", default="auto",
                   choices=["auto", "cuda", "torch", "native"])
    p.add_argument("--scheduler", action="store_true",
                   help="one PairHMMScheduler flush group (K1 on the card) "
                        "instead of compute_likelihoods a case (K2)")
    a = p.parse_args(argv)
    if a.command in ("ours", "golden") and a.engine in ("auto", "cuda"):
        from ..utils.platform import require_card
        require_card(f"engine {a.engine}")
    if a.command == "golden":
        res = golden(a.engine, a.scheduler)
        print(f"cases: {res['cases']}  worst-abs: {res['worst_abs']:.3e}  "
              f"outside rtol 5e-5/atol 1e-4: {res['outside_tight']}  "
              f"differ: {len(res['mismatches'])}  launches: "
              f"{res['launches']}  scheduler launches: "
              f"{res['scheduler_launches']}")
        for m in res["mismatches"][:30]:
            print(" ", m)
        return 1 if res["mismatches"] else 0
    if a.dir is None:
        p.error(f"{a.command} needs a directory")
    if a.command == "gen":
        gen_from_golden(a.dir)
    elif a.command == "ours":
        run_ours(a.dir, a.engine, a.scheduler)
    elif a.command == "ref":
        run_ref(a.dir)
        print("wrote result_ref.txt")
    else:
        _, fd, vd = diff(a.dir)
        return 0 if (fd == 0 and vd == 0) else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
