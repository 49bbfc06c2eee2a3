"""The port's g++ libraries against the port's Python on the golden corpus.

Counterparts of tests/test_assemble_native.py and
tests/test_finalize_native.py for rovaca_tpu_torch/native/: on every region
of tests/golden/assembly_cases.txt (the corpus the Python assembler is held
to the reference binary on, test_torch_golden_ref.py),
``finalize_native.finalize_region`` gives the records of
``finalize_region_reads`` + ``adjust_overlapping_pair_quals`` (pos, cigar,
bases, quals, hard clips, flag, tlen, order), and
``assemble_native.assemble_region_paths`` gives the Python kmer ladder's
path set, with each path's score within 1e-12 and its kmer size equal.
"""

import numpy as np

from rovaca_tpu_torch import constants as C
from rovaca_tpu_torch.assembly import assembler
from rovaca_tpu_torch.native import assemble_native, finalize_native
from rovaca_tpu_torch.tools import golden_assembly as ga


def python_paths(reads, window, monkeypatch):
    """The Python kmer-ladder result dict (oracle), as assemble_region
    builds it with the native library switched off."""
    monkeypatch.setenv("ROVACA_NO_NATIVE_ASSEMBLY", "1")
    results = {}
    any_success = False
    first_kbest = True
    for k in C.ASSEMBLY_KMER_SIZES:
        paths, ran = assembler.assemble_with_kmer(
            reads, window, k, first_kbest=first_kbest)
        first_kbest &= not ran
        if paths is None:
            continue
        any_success = True
        assembler._merge_paths(results, paths, k)
    if not any_success:
        k = C.ASSEMBLY_KMER_SIZES[-1]
        for _ in range(C.ASSEMBLY_MAX_KMER_ITERATIONS):
            k += C.ASSEMBLY_KMER_STEP
            paths, ran = assembler.assemble_with_kmer(
                reads, window, k,
                allow_low_complexity=(k >= assembler.MAX_KMER),
                first_kbest=first_kbest)
            first_kbest &= not ran
            if paths is not None:
                assembler._merge_paths(results, paths, k)
                break
    monkeypatch.delenv("ROVACA_NO_NATIVE_ASSEMBLY")
    return results


def test_assemble_native_matches_python_on_golden_corpus(monkeypatch):
    assert assemble_native.available()
    ref, cases = ga.golden_cases()
    for beg, end, reads in cases:
        ps, pe, fin = ga.finalize_case(beg, end, reads)
        window = ref[ps:pe + 1].encode()
        py = python_paths(fin, window, monkeypatch)
        nat = assemble_native.assemble_region_paths(
            fin, window, C.ASSEMBLY_KMER_SIZES, C.ASSEMBLY_KMER_STEP,
            C.ASSEMBLY_MAX_KMER_ITERATIONS)
        tag = f"chr1:{beg}-{end}"
        assert nat is not None, tag
        assert set(py) == set(nat), \
            f"{tag}: path sets differ ({len(py)} vs {len(nat)})"
        for seq, (score, k) in py.items():
            nscore, nk = nat[seq]
            assert nk == k, f"{tag}: kmer attribution differs at {seq[:30]}"
            assert abs(nscore - score) < 1e-12, f"{tag}: {score} vs {nscore}"
    assert len(cases) == 80


def test_finalize_native_matches_python_on_golden_corpus():
    assert finalize_native.available()
    _, cases = ga.golden_cases()
    for beg, end, reads in cases:
        ps, pe, py = ga.finalize_case(beg, end, reads)
        nat = finalize_native.finalize_region(reads, ps, pe)
        tag = f"chr1:{beg}-{end}"
        assert nat is not None, tag
        assert len(py) == len(nat), f"{tag}: {len(py)} vs {len(nat)} reads"
        for i, (a, b) in enumerate(zip(py, nat)):
            ctx = f"{tag}[{i}] {a.name}"
            assert a.name == b.name, ctx
            assert a.pos == b.pos, f"{ctx}: pos {a.pos} vs {b.pos}"
            assert str(a.cigar) == str(b.cigar), \
                f"{ctx}: cigar {a.cigar} vs {b.cigar}"
            assert a.bases == b.bases, ctx
            np.testing.assert_array_equal(np.asarray(a.quals),
                                          np.asarray(b.quals), err_msg=ctx)
            assert a.hard_left == b.hard_left, ctx
            assert a.hard_right == b.hard_right, ctx
            assert a.flag == b.flag and a.tlen == b.tlen, ctx
    assert len(cases) == 80
