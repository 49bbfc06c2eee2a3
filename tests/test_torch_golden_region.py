"""tools.golden_region held to rovaca_tpu on the CPU: the port's
per-region report on the torch and the native engine, on the three regions
of tests/golden_torch/region_report.txt (a SNP, an insertion and a
deletion of the committed 50 kb corpus), gives rovaca_tpu's xla report:
the same trimmed span and PairHMM read list, the same variants with QUAL
within golden_e2e's QUAL_TOL, AD, DP and GQ equal, PL within PL_TOL."""

import pytest

from rovaca_tpu_torch.tools import golden_region


@pytest.mark.parametrize("engine", ["torch", "native"])
def test_report_matches_committed(engine):
    res = golden_region.golden(engine)
    assert len(res) == 3
    assert all(not p for p in res.values()), res


def test_report_problems_sees_differences():
    want = next(iter(golden_region.read_report().values()))
    assert golden_region.report_problems(want, want) == []
    lines = want.splitlines()
    var = next(i for i, ln in enumerate(lines) if ln.startswith("variant: "))
    qual = lines[var].split("QUAL=")[1].split(" ")[0]
    shifted = lines[:var] + [lines[var].replace(
        f"QUAL={qual}", f"QUAL={float(qual) + 0.4:.2f}")] + lines[var + 1:]
    assert golden_region.report_problems("\n".join(shifted), want) == []
    shifted[var] = lines[var].replace(f"QUAL={qual}",
                                      f"QUAL={float(qual) + 0.6:.2f}")
    assert golden_region.report_problems("\n".join(shifted), want)
    read = next(i for i, ln in enumerate(lines) if ln.startswith("  "))
    assert golden_region.report_problems(
        "\n".join(lines[:read] + lines[read + 1:]), want)
