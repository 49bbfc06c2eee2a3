"""rovaca_tpu's xla runs of the flows that test_torch_golden.py does not
regenerate (banded VCF and GVCF, BQSR, dbSNP, --resume, two BAMs) still
give the references committed in tests/golden_torch/. A file of its own, so
that another worker shares the xla runs."""

import pytest

from test_torch_golden import XLA_ELSEWHERE, regenerate_matches


@pytest.mark.parametrize("flow", XLA_ELSEWHERE)
def test_reference_regenerates(flow, tmp_path):
    regenerate_matches(flow, tmp_path)
