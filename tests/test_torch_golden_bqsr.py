"""tools.golden_bqsr held to rovaca_tpu on the CPU.

The port's recalibration table is scripts/golden_bqsr.py's byte for byte;
its corpus is the one tests/golden_torch/MANIFEST.json pins
(``corpus_bqsr``), and the port's native VCF of it with the table gives
rovaca_tpu's committed xla VCF (``bqsr_full.vcf.xz``) record for record.
The table takes effect: without it the records differ. The empirical
quality math of the port's reads/bqsr.py is pinned to the values
tests/test_golden_bqsr.py pins rovaca_tpu's to.
"""

import math
import os

import pytest

from rovaca_tpu_torch.cli import main as port_cli
from rovaca_tpu_torch.reads.bqsr import (_likelihood,
                                         empirical_quality_bayesian_estimate)
from rovaca_tpu_torch.tools import golden_bqsr, golden_flows
from test_torch_golden_tools import load_script


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("bqsr"))
    golden_bqsr.generate(d)
    return d


def test_recal_table_matches_script(tmp_path):
    script = load_script("golden_bqsr")
    a, b = str(tmp_path / "script.table"), str(tmp_path / "port.table")
    script.write_recal_table(a, range(2, 51))
    golden_bqsr.write_recal_table(b, golden_bqsr.QUALS)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_native_matches_committed_reference(corpus):
    assert golden_bqsr.golden(corpus, "native") == []


def test_table_takes_effect(corpus):
    plain = os.path.join(corpus, "plain.vcf")
    assert port_cli(["HaplotypeCaller", "-i",
                     os.path.join(corpus, "sample.bam"), "-r",
                     os.path.join(corpus, "ref.fa"), "-o", plain,
                     "--pairhmm-engine", "native"]) == 0
    with_table = os.path.join(corpus, "ours.vcf")
    if not os.path.exists(with_table):
        golden_bqsr.run_ours(corpus, "native")
    assert golden_flows._records(plain) != golden_flows._records(with_table)


def test_bayesian_estimate_regression():
    """The values tests/test_golden_bqsr.py pins rovaca_tpu's to."""
    assert empirical_quality_bayesian_estimate(1_000_002, 801, 36.5) == 31.0
    assert empirical_quality_bayesian_estimate(500_002, 159, 35.0) == 35.0
    assert empirical_quality_bayesian_estimate(500_002, 200, 34.0) == 34.0
    assert empirical_quality_bayesian_estimate(40_002, 13, 36.0) == 36.0
    assert empirical_quality_bayesian_estimate(102, 1, 40.0) == 40.0


def test_likelihood_is_natural_log():
    """The reference uses logBinomialProbability's natural log as a log10
    likelihood (apply_bqsr_utils.cpp:147-160); so does the port."""
    n, k, q = 1000, 10, 20.0
    p = 10.0 ** (-0.1 * q)
    ln_binom = (math.lgamma(n + 1) - math.lgamma(k + 1)
                - math.lgamma(n - k + 1)
                + k * math.log(p) + (n - k) * math.log(1 - p))
    assert abs(_likelihood(q, n, k) - ln_binom) < 1e-9
