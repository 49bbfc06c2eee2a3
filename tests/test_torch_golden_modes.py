"""tools.golden_modes held to rovaca_tpu on the CPU.

The port's corpus helpers write what scripts/golden_modes.py's write for
the same draws; each mode's full corpus has the hashes
tests/golden_torch/MANIFEST.json pins (for multicontig, dbsnp and bed the
script's own corpus; multibam splits by CRC-32, not by the salted
``hash``); the port's native VCF of each gives rovaca_tpu's committed xla
VCF (``modes_<mode>.vcf.xz``, IDs included), and the port over a.bam and
b.bam gives the records it gives over the pre-merged sample.bam.
"""

import os

import numpy as np
import pytest

from rovaca_tpu_torch.tools import golden_flows, golden_modes
from test_torch_golden_tools import load_script


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """mode -> its corpus's directory, generated at first use."""
    root = tmp_path_factory.mktemp("modes")
    made = {}

    def get(mode):
        if mode not in made:
            made[mode] = str(root / mode)
            golden_modes.generate(mode, made[mode])
        return made[mode]
    return get


def test_helpers_match_script(tmp_path):
    script = load_script("golden_modes")
    out = {}
    for side, mod in (("script", script), ("port", golden_modes)):
        rng = np.random.default_rng(7)
        per_contig, contigs, truths = [], [], []
        for name, ln in (("chrA", 6000), ("chrB", 4000)):
            ref, reads, truth = mod._gen_contig(rng, ln, name, f"{name}_")
            per_contig.append((name, ln, reads))
            contigs.append((name, ref))
            truths.append([(tuple(map(str, v)), z) for v, z in truth])
        d = tmp_path / side
        d.mkdir()
        mod._write_fasta(str(d / "ref.fa"), contigs)
        mod._write_multi_bam(str(d / "sample.bam"), per_contig)
        out[side] = (truths, {n: (d / n).read_bytes() for n in
                              ("ref.fa", "ref.fa.fai", "sample.bam",
                               "sample.bam.bai")})
    assert out["script"] == out["port"]


@pytest.mark.parametrize("mode", golden_modes.MODES)
def test_native_matches_committed_reference(mode, corpora):
    d = corpora(mode)
    assert not golden_flows.corpus_problems(d, golden_modes.corpus_key(mode))
    assert golden_modes.golden(mode, d, "native") == []


def test_multibam_merge_property(corpora):
    d = corpora("multibam")
    if not os.path.exists(os.path.join(d, "ours.vcf")):
        golden_modes.run_ours("multibam", d, "native")
    assert golden_modes.merge_problems(d, "native") == []
    assert golden_flows._records(os.path.join(d, "merged.vcf"))
