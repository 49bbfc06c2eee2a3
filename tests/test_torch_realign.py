"""rovaca_tpu_torch realignment against rovaca_tpu's, on the CPU.

Mirrors tests/test_banded_realign.py: a simulated region scored by the XLA
engine, then every read realigned to its best haplotype. The port's
realignment (the banded batch on the CPU, or the native SW batch) must give
reads identical in position, cigar and bases to rovaca_tpu's with
ROVACA_BANDED_REALIGN set to 0 and to 1.
"""

import copy

import numpy as np
import pytest

from rovaca_tpu.native import sw_native
from rovaca_tpu_torch.genotype import alignment_utils as port_au
from rovaca_tpu_torch.ops.sw import banded

pytestmark = pytest.mark.skipif(not sw_native.available(),
                                reason="native toolchain unavailable")


@pytest.fixture(scope="module")
def region_likelihoods():
    """A realistic region: haplotypes + reads scored by the XLA engine."""
    import simdata
    from rovaca_tpu.assembly import assembler
    from rovaca_tpu.genotype.likelihoods import AlleleLikelihoods
    from rovaca_tpu.ops import pairhmm

    rng = np.random.default_rng(11)
    ref = simdata.random_ref(rng, 500)
    hap = list(ref)
    p = int(rng.integers(150, 350))
    hap[p] = str(rng.choice([b for b in "ACGT" if b != hap[p]]))
    hap[p + 40:p + 40] = list("TT")     # nearby insertion
    reads = simdata.simulate_fragments(rng, ref, "".join(hap), "chr1", 30,
                                       name_prefix="br_")
    fin = assembler.finalize_and_adjust(list(reads), 0, 499)
    haps = assembler.assemble_region(fin, ref.encode(), 0)
    lik, kept = pairhmm.compute_likelihoods(
        fin, [h.bases for h in haps], engine="xla")
    return AlleleLikelihoods(list(haps), [fin[i] for i in kept], lik)


def _fresh(lik):
    out = copy.copy(lik)
    out.reads = list(lik.reads)
    return out


def _summary(lik):
    return [(r.name, r.pos, str(r.cigar), r.bases) for r in lik.reads]


def _jax_realigned(lik, monkeypatch, banded_on):
    from rovaca_tpu.genotype import alignment_utils as jax_au
    monkeypatch.setenv("ROVACA_BANDED_REALIGN", "1" if banded_on else "0")
    lik = _fresh(lik)
    jax_au.realign_reads_to_their_best_haplotype(lik)
    return _summary(lik)


@pytest.mark.parametrize("banded_on", [False, True])
def test_realignment_identical_to_reference(region_likelihoods, monkeypatch,
                                            banded_on):
    want = _jax_realigned(region_likelihoods, monkeypatch, banded_on)
    lik = _fresh(region_likelihoods)
    before = banded.LAUNCHES
    batches, fallbacks = port_au.realign_reads_to_their_best_haplotype(
        lik, "cpu")
    assert _summary(lik) == want
    assert len(want) > 0
    # the CPU runs the plain version: a batch, never a kernel launch
    assert banded.LAUNCHES == before
    assert batches == int(banded_on)
    assert 0 <= fallbacks <= len(want)
    if not banded_on:
        assert fallbacks == 0


def test_banded_and_native_realignment_agree(region_likelihoods,
                                             monkeypatch):
    runs = []
    for flag in ("0", "1"):
        monkeypatch.setenv("ROVACA_BANDED_REALIGN", flag)
        lik = _fresh(region_likelihoods)
        port_au.realign_reads_to_their_best_haplotype(lik, "cpu")
        runs.append(_summary(lik))
    assert runs[0] == runs[1]


@pytest.mark.parametrize("value,on", [(None, False), ("0", False),
                                      ("false", False), ("", False),
                                      ("1", True), ("yes", True)])
def test_gate_reads_the_environment(monkeypatch, value, on):
    if value is None:
        monkeypatch.delenv("ROVACA_BANDED_REALIGN", raising=False)
    else:
        monkeypatch.setenv("ROVACA_BANDED_REALIGN", value)
    assert port_au.use_banded_sw() is on
