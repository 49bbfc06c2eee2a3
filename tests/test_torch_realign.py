"""rovaca_tpu_torch realignment against rovaca_tpu's, on the CPU.

Mirrors tests/test_banded_realign.py: a simulated region scored by the XLA
engine, then every read realigned to its best haplotype. The port's
realignment (the banded batch on the CPU, or the native SW batch) must give
reads identical in position, cigar and bases to rovaca_tpu's with
ROVACA_BANDED_REALIGN set to 0 and to 1. Each package realigns its own
reads and haplotypes, made from the same seed by its own simulator and
assembler, under the same likelihood matrix.
"""

import copy

import numpy as np
import pytest

from rovaca_tpu_torch.genotype import alignment_utils as port_au
from rovaca_tpu_torch.native import sw_native
from rovaca_tpu_torch.ops.sw import banded

pytestmark = pytest.mark.skipif(not sw_native.available(),
                                reason="native toolchain unavailable")


def _region(simdata, assembler):
    """A realistic region from seed 11: finalized reads, haplotypes."""
    rng = np.random.default_rng(11)
    ref = simdata.random_ref(rng, 500)
    hap = list(ref)
    p = int(rng.integers(150, 350))
    hap[p] = str(rng.choice([b for b in "ACGT" if b != hap[p]]))
    hap[p + 40:p + 40] = list("TT")     # nearby insertion
    reads = simdata.simulate_fragments(rng, ref, "".join(hap), "chr1", 30,
                                       name_prefix="br_")
    fin = assembler.finalize_and_adjust(list(reads), 0, 499)
    return fin, assembler.assemble_region(fin, ref.encode(), 0)


@pytest.fixture(scope="module")
def region_likelihoods():
    """The same region as each package's own objects, (rovaca_tpu's, the
    port's): haplotypes + reads scored by rovaca_tpu's XLA engine."""
    import simdata
    from rovaca_tpu.assembly import assembler
    from rovaca_tpu.genotype.likelihoods import AlleleLikelihoods
    from rovaca_tpu.ops import pairhmm
    from rovaca_tpu_torch.assembly import assembler as port_assembler
    from rovaca_tpu_torch.genotype.likelihoods import \
        AlleleLikelihoods as PortLikelihoods
    from rovaca_tpu_torch.tools import simdata as port_simdata

    fin, haps = _region(simdata, assembler)
    lik, kept = pairhmm.compute_likelihoods(
        fin, [h.bases for h in haps], engine="xla")
    p_fin, p_haps = _region(port_simdata, port_assembler)
    assert [h.bases for h in p_haps] == [h.bases for h in haps]
    assert [(r.name, r.pos, r.bases) for r in p_fin] == \
        [(r.name, r.pos, r.bases) for r in fin]
    return (AlleleLikelihoods(list(haps), [fin[i] for i in kept], lik),
            PortLikelihoods(list(p_haps), [p_fin[i] for i in kept],
                            lik.copy()))


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
    jax_lik, port_lik = region_likelihoods
    want = _jax_realigned(jax_lik, monkeypatch, banded_on)
    lik = _fresh(port_lik)
    before = banded.LAUNCHES
    batches, fallbacks = port_au.realign_reads_to_their_best_haplotype(
        lik, device="cpu")
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
        lik = _fresh(region_likelihoods[1])
        port_au.realign_reads_to_their_best_haplotype(lik, device="cpu")
        runs.append(_summary(lik))
    assert runs[0] == runs[1]


@pytest.mark.parametrize("banded_on", [False, True])
def test_device_resolved_only_when_a_banded_batch_runs(region_likelihoods,
                                                       monkeypatch,
                                                       banded_on):
    """No device given: the card, asked for only when the banded batch is
    about to run. The gate off never asks; the gate on with no card
    raises, and runs no plain version in its place."""
    from rovaca_tpu_torch.utils import platform
    asked = []

    def no_card(index=None):
        asked.append(index)
        raise RuntimeError("no CUDA device")

    monkeypatch.setattr(platform, "device", no_card)
    monkeypatch.setenv("ROVACA_BANDED_REALIGN", "1" if banded_on else "0")
    lik = _fresh(region_likelihoods[1])
    if banded_on:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_au.realign_reads_to_their_best_haplotype(lik)
        assert asked == [None]
    else:
        assert port_au.realign_reads_to_their_best_haplotype(lik) == (0, 0)
        assert asked == []


@pytest.mark.parametrize("value,on", [(None, False), ("0", False),
                                      ("false", False), ("", False),
                                      ("1", True), ("yes", True)])
def test_gate_reads_the_environment(monkeypatch, value, on):
    if value is None:
        monkeypatch.delenv("ROVACA_BANDED_REALIGN", raising=False)
    else:
        monkeypatch.setenv("ROVACA_BANDED_REALIGN", value)
    assert port_au.use_banded_sw() is on
