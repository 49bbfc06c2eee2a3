"""rovaca_tpu_torch dense PairHMM and the region entry against rovaca_tpu.

Inputs are made with numpy from a seed and fed to both packages. Tolerances:
- dense float32 forward: rtol 2e-5 (the bar tests/test_pairhmm.py sets the
  native engine against XLA) on pairs at or above MIN_ACCEPTED_F32, the same
  set of pairs below it (the float64 rescue set), exact zeros on padding;
- scored likelihoods: kept reads identical, log10 values within 1e-4;
- region calls: (pos, alleles, GT) identical, GQ and PL within
  scripts/golden_e2e.py's PL_TOL.
"""

import numpy as np
import pytest
import torch

from rovaca_tpu import constants as C
from rovaca_tpu.ops.pairhmm import prep
from rovaca_tpu.ops.pairhmm.api import compute_likelihoods as jax_compute
from rovaca_tpu.ops.pairhmm.kernel import pairhmm_pallas
from rovaca_tpu.ops.pairhmm.xla import pairhmm_xla
from rovaca_tpu_torch.ops.pairhmm import api, dense

from test_torch_pairhmm import assert_forward_close, region_case

THR = np.float32(C.MIN_ACCEPTED_F32)


def _inputs(b):
    return (b.trans, b.rbase, b.rlen, b.hbase, b.hlen)


def _torch_dense(b):
    return dense.pairhmm_dense(*(torch.from_numpy(a) for a in
                                 _inputs(b))).numpy()


def test_plain_matches_xla():
    rng = np.random.default_rng(51)
    reads, haps = region_case(rng, 150, 11)
    b = prep.build_pair_batch(reads, haps)
    assert (b.gr, b.gh) == (2, 2)
    before = dense.LAUNCHES
    got = _torch_dense(b)
    assert dense.LAUNCHES == before          # the CPU runs the plain version
    want = np.asarray(pairhmm_xla(*_inputs(b)))
    assert got.shape == want.shape == (2, 2, 8, 128)
    assert (want < THR).any() and (want >= THR).any()
    assert_forward_close(got, want)
    assert np.all(got[:, 1, :, 150 - 128:] == 0)      # padding lanes
    assert np.all(got[1, :, 11 - 8:] == 0)            # padding haps


def test_plain_matches_pallas_interpret():
    rng = np.random.default_rng(52)
    reads, haps = region_case(rng, 9, 11, read_len=(20, 60),
                              hap_len=(60, 120))
    b = prep.build_pair_batch(reads, haps, len_buckets=(64,),
                              hap_len_buckets=(128,))
    assert (b.max_read_len, b.max_hap_len, b.gh) == (64, 128, 2)
    want = np.asarray(pairhmm_pallas(*_inputs(b), interpret=True))
    assert_forward_close(_torch_dense(b), want)


@pytest.mark.parametrize("engine", ["torch", "native"])
def test_pairhmm_raw_matches_xla(engine):
    rng = np.random.default_rng(53)
    reads, haps = region_case(rng, 40, 5)
    b = prep.build_pair_batch(reads, haps)
    got = api.pairhmm_raw(b, engine)
    assert got.dtype == np.float32
    assert_forward_close(got, np.asarray(pairhmm_xla(*_inputs(b))))


@pytest.mark.parametrize("engine", ["cuda", "auto"])
def test_pairhmm_raw_cuda_needs_gpu(monkeypatch, engine):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b = prep.build_pair_batch(*region_case(np.random.default_rng(54), 3, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.pairhmm_raw(b, engine)


@pytest.mark.parametrize("engine", ["torch", "native"])
def test_compute_likelihoods_dense_matches_reference(engine):
    rng = np.random.default_rng(55)
    reads, haps = region_case(rng, 60, 6)
    lik, kept = api.compute_likelihoods(reads, haps, engine=engine)
    lik_w, kept_w = jax_compute(reads, haps, engine="xla")
    np.testing.assert_array_equal(kept, kept_w)
    np.testing.assert_allclose(lik, lik_w, atol=1e-4, rtol=0)


@pytest.mark.parametrize("bad", ["dtype", "shape", "device"])
def test_wrapper_rejects_bad_input(bad):
    b = prep.build_pair_batch(*region_case(np.random.default_rng(56), 4, 2))
    t = [torch.from_numpy(a) for a in _inputs(b)]
    if bad == "dtype":
        t[1] = t[1].long()
        err = TypeError
    elif bad == "shape":
        t[2] = t[2][:, :, :64].contiguous()
        err = ValueError
    else:
        t = [x.to("meta") for x in t]
        err = ValueError
    with pytest.raises(err):
        dense.pairhmm_dense(*t)


# -- the region entry: RegionCaller.call_region ----------------------------

@pytest.fixture(scope="module")
def region_inputs():
    """A 1.5 kb contig with a het SNP, a hom SNP, a het deletion and a het
    insertion, ~30x of simulated read pairs with sequencing errors, and its
    active regions."""
    import simdata
    from rovaca_tpu.pipeline import activity
    rng = np.random.default_rng(57)
    ref = simdata.random_ref(rng, 1500)
    alt = {p: "ACGT"[("ACGT".index(ref[p]) + 1) % 4] for p in (300, 700)}
    hap1 = simdata.apply_variants(ref, [(700, ref[700], alt[700])])
    hap2 = simdata.apply_variants(ref, [
        (300, ref[300], alt[300]), (700, ref[700], alt[700]),
        (1000, ref[1000:1004], ref[1000]), (1250, ref[1250],
                                           ref[1250] + "GA")])
    reads = (simdata.simulate_fragments(rng, ref, hap1, "chr1", 110,
                                        name_prefix="a")
             + simdata.simulate_fragments(rng, ref, hap2, "chr1", 110,
                                          name_prefix="b"))
    reads.sort(key=lambda r: r.pos)
    ref_b = ref.encode()
    regions = [r for r in activity.find_active_regions(
        reads, ref_b, "chr1", 0, len(ref)) if r.is_active]
    return reads, ref_b, regions


def _region_reads(reads, region):
    lo = region.start - C.REGION_PADDING
    hi = region.end + 1 + C.REGION_PADDING
    return [r for r in reads if r.pos < hi and r.end > lo]


def _call_summary(calls):
    out = []
    for c in calls:
        g = c.genotypes[0]
        out.append((c.start, tuple(a.bases for a in c.alleles),
                    tuple(sorted(a.bases for a in g.alleles)), g.gq,
                    tuple(g.pl or ())))
    return out


def _assert_calls_match(got, want):
    assert [k[:3] for k in got] == [k[:3] for k in want]
    for g, w in zip(got, want):
        assert abs(g[3] - w[3]) <= 1, (g, w)
        assert len(g[4]) == len(w[4])
        assert all(abs(a - b) <= 1 for a, b in zip(g[4], w[4])), (g, w)


@pytest.mark.parametrize("banded_realign", ["0", "1"])
def test_call_region_matches_reference(region_inputs, monkeypatch,
                                       banded_realign):
    from rovaca_tpu.pipeline.hc_engine import CallerConfig
    from rovaca_tpu.pipeline.hc_engine import RegionCaller as JaxCaller
    from rovaca_tpu_torch.pipeline.hc_engine import RegionCaller
    monkeypatch.setenv("ROVACA_BANDED_REALIGN", banded_realign)
    reads, ref, regions = region_inputs
    assert len(regions) >= 3
    contigs = {"chr1": len(ref)}
    ours = RegionCaller(CallerConfig(pairhmm_engine="torch"), contigs)
    theirs = JaxCaller(CallerConfig(pairhmm_engine="xla"), contigs)
    n_calls = 0
    for region in regions:
        rr = _region_reads(reads, region)
        got = _call_summary(ours.call_region(region, rr, ref, "chr1"))
        want = _call_summary(theirs.call_region(region, rr, ref, "chr1"))
        _assert_calls_match(got, want)
        n_calls += len(got)
    assert n_calls >= 4
    if banded_realign == "1":
        assert ours.sw_launches > 0
    else:
        assert ours.sw_launches == ours.sw_fallbacks == 0
