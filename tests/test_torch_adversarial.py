"""The adversarial corpus through the port, held to rovaca_tpu's outputs.

``tools.golden_adversarial`` is the port's counterpart of
scripts/golden_adversarial.py: three 150 kb contigs at 30x with homopolymer
stutter, STR expansions, SNP clusters beside indels, N-gaps with variants at
their edges and variants near the contig edges. rovaca_tpu's xla VCF and
GVCF of the seed-20260505 corpus are committed in tests/golden_torch/; the
corpus is pinned by the hashes of its ref.fa, BAM payload and truth.txt in
MANIFEST.json. Here, on the CPU:

- the port's ``_plant_adversarial_ref`` and ``_truth_for`` equal the
  script's for three seeds at a 20 kb contig, and ``generate`` gives the
  manifest's hashes;
- the port's CLI (``--pairhmm-engine native``) gives the committed VCF and
  GVCF (``golden_e2e.diff``, IDs included, GVCF band rows exactly), with
  the native SW batch and with ROVACA_BANDED_REALIGN=1 (K3's plain
  versions: at least one banded batch, no fallback, no kernel launch);
- the realignment gate's truth table: the environment's 0/1 over any
  device, unset on exactly the CUDA devices;
- marked slow: rovaca_tpu's xla runs regenerate both references.

The corpus is generated once for the module (~30 s); the unmarked tests
take ~100 s on one worker.
"""

import numpy as np
import pytest
import torch

from rovaca_tpu.cli import main as jax_cli
from rovaca_tpu_torch.cli import main as port_cli
from rovaca_tpu_torch.genotype import alignment_utils as port_au
from rovaca_tpu_torch.ops.sw import banded
from rovaca_tpu_torch.tools import golden_adversarial, golden_flows
from test_torch_golden import ADVERSARIAL, _large_argv, \
    golden_adversarial_script


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_planting_and_truth_equal_the_script(seed):
    script = golden_adversarial_script()
    rng_s, rng_p = (np.random.default_rng(seed) for _ in range(2))
    ref_s, feats_s = script._plant_adversarial_ref(rng_s, 20_000)
    ref_p, feats_p = golden_adversarial._plant_adversarial_ref(rng_p, 20_000)
    assert ref_p == ref_s and feats_p == feats_s
    assert {k for k, *_ in feats_p} >= {"homopoly", "str"}
    truth_p = golden_adversarial._truth_for(rng_p, ref_p, feats_p)
    assert truth_p == script._truth_for(rng_s, ref_s, feats_s)
    assert truth_p and rng_p.random() == rng_s.random()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("adversarial"))
    golden_adversarial.generate(path)
    return path


def test_generate_gives_the_manifest_hashes(corpus):
    pinned = golden_flows.load_manifest()["corpus_adversarial"]
    assert pinned["args"] == golden_flows.CORPUS_ADVERSARIAL
    assert golden_flows.corpus_hashes(corpus) == {
        k: pinned[k] for k in golden_flows.CORPUS_HASHED}
    assert not golden_flows.corpus_problems(corpus, "corpus_adversarial")


@pytest.mark.parametrize("banded_on", [False, True])
@pytest.mark.parametrize("gvcf", [False, True])
def test_port_matches_committed_reference(corpus, tmp_path, monkeypatch,
                                          gvcf, banded_on):
    if banded_on:
        monkeypatch.setenv("ROVACA_BANDED_REALIGN", "1")
    else:       # the default: on the CPU the native SW batch
        monkeypatch.delenv("ROVACA_BANDED_REALIGN", raising=False)
    out = str(tmp_path / ("ours.g.vcf" if gvcf else "ours.vcf"))
    stats = {}
    before = banded.LAUNCHES, banded.TB_LAUNCHES
    argv = _large_argv(corpus, out, gvcf)
    argv[argv.index("xla")] = "native"
    assert port_cli(argv, stats=stats) == 0
    assert golden_adversarial.diff(str(tmp_path), gvcf) == 0
    # the CPU runs K3's plain versions: banded batches, no kernel launch
    assert (banded.LAUNCHES, banded.TB_LAUNCHES) == before
    assert stats["regions"] > 0 and stats["sw_fallbacks"] == 0
    assert (stats["sw_launches"] > 0) == banded_on, stats


@pytest.mark.slow
@pytest.mark.parametrize("mode", list(ADVERSARIAL))
def test_xla_regenerates_the_references(corpus, tmp_path, monkeypatch, mode):
    monkeypatch.delenv("ROVACA_BANDED_REALIGN", raising=False)
    gvcf = mode == "gvcf"
    out = str(tmp_path / f"adversarial.{mode}")
    assert jax_cli(_large_argv(corpus, out, gvcf)) == 0
    assert golden_flows.diff_against(out, ADVERSARIAL[mode],
                                     str(tmp_path / "diff"), gvcf) == 0


@pytest.mark.parametrize("env,on_cpu,on_card", [
    (None, False, True), ("0", False, False), ("false", False, False),
    ("", False, False), ("1", True, True)])
def test_gate_truth_table(monkeypatch, env, on_cpu, on_card):
    """rovaca_tpu's _use_banded_tpu_sw with the card as the device verdict:
    the environment decides when set, else the device (None is the card);
    nothing is resolved, so no card is needed."""
    if env is None:
        monkeypatch.delenv("ROVACA_BANDED_REALIGN", raising=False)
    else:
        monkeypatch.setenv("ROVACA_BANDED_REALIGN", env)
    for device in ("cpu", torch.device("cpu")):
        assert port_au.use_banded_sw(device) is on_cpu, device
    for device in (None, "cuda", "cuda:1", torch.device("cuda"),
                   torch.device("cuda", 0)):
        assert port_au.use_banded_sw(device) is on_card, device


def test_realignment_on_the_cpu_keeps_native_sw_by_default(monkeypatch):
    """A caller that names the CPU keeps the native SW batch when the
    environment is unset; the CLI's CPU engines give the CPU."""
    from rovaca_tpu_torch.pipeline.hc_engine import CallerConfig, RegionCaller
    monkeypatch.delenv("ROVACA_BANDED_REALIGN", raising=False)
    for engine in ("torch", "native"):
        dev = RegionCaller(CallerConfig(pairhmm_engine=engine)).sw_device
        assert dev == torch.device("cpu")
        assert not port_au.use_banded_sw(dev)
