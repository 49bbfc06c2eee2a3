"""Corpus, diff and measuring tools of the port (counterparts of scripts/,
bench.py and tests/simdata.py), each runnable as ``python -m
rovaca_tpu_torch.tools.<name>``: ``golden_e2e`` (generate, run either
caller, diff), ``simdata`` (what the generators call), ``golden_flows`` (the
flows whose rovaca_tpu outputs tests/golden_torch/ commits), ``race_e2e``
(interleaved repeated runs, depth_masked_diff), ``host_profile`` (a run's
host time by layer), ``kernel_bench`` (PairHMM cells/s on the card),
``scaling_bench`` (--shards 1/2/4), ``accuracy_eval`` (recall, precision
and genotype concordance against a truth set), ``golden_adversarial`` (the
adversarial corpus), the reference-golden tools ``golden_assembly`` and
``golden_pairhmm`` (cases in the C++ reference harness's format; ``golden``
holds this package to the reference's committed outputs in tests/golden/),
and ``golden_bqsr`` (a recalibration table that exercises every lookup
level), ``golden_modes`` (three contigs, two BAMs, dbSNP, BED targets),
``golden_region`` (one active region's chain), ``finalize_diff`` (the
region finalizer read for read) and ``golden_sweep`` (golden_e2e over
several seeds). Every ``ref`` leg runs the reference binary under
.refbuild/ and stops with one line without it; ``golden_bqsr``,
``golden_modes`` and ``golden_region`` also have a ``golden`` command that
holds this package to rovaca_tpu's outputs committed in
tests/golden_torch/."""
