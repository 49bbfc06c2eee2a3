"""Per-region calling engine on the port's PairHMM and banded SW.

Counterpart of rovaca_tpu/pipeline/hc_engine.py. ``RegionCaller`` subclasses
rovaca_tpu's and keeps its ``prepare_region`` (finalize, assemble, trim) and
GVCF helpers; two methods are carried over with their seams pointed at the
port:

- ``call_region`` scores through the port's ``compute_likelihoods`` (a dense
  batch on the dense kernel, its plain version or the native engine);
- ``finish_region`` realigns through the port's
  ``realign_reads_to_their_best_haplotype``, whose banded SW batch runs on
  the engine's device: the card for 'cuda', the CPU for 'torch' and
  'native'.

``sw_launches`` counts the banded batches run and ``sw_fallbacks`` the
alignments among them sent to the host SW.
"""

import torch

from rovaca_tpu.genotype.likelihoods import AlleleLikelihoods
from rovaca_tpu.pipeline import hc_engine as _ref
from rovaca_tpu.pipeline.hc_engine import CallerConfig, PreparedRegion

from ..genotype.alignment_utils import realign_reads_to_their_best_haplotype
from ..ops.pairhmm.api import compute_likelihoods, engine_device, \
    resolve_engine

__all__ = ["CallerConfig", "PreparedRegion", "RegionCaller"]


class RegionCaller(_ref.RegionCaller):
    def __init__(self, config=None, contig_lengths=None):
        super().__init__(config, contig_lengths)
        engine = resolve_engine(self.config.pairhmm_engine)
        self.sw_device = (engine_device(engine) if engine == "cuda"
                          else torch.device("cpu"))
        self.sw_launches = 0
        self.sw_fallbacks = 0

    def call_region(self, region, reads, ref, contig):
        """Single-region entry (prepare + score + finish in one step)."""
        prepared = self.prepare_region(region, reads, ref, contig)
        if isinstance(prepared, list):
            return prepared
        lik_matrix, kept = compute_likelihoods(
            prepared.call_reads, [h.bases for h in prepared.haps],
            pcr_model=self.config.pcr_indel_model,
            min_quality_threshold=self.config.min_quality_threshold,
            engine=self.config.pairhmm_engine)
        return self.finish_region(prepared, lik_matrix, kept)

    def finish_region(self, prepared, lik_matrix, kept):
        """Genotype a scored region."""
        cfg = self.config
        p = prepared
        self.genotyping.args.contig_length = p.contig_length
        pad_start = max(0, p.region.start - cfg.region_padding)
        pad_stop = min(p.contig_length - 1, p.region.end + cfg.region_padding)
        kept_reads = [p.call_reads[i] for i in kept]
        if not kept_reads:
            if cfg.gvcf_mode:
                return self._reference_confidence_only(
                    p.region, p.reads, p.ref, p.contig,
                    (pad_start, pad_stop))
            return []
        hap_lik = AlleleLikelihoods(list(p.haps), kept_reads, lik_matrix)
        # project reads through their best haplotype into ref coordinates
        batches, fallbacks = realign_reads_to_their_best_haplotype(
            hap_lik, self.sw_device)
        self.sw_launches += batches
        self.sw_fallbacks += fallbacks
        kept_reads = hap_lik.reads

        span_start, span_stop = p.span
        var_start, var_stop = p.variant_span
        trimmed_window = bytes(p.ref[span_start:span_stop + 1])
        calls, called_haps = self.genotyping.assign_genotype_likelihoods(
            hap_lik, trimmed_window, span_start, var_start, var_stop,
            filtered_reads=p.filtered_reads)
        for c in calls:
            c.contig = p.contig

        if cfg.gvcf_mode:
            if not calls:
                # no real calls survived genotyping: the whole region falls
                # back to the no-variation model over the finalized reads
                return self._reference_confidence_only(
                    p.region, p.reads, p.ref, p.contig,
                    (pad_start, pad_stop))
            calls = self._merge_with_ref_confidence(
                p.region, p.reads, p.ref, p.contig, calls, kept_reads,
                p.variant_span, p.span, (pad_start, pad_stop))
        return calls
