"""Per-region calling engine: reads + region -> variant calls.

Counterpart of the reference's HaplotypeCallerEngine::call_region (reference:
src/haplotypecaller/haplotypecaller_engine.cpp:107-309): finalize reads,
assemble, trim to the variant span, filter, PairHMM, realign reads to their
best haplotype, genotype, and (GVCF) reference-confidence for non-variant
flanks.

Counterpart of rovaca_tpu/pipeline/hc_engine.py, carried over with two seams
pointed at the port:

- ``call_region`` scores through the port's ``compute_likelihoods`` (a dense
  batch on the dense kernel, its plain version or the native engine);
- ``finish_region`` realigns through the port's
  ``realign_reads_to_their_best_haplotype`` on the engine's device
  (``sw_device``): for 'cuda' the card, where its SW batch runs the banded
  kernel by default; for 'torch' and 'native' the CPU, where it runs the
  native SW batch unless ROVACA_BANDED_REALIGN=1 forces the banded plain
  versions.

``sw_launches`` counts the banded batches run and ``sw_fallbacks`` the
alignments among them sent to the host SW. ``prepare_region`` is host-only:
the module imports torch only where a region is scored or realigned, so a
``-t`` worker that prepares regions never imports it.
"""

import dataclasses

import numpy as np

from .. import constants as C
from ..assembly import assembler
from ..genotype.engine import GenotypingArgs, GermlineGenotypingEngine
from ..genotype.likelihoods import AlleleLikelihoods
from ..reads.cigar import CigarOp
from . import trimming

READ_LENGTH_FILTER_THRESHOLD = 10  # haplotypecaller_engine.cpp:31


@dataclasses.dataclass
class PreparedRegion:
    """A region after host-side prep, awaiting PairHMM scoring."""
    region: object
    reads: list
    ref: object            # RefWindow over the padded region
    contig: str
    haps: list
    call_reads: list
    span: tuple
    variant_span: tuple
    contig_length: int = 1 << 60
    filtered_reads: tuple = ()  # non-passing reads kept for DP/AD annotation


@dataclasses.dataclass
class CallerConfig:
    gvcf_mode: bool = False
    pcr_indel_model: str = "CONSERVATIVE"
    mapping_quality_threshold: int = C.MAPPING_QUALITY_THRESHOLD
    sample_name: str = "SAMPLE"
    pairhmm_engine: str = "auto"
    max_mnp_distance: int = C.MAX_MNP_DISTANCE
    region_padding: int = C.REGION_PADDING
    reference_padding: int = C.REFERENCE_PADDING
    assemble_output_path: str = None
    min_quality_threshold: int = C.MIN_QUALITY_THRESHOLD


class RegionCaller:
    def __init__(self, config=None, contig_lengths=None):
        self.config = config or CallerConfig()
        self.contig_lengths = contig_lengths or {}
        self.genotyping = GermlineGenotypingEngine(GenotypingArgs(
            gvcf_mode=self.config.gvcf_mode,
            max_mnp_distance=self.config.max_mnp_distance,
            sample_name=self.config.sample_name))
        self._sw_device = None
        self.sw_launches = 0
        self.sw_fallbacks = 0

    @property
    def sw_device(self):
        """Device of the realignment's banded SW batch: the card for the
        'cuda' engine (raises without one), else the CPU. Resolved at first
        use, so building a caller imports no torch."""
        if self._sw_device is None:
            import torch

            from ..ops.pairhmm.api import engine_device, resolve_engine
            engine = resolve_engine(self.config.pairhmm_engine)
            self._sw_device = (engine_device(engine) if engine == "cuda"
                               else torch.device("cpu"))
        return self._sw_device

    def call_region(self, region, reads, ref, contig):
        """Single-region entry (prepare + score + finish in one step)."""
        prepared = self.prepare_region(region, reads, ref, contig)
        if isinstance(prepared, list):
            return prepared
        from ..ops.pairhmm.api import compute_likelihoods
        lik_matrix, kept = compute_likelihoods(
            prepared.call_reads, [h.bases for h in prepared.haps],
            pcr_model=self.config.pcr_indel_model,
            min_quality_threshold=self.config.min_quality_threshold,
            engine=self.config.pairhmm_engine)
        return self.finish_region(prepared, lik_matrix, kept)

    def prepare_region(self, region, reads, ref, contig):
        """Host-side region prep: finalize, assemble, trim.

        Returns a PreparedRegion (needs PairHMM scoring) or a ready list of
        calls (inactive/no-variation regions)."""
        cfg = self.config
        contig_len = self.contig_lengths.get(contig, len(ref))

        pad_start = max(0, region.start - cfg.region_padding)
        pad_stop = min(contig_len - 1, region.end + cfg.region_padding)

        # columnar payload from the ingestion slabs (io/bamcols.py):
        # ("cols", BamColumns, row-indices). Inactive GVCF regions feed the
        # packed native path with slab gathers; only active regions (and
        # fallbacks) materialize ReadRecords.
        cols_idx = None
        if isinstance(reads, tuple) and len(reads) == 3 and \
                reads[0] == "cols":
            cols_idx = (reads[1], reads[2])
        if not region.is_active:
            if cfg.gvcf_mode:
                # the reference finalizes reads AND corrects overlapping
                # mate quals before the active check (hc_assemble_reads.c:
                # 35-45; non-active returns right after). Packed fast
                # path: the finalize arrays feed the position-obs
                # accumulator directly, no ReadRecord round-trip.
                import os
                if not os.environ.get("ROVACA_NO_NATIVE_FINALIZE"):
                    from ..native import finalize_native, posobs_native
                    if posobs_native.available():
                        pk = finalize_native.finalize_region_packed(
                            None if cols_idx is not None else reads,
                            pad_start, pad_stop, cols_idx=cols_idx)
                        if pk is not None:
                            return self._reference_confidence_only(
                                region, pk, ref, contig,
                                (pad_start, pad_stop))
                if cols_idx is not None:
                    reads = cols_idx[0].materialize(cols_idx[1])
                fin = assembler.finalize_and_adjust(reads, pad_start,
                                                    pad_stop)
                return self._reference_confidence_only(
                    region, fin, ref, contig, (pad_start, pad_stop))
            return []

        packed = None
        window = bytes(ref[pad_start:pad_stop + 1])
        if cols_idx is not None:
            # columnar active region: the native fused prepare consumes the
            # slab-gathered pack and build_records sources names/tags etc.
            # straight from the slabs — source ReadRecords are materialized
            # ONLY if the native path is unavailable
            packed = cols_idx[0].pack(cols_idx[1])
            fused = assembler.prepare_region_native(
                None, pad_start, pad_stop, window, pad_start,
                packed=packed, src_cols=cols_idx, lazy_records=True)
            if fused is None:
                reads = cols_idx[0].materialize(cols_idx[1])
        else:
            fused = assembler.prepare_region_native(
                reads, pad_start, pad_stop, window, pad_start,
                lazy_records=True)
        if fused is not None:
            # fin is a memoized thunk: regions that trim away in VCF mode
            # never pay for ReadRecord materialization
            fin_thunk, haplotypes = fused
        else:
            fin = assembler.finalize_and_adjust(reads, pad_start, pad_stop)
            haplotypes = assembler.assemble_region(fin, window, pad_start)
            fin_thunk = lambda: fin  # noqa: E731

        if cfg.assemble_output_path:
            self._dump_assembly(region, contig, fin_thunk(), haplotypes)

        trim = trimming.trim_region(
            haplotypes, window, pad_start, region.start, region.end,
            pad_start, pad_stop, cfg.max_mnp_distance)
        # GVCF fallbacks prefer the packed finalize slabs (no ReadRecord
        # materialization); fused-native thunks expose them as .packed
        def rc_reads():
            pk = getattr(fin_thunk, "packed", None)
            return pk() if pk is not None else fin_thunk()

        if trim is None:
            if cfg.gvcf_mode:
                return self._reference_confidence_only(
                    region, rc_reads(), ref, contig, (pad_start, pad_stop))
            return []

        span_start, span_stop = trim.padded_span
        var_start, var_stop = trim.variant_span
        haps = trimming.trim_haplotypes(haplotypes, window, span_start,
                                        span_stop)
        if len(haps) <= 1:
            if cfg.gvcf_mode:
                return self._reference_confidence_only(
                    region, rc_reads(), ref, contig, (pad_start, pad_stop))
            return []
        fin = fin_thunk()
        call_reads = trimming.trim_reads(fin, span_start, span_stop)
        untrimmed_fin = fin  # original_reads for GVCF flanks / fallbacks
        # filter_non_passing_reads (haplotypecaller_engine.cpp:419-437):
        # short, low-MQ, or mate-on-other-contig reads leave the calling
        # set but are fed back into the annotation likelihoods with 0.0
        # likelihood so DP reflects them
        # (prepare_read_allele_likelihoods_for_annotation,
        # germline_genotying_engine.cpp:606-641)
        passing, filtered = [], []
        for r in call_reads:
            softclips = sum(n for op, n in r.cigar.elements
                            if op == CigarOp.S)
            aligned_len = len(r.bases) - softclips
            mate_ok = (not r.is_paired or r.is_unmapped
                       or r.ref_id == r.mate_ref_id)
            if (aligned_len < READ_LENGTH_FILTER_THRESHOLD
                    or r.mapping_quality < cfg.mapping_quality_threshold
                    or not mate_ok):
                filtered.append(r)
            else:
                passing.append(r)
        call_reads = passing
        if not call_reads:
            if cfg.gvcf_mode:
                return self._reference_confidence_only(
                    region, untrimmed_fin, ref, contig,
                    (pad_start, pad_stop))
            return []

        from ..utils.refwindow import RefWindow
        # extra margin: reads attached to the region can start before the
        # padded span, and the GVCF pileup path walks their full alignments
        margin = 600
        ref_view = RefWindow.of(ref, max(0, pad_start - margin),
                                min(contig_len - 1, pad_stop + margin))
        return PreparedRegion(region=region, reads=untrimmed_fin,
                              ref=ref_view,
                              contig=contig, haps=haps,
                              call_reads=call_reads, span=(span_start,
                                                           span_stop),
                              variant_span=(var_start, var_stop),
                              contig_length=contig_len,
                              filtered_reads=tuple(filtered))

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
        # (realign_reads_to_their_best_haplotype, haplotypecaller_engine:264)
        from ..genotype.alignment_utils import \
            realign_reads_to_their_best_haplotype
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
                # (haplotypecaller_engine.cpp:269-273 contains_calls)
                return self._reference_confidence_only(
                    p.region, p.reads, p.ref, p.contig,
                    (pad_start, pad_stop))
            calls = self._merge_with_ref_confidence(
                p.region, p.reads, p.ref, p.contig, calls, kept_reads,
                p.variant_span, p.span, (pad_start, pad_stop))
        return calls

    def _dump_assembly(self, region, contig, reads, haplotypes):
        """Golden-diff dump: region, sorted reads, lexicographically sorted
        haplotypes (--assemble-output; haplotypecaller_engine.cpp:339-395)."""
        with open(self.config.assemble_output_path, "a") as fh:
            fh.write(f"{contig}:{region.start}-{region.end}\t"
                     f"reads: {len(reads)}\t"
                     f"haplotypes: {len(haplotypes)}\n")
            for r in sorted(reads, key=lambda r: (r.pos, r.name)):
                fh.write(f"{r.name}\t{r.pos}\n")
            for h in sorted(haplotypes, key=lambda h: h.bases):
                fh.write(h.bases.decode() + "\n")
            fh.write("\n")

    # -- GVCF support (filled in by the reference-confidence model) --------
    def _reference_confidence_only(self, region, reads, ref, contig,
                                   padded_span=None):
        from . import ref_confidence
        return ref_confidence.reference_model_for_no_variation(
            region, reads, ref, contig, padded_span=padded_span,
            mapping_quality_threshold=self.config.mapping_quality_threshold,
            sample=self.config.sample_name)

    def _merge_with_ref_confidence(self, region, reads, ref, contig, calls,
                                   genotype_reads, variant_span,
                                   variant_padded_span=None,
                                   padded_span=None):
        from . import ref_confidence
        return ref_confidence.calculate_ref_confidence_with_calls(
            region, reads, ref, contig, calls, genotype_reads, variant_span,
            variant_padded_span=variant_padded_span,
            padded_span=padded_span,
            mapping_quality_threshold=self.config.mapping_quality_threshold,
            sample=self.config.sample_name,
            region_padding=self.config.region_padding,
            contig_length=self.genotyping.args.contig_length)
