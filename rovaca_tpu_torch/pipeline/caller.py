"""HaplotypeCaller top-level pipeline on the card: BAM + FASTA (+BED) -> VCF.

Counterpart of rovaca_tpu/pipeline/caller.py. ``__init__``, the read
streams, contig validation and ``HCArgs`` are inherited unchanged; ``run`` and
``_call_contig`` are carried over with their JAX seams replaced:

- no XLA compile cache and no compile prewarm of launch shapes;
- ``--profile-dir`` records a torch.profiler trace instead of jax.profiler;
- each flush group is scored by this package's ``PairHMMScheduler``;
- regions are genotyped by this package's ``RegionCaller``, whose
  realignment runs the banded SW kernel on the engine's device when
  ROVACA_BANDED_REALIGN is set (the native SW batch otherwise).

Region prep, activity, trimming, genotyping, reference confidence, the block
combiner and the VCF writer are rovaca_tpu's own.
"""

import dataclasses
import os

import numpy as np

from rovaca_tpu import constants as C
from rovaca_tpu.io.vcf import VcfWriter
from rovaca_tpu.pipeline import activity
from rovaca_tpu.pipeline import caller as _ref
from rovaca_tpu.pipeline.caller import (WINDOW_MARGIN, WINDOW_SIZE, HCArgs,
                                        RegionBatchSim, parse_span)

from ..ops.pairhmm.api import engine_device, resolve_engine
from .hc_engine import CallerConfig, RegionCaller
from .scheduler import PairHMMScheduler

__all__ = ["HCArgs", "HaplotypeCaller", "parse_span"]


class HaplotypeCaller(_ref.HaplotypeCaller):
    """rovaca_tpu's HaplotypeCaller with PairHMM scoring on the port's
    engines. ``stats`` gains ``launches`` (indexed-forward launches),
    ``device_ms`` (card time of those launches), ``sw_launches`` (banded SW
    batches of the realignment) and ``sw_fallbacks`` (alignments of those
    batches sent to the host SW)."""

    def __init__(self, args):
        if args.host_workers and args.host_workers > 1:
            raise ValueError(
                "-t/--host-workers > 1 is not ported yet: its worker "
                "processes pin jax to the CPU (a later PR ports them)")
        # fail before any IO when the engine is unknown or has no device
        engine = resolve_engine(args.pairhmm_engine)
        if engine != "native":
            engine_device(engine)
        super().__init__(args)
        self.stats.update(launches=0, device_ms=0.0, sw_launches=0,
                          sw_fallbacks=0)

    def run(self):
        args = self.args
        from rovaca_tpu.utils import logging as rlog
        log = rlog.init(args.log_level)
        rlog.banner({k: v for k, v in dataclasses.asdict(args).items()
                     if v is not None})
        span = parse_span(args.target_span) if args.target_span else None
        reader = self._open_reader(span)
        # peek header for sample name
        from rovaca_tpu.io.bam import BamReader
        header = BamReader(args.bam_paths[0]).header
        self._validate_contigs(header)
        sample = args.sample_name or (header.samples[0] if header.samples
                                      else "SAMPLE")

        config = CallerConfig(gvcf_mode=args.gvcf_mode,
                              pcr_indel_model=args.pcr_indel_model,
                              sample_name=sample,
                              pairhmm_engine=args.pairhmm_engine,
                              assemble_output_path=args.assemble_output_path,
                              min_quality_threshold=args.base_quality_threshold,
                              max_mnp_distance=args.max_mnp_distance)
        caller = RegionCaller(config, self.fasta.contig_dict)
        from rovaca_tpu.parallel.host_executor import HostExecutor
        self.executor = HostExecutor(args.host_workers, config,
                                     self.fasta.contig_dict)

        from rovaca_tpu.utils.checkpoint import ProgressCheckpoint, \
            truncate_output_after
        self.checkpoint = None
        append = False
        if args.resume:
            self.checkpoint = ProgressCheckpoint(args.output_path)
            if os.path.exists(args.output_path) and \
                    self.checkpoint.state["contigs"]:
                for contig, win in self.checkpoint.state["contigs"].items():
                    truncate_output_after(args.output_path, contig,
                                          win + WINDOW_SIZE)
                append = True
                log.info("resuming from checkpoint: %s",
                         self.checkpoint.state["contigs"])

        writer = VcfWriter(args.output_path, self.fasta.contig_dict,
                           sample=sample, gvcf=args.gvcf_mode,
                           gq_bands=list(args.gq_bands), append=append,
                           compression_level=args.compression_level)

        # close output cleanly on SIGINT/SIGTERM (rovaca_signal_handler.h)
        import signal as _signal

        def _on_signal(signum, frame):
            log.warning("signal %d received; closing output", signum)
            try:
                writer.close()
            finally:
                os._exit(1)

        for sig in (_signal.SIGINT, _signal.SIGTERM):
            try:
                _signal.signal(sig, _on_signal)
            except ValueError:
                pass  # not the main thread
        combiner = None
        if args.gvcf_mode:
            from rovaca_tpu.pipeline.block_combiner import BlockCombiner
            combiner = BlockCombiner(list(args.gq_bands), writer)

        profiler = None
        if args.profile_dir:
            # host + card trace, viewable in Perfetto / chrome://tracing
            import torch
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=acts)
            profiler.start()
        try:
            for contig, reads in self._read_stream(reader, span):
                self._call_contig(contig, reads, caller, writer, combiner,
                                  span)
        finally:
            if profiler is not None:
                profiler.stop()
                os.makedirs(args.profile_dir, exist_ok=True)
                profiler.export_chrome_trace(
                    os.path.join(args.profile_dir, "trace.json"))
            if combiner:
                combiner.finish()
            writer.close()
            self.executor.close()
            if self.checkpoint is not None:
                self.checkpoint.finish()
        self.stats.update(sw_launches=caller.sw_launches,
                          sw_fallbacks=caller.sw_fallbacks)
        rlog.teardown_counters(self.stats)
        return self.stats

    # ------------------------------------------------------------------
    def _call_contig(self, contig, reads, caller, writer, combiner, span):
        args = self.args
        ref = self.fasta.fetch(contig)
        contig_len = len(ref)
        from rovaca_tpu.io.bamcols import BamColumns
        is_cols = isinstance(reads, BamColumns)
        if (is_cols and reads.n == 0) or (not is_cols and not reads):
            return

        # hoist read spans into arrays once: the window/region loops below
        # select overlapping reads millions of times
        if is_cols:
            pos_arr, end_arr = reads.pos, reads.end
            n_reads = reads.n
        else:
            pos_arr = np.fromiter((r.pos for r in reads), np.int64,
                                  len(reads))
            end_arr = np.fromiter((r.end for r in reads), np.int64,
                                  len(reads))
            n_reads = len(reads)
        pos_sorted = bool(np.all(pos_arr[1:] >= pos_arr[:-1]))

        # left bound for sorted selections: a read at pos < start-max_span
        # cannot reach `start`, so the end-test only needs the
        # [start-max_span, stop) pos slice instead of a prefix scan from 0
        max_span = int((end_arr - pos_arr).max()) if n_reads else 0

        def overlapping_sel(p_arr, e_arr, start, stop, sorted_ok):
            if sorted_ok:
                lo_i = int(np.searchsorted(p_arr, start - max_span))
                hi_i = int(np.searchsorted(p_arr, stop))
                return lo_i + np.nonzero(e_arr[lo_i:hi_i] > start)[0]
            return np.nonzero((p_arr < stop) & (e_arr > start))[0]

        lo = int(pos_arr.min())
        hi = int(end_arr.max())
        pad = C.REGION_MAX_SIZE + C.REGION_PADDING
        if span and span[1] is not None:
            # process with boundary context beyond the owned span; emission is
            # still filtered to the core span (regions never straddle shards)
            lo, hi = max(lo, span[1] - pad), min(hi, span[2] + pad)
        caller.genotyping.clear_upstream_deletions()
        # cross-region spanning-deletion emission fixup (GVCF): hom-ref
        # lines under a deletion emitted by an earlier region are dropped /
        # clipped so the next emitted position is the deletion end + 1
        # (reference: block_combiner.cpp:41-48 next_variant_pos,
        # writer.cpp:218-335 check_deletion_variant)
        next_available = 0
        batch_sim = RegionBatchSim(contig_len)

        emit_inactive = args.gvcf_mode
        resume_floor = (self.checkpoint.completed_through(contig)
                        if self.checkpoint is not None else -1)
        from rovaca_tpu.utils import logging as rlog

        def finish_window(results, pw):
            """Genotype + emit one window whose batch was dispatched earlier.
            Runs while the NEXT flush group occupies the card (the
            reference's producer/consumer overlap, haplotypecaller.cpp:
            117-146)."""
            nonlocal next_available
            prepared, ready_calls, ordered, w_start, rbytes = pw
            from rovaca_tpu.pipeline.ref_confidence import HomRefSpan
            for key in ordered:
                if combiner is not None and batch_sim.next_region(rbytes[key]):
                    combiner.flush_batch()
                if key in ready_calls:
                    calls = ready_calls[key]
                else:
                    lik, kept = results[key]
                    calls = caller.finish_region(prepared[key], lik, kept)
                for call in calls:
                    if isinstance(call, HomRefSpan):
                        if next_available > call.start:
                            call = call.clip(next_available, 1 << 62)
                            if call is None:
                                continue
                        # hom-ref runs stay as arrays end to end; dbSNP IDs
                        # never survive block merging, so the lookup is
                        # skipped (same output as the per-position path)
                        if span and span[1] is not None:
                            call = call.clip(span[1], span[2])
                            if call is None:
                                continue
                        self.stats["calls"] += len(call)
                        if combiner is not None:
                            combiner.submit_span(call)
                        else:
                            for v in call.expand():
                                writer.write(v)
                        continue
                    ref_len = len(call.ref.bases)
                    if ref_len > 1:
                        # deletion horizon: next emittable hom-ref position
                        # (tracked before span filtering so context regions
                        # at shard edges still update it)
                        next_available = max(next_available,
                                             call.start + ref_len)
                    if span and span[1] is not None and not (
                            span[1] <= call.start < span[2]):
                        continue
                    if self.dbsnp is not None:
                        rsid = self.dbsnp.lookup_id(
                            contig, call.start, call.ref.bases,
                            [a.bases for a in call.alts])
                        if rsid:
                            call.id = rsid
                    self.stats["calls"] += 1
                    if combiner is not None:
                        combiner.submit(call)
                    else:
                        writer.write(call)
            if (self.checkpoint is not None and combiner is None):
                self.checkpoint.mark_window(contig, w_start)

        # regions accumulate across windows into flush groups so launches
        # stay large; the previous group is genotyped while the current one
        # runs on the card
        from rovaca_tpu.utils.refwindow import RefWindow

        def new_sched():
            return PairHMMScheduler(
                engine=args.pairhmm_engine,
                min_quality_threshold=args.base_quality_threshold)

        flush_tiles = int(os.environ.get("ROVACA_FLUSH_TILES", "256"))
        group_sched = new_sched()
        group_windows = []   # (prepared, ready_calls, ordered, win_start)
        group_tiles = 0
        flushed = None       # (sched, windows) dispatched, not yet collected

        def drain_flushed():
            nonlocal flushed
            if flushed is None:
                return
            fin_sched, fin_windows = flushed
            flushed = None
            results = fin_sched.collect()
            self.stats["launches"] += fin_sched.launches
            self.stats["device_ms"] += fin_sched.device_ms
            for pw in fin_windows:
                finish_window(results, pw)

        for win_start in range(max(0, lo - WINDOW_MARGIN), hi, WINDOW_SIZE):
            if win_start <= resume_floor:
                continue
            win_end = min(contig_len, win_start + WINDOW_SIZE + WINDOW_MARGIN)
            if span and span[1] is not None:
                # don't form (and then discard) regions beyond the -L span:
                # emission is clamped to the core span anyway
                win_end = min(win_end, span[2] + pad)
            win_sel = overlapping_sel(pos_arr, end_arr, win_start, win_end,
                                      pos_sorted)
            if win_sel.size == 0:
                continue
            if is_cols:
                win_items = reads.select(win_sel)
                win_pool_bytes = (win_items.region_pool_bytes()
                                  if combiner is not None else None)
            else:
                win_items = [reads[i] for i in win_sel]
            win_pos = pos_arr[win_sel]
            win_ends = end_arr[win_sel]
            mask = (self.bed.mask(contig, win_start, win_end, padded=True)
                    if self.bed else None)
            regions = activity.find_active_regions(
                win_items, ref, contig, win_start, win_end,
                emit_inactive=emit_inactive, target_mask=mask)
            # prepare all regions of the window, score them in batched
            # launches spanning windows, then genotype (scheduler.py)
            prepared = {}
            ready_calls = {}
            ordered = []
            rbytes = {}
            tasks = []
            for region in regions:
                # regions fully in the overlap margin belong to the next window
                if region.start >= win_start + WINDOW_SIZE:
                    continue
                self.stats["regions"] += 1
                pad_s = max(0, region.start - C.REGION_PADDING)
                pad_e = min(contig_len, region.end + 1 + C.REGION_PADDING)
                sel = overlapping_sel(win_pos, win_ends, pad_s, pad_e,
                                      pos_sorted)
                key = (region.start, region.end)
                ordered.append(key)
                if is_cols:
                    rbytes[key] = (int(win_pool_bytes[sel].sum())
                                   if combiner is not None else 0)
                    region_reads = ("cols", win_items, sel)
                else:
                    region_reads = [win_items[i] for i in sel]
                    rbytes[key] = (sum(RegionBatchSim.read_bytes(r)
                                       for r in region_reads)
                                   if combiner is not None else 0)
                rw = RefWindow.of(ref, max(0, pad_s - 700),
                                  min(contig_len - 1, pad_e + 700))
                tasks.append((key, region, region_reads, rw, contig))
            results_by_key = self.executor.map_prepare(caller, tasks)
            for key, p in results_by_key.items():
                if isinstance(p, list):
                    ready_calls[key] = p
                else:
                    prepared[key] = p
                    group_sched.submit(key, p.call_reads,
                                       [h.bases for h in p.haps],
                                       pcr_model=args.pcr_indel_model)
                    group_tiles += (-(-len(p.call_reads) // 128)
                                    * -(-len(p.haps) // 8))
            group_windows.append((prepared, ready_calls, ordered, win_start,
                                  rbytes))
            if group_tiles >= flush_tiles:
                group_sched.dispatch()
                drain_flushed()  # genotype the prior group during this one
                flushed = (group_sched, group_windows)
                group_sched = new_sched()
                group_windows = []
                group_tiles = 0
        if group_windows:
            group_sched.dispatch()
            drain_flushed()
            flushed = (group_sched, group_windows)
        drain_flushed()
        if combiner is not None:
            combiner.flush_contig()
        if self.checkpoint is not None and combiner is not None:
            self.checkpoint.mark_window(contig, hi)
        rlog.logger.info("contig %s done: %d regions, %d records so far",
                         contig, self.stats["regions"], self.stats["calls"])
