"""HaplotypeCaller top-level pipeline: BAM + FASTA (+BED) -> VCF/GVCF.

Counterpart of the reference's HaplotypeCaller::do_work wiring (reference:
src/haplotypecaller/haplotypecaller.cpp:45-181) — rebuilt as a windowed
batch pipeline instead of an 8-thread queue mesh: stream filtered,
downsampled reads per contig; compute the activity profile per window;
cut regions; call each region; emit coordinate-ordered records.

Counterpart of rovaca_tpu/pipeline/caller.py. ``HCArgs``, ``RegionBatchSim``,
``__init__``, the read streams and contig validation are carried over as
they are; ``run`` and ``_call_contig`` with their JAX seams replaced:

- no XLA compile cache and no compile prewarm of launch shapes;
- ``--profile-dir`` records a torch.profiler trace instead of jax.profiler;
- each flush group is scored by this package's ``PairHMMScheduler``, its
  launches spread over every card of ``platform.devices()``;
- ``-t`` > 1 prepares regions in ``HostExecutor`` workers, which never touch
  the card;
- regions are genotyped by this package's ``RegionCaller``, whose
  realignment runs the banded SW kernel on the card for the cuda engine and
  the native SW batch for torch and native; ROVACA_BANDED_REALIGN=0 or =1
  forces one or the other.
"""

import dataclasses
import os

import numpy as np

from .. import constants as C
from ..io.bam import merged_reader
from ..io.bed import BedFile
from ..io.fasta import FastaFile
from ..io.vcf import VcfWriter
from ..ops.pairhmm.api import engine_device, resolve_engine
from ..reads.downsampler import PositionalDownsampler
from ..reads.filters import HCReadFilter
from . import activity
from .hc_engine import CallerConfig, RegionCaller
from .scheduler import PairHMMScheduler

WINDOW_SIZE = 1 << 20          # 1 Mbp activity windows
WINDOW_MARGIN = 1000           # reads/smear margin around each window


class RegionBatchSim:
    """Replays the reference's RegionSource batch boundaries so GVCF hom-ref
    blocks flush at the same positions (reference: RegionManager.cpp:11-108,
    haplotypecaller_engine.cpp:288-291 force_output per task).

    The reference's GVCF/VCF/little-chrom buffer factors are written `1/4`,
    `1/32` etc. — integer divisions that evaluate to 0 (RegionManager.cpp:5-9)
    — so on contigs < 500kb the batch breaks after every region that copied
    at least one read. On bigger contigs batching follows the 32 MiB
    BamDataPool: each copied read costs sizeof(bam1_t)=80 + round8(l_data)
    (bam_data_pool.hpp:37-71), and a batch closes when the remaining pool
    is <= 16x the costliest region so far (RegionManager.cpp:23,
    EXTRA_FACTOR=16)."""

    POOL = 32 * 1024 * 1024     # k_wgs_bamdata_pool_mem, haplotypecaller.cpp:24
    LITTLE = 500_000            # LITTLE_CHROM_SIZE, RegionManager.cpp:5
    MARGIN = 16                 # EXTRA_FACTOR, RegionManager.cpp:9

    def __init__(self, contig_len):
        self.little = contig_len < self.LITTLE
        self.used = 0
        self.max_region = 0

    @staticmethod
    def read_bytes(read):
        """Pool bytes one bam_copy1 of this read consumes."""
        tags = read.tags
        raw = getattr(tags, "_raw", None)
        if raw is not None:
            aux = len(raw)
        else:
            aux = 0
            for tag, val in tags.items():
                if isinstance(val, str) and len(val) == 1:
                    aux += 4
                elif isinstance(val, float):
                    aux += 7
                elif isinstance(val, int):
                    aux += 7
                else:
                    aux += 4 + len(str(val))
        qname_block = (len(read.name) + 1 + 3) // 4 * 4
        lq = len(read.bases)
        l_data = (qname_block + 4 * len(read.cigar) + (lq + 1) // 2 + lq
                  + aux)
        return 80 + ((l_data + 7) & ~7)

    def next_region(self, region_bytes):
        """Account one region (its copied-read bytes); True if the reference
        would have closed the batch BEFORE this region."""
        if self.little:
            flush = self.used > 0
        else:
            flush = (self.POOL - self.used) <= self.max_region * self.MARGIN
        if flush:
            self.used = 0
            self.max_region = 0
        self.used += region_bytes
        self.max_region = max(self.max_region, region_bytes)
        return flush


@dataclasses.dataclass
class HCArgs:
    bam_paths: list
    reference_path: str
    output_path: str
    bed_path: str = None
    interval_padding: int = C.DEFAULT_INTERVAL_PADDING
    gvcf_mode: bool = False
    gq_bands: tuple = C.DEFAULT_GVCF_GQ_BANDS
    max_reads_depth: int = C.DOWNSAMPLE_DEFAULT_TARGET
    pcr_indel_model: str = "CONSERVATIVE"
    dbsnp_path: str = None
    recal_table: str = None
    sample_name: str = None
    pairhmm_engine: str = "auto"
    base_quality_threshold: int = C.DEFAULT_BASE_QUALITY_THRESHOLD
    max_mnp_distance: int = C.MAX_MNP_DISTANCE
    target_span: str = None    # "chr20:1000000-2000000" restriction
    target_intervals: list = None  # multiple -L values -> BED-style targets
    host_workers: int = 1
    assemble_output_path: str = None
    resume: bool = False
    log_level: str = "INFO"
    compression_level: int = 6     # --compression-level (writer.cpp bgzf)
    profile_dir: str = None        # torch.profiler trace output directory


def parse_span(span):
    contig, _, rng = span.partition(":")
    if not rng:
        return contig, None, None
    s, _, e = rng.partition("-")
    return contig, int(s) - 1, int(e)


class HaplotypeCaller:
    """``stats`` gains ``launches`` (indexed-forward launches), ``device_ms``
    (card time of those launches), ``sw_launches`` (banded SW batches of the
    realignment) and ``sw_fallbacks`` (alignments of those batches sent to
    the host SW)."""

    def __init__(self, args):
        # fail before any IO when the engine is unknown or has no device
        engine = resolve_engine(args.pairhmm_engine)
        if engine != "native":
            engine_device(engine)
        self.args = args
        self.fasta = FastaFile(args.reference_path)
        self.bed = None
        if args.bed_path:
            self.bed = BedFile(args.bed_path,
                               contig_dict=self.fasta.contig_dict,
                               padding=args.interval_padding)
        elif args.target_intervals:
            # multiple -L spans behave like an interval list (BED targeting)
            clamped = [(c, s, min(e, self.fasta.contig_dict.get(c, e)))
                       for c, s, e in args.target_intervals]
            self.bed = BedFile.from_intervals(
                clamped, contig_dict=self.fasta.contig_dict,
                padding=args.interval_padding)
        self.dbsnp = None
        if args.dbsnp_path:
            from ..io.vcf import VcfReader
            self.dbsnp = VcfReader(args.dbsnp_path)
        self.bqsr = None
        if args.recal_table:
            from ..reads.bqsr import BQSRReadTransformer
            self.bqsr = BQSRReadTransformer.from_table(args.recal_table)
        self.stats = {"reads": 0, "filtered": 0, "regions": 0, "calls": 0,
                      "launches": 0, "device_ms": 0.0, "sw_launches": 0,
                      "sw_fallbacks": 0}

    def run(self):
        args = self.args
        from ..utils import logging as rlog
        log = rlog.init(args.log_level)
        rlog.banner({k: v for k, v in dataclasses.asdict(args).items()
                     if v is not None})
        span = parse_span(args.target_span) if args.target_span else None
        reader = self._open_reader(span)
        # peek header for sample name
        from ..io.bam import BamReader
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
        from ..parallel.host_executor import HostExecutor
        self.executor = HostExecutor(args.host_workers, config,
                                     self.fasta.contig_dict)

        from ..utils.checkpoint import ProgressCheckpoint, \
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
            from .block_combiner import BlockCombiner
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
    def _validate_contigs(self, bam_header):
        """Each BAM contig must exist in the reference with matching length
        (rovaca_tool.hpp:250-262 counterpart)."""
        ref_dict = self.fasta.contig_dict
        for name, length in zip(bam_header.ref_names,
                                bam_header.ref_lengths):
            ref_len = ref_dict.get(name)
            if ref_len is None:
                raise ValueError(
                    f"BAM contig {name!r} not present in the reference")
            if ref_len != length:
                raise ValueError(
                    f"contig {name!r} length mismatch: BAM {length} "
                    f"vs reference {ref_len}")

    def _open_reader(self, span):
        """Sequential k-way merge, or indexed fetch when a -L span is given
        and every input has a .bai (role of sam_itr_querys, reference:
        src/IOStream/bam_loader.cpp:63-91). Fetch is padded by the region
        boundary context so shard-edge regions see their full read support."""
        from ..io.bam import BamReader, merged_fetch, merged_reader
        if span is not None:
            readers = [BamReader(p) for p in self.args.bam_paths]
            if all(r.has_index() for r in readers):
                contig, beg, end = span
                clen = self.fasta.contig_dict.get(contig, 0)
                pad = C.REGION_MAX_SIZE + C.REGION_PADDING
                beg = max(0, (beg or 0) - pad)
                end = min(clen, end + pad) if end is not None else clen
                return merged_fetch(readers, contig, beg, end)
            for r in readers:
                r.close()
        return merged_reader(self.args.bam_paths)

    def _use_columnar(self):
        """Columnar ingestion handles the common single-BAM, no-BQSR
        configuration (the BQSR transform and the multi-BAM k-way merge
        stay on the object stream); see io/bamcols.py."""
        import os
        if os.environ.get("ROVACA_NO_COLUMNS"):
            return False
        if self.bqsr is not None or len(self.args.bam_paths) != 1:
            return False
        from ..io import bamcols
        from ..native import activity_native
        return bamcols.available() and activity_native.available()

    def _read_stream(self, reader, span):
        """(contig, reads) stream — columnar fast path when eligible,
        otherwise the ReadRecord object stream."""
        if not self._use_columnar():
            yield from self._reads_by_contig(reader, span)
            return
        # the object reader opened in run() is unused on this path
        if hasattr(reader, "close"):
            reader.close()
        yield from self._columns_by_contig(span)

    def _columns_by_contig(self, span):
        """Columnar mirror of _reads_by_contig: per contig, vectorized
        HC filter + WES targeting + native Java-LCG positional downsample
        over the column arrays; reads stay in slab form until a region
        needs objects. Bit-equal keep-set and order to the object path
        (tests/test_bamcols.py)."""
        from ..io.bamcols import ColumnarDownsampler, stream_contig_columns
        ds = ColumnarDownsampler(target=self.args.max_reads_depth)

        wes_ivals = {}
        if self.bed is not None:
            for ctg in self.fasta.contig_dict:
                ivs = self.bed.padded_intervals(ctg)
                if ivs:
                    wes_ivals[ctg] = (
                        np.array([s for s, _ in ivs], dtype=np.int64),
                        np.array([e for _, e in ivs], dtype=np.int64))

        pad = C.REGION_MAX_SIZE + C.REGION_PADDING
        pending = None      # (contig, cols, rows) buffered for at_eof
        for contig, cols in stream_contig_columns(self.args.bam_paths[0]):
            self.stats["reads"] += cols.n
            if span and contig != span[0]:
                continue
            mask = cols.hc_filter_mask()
            if self.bed is not None:
                ivs = wes_ivals.get(contig)
                if ivs is None:
                    continue
                starts, ends = ivs
                i = np.searchsorted(starts, cols.pos, side="right")
                c1 = (i > 0) & (ends[np.maximum(i - 1, 0)] > cols.pos)
                i_cl = np.minimum(i, len(starts) - 1)
                c2 = (i < len(starts)) & (starts[i_cl] < cols.end)
                on_target = c1 | c2
                # the reference's WES loader never streams off-target reads
                # (rovaca_tool.hpp:275); both filter counters and the LCG
                # stream see only targeted reads
                n_reaching = int(on_target.sum())
                mask &= on_target
                # filtered counter mirrors HCReadFilter.filtered_count:
                # on-target reads that failed the filter
                self.stats["filtered"] += n_reaching - int(mask.sum())
            else:
                self.stats["filtered"] += cols.n - int(mask.sum())
            if span and span[1] is not None:
                lo = max(0, span[1] - pad)
                hi = span[2] + pad
                mask &= (cols.pos < hi) & (cols.end > lo)
            rows = np.nonzero(mask)[0]
            if rows.size == 0:
                continue
            if pending is not None:
                pc, pcols, prows = pending
                kept = ds.keep_indices(pcols.pos[prows], at_eof=False)
                yield pc, pcols.select(prows[kept])
            pending = (contig, cols, rows)
        if pending is not None:
            pc, pcols, prows = pending
            kept = ds.keep_indices(pcols.pos[prows], at_eof=True)
            yield pc, pcols.select(prows[kept])

    def _reads_by_contig(self, reader, span):
        """Filtered + downsampled reads grouped per contig (streaming).

        One downsampler spans the whole run (the reference's stream is
        global: a single LCG state and reservoir across contigs,
        haplotypecaller.cpp:191-193). At contig boundaries the pending
        reservoir flushes losslessly (the position-change finalize); at the
        global end of stream the reference's iterator drops all but one
        read of the final flush (see PositionalDownsampler.stream_consume)."""
        filt = HCReadFilter()
        ds = PositionalDownsampler(target=self.args.max_reads_depth)
        current = None
        bucket = []
        # WES: the reference's loader fetches ONLY reads overlapping the
        # padded targets (hts_itr_multi over all_padded_intervals,
        # rovaca_tool.hpp:275) — the downsampler therefore consumes the
        # targeted stream. Filter identically so deep-pileup reservoir
        # draws stay bit-equal.
        wes_ivals = {}
        if self.bed is not None:
            import numpy as np_
            for ctg in self.fasta.contig_dict:
                ivs = self.bed.padded_intervals(ctg)
                if ivs:
                    wes_ivals[ctg] = (
                        np_.array([s for s, _ in ivs], dtype=np_.int64),
                        np_.array([e for _, e in ivs], dtype=np_.int64))

        def on_target(read):
            ivs = wes_ivals.get(read.contig)
            if ivs is None:
                return False
            starts, ends = ivs
            import bisect
            i = bisect.bisect_right(starts, read.pos)
            # candidate: the interval starting at or before read.pos, or
            # the next one beginning before read.end
            if i > 0 and ends[i - 1] > read.pos:
                return True
            return i < len(starts) and starts[i] < read.end

        for read in reader:
            self.stats["reads"] += 1
            if span and read.contig != span[0]:
                continue
            if self.bed is not None and not on_target(read):
                continue
            if not filt.test(read):
                continue
            if self.bqsr is not None:
                read = self.bqsr.apply(read)
            if read.contig != current:
                if current is not None and bucket:
                    out = ds.stream_consume(bucket, at_eof=False)
                    out.extend(ds.finalize())
                    yield current, out
                current = read.contig
                bucket = []
            bucket.append(read)
        if current is not None and bucket:
            yield current, ds.stream_consume(bucket, at_eof=True)
        self.stats["filtered"] = filt.filtered_count

    # ------------------------------------------------------------------
    def _call_contig(self, contig, reads, caller, writer, combiner, span):
        args = self.args
        ref = self.fasta.fetch(contig)
        contig_len = len(ref)
        from ..io.bamcols import BamColumns
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
        from ..utils import logging as rlog

        def finish_window(results, pw):
            """Genotype + emit one window whose batch was dispatched earlier.
            Runs while the NEXT flush group occupies the card (the
            reference's producer/consumer overlap, haplotypecaller.cpp:
            117-146)."""
            nonlocal next_available
            prepared, ready_calls, ordered, w_start, rbytes = pw
            from .ref_confidence import HomRefSpan
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
        from ..utils.refwindow import RefWindow

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
