"""Full-pipeline data parallelism over a list of devices.

Counterpart of rovaca_tpu/parallel/pipeline_shard.py, which imports jax
through its ``sharding``. Genomic interval shards map onto devices; each
shard's compact indexed launch (the production wire format of
ops/pairhmm/compact.py: uint8 quals, gap phreds and base codes plus a
(hap-tile, read-tile) pair list) runs on its own device as one launch of the
indexed kernel (K1), which reads the compact arrays directly; the results
gather in shard (== genome) order, the host genotypes per shard and merges
records coordinate-ordered.

``pipeline_dryrun(n_devices)`` drives regions -> assembly -> sharded PairHMM
-> genotyping -> ordered merge end to end over ``n_devices`` shards and
asserts that the merged records equal an unsharded run. The simulation, the
region selection, the launch packing and the record identity are carried
over unchanged; the packing builds its batches with the port's
``build_pair_batch_compact``.
"""

import numpy as np
import torch

from .. import constants as C
from ..ops.pairhmm.api import finish_scores
from ..ops.pairhmm.indexed import pairhmm_indexed_compact
from .sharding import data_devices, per_shard, shard_intervals

_DRY_LR = 64     # fixed read-length bucket for the dryrun step
_DRY_LH = 512    # fixed hap-length bucket (indel regions re-pad haps)
_DRY_NR = 32     # read tiles per shard launch
_DRY_NH = 16     # hap tiles per shard launch
_DRY_G = 96      # (hap-tile, read-tile) pairs per shard launch


def sharded_pipeline_step(devices, q, gi, gc, rbase, rlen, hcode, hlen,
                          hidx, ridx):
    """One multi-device step over per-shard compact indexed launches.

    Inputs carry an [S, ...] leading dim: per shard, the compact launch
    arrays exactly as the production scheduler ships them. Shard ``s`` is one
    K1 launch on ``devices[s % len(devices)]`` (the plain version on CPU
    tensors). Returns raw scores [S, G, 8, 128] in shard order on
    ``devices[0]``.
    """
    return per_shard(devices, (q, gi, gc, rbase, rlen, hcode, hlen, hidx,
                               ridx), pairhmm_indexed_compact)


def _postprocess(batch, raw, reads, haps, pcr_model, mqt):
    """The scheduler's post-processing for one region (multi-tile)."""
    return finish_scores(batch.result_matrix(raw), reads, haps, pcr_model,
                         mqt)


# --------------------------------------------------------------------------
# dryrun: simulate -> regions -> sharded step -> genotype -> merge
# --------------------------------------------------------------------------

def _simulate(genome_len=16000, coverage=24, read_len=50, seed=20260819):
    """Tiny in-memory diploid case with SNPs AND indels; reads sampled
    from the alt haplotype get real cigars by SW alignment to the
    reference (the same GATK-exact SW the production pipeline uses)."""
    from ..assembly.sw import (READ_TO_HAPLOTYPE_PARAMS, OverhangStrategy,
                               sw_align)
    from ..reads.record import ReadRecord

    rng = np.random.default_rng(seed)
    contig = "chr20"
    ref = "".join(rng.choice(list("ACGT"), size=genome_len))
    # het SNP / insertion / deletion alternating every ~1500bp
    truth = []
    kinds = ["snp", "snp", "ins", "snp", "del"]
    for n, pos in enumerate(range(700, genome_len - 700, 1500)):
        kind = kinds[n % len(kinds)]
        if kind == "snp":
            alt = "ACGT"[("ACGT".index(ref[pos]) + 1) % 4]
            truth.append((pos, ref[pos], alt))
        elif kind == "ins":
            truth.append((pos, ref[pos], ref[pos] + "ACT"))
        else:
            truth.append((pos, ref[pos:pos + 4], ref[pos]))
    alt_ref = []
    prev = 0
    for pos, r, a in truth:
        alt_ref.append(ref[prev:pos])
        alt_ref.append(a)
        prev = pos + len(r)
    alt_ref.append(ref[prev:])
    alt_ref = "".join(alt_ref)

    # projection of alt-hap coordinates to reference coordinates
    shifts = []   # (alt_pos_after, ref_delta)
    delta = 0
    for pos, r, a in truth:
        delta += len(a) - len(r)
        shifts.append((pos + delta, len(a) - len(r)))

    def ref_pos_of(alt_pos):
        d = 0
        for ap, dd in shifts:
            if alt_pos >= ap:
                d += dd
        return alt_pos - d

    reads = []
    for hap_i, hap in enumerate((ref, alt_ref)):
        n_reads = coverage * len(hap) // read_len // 2
        for i in range(n_reads):
            s = int(rng.integers(0, len(hap) - read_len))
            bases = hap[s:s + read_len]
            if hap_i == 0:
                pos, cigar = s, f"{read_len}M"
            else:
                # align read to the reference around its projected start
                rp = ref_pos_of(s)
                lo = max(0, rp - 12)
                seg = ref[lo:rp + read_len + 12]
                res = sw_align(seg, bases, READ_TO_HAPLOTYPE_PARAMS,
                               OverhangStrategy.SOFTCLIP)
                pos = lo + res.alignment_offset
                cigar = str(res.cigar)
            reads.append(ReadRecord(
                name=f"h{hap_i}_{i}", flag=0, ref_id=0, pos=pos,
                mapping_quality=60, cigar=cigar, bases=bases,
                quals=rng.integers(30, 40, size=read_len),
                contig=contig))
    reads.sort(key=lambda r: r.pos)
    from ..utils.refwindow import RefWindow
    return contig, RefWindow(ref.encode(), 0), reads, truth


def _regions_for_span(reads, ref, contig, lo, hi):
    from ..pipeline import activity
    sel = [r for r in reads if r.pos < hi and r.end > lo]
    if not sel:
        return [], sel
    regions = activity.find_active_regions(sel, ref, contig, lo, hi)
    return [rg for rg in regions if rg.is_active], sel


def _record_key(v):
    """FIELD-LEVEL record identity: site + alleles + GT + QUAL + INFO
    annotations + FORMAT (AD/DP/GQ/PL). A sharding bug that perturbed
    annotations or likelihoods without flipping the genotype must fail
    the dryrun equality, same bar as the golden e2e diff."""
    def _num(x):
        return round(float(x), 4) if isinstance(x, float) else x

    g = v.genotypes[0] if v.genotypes else None
    gt = tuple(sorted(a.bases for a in g.alleles)) if g else ()
    fmt = (tuple(g.ad or ()), g.dp, g.gq, tuple(g.pl or ())) if g else ()
    info = tuple(sorted((k, _num(val))
                        for k, val in (v.attributes or {}).items()))
    return (v.contig, v.start, bytes(v.ref.bases),
            tuple(bytes(a.bases) for a in v.alts), gt,
            round(v.qual, 2), info, fmt)


def _pack_shard_launch(entries, pcr_model):
    """Pack a shard's region batches into ONE compact indexed launch with
    the production layout (mirrors scheduler._dispatch_indexed packing)."""
    from ..ops.pairhmm.compact import build_pair_batch_compact

    q = np.zeros((_DRY_NR, _DRY_LR, 128), np.uint8)
    gi = np.zeros((_DRY_NR, _DRY_LR, 128), np.uint8)
    gc = np.zeros((_DRY_NR, _DRY_LR, 128), np.uint8)
    rbase = np.zeros((_DRY_NR, _DRY_LR, 128), np.int8)
    # padding slots get 1-base lengths so the kernel stays well-defined
    rlen = np.ones((_DRY_NR, 1, 128), np.int32)
    hcode = np.zeros((_DRY_NH, _DRY_LH, 8), np.int8)
    hlen = np.ones((_DRY_NH, 8, 1), np.int32)
    hidx = np.zeros(_DRY_G, np.int32)
    ridx = np.zeros(_DRY_G, np.int32)

    r_off = h_off = g_off = 0
    packed = []   # (prepared, batch, reads, haps, pair_slice, gh, gr)
    for prepared, rg_reads, haps in entries:
        batch = build_pair_batch_compact(
            rg_reads, haps, pcr_model=pcr_model,
            len_buckets=(_DRY_LR,), hap_len_buckets=(_DRY_LH,))
        npairs = batch.gh * batch.gr
        assert (r_off + batch.gr <= _DRY_NR and h_off + batch.gh <= _DRY_NH
                and g_off + npairs <= _DRY_G), \
            "dryrun shard launch capacity exceeded"
        q[r_off:r_off + batch.gr] = batch.q
        gi[r_off:r_off + batch.gr] = batch.gi
        gc[r_off:r_off + batch.gr] = batch.gc
        rbase[r_off:r_off + batch.gr] = batch.rbase
        rlen[r_off:r_off + batch.gr] = batch.rlen
        hcode[h_off:h_off + batch.gh] = batch.hcode
        hlen[h_off:h_off + batch.gh] = batch.hlen
        k = g_off
        for hh in range(batch.gh):
            for rr in range(batch.gr):
                hidx[k] = h_off + hh
                ridx[k] = r_off + rr
                k += 1
        packed.append((prepared, batch, rg_reads, haps,
                       (g_off, k)))
        r_off += batch.gr
        h_off += batch.gh
        g_off = k
    return (q, gi, gc, rbase, rlen, hcode, hlen, hidx, ridx), packed


def pipeline_dryrun(n_devices, pcr_model="CONSERVATIVE", genome_len=16000,
                    devices=None):
    """regions -> sharded PairHMM -> genotyping -> ordered merge over
    ``n_devices`` shards, round-robin over ``devices`` (every card of
    ``platform.devices()`` by default; pass CPU devices for the plain
    versions); asserts equality with the unsharded pipeline, whose regions
    go through ``RegionCaller.call_region`` (K2) on the same engine.
    Returns the number of records."""
    from ..pipeline.hc_engine import CallerConfig, RegionCaller

    devices = data_devices(devices)
    engine = "cuda" if devices[0].type == "cuda" else "torch"
    contig, ref, reads, truth = _simulate(genome_len=genome_len)
    genome_len = len(ref)
    config = CallerConfig(pairhmm_engine=engine, pcr_indel_model=pcr_model)
    contig_dict = {contig: genome_len}

    # ---- unsharded baseline --------------------------------------------
    caller = RegionCaller(config, contig_dict)
    base_records = []
    regions, sel = _regions_for_span(reads, ref, contig, 0, genome_len)
    for rg in regions:
        rg_reads = [r for r in sel
                    if r.pos < rg.end + 1 + C.REGION_PADDING
                    and r.end > rg.start - C.REGION_PADDING]
        base_records.extend(caller.call_region(rg, rg_reads, ref, contig))
    base_keys = [_record_key(v) for v in base_records]

    # ---- sharded run ----------------------------------------------------
    shards = shard_intervals([(contig, 0, genome_len)], n_devices)

    mqt = C.MIN_QUALITY_THRESHOLD
    per_shard_state = []   # (shard_caller, ready_records, packed)
    launches = []
    for shard in shards:
        shard_caller = RegionCaller(config, contig_dict)
        entries, ready = [], []
        for (ctg, pad_s, pad_e, core_s, core_e) in shard:
            regions, sel = _regions_for_span(reads, ref, ctg, pad_s, pad_e)
            for rg in regions:
                # ownership: the shard whose core span holds the region
                # midpoint calls it (regions never straddle shards)
                mid = (rg.start + rg.end + 1) // 2
                if not (core_s <= mid < core_e):
                    continue
                rg_reads = [r for r in sel
                            if r.pos < rg.end + 1 + C.REGION_PADDING
                            and r.end > rg.start - C.REGION_PADDING]
                prepared = shard_caller.prepare_region(rg, rg_reads, ref,
                                                       ctg)
                if isinstance(prepared, list):
                    ready.extend(prepared)
                    continue
                entries.append((prepared, prepared.call_reads,
                                [h.bases for h in prepared.haps]))
        launch, packed = _pack_shard_launch(entries, pcr_model)
        launches.append(launch)
        per_shard_state.append((shard_caller, ready, packed))

    stacked = tuple(torch.from_numpy(np.stack([ln[i] for ln in launches]))
                    for i in range(9))
    gathered = sharded_pipeline_step(devices, *stacked).cpu().numpy()
    if gathered.shape[:2] != (n_devices, _DRY_G):
        raise AssertionError(f"gathered shape {gathered.shape}")

    sharded_records = []
    for si, (shard_caller, ready, packed) in enumerate(per_shard_state):
        sharded_records.extend(ready)
        for prepared, batch, rg_reads, haps, (g0, g1) in packed:
            # reassemble this region's (gh, gr) tile block from the
            # launch's flat pair rows (packing is job-contiguous)
            raw = gathered[si, g0:g1].reshape(batch.gh, batch.gr, 8, 128)
            lik, kept = _postprocess(batch, raw, rg_reads, haps,
                                     pcr_model, mqt)
            sharded_records.extend(
                shard_caller.finish_region(prepared, lik, kept))
    sharded_records.sort(key=lambda v: (v.contig, v.start))
    sharded_keys = [_record_key(v) for v in sharded_records]

    if sharded_keys != base_keys:
        only_b = set(base_keys) - set(sharded_keys)
        only_s = set(sharded_keys) - set(base_keys)
        raise AssertionError(
            f"sharded != unsharded: base-only={sorted(only_b)[:5]} "
            f"sharded-only={sorted(only_s)[:5]}")
    if len(base_keys) < len(truth) // 2:
        raise AssertionError(
            f"dryrun called too few variants: {len(base_keys)} records "
            f"for {len(truth)} truth variants")
    return len(base_keys)
