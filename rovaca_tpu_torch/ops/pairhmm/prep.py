"""Host-side PairHMM batch preparation.

Converts reads + haplotypes into padded, tiled device arrays. Semantics mirror
the reference's decompression/prepare stages (reference: src/haplotypecaller/
pairhmm/pairhmm_internal.cpp:413-483) and the PCR/STR error model
(pairhmm_internal.cpp:65-159), but the layout is TPU-native:

- pair dimension = (8 haplotypes) x (128 reads) per vector tile
- per-read transition/emission values packed as 8 channels in the sublane dim
- haplotype base codes broadcast across the read lane dim

Channel order (axis of size 8): [mm, gapm, mi, ii, md, dd, distm, one_distm].
"""

import dataclasses

import numpy as np

from ... import constants as C
from .. import gatk_math

HAP_TILE = 8     # haplotypes per tile (sublane dim)
READ_TILE = 128  # reads per tile (lane dim)

# ASCII -> bitmask base codes; match test is (r & h) != 0
# (reference: pairhmm_internal.cpp:27-43)
BASE_CODE = np.zeros(256, dtype=np.int32)
for _b, _c in ((b"Aa", C.BASE_A), (b"Cc", C.BASE_C), (b"Tt", C.BASE_T),
               (b"Gg", C.BASE_G), (b"Nn", C.BASE_N)):
    BASE_CODE[_b[0]] = _c
    BASE_CODE[_b[1]] = _c

_PCR_CACHES = {
    "NONE": None,
    "HOSTILE": C.PCR_INDEL_MODEL_HOSTILE,
    "AGGRESSIVE": C.PCR_INDEL_MODEL_AGGRESSIVE,
    "CONSERVATIVE": C.PCR_INDEL_MODEL_CONSERVATIVE,
}


def find_number_of_repetitions(unit, test, leading):
    """Count consecutive occurrences of `unit` at the start (leading) or end
    of `test` (reference: pairhmm_internal.cpp:196-229)."""
    ulen = len(unit)
    tlen = len(test)
    if tlen == 0 or ulen == 0:
        return 0
    n = 0
    if leading:
        start = 0
        while start + ulen <= tlen and test[start:start + ulen] == unit:
            n += 1
            start += ulen
    else:
        start = tlen - ulen
        while start >= 0 and test[start:start + ulen] == unit:
            n += 1
            start -= ulen
    return n


def find_tandem_repeat_units(bases, offset):
    """Tandem-repeat length around `offset` used by the PCR indel model
    (reference: pairhmm_internal.cpp:65-119; GATK findTandemRepeatUnits).

    Searches backward for the shortest repeat unit ending at `offset`, forward
    for the shortest unit starting at offset+1, recounts the backward run with
    the forward unit, and returns the total run length capped at 20.
    """
    n = len(bases)
    max_bw = 0
    for str_len in range(1, C.MAX_STR_UNIT_LENGTH + 1):
        if offset + 1 - str_len < 0:
            break
        unit = bases[offset - str_len + 1:offset + 1]
        max_bw = find_number_of_repetitions(unit, bases[:offset + 1], leading=False)
        if max_bw > 1:
            break

    max_rl = max_bw
    if offset < n - 1:
        # the recount unit is best_FW_repeat_unit, which stays at its
        # default (offset+1, length 1) unless a forward repeat (count > 1)
        # was found — while max_fw keeps the count of the LAST TRIED unit.
        # Quirky, but exactly pairhmm_internal.cpp:87-111.
        fw_unit = bases[offset + 1:offset + 2]
        max_fw = 0
        for str_len in range(1, C.MAX_STR_UNIT_LENGTH + 1):
            if offset + str_len + 1 > n:
                break
            max_fw = find_number_of_repetitions(
                bases[offset + 1:offset + 1 + str_len], bases[offset + 1:],
                leading=True)
            if max_fw > 1:
                fw_unit = bases[offset + 1:offset + 1 + str_len]
                break
        max_bw = find_number_of_repetitions(fw_unit, bases[:offset + 1], leading=False)
        max_rl = max_bw + max_fw

    return min(max_rl, C.MAX_REPEAT_LENGTH)


def apply_pcr_error_model(bases, gap_quals, pcr_model):
    """Cap gap-open quals by STR context in place
    (reference: pairhmm_internal.cpp:121-159). `bases` is a python bytes
    object; `gap_quals` a uint8 numpy array modified in place."""
    cache = _PCR_CACHES[pcr_model]
    if cache is None:
        return
    for i in range(1, len(bases)):
        repeat_length = find_tandem_repeat_units(bases, i - 1)
        gap_quals[i - 1] = min(gap_quals[i - 1], cache[repeat_length])


def apply_pcr_error_model_batch(bases_list, gap_list, pcr_model):
    """Batched apply_pcr_error_model over many reads.

    Dispatches one native OpenMP call when the C++ extension is available
    (rovaca_tpu/native/pcr.cpp); falls back to the per-read python loop.
    `gap_list` arrays are mutated in place either way.
    """
    cache = _PCR_CACHES[pcr_model]
    if cache is None or not bases_list:
        return
    from ...native import pcr_native
    if not pcr_native.available():
        for b, g in zip(bases_list, gap_list):
            apply_pcr_error_model(b, g, pcr_model)
        return
    lengths = np.array([len(b) for b in bases_list], dtype=np.int32)
    offsets = np.zeros(len(bases_list), dtype=np.int64)
    np.cumsum(lengths[:-1], out=offsets[1:])
    buf = np.frombuffer(b"".join(bases_list), dtype=np.uint8)
    gq = np.concatenate(gap_list).astype(np.uint8, copy=False)
    pcr_native.apply_batch(buf, offsets, lengths, gq,
                           np.asarray(cache, dtype=np.uint8))
    for i, g in enumerate(gap_list):
        g[:] = gq[offsets[i]:offsets[i] + lengths[i]]


def modify_read_quals(quals, mapping_quality,
                      min_quality_threshold=C.MIN_QUALITY_THRESHOLD):
    """Cap base quals by MQ; floor sub-threshold quals at MIN_QUALITY
    (reference: pairhmm_internal.cpp:450-457)."""
    q = np.minimum(np.asarray(quals, dtype=np.int32), int(mapping_quality))
    return np.where(q < min_quality_threshold, C.MIN_QUALITY, q).astype(np.uint8)


def prepare_read_channels(bases, quals, mapping_quality,
                          ins_gops=None, gcp=None,
                          pcr_model="CONSERVATIVE",
                          min_quality_threshold=C.MIN_QUALITY_THRESHOLD,
                          dtype=np.float32):
    """Per-read channel vectors for the kernel.

    Returns (codes int32 [L], channels float32 [8, L]) with channel order
    [mm, gapm, mi, ii, md, dd, distm, one_distm]. `ins_gops` doubles as the
    deletion gap-open array (the reference aliases them,
    pairhmm_internal.cpp:455-457).
    """
    if isinstance(bases, str):
        bases = bases.encode()
    L = len(bases)
    if ins_gops is None:
        ins_gops = np.full(L, C.DEFAULT_GAP_OPEN_PHRED, dtype=np.uint8)
    else:
        ins_gops = np.asarray(ins_gops, dtype=np.uint8).copy()
    if gcp is None:
        gcp = np.full(L, C.GAP_CONTINUATION_PHRED, dtype=np.uint8)
    else:
        gcp = np.asarray(gcp, dtype=np.uint8)

    q = modify_read_quals(quals, mapping_quality, min_quality_threshold)
    apply_pcr_error_model(bytes(bases), ins_gops, pcr_model)

    dtype = np.dtype(dtype).type
    ph2pr = gatk_math.ph2pr_table(dtype)
    m2m = gatk_math.match_to_match_table(dtype)

    gi = (ins_gops & 127).astype(np.int64)
    gc = (gcp & 127).astype(np.int64)
    qq = (q & 127).astype(np.int64)

    ch = np.empty((8, L), dtype=dtype)
    ch[0] = m2m[gi, gi]                 # mm   (ins==del gop)
    ch[1] = dtype(1.0) - ph2pr[gc]      # gapm (indel->match)
    ch[2] = ph2pr[gi]                   # mi   (match->ins)
    ch[3] = ph2pr[gc]                   # ii   (ins->ins)
    ch[4] = ph2pr[gi]                   # md   (match->del; del gop aliases ins)
    ch[5] = ph2pr[gc]                   # dd   (del->del)
    dist = ph2pr[qq]
    ch[6] = dist / dtype(3.0)           # distm (mismatch emission)
    ch[7] = dtype(1.0) - dist           # one_distm (match emission)

    codes = BASE_CODE[np.frombuffer(bytes(bases), dtype=np.uint8)]
    return codes, ch


@dataclasses.dataclass
class PairBatch:
    """Padded, tiled PairHMM inputs for one region batch.

    Shapes (GR = read tiles, GH = hap tiles, Lr/Lh = padded max lengths):
      trans:    (GR, Lr, 8, READ_TILE) f32 — per-read channels
      rbase:    (GR, Lr, READ_TILE)    i32 — read base codes
      rlen:     (GR, 1, READ_TILE)     i32 — read lengths (0 = padding lane)
      hbase:    (GH, Lh, HAP_TILE, READ_TILE) i32 — hap codes, lane-broadcast
      hlen:     (GH, HAP_TILE, 1)      i32 — hap lengths (0 = padding sublane)
      n_reads, n_haps: true counts before padding
    """
    trans: np.ndarray
    rbase: np.ndarray
    rlen: np.ndarray
    hbase: np.ndarray
    hlen: np.ndarray
    n_reads: int
    n_haps: int

    @property
    def gr(self):
        return self.trans.shape[0]

    @property
    def gh(self):
        return self.hbase.shape[0]

    @property
    def max_read_len(self):
        return self.trans.shape[1]

    @property
    def max_hap_len(self):
        return self.hbase.shape[1]

    def result_matrix(self, raw):
        """(GH, GR, 8, 128) kernel output -> (n_haps, n_reads) float32."""
        raw = np.asarray(raw)
        gh, gr = raw.shape[0], raw.shape[1]
        full = raw.transpose(0, 2, 1, 3).reshape(gh * HAP_TILE, gr * READ_TILE)
        return full[: self.n_haps, : self.n_reads]


def _round_up(x, m):
    return -(-x // m) * m


def build_pair_batch(reads, haps, pcr_model="CONSERVATIVE",
                     min_quality_threshold=C.MIN_QUALITY_THRESHOLD,
                     len_buckets=(64, 128, 192, 256, 384, 512),
                     hap_len_buckets=(128, 256, 384, 512, 768, 1024),
                     dtype=np.float32):
    """Build a PairBatch from reads and haplotypes.

    `reads`: sequence of objects with .bases (bytes/str), .quals (uint8 array),
    .mapping_quality, and optionally .ins_quals/.gcp arrays.
    `haps`: sequence of bytes/str haplotype sequences.
    """
    n_reads = len(reads)
    n_haps = len(haps)
    hap_bytes = [h.encode() if isinstance(h, str) else bytes(h) for h in haps]

    max_rl = max(len(r.bases) for r in reads)
    max_hl = max(len(h) for h in hap_bytes)
    Lr = next((b for b in len_buckets if b >= max_rl), _round_up(max_rl, 128))
    Lh = next((b for b in hap_len_buckets if b >= max_hl), _round_up(max_hl, 128))

    GR = _round_up(n_reads, READ_TILE) // READ_TILE
    GH = _round_up(n_haps, HAP_TILE) // HAP_TILE

    trans = np.zeros((GR, Lr, 8, READ_TILE), dtype=dtype)
    rbase = np.zeros((GR, Lr, READ_TILE), dtype=np.int32)
    rlen = np.zeros((GR, 1, READ_TILE), dtype=np.int32)
    hbase = np.zeros((GH, Lh, HAP_TILE, READ_TILE), dtype=np.int32)
    hlen = np.zeros((GH, HAP_TILE, 1), dtype=np.int32)

    # PCR/STR gap-penalty caps for the whole batch in one native call
    # (per-read python fallback inside); pass the capped arrays down and
    # disable the per-read model.
    base_bytes = [r.bases.encode() if isinstance(r.bases, str)
                  else bytes(r.bases) for r in reads]
    gap_list = []
    for r, bb in zip(reads, base_bytes):
        ig = getattr(r, "ins_quals", None)
        if ig is None:
            ig = np.full(len(bb), C.DEFAULT_GAP_OPEN_PHRED, dtype=np.uint8)
        else:
            ig = np.asarray(ig, dtype=np.uint8).copy()
        gap_list.append(ig)
    apply_pcr_error_model_batch(base_bytes, gap_list, pcr_model)

    # one concatenated channel-table pass over every read, then a single
    # fancy-index scatter into the tiles (replaces per-read prepare calls)
    lens = np.array([len(b) for b in base_bytes], dtype=np.int64)
    total = int(lens.sum())
    read_idx = np.repeat(np.arange(n_reads, dtype=np.int64), lens)
    row0 = np.cumsum(lens) - lens
    within = np.arange(total, dtype=np.int64) - np.repeat(row0, lens)

    mq = np.repeat(np.array([r.mapping_quality for r in reads],
                            dtype=np.int32), lens)
    q_cat = np.minimum(np.concatenate(
        [np.asarray(r.quals, dtype=np.int32) for r in reads]), mq)
    q_cat = np.where(q_cat < min_quality_threshold, C.MIN_QUALITY, q_cat)
    gi_cat = np.concatenate(gap_list).astype(np.int64) & 127
    gc_parts = []
    for r, bb in zip(reads, base_bytes):
        gcp = getattr(r, "gcp", None)
        if gcp is None:
            gc_parts.append(np.full(len(bb), C.GAP_CONTINUATION_PHRED,
                                    dtype=np.int64))
        else:
            gc_parts.append(np.asarray(gcp, dtype=np.int64) & 127)
    gc_cat = np.concatenate(gc_parts)
    qq_cat = q_cat.astype(np.int64) & 127

    fdt = np.dtype(dtype).type
    ph2pr = gatk_math.ph2pr_table(fdt)
    m2m = gatk_math.match_to_match_table(fdt)
    ch = np.empty((8, total), dtype=dtype)
    ch[0] = m2m[gi_cat, gi_cat]
    ch[1] = fdt(1.0) - ph2pr[gc_cat]
    ch[2] = ph2pr[gi_cat]
    ch[3] = ph2pr[gc_cat]
    ch[4] = ph2pr[gi_cat]
    ch[5] = ph2pr[gc_cat]
    dist = ph2pr[qq_cat]
    ch[6] = dist / fdt(3.0)
    ch[7] = fdt(1.0) - dist
    codes_cat = BASE_CODE[np.frombuffer(b"".join(base_bytes),
                                        dtype=np.uint8)]

    g_arr, lane_arr = np.divmod(read_idx, READ_TILE)
    trans[g_arr, within, :, lane_arr] = ch.T
    rbase[g_arr, within, lane_arr] = codes_cat
    rg, rlane = np.divmod(np.arange(n_reads, dtype=np.int64), READ_TILE)
    rlen[rg, 0, rlane] = lens

    for idx, h in enumerate(hap_bytes):
        g, sub = divmod(idx, HAP_TILE)
        codes = BASE_CODE[np.frombuffer(h, dtype=np.uint8)]
        hbase[g, : len(h), sub, :] = codes[:, None]
        hlen[g, sub, 0] = len(h)

    return PairBatch(trans=trans, rbase=rbase, rlen=rlen, hbase=hbase,
                     hlen=hlen, n_reads=n_reads, n_haps=n_haps)
