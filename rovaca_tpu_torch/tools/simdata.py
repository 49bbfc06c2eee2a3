"""Synthetic corpus data: diploid genomes, paired-end reads, BAM/FASTA.

Counterpart of tests/simdata.py, carried over with what
``tools.golden_e2e.generate``, ``tools.host_profile`` and
``tools.accuracy_eval`` call, on this package's SW, BAM writer and records:
the same seed gives the same FASTA and BAM bytes.
"""

import numpy as np

from ..assembly.sw import (READ_TO_HAPLOTYPE_PARAMS, OverhangStrategy,
                           sw_align)
from ..io.bam import BamHeader, BamWriter
from ..io.fasta import write_fasta  # noqa: F401 (golden_e2e.generate)
from ..reads.cigar import Cigar, CigarOp
from ..reads.record import ReadRecord


def random_ref(rng, length):
    return "".join(rng.choice(list("ACGT"), size=length))


def apply_variants(ref, variants):
    """variants: list of (pos, ref_allele, alt_allele) on 0-based ref coords.
    Returns the alt sequence. Variants must be sorted and non-overlapping."""
    out = []
    prev = 0
    for pos, ref_a, alt_a in variants:
        assert ref[pos:pos + len(ref_a)] == ref_a, (pos, ref_a)
        out.append(ref[prev:pos])
        out.append(alt_a)
        prev = pos + len(ref_a)
    out.append(ref[prev:])
    return "".join(out)


def simulate_reads(rng, ref, hap_seq, contig, n_reads, read_len=100,
                   qual=35, mapq=60, name_prefix="sim", start=0, end=None):
    """Sample reads from hap_seq, align each back to ref (our SW as the
    'aligner') to get realistic pos/cigar."""
    end = end if end is not None else len(hap_seq)
    reads = []
    for i in range(n_reads):
        s = int(rng.integers(start, max(start + 1, end - read_len)))
        frag = hap_seq[s:s + read_len]
        if len(frag) < 30:
            continue
        # local alignment window on ref around s
        w_lo = max(0, s - 50)
        w_hi = min(len(ref), s + read_len + 50)
        res = sw_align(ref[w_lo:w_hi].encode(), frag.encode(),
                       READ_TO_HAPLOTYPE_PARAMS, OverhangStrategy.SOFTCLIP)
        pos = w_lo + res.alignment_offset
        quals = rng.integers(qual - 4, qual + 4, size=len(frag))
        reads.append(ReadRecord(
            name=f"{name_prefix}{i}", flag=0, ref_id=0, pos=pos,
            mapping_quality=mapq, cigar=res.cigar, bases=frag, quals=quals,
            contig=contig))
    return reads


def write_test_bam(path, reads, contig, contig_len, sample="NA12878",
                   read_groups=("rg1",)):
    rg_lines = "".join(f"@RG\tID:{rg}\tSM:{sample}\n" for rg in read_groups)
    header = BamHeader(
        f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{contig}\tLN:{contig_len}\n"
        + rg_lines,
        [contig], [contig_len])
    reads = sorted(reads, key=lambda r: (r.ref_id, r.pos))
    with BamWriter(path, header) as w:
        for r in reads:
            r.tags.setdefault("RG", read_groups[0])
            w.write(r)


# --------------------------------------------------------------------------
# realistic paired-end error-model simulator (adversarial golden corpus)
# --------------------------------------------------------------------------
FLAG_PAIRED = 0x1
FLAG_PROPER = 0x2
FLAG_REVERSE = 0x10
FLAG_MREVERSE = 0x20
FLAG_FIRST = 0x40
FLAG_SECOND = 0x80
FLAG_SECONDARY = 0x100
FLAG_DUP = 0x400


def _qual_profile(rng, read_len):
    """Machine-orientation base quals: high 5' declining to the 3' end,
    with noise; occasional globally-poor reads and qual-2 tails."""
    hi = float(rng.integers(34, 41))
    lo = hi - float(rng.integers(8, 18))
    q = hi + (lo - hi) * np.linspace(0, 1, read_len) ** 1.5
    q = q + rng.normal(0, 2.5, size=read_len)
    if rng.random() < 0.08:          # globally poor read
        q -= rng.integers(8, 16)
    q = np.clip(np.round(q), 2, 41).astype(np.uint8)
    if rng.random() < 0.10:          # low-quality 3' tail (clip target)
        t = int(rng.integers(3, 12))
        q[-t:] = 2
    return q


def _apply_seq_errors(rng, bases, quals, allow_indels=True):
    """Qual-correlated substitutions + rare indel errors (machine
    orientation). Returns mutated bases (quals unchanged: the instrument
    reports its confidence, not the truth)."""
    out = list(bases)
    perr = 10.0 ** (-quals.astype(np.float64) / 10.0)
    hits = np.nonzero(rng.random(len(out)) < perr)[0]
    for i in hits:
        choices = [c for c in "ACGT" if c != out[i]]
        out[i] = choices[int(rng.integers(0, 3))]
    if allow_indels and rng.random() < 0.03:  # ~3% of reads get one indel
        i = int(rng.integers(5, max(6, len(out) - 5)))
        n = int(rng.integers(1, 4))
        if rng.random() < 0.5:
            out[i:i] = list("".join(rng.choice(list("ACGT"), size=n)))
            del out[len(out) - n:]
        else:
            del out[i:i + n]
            out.extend(rng.choice(list("ACGT"), size=n))
    return "".join(out[:len(bases)])


def _align_read(ref, frag, pos_hint, rng):
    w_lo = max(0, pos_hint - 60)
    w_hi = min(len(ref), pos_hint + len(frag) + 60)
    res = sw_align(ref[w_lo:w_hi].encode(), frag.encode(),
                   READ_TO_HAPLOTYPE_PARAMS, OverhangStrategy.SOFTCLIP)
    return w_lo + res.alignment_offset, res.cigar


def _cigar_has(cigar, ops):
    return any(op.name in ops for op, _ in cigar)


def simulate_fragments(rng, ref, hap_seq, contig, n_frags, read_len=100,
                       frag_mean=260, frag_sd=60, name_prefix="frag",
                       start=0, end=None, read_groups=("rg1", "rg2"),
                       dup_rate=0.02, secondary_rate=0.01,
                       lowmq_rate=0.03, hotspot_rate=0.004):
    """Paired-end reads with a realistic error model: qual-correlated
    substitutions, rare indel errors, declining qual tails, adapter
    read-through soft clips (short fragments), duplicates/secondary flags,
    multiple read groups, MQ variation, and positional pileup hotspots that
    engage the downsampler.

    Reads whose alignment would carry BOTH a soft clip and an indel are
    regenerated error-free: the reference's one-to-one gapped array leaves
    an uninitialized tail for such reads (alignment_utils.cpp:755-785 sizes
    by count_ref_bases_and_soft_clips but never fills the soft-clip bases),
    making its output scheduling-dependent — see GOLDEN.md."""
    end = end if end is not None else len(hap_seq)
    reads = []
    i = 0
    frags_left = n_frags
    while frags_left > 0:
        stack = 1
        if rng.random() < hotspot_rate:
            stack = min(int(rng.poisson(60)) + 2, frags_left)
        if rng.random() < 0.05:
            # short-fragment mixture: adapter read-through -> soft clips
            frag_len = int(rng.integers(max(60, read_len - 30),
                                        read_len - 2))
        else:
            frag_len = int(np.clip(rng.normal(frag_mean, frag_sd),
                                   70, 2 * read_len + 240))
        fs = int(rng.integers(start, max(start + 1, end - frag_len)))
        for _ in range(stack):
            pair = _make_pair(rng, ref, hap_seq, contig, fs, frag_len,
                              read_len, f"{name_prefix}{i}", read_groups,
                              lowmq_rate)
            i += 1
            frags_left -= 1
            if pair is None:
                continue
            reads.extend(pair)
            r = rng.random()
            if r < dup_rate:
                for p in pair:
                    d = p.copy(flag=p.flag | FLAG_DUP,
                               name=p.name + "_dup")
                    d.tags = dict(p.tags)
                    reads.append(d)
            elif r < dup_rate + secondary_rate:
                p = pair[0]
                s = p.copy(flag=p.flag | FLAG_SECONDARY,
                           name=p.name)
                s.tags = dict(p.tags)
                reads.append(s)
            if frags_left <= 0:
                break
    return reads


def _make_pair(rng, ref, hap_seq, contig, fs, frag_len, read_len,
               name, read_groups, lowmq_rate):
    fe = fs + frag_len
    rg = read_groups[int(rng.integers(0, len(read_groups)))]

    def one_read(machine_start_is_left):
        """One mate; machine_start_is_left: R1 (forward). The core (real
        fragment bases) is aligned with SW; adapter read-through bases are
        appended as an explicit soft clip (what a real mapper emits)."""
        n_real = min(read_len, frag_len)
        n_adapter = read_len - n_real
        if machine_start_is_left:
            core = hap_seq[fs:fs + n_real]
        else:
            core = hap_seq[fe - n_real:fe]
        adapter = "".join(rng.choice(list("ACGT"), size=n_adapter))
        quals_m = _qual_profile(rng, read_len)  # machine orientation
        quals_f = quals_m if machine_start_is_left else quals_m[::-1]
        if machine_start_is_left:
            core_q = quals_f[:n_real]
        else:
            core_q = quals_f[n_adapter:]
        for attempt in range(3):
            # never combine indel errors with an adapter soft clip: the
            # reference's gapped one-to-one array leaves soft-clip tails
            # uninitialized for indel reads (alignment_utils.cpp:755-785)
            allow_ind = attempt == 0 and n_adapter == 0
            b = _apply_seq_errors(rng, core, core_q,
                                  allow_indels=allow_ind) \
                if attempt < 2 else core
            hint = fs if machine_start_is_left else fe - n_real
            pos, cigar = _align_read(ref, b, hint, rng)
            if _cigar_has(cigar, ("S",)) and _cigar_has(cigar, ("I", "D")):
                continue
            if n_adapter:
                if _cigar_has(cigar, ("S", "I", "D")):
                    continue
                if machine_start_is_left:
                    bases = b + adapter
                    cigar = Cigar(tuple(cigar.elements)
                                  + ((CigarOp.S, n_adapter),))
                    quals = quals_f
                else:
                    bases = adapter + b
                    cigar = Cigar(((CigarOp.S, n_adapter),)
                                  + tuple(cigar.elements))
                    quals = quals_f
            else:
                bases, quals = b, quals_f
            return pos, cigar, bases, np.asarray(quals, dtype=np.uint8)
        return None

    left = one_read(True)
    right = one_read(False)
    if left is None or right is None:
        return None
    lpos, lcig, lb, lq = left
    rpos, rcig, rb, rq = right
    # reference span ends for TLEN
    lc = lcig if not isinstance(lcig, str) else Cigar.from_string(lcig)
    rc = rcig if not isinstance(rcig, str) else Cigar.from_string(rcig)
    rend = rpos + rc.reference_length
    tlen = rend - lpos
    mq = 60
    x = rng.random()
    if x < lowmq_rate:
        mq = int(rng.integers(0, 20))     # filtered by the MQ filter
    elif x < lowmq_rate + 0.05:
        mq = int(rng.integers(20, 60))

    fl = FLAG_PAIRED | FLAG_PROPER | FLAG_MREVERSE | FLAG_FIRST
    fr = FLAG_PAIRED | FLAG_PROPER | FLAG_REVERSE | FLAG_SECOND
    r1 = ReadRecord(name=name, flag=fl, ref_id=0, pos=lpos,
                    mapping_quality=mq, cigar=lc, bases=lb, quals=lq,
                    mate_ref_id=0, mate_pos=rpos, tlen=tlen,
                    contig=contig, tags={"RG": rg})
    r2 = ReadRecord(name=name, flag=fr, ref_id=0, pos=rpos,
                    mapping_quality=mq, cigar=rc, bases=rb, quals=rq,
                    mate_ref_id=0, mate_pos=lpos, tlen=-tlen,
                    contig=contig, tags={"RG": rg})
    return [r1, r2]
