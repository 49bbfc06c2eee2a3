"""Realignment of reads to their best haplotype, with the banded SW on a device.

Counterpart of rovaca_tpu/genotype/alignment_utils.py:
realign_reads_to_their_best_haplotype. The best-haplotype choice, the
exact-substring shortcut and the projection into reference coordinates are
the same; ``realign_read_to_haplotype`` and ``hap_to_ref_map`` are imported
unchanged. The SW batch runs through the port's banded kernel when
``use_banded_sw()`` says so, on the device it is given, or else on the native
SW batch, as in rovaca_tpu.
"""

import os

import numpy as np

from rovaca_tpu.assembly.sw import (READ_TO_HAPLOTYPE_PARAMS,
                                    OverhangStrategy, SWResult)
from rovaca_tpu.genotype.alignment_utils import (hap_to_ref_map,
                                                 realign_read_to_haplotype)
from rovaca_tpu.genotype.likelihoods import INFORMATIVE_THRESHOLD
from rovaca_tpu.native import sw_native
from rovaca_tpu.reads.cigar import Cigar, CigarOp

from ..ops.sw import sw_align_banded_batch


def use_banded_sw():
    """Route realignment SW through the banded kernel? ROVACA_BANDED_REALIGN
    set to anything but 0/false/empty forces it; unset or off, realignment
    stays on the native SW batch (rovaca_tpu's default off a TPU)."""
    env = os.environ.get("ROVACA_BANDED_REALIGN")
    return env is not None and env not in ("0", "false", "")


def _best_haplotype(col, prio):
    """Index of a read's best haplotype: argmax, re-picked among every hap
    within INFORMATIVE_THRESHOLD of the best by priority (is_ref, then the
    simplest cigar) when the best is a near tie."""
    best = 0
    best_lik = col[0]
    second_lik = -np.inf
    for a in range(1, len(col)):
        if col[a] > best_lik:
            second_lik = best_lik
            best = a
            best_lik = col[a]
        elif col[a] > second_lik:
            second_lik = col[a]
    if best_lik - second_lik < INFORMATIVE_THRESHOLD:
        best_priority = prio[best]
        for a in range(len(col)):
            if a == best or best_lik - col[a] > INFORMATIVE_THRESHOLD:
                continue
            if prio[a] > best_priority:
                best = a
                best_priority = prio[a]
    return best


def realign_reads_to_their_best_haplotype(likelihoods, device="cpu"):
    """Replace evidence reads with realigned versions (per-read best
    haplotype, ties to the reference haplotype). Mutates
    ``likelihoods.reads``. With the banded gate on, the reads that are not
    exact substrings of their haplotype go through one banded batch on
    ``device``. Returns (banded batches run, alignments that fell back to
    the host SW)."""
    haps = likelihoods.alleles
    if not haps:
        return 0, 0
    m = likelihoods.matrix
    ref_idx = next((i for i, h in enumerate(haps)
                    if getattr(h, "is_ref", False)), 0)
    prio = np.array([(1.0 if getattr(h, "is_ref", False) else 0.0)
                     + (1.0 - len(h.cigar.elements)) for h in haps])
    maps = {}
    best_haps = []
    for r in range(len(likelihoods.reads)):
        hap = haps[_best_haplotype(m[:, r], prio)]
        if id(hap) not in maps:
            maps[id(hap)] = hap_to_ref_map(hap)
        best_haps.append(hap)

    batches = fallbacks = 0
    sw_results = [None] * len(likelihoods.reads)
    if sw_native.available():
        batch_idx = []
        pairs = []
        for r, read in enumerate(likelihoods.reads):
            hap = best_haps[r]
            idx = hap.bases.rfind(read.bases)
            if idx != -1:       # exact substring: sw_align's fast path
                sw_results[r] = SWResult(
                    Cigar([(CigarOp.M, len(read.bases))]), idx)
            else:
                batch_idx.append(r)
                pairs.append((hap.bases, read.bases))
        if batch_idx and use_banded_sw():
            # diagonals seeded from the read's offset in its hap's window
            diags = [max(0, likelihoods.reads[r].pos
                         - getattr(best_haps[r], "window_start",
                                   likelihoods.reads[r].pos))
                     for r in batch_idx]
            banded = sw_align_banded_batch(
                pairs, READ_TO_HAPLOTYPE_PARAMS,
                overhang=OverhangStrategy.SOFTCLIP, diagonals=diags,
                device=device)
            batches = 1
            fallbacks = sum(br.fell_back for br in banded)
            for r, br in zip(batch_idx, banded):
                sw_results[r] = br.result
        else:
            for r, res in zip(batch_idx, sw_native.align_batch(
                    pairs, READ_TO_HAPLOTYPE_PARAMS,
                    int(OverhangStrategy.SOFTCLIP))):
                if res is not None:
                    ops, lens, offset = res
                    sw_results[r] = SWResult(Cigar(zip(ops, lens)), offset)

    ref_hap = haps[ref_idx]
    likelihoods.reads = [
        realign_read_to_haplotype(read, best_haps[r],
                                  maps[id(best_haps[r])],
                                  sw_result=sw_results[r], ref_hap=ref_hap)
        for r, read in enumerate(likelihoods.reads)]
    return batches, fallbacks
