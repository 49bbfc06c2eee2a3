"""Physical phasing of calls sharing haplotype support.

Faithful reimplementation of the reference's phase_calls (reference:
src/haplotypecaller/genotype/utils/assembly_based_caller_utils.cpp:267-465;
GATK AssemblyBasedCallerUtils.phaseCalls): biallelic calls whose alt alleles
ride the same (or complementary) called haplotypes get PGT (0|1 / 1|0) and a
shared PID; inconsistencies abort phasing for the region. Runs in GVCF mode
(genotype_argument.h:75: do_not_run_physical_phasing unless GVCF).
"""

from .variant import NON_REF, SPAN_DEL

PHASE_01 = "0|1"
PHASE_10 = "1|0"


def _site_specific_alt(call):
    """The single non-symbolic alt allele, or None
    (is_biallelic_with_one_site_specific_alternate_allele)."""
    alts = [a for a in call.alts if a != NON_REF and a != SPAN_DEL]
    if len(alts) != 1:
        return None
    return alts[0]


def construct_haplotype_mapping(calls, called_haplotypes):
    """{call index -> frozenset of haplotypes carrying its alt}."""
    result = {}
    for idx, call in enumerate(calls):
        alt = _site_specific_alt(call)
        if alt is None:
            result[idx] = frozenset()
            continue
        haps = set()
        for h in called_haplotypes:
            em = getattr(h, "event_map", None)
            if em is None:
                continue
            for vc in em.events.values():
                if vc.start == call.start and any(
                        a.bases == alt.bases for a in vc.alts):
                    haps.add(id(h))
        result[idx] = frozenset(haps)
    return result


def construct_phase_set_mapping(calls, hap_map):
    """{call index -> (set_id, PGT)} with the reference's pairing rules."""
    all_haps = set()
    for haps in hap_map.values():
        all_haps |= haps
    total = len(all_haps)

    mapping = {}
    unique_counter = 0
    n = len(calls)
    for i in range(n - 1):
        haps_i = hap_map[i]
        if not haps_i:
            continue
        call_on_all = len(haps_i) == total
        available = set(haps_i)
        for j in range(i + 1, n):
            haps_j = hap_map[j]
            if not haps_j:
                continue
            comp_on_all = len(haps_j) == total
            if ((len(haps_i) == len(haps_j) and haps_i == haps_j)
                    or (call_on_all and haps_j <= available)
                    or comp_on_all):
                if i not in mapping:
                    if j in mapping:
                        return {}  # inconsistent: abort phasing
                    mapping[i] = (unique_counter, PHASE_01)
                    mapping[j] = (unique_counter, PHASE_01)
                    available &= haps_j
                    unique_counter += 1
                elif j not in mapping:
                    mapping[j] = mapping[i]
            elif len(haps_i) + len(haps_j) == total:
                if not (haps_i & haps_j):
                    if i not in mapping:
                        if j in mapping:
                            return {}
                        mapping[i] = (unique_counter, PHASE_01)
                        mapping[j] = (unique_counter, PHASE_10)
                        unique_counter += 1
                    elif j not in mapping:
                        sid, pg = mapping[i]
                        mapping[j] = (sid,
                                      PHASE_10 if pg == PHASE_01 else PHASE_01)
    return mapping


def phase_calls(calls, called_haplotypes):
    """Annotate PGT/PID/PS on phased groups; returns the call list."""
    if len(calls) < 2:
        return calls
    hap_map = construct_haplotype_mapping(calls, called_haplotypes)
    mapping = construct_phase_set_mapping(calls, hap_map)
    set_ids = {sid for sid, _ in mapping.values()}

    for sid in set_ids:
        members = [i for i in range(len(calls))
                   if i in mapping and mapping[i][0] == sid]
        if len(members) < 2:
            continue
        first = calls[members[0]]
        uid = (f"{first.start + 1}_{first.ref.bases.decode()}_"
               f"{first.alts[0].bases.decode()}")
        ps = first.start + 1
        for i in members:
            call = calls[i]
            for g in call.genotypes:
                g.attributes["PGT"] = mapping[i][1]
                g.attributes["PID"] = uid
                g.attributes["PS"] = ps
    return calls
