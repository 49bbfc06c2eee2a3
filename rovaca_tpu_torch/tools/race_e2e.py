"""The split-run VCF check of scripts/race_e2e.py.

Counterpart of scripts/race_e2e.py's ``depth_masked_diff`` (its contenders
stay there). Reservoir downsampling consumes a Java-LCG stream in traversal
order (reference: src/common/downsampler_hc.h:94-210), so an interval-split
run picks different survivors at >50-deep alignment starts than a
whole-contig run, exactly as the reference binary does under -L interval
splits: a sharded run may differ from an unsharded one only at such
pileups.
"""


def parse_vcf_records(path):
    """{(contig, pos, ref, alts): (line_fields, DP)} over a VCF file."""
    out = {}
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            key = (f[0], int(f[1]), f[3], f[4])
            dp = 0
            for kv in f[7].split(";"):
                if kv.startswith("DP="):
                    dp = int(kv[3:])
            out[key] = (f, dp)
    return out


def _downsampled_hotspots(bam_path, target=50):
    """{contig: sorted positions whose raw alignment-start count exceeds
    the positional-downsampler reservoir} — the places where a traversal
    split reseeds the LCG stream and survivor sets legitimately differ."""
    from collections import Counter
    from ..io.bam import BamReader
    counts = {}
    for r in BamReader(bam_path):
        counts.setdefault(r.contig, Counter())[r.pos] += 1
    return {c: sorted(p for p, n in cnt.items() if n > target)
            for c, cnt in counts.items()}


def depth_masked_diff(unsharded_path, sharded_path, bam_path=None,
                      max_depth=50, reach=400):
    """Verify the sharded-vs-unsharded divergence is CONFINED to
    reservoir-downsampled pileups: records may differ only at sites where
    either side reports DP >= max_depth, or (when the BAM is given) within
    `reach` bp of a raw alignment-start hotspot the positional downsampler
    truncated — a site's own output DP can be small while its active
    region still contains reads whose survivor set depends on the LCG
    stream (read span + region padding; the traversal-split stream picks
    different survivors there, exactly as the reference does under -L
    splits; see module docstring). Returns (ok, detail)."""
    import bisect
    a = parse_vcf_records(unsharded_path)
    b = parse_vcf_records(sharded_path)
    hot = (_downsampled_hotspots(bam_path, max_depth)
           if bam_path else {})

    def near_hotspot(contig, pos1):
        ps = hot.get(contig)
        if not ps:
            return False
        p0 = pos1 - 1
        i = bisect.bisect_left(ps, p0 - reach)
        return i < len(ps) and ps[i] <= p0 + reach

    bad = []
    for key in sorted(set(a) | set(b)):
        ra, rb = a.get(key), b.get(key)
        if ra is not None and rb is not None and ra[0] == rb[0]:
            continue
        dp = max(ra[1] if ra else 0, rb[1] if rb else 0)
        if dp < max_depth and not near_hotspot(key[0], key[1]):
            bad.append((key, "missing" if ra is None or rb is None
                        else "fields", dp))
    if bad:
        return False, f"DIVERGENT beyond depth mask: {bad[:5]}"
    n_deep = sum(1 for key in set(a) & set(b) if a[key][0] != b[key][0])
    return True, f"MATCH (depth-masked; {n_deep} deep-pileup sites differ)"
