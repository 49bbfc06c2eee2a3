"""Command-line interface of the port.

Counterpart of rovaca_tpu/cli.py with the same tools and flags:

    python -m rovaca_tpu_torch.cli HaplotypeCaller -i in.bam -r ref.fa \
        -o out.vcf

``--pairhmm-engine`` is auto|cuda|torch|native; auto is cuda and fails
without a card. On the cuda engine the realignment of reads to their best
haplotype runs through the banded SW kernel on the card, and
ROVACA_BANDED_REALIGN=0 in the environment keeps it on the native SW batch;
on torch and native it runs on the native SW batch, and
ROVACA_BANDED_REALIGN=1 runs the banded kernel's plain versions instead.
``--shards N`` runs N shard processes and merges their VCFs
(parallel/sharded_runner.py), ``-t N`` prepares regions in N worker
processes while this one launches the kernels (parallel/host_executor.py),
and a torchrun environment (or rovaca_tpu's JAX_COORDINATOR_ADDRESS /
JAX_NUM_PROCESSES / JAX_PROCESS_ID) makes each process one rank of a
``torch.distributed`` run that rank 0 merges (parallel/distributed.py).
"""

import argparse
import os
import sys
import time

TOOL_REGISTRY = {}


def register_tool(name):
    def deco(fn):
        TOOL_REGISTRY[name] = fn
        return fn
    return deco


@register_tool("HaplotypeCaller")
def run_haplotype_caller(argv, stats=None):
    p = argparse.ArgumentParser(
        prog="rovaca_tpu_torch HaplotypeCaller",
        description="Germline SNP/INDEL calling via local re-assembly "
                    "(CUDA PairHMM)")
    p.add_argument("-i", "--input", action="append", required=True,
                   dest="bams", help="input BAM (repeatable)")
    p.add_argument("-r", "--reference", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-b", "--bed", default=None, help="target intervals BED")
    p.add_argument("-P", "--interval-padding", type=int, default=0)
    p.add_argument("-e", "--erc", "--emit-ref-confidence", dest="erc",
                   default="NONE", choices=["NONE", "GVCF"])
    p.add_argument("--max-reads-depth", type=int, default=50)
    p.add_argument("--base-quality-score-threshold", type=int, default=18)
    p.add_argument("--max-mnp-distance", type=int, default=0)
    p.add_argument("--pcr-indel-model", default="CONSERVATIVE",
                   choices=["NONE", "HOSTILE", "AGGRESSIVE", "CONSERVATIVE"])
    p.add_argument("-d", "--dbsnp", default=None)
    p.add_argument("--bqsr-recal-table", default=None)
    p.add_argument("--gq-bands", default=None,
                   help="comma-separated GQ band upper bounds")
    p.add_argument("-L", "--target-span", action="append", default=None,
                   dest="target_span",
                   help="restrict to contig[:start-end] (1-based); "
                        "repeatable — multiple values act as a target list")
    p.add_argument("--pairhmm-engine", default="auto",
                   choices=["auto", "cuda", "torch", "native"],
                   help="auto = cuda (needs a GPU); torch = plain torch on "
                        "the CPU; native = host C++ engine")
    p.add_argument("--sample-name", default=None)
    p.add_argument("-t", "--host-workers", type=int, default=1,
                   help="host worker processes for region preparation")
    p.add_argument("--assemble-output", default=None,
                   help="dump per-region reads+haplotypes for golden diffs")
    p.add_argument("--resume", action="store_true",
                   help="resume an interrupted run from its checkpoint")
    p.add_argument("--log-level", default="INFO",
                   choices=["DEBUG", "INFO", "WARNING", "ERROR"])
    p.add_argument("--compression-level", type=int, default=6,
                   help="bgzf compression level for .gz outputs (0-9)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler host/card trace here")
    p.add_argument("--shards", type=int, default=1,
                   help="interval-sharded data-parallel run: N shard "
                        "processes with coordinate-ordered output merge")
    a = p.parse_args(argv)

    from rovaca_tpu_torch import constants as C
    from rovaca_tpu_torch.pipeline.caller import HaplotypeCaller, HCArgs

    # file validation (rovaca_tool_args valid_check counterpart)
    for path in [*a.bams, a.reference] + (
            [a.bed] if a.bed else []) + ([a.dbsnp] if a.dbsnp else []) + (
            [a.bqsr_recal_table] if a.bqsr_recal_table else []):
        if not os.path.exists(path):
            print(f"error: input file does not exist: {path}",
                  file=sys.stderr)
            return 2

    if a.shards > 1:
        from rovaca_tpu_torch.parallel.sharded_runner import run_sharded
        passthrough = []
        it = iter(argv)
        for tok in it:
            if tok in ("-o", "--output", "--shards", "-L", "--target-span"):
                next(it, None)
                continue
            passthrough.append(tok)
        t0 = time.time()
        try:
            counts = run_sharded(passthrough, a.shards, a.output)
        except RuntimeError as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 1
        print(f"[rovaca_tpu_torch] sharded x{a.shards}: {sum(counts)} "
              f"records in {time.time() - t0:.1f}s", file=sys.stderr)
        return 0

    bands = (tuple(int(x) for x in a.gq_bands.split(","))
             if a.gq_bands else C.DEFAULT_GVCF_GQ_BANDS)
    spans = a.target_span or []
    target_span = spans[0] if len(spans) == 1 else None
    target_intervals = None
    if len(spans) > 1:
        if a.bed:
            print("error: use either -b/--bed or multiple -L, not both",
                  file=sys.stderr)
            return 2
        from rovaca_tpu_torch.pipeline.caller import parse_span
        target_intervals = []
        for s in spans:
            contig, beg, end = parse_span(s)
            target_intervals.append((contig, beg or 0,
                                     end if end is not None else 1 << 62))
    args = HCArgs(bam_paths=a.bams, reference_path=a.reference,
                  output_path=a.output, bed_path=a.bed,
                  interval_padding=a.interval_padding,
                  gvcf_mode=(a.erc == "GVCF"), gq_bands=bands,
                  max_reads_depth=a.max_reads_depth,
                  base_quality_threshold=a.base_quality_score_threshold,
                  max_mnp_distance=a.max_mnp_distance,
                  pcr_indel_model=a.pcr_indel_model,
                  dbsnp_path=a.dbsnp, recal_table=a.bqsr_recal_table,
                  sample_name=a.sample_name,
                  pairhmm_engine=a.pairhmm_engine,
                  target_span=target_span,
                  target_intervals=target_intervals,
                  host_workers=a.host_workers,
                  assemble_output_path=a.assemble_output,
                  resume=a.resume, log_level=a.log_level,
                  compression_level=a.compression_level,
                  profile_dir=a.profile_dir)
    t0 = time.time()
    try:
        # multi-process run: each process takes its interval shard and
        # rank 0 merges (parallel/distributed.py)
        from rovaca_tpu_torch.parallel import distributed
        _, world = distributed.maybe_init_distributed()
        if world > 1:
            result = distributed.run_distributed(
                args, lambda a: HaplotypeCaller(a).run())
        else:
            result = HaplotypeCaller(args).run()
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    dt = time.time() - t0
    if stats is not None:
        stats.update(result, wall_s=dt)
    print(f"[rovaca_tpu_torch] {result['reads']} reads, {result['regions']} "
          f"regions, {result['calls']} records in {dt:.3f}s "
          f"({result['launches']} launches, "
          f"{result['device_ms'] / 1e3:.4f}s on the card; banded SW "
          f"{result['sw_launches']} launches, {result['sw_fallbacks']} "
          f"fallbacks)", file=sys.stderr)
    return 0


@register_tool("BuildBamIndex")
def run_build_bam_index(argv, stats=None):
    p = argparse.ArgumentParser(
        prog="rovaca_tpu_torch BuildBamIndex",
        description="Build a .bai index for a coordinate-sorted BAM "
                    "(samtools index equivalent; enables indexed -L seeks)")
    p.add_argument("-i", "--input", required=True, help="input BAM")
    p.add_argument("-o", "--output", default=None,
                   help="index path (default: <input>.bai)")
    a = p.parse_args(argv)
    if not os.path.exists(a.input):
        print(f"error: input file does not exist: {a.input}", file=sys.stderr)
        return 2
    from rovaca_tpu_torch.io.bai import build_index
    t0 = time.time()
    try:
        out = build_index(a.input, a.output)
    except (ValueError, OSError) as exc:
        print(f"error: cannot index {a.input}: {exc}", file=sys.stderr)
        return 2
    print(f"[rovaca_tpu_torch] indexed {a.input} -> {out} "
          f"in {time.time() - t0:.1f}s", file=sys.stderr)
    return 0


@register_tool("IndexFeatureFile")
def run_index_feature_file(argv, stats=None):
    p = argparse.ArgumentParser(
        prog="rovaca_tpu_torch IndexFeatureFile",
        description="Build a .tbi index for a bgzipped, coordinate-sorted "
                    "VCF (tabix equivalent)")
    p.add_argument("-i", "--input", required=True, help="input .vcf.gz")
    p.add_argument("-o", "--output", default=None,
                   help="index path (default: <input>.tbi)")
    a = p.parse_args(argv)
    if not os.path.exists(a.input):
        print(f"error: input file does not exist: {a.input}", file=sys.stderr)
        return 2
    from rovaca_tpu_torch.io.tabix import build_index
    t0 = time.time()
    try:
        out = build_index(a.input, a.output)
    except (ValueError, OSError) as exc:
        print(f"error: cannot index {a.input}: {exc}", file=sys.stderr)
        return 2
    print(f"[rovaca_tpu_torch] indexed {a.input} -> {out} "
          f"in {time.time() - t0:.1f}s", file=sys.stderr)
    return 0


def main(argv=None, stats=None):
    """Run one tool; returns its exit code. A dict passed as ``stats``
    receives the HaplotypeCaller's counters (reads, regions, calls,
    launches, device_ms, sw_launches, sw_fallbacks, wall_s)."""
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: rovaca_tpu_torch <tool> [options]\n\ntools:")
        for name in TOOL_REGISTRY:
            print(f"  {name}")
        return 0 if argv else 2
    tool = argv[0]
    if tool not in TOOL_REGISTRY:
        print(f"unknown tool: {tool}; available: {list(TOOL_REGISTRY)}",
              file=sys.stderr)
        return 2
    return TOOL_REGISTRY[tool](argv[1:], stats)


if __name__ == "__main__":
    sys.exit(main())
