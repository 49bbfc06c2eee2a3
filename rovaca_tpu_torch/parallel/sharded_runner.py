"""Interval-sharded multi-process runs (``--shards N``).

Counterpart of rovaca_tpu/parallel/sharded_runner.py, which imports jax
through its ``sharding``. The FASTA is replicated, genomic intervals are
sharded data-parallel, and the per-shard VCF streams merge in coordinate
order (the reference's source_id-ordered writer merge — reference:
src/haplotypecaller/writer/writer.cpp:147-196 — lifted to shard
granularity).

Each shard is an independent ``python -m rovaca_tpu_torch.cli`` invocation
restricted to its core span with boundary context; shard outputs concatenate
in genome order (a shard only emits records whose start lies in its core
span, so the merge is exact). With more than one visible card, shard process
``k`` sees card ``k % n`` alone (``CUDA_VISIBLE_DEVICES``); with one card,
every shard shares it, as rovaca_tpu's shards share the chip. Shard
processes log to this process's stderr.
"""

import os
import subprocess
import sys

from ..io.fasta import FastaFile
from .sharding import local_device_count, shard_intervals


def compute_shards(reference_path, n_shards, contig=None, start=None,
                   end=None):
    """Shard (contig, core_start, core_end) spans by base count."""
    fasta = FastaFile(reference_path)
    if contig is not None:
        intervals = [(contig, start or 0,
                      end or fasta.contig_length(contig))]
    else:
        intervals = [(c, 0, length)
                     for c, length in fasta.contig_dict.items()]
    return shard_intervals(intervals, n_shards)


def _shard_cards():
    """The card each shard process k gets, as CUDA_VISIBLE_DEVICES values
    (k % n of the cards this process sees); empty with fewer than two."""
    n = local_device_count()
    if n < 2:
        return []
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = ([v.strip() for v in visible.split(",") if v.strip()]
           if visible else [str(i) for i in range(n)])
    return ids[:n]


def run_sharded(cli_args, n_shards, output_path):
    """Run the HaplotypeCaller CLI once per shard, in parallel, and merge
    outputs. A shard that exits non-zero raises RuntimeError once every
    shard has ended.

    cli_args: the argv list WITHOUT -o/-L (they're added per shard).
    Returns the list of per-shard record counts.
    """
    ref = cli_args[cli_args.index("-r") + 1] if "-r" in cli_args else \
        cli_args[cli_args.index("--reference") + 1]
    shards = compute_shards(ref, n_shards)

    # index every input BAM once up front so each shard's -L becomes an
    # indexed seek instead of a whole-file scan (the reference hands each
    # worker an hts_itr over the shared index; here the .bai is the shared
    # structure and shard processes open it read-only)
    for flag in ("-i", "--input"):
        for k, a in enumerate(cli_args):
            if a == flag and k + 1 < len(cli_args):
                bam = cli_args[k + 1]
                from ..io.bai import build_index, find_index
                if find_index(bam) is None:
                    try:
                        build_index(bam)
                    except (ValueError, OSError):
                        pass  # unindexable input: shards fall back to scans

    cards = _shard_cards()
    # torch's intra-op threads: a share of the cores each, as torchrun
    # gives its ranks; N shards of all cores spin against each other
    threads = str(max(1, (os.cpu_count() or 1)
                      // max(1, sum(map(len, shards)))))
    procs = []
    shard_files = []
    for si, shard in enumerate(shards):
        if not shard:
            continue
        # one invocation per contiguous span in the shard
        for pi, (contig, _ps, _pe, core_s, core_e) in enumerate(shard):
            out = f"{output_path}.shard{si:04d}_{pi:03d}"
            shard_files.append(out)
            argv = [sys.executable, "-m", "rovaca_tpu_torch.cli",
                    "HaplotypeCaller", *cli_args, "-o", out,
                    "-L", f"{contig}:{core_s + 1}-{core_e}"]
            env = dict(os.environ)
            env.setdefault("OMP_NUM_THREADS", threads)
            if cards:
                env["CUDA_VISIBLE_DEVICES"] = cards[len(procs) % len(cards)]
            # ROVACA_PIN_SHARDS: give each worker its own core, like a
            # multi-host rank owns its host. Without pinning, N workers
            # x (native threads + overlap thread) oversubscribe an N-core
            # box and thrash.
            preexec = None
            if os.environ.get("ROVACA_PIN_SHARDS"):
                core = len(procs) % (os.cpu_count() or 1)
                preexec = (lambda c=core: os.sched_setaffinity(0, {c}))
            procs.append(subprocess.Popen(argv, env=env,
                                          preexec_fn=preexec))
    failed = [p.args for p in procs if p.wait() != 0]
    if failed:
        raise RuntimeError(f"shard process failed: {failed[0]}")

    counts = merge_shard_vcfs(shard_files, output_path)
    for f in shard_files:
        os.unlink(f)
    return counts


def _open_vcf_lines(path):
    """Iterate text lines of a plain or BGZF/gzip-compressed VCF."""
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        import io

        from ..io import bgzf
        fh = io.TextIOWrapper(bgzf.open_read(path))
    else:
        fh = open(path)
    return fh


def merge_shard_vcfs(shard_files, output_path, compression_level=6):
    """Coordinate-ordered merge: header from shard 0, bodies concatenated
    (shards are genome-ordered and emit only their core span).

    BGZF-aware on both sides: shard inputs may be plain or compressed, and
    a `.gz` output is written as true BGZF and re-indexed with a fresh .tbi
    (mirrors the unsharded writer's close path, reference writer.cpp:97-98)."""
    counts = []
    if output_path.endswith(".gz"):
        import io

        from ..io import bgzf
        from ..io.vcf import _BgzfRaw
        out = io.TextIOWrapper(_BgzfRaw(bgzf.Writer(output_path,
                                                    compression_level)))
    else:
        out = open(output_path, "w")
    try:
        wrote_header = False
        for path in shard_files:
            n = 0
            with _open_vcf_lines(path) as fh:
                for line in fh:
                    if line.startswith("#"):
                        if not wrote_header:
                            out.write(line)
                        continue
                    out.write(line)
                    n += 1
            wrote_header = True
            counts.append(n)
    finally:
        out.close()
    if output_path.endswith(".gz"):
        from ..io import tabix
        tabix.build_index(output_path)
    return counts
