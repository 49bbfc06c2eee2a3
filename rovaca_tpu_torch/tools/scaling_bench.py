"""Host-level scaling: interval-shard processes of this package on one
machine.

Counterpart of scripts/scaling_bench.py. It runs ``python -m
rovaca_tpu_torch.cli HaplotypeCaller`` with ``--shards`` 1, 2 and 4 (one
process for 1, N shard processes for N) on a corpus, each shard process
pinned to its own core with one native thread and one prep thread; the
1-shard run is pinned to core 0, so the question is whether a
rank-per-core split scales. It reports each count's wall, reads/s and
parallel efficiency against 1 shard (wall_1 / (wall_N x N)), a start-up
probe (a run over the contig's first 2 kb) and the model wall(P) = start-up
+ W / min(P, cores) with its residual, and holds each split's VCF to the
1-shard VCF with ``race_e2e.depth_masked_diff``. SCALING.json is written
into the corpus directory.

    python -m rovaca_tpu_torch.tools.scaling_bench <dir> [shard counts...]
        [--engine cuda|native|torch]

The cuda engine (the default) needs the card and stops without one; the
shards of one card share it. ``native`` and ``torch`` run on the CPU.
"""

import argparse
import json
import os
import subprocess
import sys
import time

from .race_e2e import cli_env, count_reads, depth_masked_diff


def _cmd(corpus, out, engine, *extra):
    return [sys.executable, "-m", "rovaca_tpu_torch.cli", "HaplotypeCaller",
            "-i", os.path.join(corpus, "sample.bam"),
            "-r", os.path.join(corpus, "ref.fa"), "-o", out,
            "--pairhmm-engine", engine, "--log-level", "WARNING", *extra]


def run_scaling(corpus, shard_counts=(1, 2, 4), engine="cuda", log=print):
    """Run each shard count on ``corpus``; writes and returns
    SCALING.json's dict."""
    if engine in ("auto", "cuda"):
        from ..utils.platform import require_card
        require_card("the cuda engine's scaling run")
    bam = os.path.join(corpus, "sample.bam")
    env = cli_env((("ROVACA_NATIVE_THREADS", "1"),
                   ("ROVACA_PIN_SHARDS", "1"),
                   ("ROVACA_PREP_THREADS", "1")))
    results = {"n_reads": count_reads(bam), "ncpu": os.cpu_count(),
               "engine": engine, "runs": {}}
    base = None
    for s in shard_counts:
        out = os.path.join(corpus, f"scale_{s}.vcf")
        cmd = _cmd(corpus, out, engine,
                   *(("--shards", str(s)) if s > 1 else ()))
        preexec = (lambda: os.sched_setaffinity(0, {0})) if s == 1 else None
        t0 = time.perf_counter()
        cp = subprocess.run(cmd, env=env, capture_output=True, text=True,
                            timeout=3600, preexec_fn=preexec)
        dt = time.perf_counter() - t0
        if cp.returncode != 0:
            sys.stderr.write(cp.stderr[-2000:])
            raise SystemExit(f"shards={s} failed rc={cp.returncode}")
        with open(out) as f:
            records = sum(1 for ln in f if not ln.startswith("#"))
        if base is None:
            base = out
            ok, detail = True, "the 1-shard run itself"
        else:
            ok, detail = depth_masked_diff(base, out, bam_path=bam)
        results["runs"][str(s)] = {"wall_s": dt, "reads_per_s":
                                   results["n_reads"] / dt,
                                   "records": records, "ok": ok,
                                   "diff_vs_1shard": detail}
        log(f"shards={s}: {dt:.3f}s {results['n_reads'] / dt:.0f} reads/s "
            f"{detail}")

    # the fixed start-up of a process, from a run over the first 2 kb
    from ..io.fasta import FastaFile
    contig = next(iter(FastaFile(os.path.join(corpus, "ref.fa"))
                       .contig_dict))
    t0 = time.perf_counter()
    cp = subprocess.run(_cmd(corpus, os.path.join(corpus,
                                                  "scale_startup.vcf"),
                             engine, "-L", f"{contig}:1-2000"),
                        env=env, capture_output=True, text=True, timeout=600)
    startup = time.perf_counter() - t0 if cp.returncode == 0 else None
    results["startup_probe_s"] = startup
    one = results["runs"].get("1")
    if one:
        ncpu = os.cpu_count() or 1
        w1 = one["wall_s"] - (startup or 0)
        for s, r in results["runs"].items():
            r["efficiency_vs_1"] = one["wall_s"] / (r["wall_s"] * int(s))
            model = (startup or 0) + w1 / min(int(s), ncpu)
            r["model_wall_s"] = model
            r["model_residual_pct"] = 100.0 * (r["wall_s"] - model) / model
        results["model"] = ("wall(P) = startup + W/min(P,ncpu); startup "
                            "measured with a run over the first 2 kb")
    path = os.path.join(corpus, "SCALING.json")
    with open(path, "w") as f:
        json.dump(results, f, indent=1)
    results["path"] = path
    return results


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m rovaca_tpu_torch.tools.scaling_bench",
        description="--shards 1/2/4 walls and efficiency; SCALING.json")
    p.add_argument("dir", help="corpus directory with sample.bam, ref.fa")
    p.add_argument("shards", nargs="*", type=int)
    p.add_argument("--engine", default="cuda",
                   choices=["auto", "cuda", "native", "torch"])
    a = p.parse_args(argv)
    res = run_scaling(a.dir, tuple(a.shards) or (1, 2, 4), a.engine)
    print("->", res["path"])
    return 0 if all(r["ok"] for r in res["runs"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
