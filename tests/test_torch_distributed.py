"""Two torch.distributed ranks of the port's CLI on the CPU (gloo).

Counterpart of tests/test_distributed_2proc.py: two CLI processes (torch
engine) form one run, each calls its interval shard and rank 0 merges. The
environment comes in two forms: torchrun's names (WORLD_SIZE, RANK,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and the names rovaca_tpu reads
(JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID). On
simdata.make_standard_case no pileup is downsampled, so rank 0's merged VCF
must be byte-identical to a single-process run. No rank imports jax. A
rank that fails makes the other fail too, with no merged output.
"""

import os
import socket
import subprocess
import sys

import pytest

import simdata
from test_torch_e2e import REPO, _run_without_jax


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_envs(form, port):
    if form == "torchrun":
        return [{"WORLD_SIZE": "2", "RANK": str(r), "LOCAL_RANK": str(r),
                 "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
                for r in range(2)]
    return [{"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
             "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": str(r)}
            for r in range(2)]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_distributed")
    fasta, bam, _, _ = simdata.make_standard_case(tmp)
    _run_without_jax((tmp, fasta, bam), {}, argv=(), out="single.vcf")
    return tmp, fasta, bam


@pytest.mark.parametrize("form", ["torchrun", "jax_names"])
def test_two_ranks_match_single_process(case, form):
    tmp = case[0]
    out = f"dist_{form}.vcf"
    stats, marks = _run_without_jax(case, {}, argv=(), out=out,
                                    ranks=_rank_envs(form, _free_port()))
    assert stats["regions"] > 0
    assert len(marks) >= 2                      # both ranks, jax-free
    merged = (tmp / out).read_bytes()
    assert merged.count(b"\n#CHROM") == 1 and b"\nchr" in merged
    assert merged == (tmp / "single.vcf").read_bytes()
    assert not list(tmp.glob(f"{out}.rank*"))   # shard files removed


def test_failed_rank_fails_the_run(case):
    """Rank 1 fails (engine cuda without a card) after the rendezvous: it
    exits non-zero, and rank 0 fails at the barrier instead of merging."""
    tmp, fasta, bam = case
    out = tmp / "failed_rank.vcf"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    procs = []
    for rank, rank_env in enumerate(_rank_envs("torchrun", _free_port())):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "rovaca_tpu_torch.cli", "HaplotypeCaller",
             "-i", bam, "-r", fasta, "-o", str(out), "--pairhmm-engine",
             "torch" if rank == 0 else "cuda"], env={**env, **rank_env},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        errs = [p.communicate(timeout=240)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode != 0 for p in procs] == [True, True]
    assert "no CUDA device" in errs[1]
    assert "Traceback" in errs[0]             # at the barrier
    assert not out.exists()
