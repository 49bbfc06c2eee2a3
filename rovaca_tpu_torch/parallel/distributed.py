"""Multi-process execution on ``torch.distributed``.

Counterpart of rovaca_tpu/parallel/distributed.py (``jax.distributed``).
Every process owns a contiguous interval shard (FASTA replicated, BAM read
via indexed fetch of its shard only), runs the full pipeline on its card,
writes ``<out>.rankNNNN_PPP``, and rank 0 concatenates the genome-ordered
shard outputs after a cross-process barrier.

Wire-up:
  - ``maybe_init_distributed()`` joins a process group when the environment
    describes a multi-process run: torchrun's names (``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``; ``LOCAL_RANK`` picks the
    card, utils/platform.py) or rovaca_tpu's (``JAX_COORDINATOR_ADDRESS`` as
    host:port, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``), so existing launch
    scripts keep working. ``ROVACA_AUTO_DISTRIBUTED`` asks for the rank from
    torchrun's names and fails without them.
  - ``run_distributed(args, fn)`` is what each process of the CLI runs
    when the world has more than one process.

The group runs on gloo: the barriers carry no card data, and NCCL refuses two
ranks on one card, the layout of a one-card host.
"""

import copy
import os

_TORCHRUN_NAMES = ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")


def requested():
    """True when the environment asks for a multi-process run."""
    return bool(os.environ.get("JAX_COORDINATOR_ADDRESS")
                or os.environ.get("ROVACA_AUTO_DISTRIBUTED")
                or os.environ.get("WORLD_SIZE"))


def _rendezvous():
    """(init_method, rank, world) from the environment; raises ValueError
    when it is incomplete."""
    env = os.environ
    coord = env.get("JAX_COORDINATOR_ADDRESS")
    if coord:
        if not env.get("JAX_NUM_PROCESSES") or \
                env.get("JAX_PROCESS_ID") is None:
            raise ValueError("JAX_COORDINATOR_ADDRESS needs "
                             "JAX_NUM_PROCESSES and JAX_PROCESS_ID")
        host, _, port = coord.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"JAX_COORDINATOR_ADDRESS {coord!r} is not "
                             "host:port")
        return (f"tcp://{host}:{port}", int(env["JAX_PROCESS_ID"]),
                int(env["JAX_NUM_PROCESSES"]))
    missing = [k for k in _TORCHRUN_NAMES if not env.get(k)]
    if missing:
        raise ValueError("a multi-process run needs torchrun's environment "
                         f"(missing {', '.join(missing)})")
    return (f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
            int(env["RANK"]), int(env["WORLD_SIZE"]))


def maybe_init_distributed():
    """Join the gloo process group when the environment describes a
    multi-process run; a no-op otherwise. Returns (rank, world). Raises
    ValueError on an incomplete environment and RuntimeError when the
    rendezvous fails."""
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if not requested():
        return 0, 1
    init_method, rank, world = _rendezvous()
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    if world > 1:
        dist.init_process_group("gloo", init_method=init_method, rank=rank,
                                world_size=world)
    return rank, world


def process_shard_span(reference_path, process_index, process_count,
                       contig=None, start=None, end=None):
    """This process's contiguous (contig, core_start, core_end) spans."""
    from .sharded_runner import compute_shards
    shards = compute_shards(reference_path, process_count, contig=contig,
                            start=start, end=end)
    return shards[process_index] if process_index < len(shards) else []


def run_distributed(args, run_single_fn):
    """Per-process run: run ``run_single_fn(args)`` restricted to this
    process's interval shard, then merge on rank 0 and leave the group.

    ``args`` is pipeline.caller.HCArgs; ``run_single_fn(args)`` runs the
    normal single-process pipeline honoring args.target_span/output_path.
    Returns the stats of this rank's last span.
    """
    import torch.distributed as dist
    rank, world = dist.get_rank(), dist.get_world_size()
    span = None
    if args.target_span:
        from ..pipeline.caller import parse_span
        span = parse_span(args.target_span)

    def spans_of(r):
        return process_shard_span(
            args.reference_path, r, world,
            contig=span[0] if span else None,
            start=span[1] if span else None,
            end=span[2] if span else None)

    shard_files_all = []   # every rank computes the same global list
    for r in range(world):
        for pi in range(len(spans_of(r))):
            shard_files_all.append(f"{args.output_path}.rank{r:04d}_{pi:03d}")

    stats = None
    try:
        for pi, (contig, _ps, _pe, core_s, core_e) in enumerate(
                spans_of(rank)):
            shard_args = copy.copy(args)
            shard_args.output_path = \
                f"{args.output_path}.rank{rank:04d}_{pi:03d}"
            shard_args.target_span = f"{contig}:{core_s + 1}-{core_e}"
            stats = run_single_fn(shard_args)

        dist.barrier()   # every rank's shard files are closed
        if rank == 0:
            from .sharded_runner import merge_shard_vcfs
            merge_shard_vcfs([f for f in shard_files_all
                              if os.path.exists(f)],
                             args.output_path,
                             compression_level=args.compression_level)
            for f in shard_files_all:
                if os.path.exists(f):
                    os.unlink(f)
        dist.barrier()   # the merged output is complete
    finally:
        dist.destroy_process_group()
    return stats
