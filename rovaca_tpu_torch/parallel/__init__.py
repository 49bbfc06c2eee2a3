"""Multi-device / multi-process parallel runtime of the port.

Counterpart of rovaca_tpu/parallel: interval sharding and the sharded device
steps (``sharding``, ``pipeline_shard``), the ``--shards`` process runner
(``sharded_runner``), the ``-t`` host worker pool (``host_executor``) and
``torch.distributed`` ranks (``distributed``). Nothing is imported here, so
a ``-t`` worker that imports ``host_executor`` imports no torch.
"""
