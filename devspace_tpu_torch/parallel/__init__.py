"""Parallelism of the port over ``torch.distributed``, explicit SPMD:
named meshes and partition specs (``mesh``), the collectives with their
gradients (``collectives``), data, tensor, sequence (ring, Ulysses),
expert and fully-sharded data parallelism, and the 1F1B and interleaved
pipelines (``pipeline``, with ``interleaved``'s schedule tables)."""
