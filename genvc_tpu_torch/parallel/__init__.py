"""Parallelism (``genvc_tpu/parallel``): the ``(data, model)`` mesh over
``torch.distributed`` process groups, the sharding helpers of the GPT tree,
Megatron's conjugate collectives, and the launcher of rank processes."""
