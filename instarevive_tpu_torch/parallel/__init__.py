"""Parallelism over ``torch.distributed`` (``instarevive_tpu/parallel``): one
process a card, NCCL on the card and gloo on the CPU.

* ``dist``: the rendezvous (``MASTER_ADDR``/``MASTER_PORT``/``RANK``/
  ``WORLD_SIZE``/``LOCAL_RANK``, ``torchrun``'s contract), the host-level
  helpers, and the self-start of a CLI's ranks;
* ``mesh``: the ('data', 'fsdp', 'tensor') device mesh, the batch split of
  data parallelism, and the training wrappers (gradient all-reduce, FSDP2);
* ``tp``: Megatron tensor parallelism of the DiT blocks;
* ``sp``: sequence parallelism of the DiT's tokens;
* ``pp``: GPipe pipeline parallelism of the DiT's block stack.
"""
