"""Data parallelism over ``torch.distributed``: one process per card under
``torchrun`` (``mesh``), and the collectives of the train step and of the
eval merge (``mesh``, ``comm``)."""
