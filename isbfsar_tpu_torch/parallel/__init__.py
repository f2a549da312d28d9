"""Several devices over ``torch.distributed`` (port of ``isbfsar_tpu/parallel/``).

``launch.run_ranks`` starts a process group of fresh processes; ``mesh``
holds the placement rules and the DDP / FSDP2 / tensor-parallel wrappers;
``collectives`` the differentiable collectives the models and the trainer
call; ``support`` the way-sharded matcher; ``parity`` the certificates that
an n-rank step equals the 1-device one; ``multihost`` the same over nodes.
"""
