"""Distributed-optimization pieces of the port (``repro.distributed``):
so far only the gradient compression the optimizer's ``compression`` uses
(:mod:`repro_torch.distributed.collectives`)."""
