"""Multi-device pieces of the port (``repro.distributed``): halo-exchanged
stencils over ``torch.distributed`` (:mod:`repro_torch.distributed.halo`),
the logical-axis sharding rules (:mod:`repro_torch.distributed.sharding`),
gradient compression and the quantized all-reduce
(:mod:`repro_torch.distributed.collectives`)."""
