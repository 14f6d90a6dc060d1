"""LM side path of the port (``repro.models``): the blocks of every family
(RecurrentGemma's RG-LRU and local attention, full attention with dense or
MoE MLPs, RWKV-6, the vlm's M-RoPE and patches, the enc-dec backbone), the
decoder stack, parameter specs and weight conversion from the JAX package's
pytrees."""
