"""LM side path of the port (``repro.models``): the RecurrentGemma family's
blocks, the decoder stack, parameter specs and weight conversion from the
JAX package's pytrees."""
