"""Serving path of the port (``repro.serving``): prefill and decode step
builders and the batched decode engine."""
