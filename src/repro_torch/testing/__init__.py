"""Test-support utilities shipped with the library (no third-party deps).

``repro_torch.testing.minihyp`` (carried over from ``repro.testing``) is a
minimal, deterministic stand-in for the `hypothesis` property-testing API
so the tier-1 property sweep runs (rather than skips) in environments where
``hypothesis`` cannot be installed.
"""
