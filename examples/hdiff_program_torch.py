"""Walkthrough on the PyTorch port: a StencilFlow-style horizontal-diffusion
*program* fused into one spatial pipeline (laplacian → flux → output).

The counterpart of ``examples/hdiff_program.py`` (the same program, seeds
and checks), on ``repro_torch``.  The paper maps one stencil; real
weather/seismic kernels are DAGs of several.  ``repro_torch.program``
composes them: the IR infers per-field halos across the DAG, the lowering
splices every producer's worker streams directly into its consumers' tap
chains (no store/reload of ``lap`` or ``flx``), sizes the inter-operator
skew buffer that the ``inp`` fan-out needs to meet ``flx`` at the final
combine, and the whole thing places, routes, and simulates on the paper's
16x16 mesh — bit-exact against the composed numpy oracle and faster than
running the three ops as separate store-to-memory sweeps.  Host numpy only:
nothing runs on a card.

Run:  PYTHONPATH=src python examples/hdiff_program_torch.py
"""
import numpy as np

from repro_torch.core import CGRA
from repro_torch.fabric import FabricTopology, place, route
from repro_torch.program import (StencilProgram, field_leads, hdiff_program,
                                 lower, program_reference_np,
                                 simulate_program)


def main():
    prog = hdiff_program(48, 64)
    print(f"{prog!r}")
    leads = field_leads(prog)
    print("fields (margin = invalid rim per axis, lead = pipeline depth in "
          "sites):")
    for f, m in prog.margins().items():
        print(f"  {f:<4} margin={m} lead={leads[f]}")

    plan = lower(prog, workers=4, auto_capacity=True)
    print(f"\nlowered: {len(plan.dfg.nodes)} instructions, "
          f"{sum(1 for _ in plan.dfg.edges())} queues")
    print(f"  {plan.notes}")
    skew = max(plan.min_capacities.values())
    print(f"  largest computed skew buffer: {skew} tokens "
          f"(the 'inp' branch waiting for 'flx' at the combine)")

    # --- physical fabric: the paper's 16x16 mesh --------------------------
    topo = FabricTopology.mesh(16, 16)
    rf = route(place(plan, topo, seed=0))
    s = rf.stats()
    print(f"\nplaced on {topo!r}")
    print(f"  PEs used          {s['pes_used']}/{len(topo.pes)} "
          f"({s['pe_utilization']:.0%})")
    print(f"  hop count         mean={s['hops_mean']} max={s['hops_max']}")
    print(f"  max channel load  {s['max_channel_load']}/"
          f"{s['channel_capacity']}")

    # --- fused pipeline vs separate store-to-memory sweeps ----------------
    rng = np.random.default_rng(0)
    x = rng.normal(size=prog.grid_shape)
    ideal, _ = simulate_program(lower(prog, workers=4), {"inp": x}, CGRA)
    routed, fields = simulate_program(plan, {"inp": x}, CGRA, fabric=rf)
    assert np.array_equal(ideal.output, routed.output)
    ref = program_reference_np(prog, {"inp": x})
    assert np.allclose(fields["out"], ref["out"], atol=1e-9)

    separate = 0
    for op in prog.schedule():
        solo = StencilProgram(f"solo_{op.name}", [op],
                              grid_shape=prog.grid_shape, dtype=prog.dtype)
        ins = {f: rng.normal(size=prog.grid_shape) for f in solo.in_fields}
        separate += simulate_program(lower(solo, workers=4), ins,
                                     CGRA)[0].cycles
    print(f"\nfused pipeline (ideal wires):   {ideal.cycles} cycles")
    print(f"fused pipeline (routed mesh):   {routed.cycles} cycles "
          f"({routed.fabric['token_hops']} token-hops)")
    print(f"separate sweeps (3 memory round trips): {separate} cycles")
    print(f"fusion speedup: {separate / ideal.cycles:.2f}x — "
          "oracle check passed, outputs bit-identical ideal vs routed")


def lint_plans():
    """Static-verifier hook
    (``python -m repro_torch.analysis.lint examples/*_torch.py``)."""
    yield lower(hdiff_program(24, 32), workers=4, auto_capacity=True)


if __name__ == "__main__":
    main()
