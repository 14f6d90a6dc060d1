"""Walkthrough on the PyTorch port: a 3D heat stencil on the physical PE
fabric via ``map_nd``.

The counterpart of ``examples/heat3d_fabric.py`` (the same spec, seeds and
checks), on ``repro_torch``.  The dimension-generic worker pipeline makes
rank 3 fall out of the same construction as 1D and 2D:

  heat_3d spec -> map_3d (= map_nd) -> place -> route -> network-aware sim

A 7-pt heat step is mapped with 8 workers — each compute worker carries
three tap chains (x: 3 taps from 3 readers; y and z: 2 taps each from the
column-owning reader) joined by an ADD tree — placed on the paper's 16x16
mesh, routed with XY multicast trees, and simulated twice (ideal wires vs
routed network).  The numerics stay bit-identical to the numpy oracle.
Host numpy only: nothing runs on a card.

Run:  PYTHONPATH=src python examples/heat3d_fabric_torch.py
"""
import numpy as np

from repro_torch.core import CGRA, map_3d, simulate
from repro_torch.core.reference import stencil_reference_np
from repro_torch.core.spec import heat_3d
from repro_torch.fabric import FabricTopology, place, placed_assembly, route


def main():
    spec = heat_3d(10, 12, 16, dtype="float64")
    plan = map_3d(spec, workers=8)
    print(f"logical mapping: {len(plan.dfg.nodes)} instructions, "
          f"{sum(1 for _ in plan.dfg.edges())} queues — {plan.notes}")
    print(f"per-worker pipeline: {plan.pe_counts['filter'] // 8} filters, "
          f"{plan.pe_counts['mul'] // 8} MUL + {plan.pe_counts['mac'] // 8} "
          f"MAC chains, {plan.pe_counts['add'] // 8} axis-combining ADDs")

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
    print(f"  busiest link      {s['hotspots'][0]['link']} "
          f"({s['hotspots'][0]['trees']} trees)")

    # --- per-PE configuration excerpt -------------------------------------
    print("\nper-PE configuration (excerpt):")
    for line in placed_assembly(rf).splitlines()[:8]:
        print(f"  {line}")

    # --- ideal vs network-aware simulation --------------------------------
    rng = np.random.default_rng(0)
    x = rng.normal(size=spec.grid_shape)
    ideal = simulate(map_3d(spec, workers=8), x, CGRA)
    routed = simulate(plan, x, CGRA, fabric=rf)
    assert np.array_equal(ideal.output, routed.output)
    assert np.allclose(routed.output, stencil_reference_np(x, spec))
    print(f"\nideal (free wires):  {ideal.cycles} cycles")
    print(f"routed (16x16 mesh): {routed.cycles} cycles "
          f"({routed.cycles / ideal.cycles:.2f}x, "
          f"{routed.fabric['token_hops']} token-hops, "
          f"{routed.fabric['stall_cycles']} link stalls)")
    print("outputs bit-identical; oracle check passed")


def lint_plans():
    """Static-verifier hook
    (``python -m repro_torch.analysis.lint examples/*_torch.py``)."""
    plan = map_3d(heat_3d(8, 10, 12, dtype="float64"), workers=4)
    yield plan
    yield plan, route(place(plan, FabricTopology.mesh(16, 16), seed=0))


if __name__ == "__main__":
    main()
