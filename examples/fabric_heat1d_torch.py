"""Walkthrough on the PyTorch port: mapping a 1D heat stencil onto the
physical PE fabric.

The counterpart of ``examples/fabric_heat1d.py`` (the same spec, seeds and
checks), on ``repro_torch``.  The full pipeline the paper implies but never
shows end-to-end:

  spec -> map_1d -> place -> route -> per-PE config -> network-aware simulate

A 3-pt heat step is mapped with 4 workers, placed on an 8x8 mesh (memory
ports on the boundary), routed with XY multicast trees, exported as a per-PE
configuration, and simulated twice — with free one-hop wires (ideal) and on
the routed network — to show the on-chip network's real latency cost while
the numerics stay bit-identical.  Host numpy only: nothing runs on a card.

Run:  PYTHONPATH=src python examples/fabric_heat1d_torch.py [--dot FILE]
"""
import argparse

import numpy as np

from repro_torch.core import CGRA, map_1d, simulate
from repro_torch.core.reference import stencil_reference_np
from repro_torch.core.spec import StencilSpec
from repro_torch.fabric import (FabricTopology, place, placed_assembly,
                                placed_dot, route)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dot", default=None,
                    help="write the floorplan as a graphviz file here")
    args = ap.parse_args(argv)

    # 3-pt heat step u[i] += alpha * (u[i-1] - 2u[i] + u[i+1]), n=360
    alpha = 0.1
    spec = StencilSpec((360,), (1,), ((alpha, 1 - 2 * alpha, alpha),),
                       dtype="float64")
    plan = map_1d(spec, workers=4)
    print(f"logical mapping: {len(plan.dfg.nodes)} instructions, "
          f"{sum(1 for _ in plan.dfg.edges())} queues — {plan.notes}")

    # --- physical fabric: 8x8 mesh, memory ports on the boundary ----------
    topo = FabricTopology.mesh(8, 8)
    pl = place(plan, topo, seed=0)
    rf = route(pl)
    s = rf.stats()
    print(f"\nplaced on {topo!r}")
    print(f"  PEs used          {s['pes_used']}/{len(topo.pes)} "
          f"({s['pe_utilization']:.0%})")
    print(f"  hop count         mean={s['hops_mean']} max={s['hops_max']}")
    print(f"  links used        {s['links_used']}/{len(topo.links)} "
          f"({s['link_utilization']:.0%})")
    print(f"  max channel load  {s['max_channel_load']}/"
          f"{s['channel_capacity']}")
    print(f"  busiest link      {s['hotspots'][0]['link']} "
          f"({s['hotspots'][0]['trees']} trees)")

    # --- per-PE configuration (first worker's pipeline) -------------------
    print("\nper-PE configuration (excerpt):")
    for line in placed_assembly(rf).splitlines()[:10]:
        print(f"  {line}")

    # --- ideal vs network-aware simulation --------------------------------
    rng = np.random.default_rng(0)
    x = rng.normal(size=360)
    ideal = simulate(map_1d(spec, workers=4), x, CGRA)
    routed = simulate(plan, x, CGRA, fabric=rf)
    assert np.array_equal(ideal.output, routed.output)
    assert np.allclose(routed.output, stencil_reference_np(x, spec))
    print(f"\nideal (free wires):  {ideal.cycles} cycles")
    print(f"routed (8x8 mesh):   {routed.cycles} cycles "
          f"({routed.cycles / ideal.cycles:.2f}x, "
          f"{routed.fabric['token_hops']} token-hops, "
          f"{routed.fabric['stall_cycles']} link stalls)")
    print("outputs bit-identical; oracle check passed")

    if args.dot:
        with open(args.dot, "w") as f:
            f.write(placed_dot(rf))
        print(f"\nfloorplan dot written to {args.dot} (render: neato -Tpng)")


def lint_plans():
    """Static-verifier hook
    (``python -m repro_torch.analysis.lint examples/*_torch.py``)."""
    alpha = 0.1
    spec = StencilSpec((360,), (1,), ((alpha, 1 - 2 * alpha, alpha),),
                       dtype="float64")
    plan = map_1d(spec, workers=4)
    yield plan                                     # ideal wires
    yield plan, route(place(plan, FabricTopology.mesh(8, 8), seed=0))


if __name__ == "__main__":
    main()
