"""Physical fabric subsystem: PE-grid topology, placement, routing, export.

Pipeline (docs/fabric.md):

    plan  = map_1d(spec, workers=w)                  # logical DFG (core)
    topo  = FabricTopology.mesh(16, 16)              # physical PE grid
    pl    = place(plan, topo, seed=0)                # DFG node -> PE
    rf    = route(pl)                                # edge -> XY circuit
    res   = simulate(plan, x, CGRA, fabric=rf)       # network-aware timing
"""
from repro_torch.fabric.topology import (Coord, FabricTopology, Link, LinkKey, PE,
                                         op_class)
from repro_torch.fabric.place import Placement, PlacementError, edge_traffic, place
from repro_torch.fabric.route import (EdgeKey, RoutedFabric, RouteError,
                                      apply_routed_capacities, edge_key, route,
                                      xy_route)
from repro_torch.fabric.config import placed_assembly, placed_dot, route_string

__all__ = ["Coord", "FabricTopology", "Link", "LinkKey", "PE", "op_class",
           "Placement", "PlacementError", "edge_traffic", "place",
           "EdgeKey", "RoutedFabric", "RouteError", "apply_routed_capacities",
           "edge_key", "route", "xy_route", "placed_assembly", "placed_dot",
           "route_string"]
