"""Stencil program graphs: compose multi-operator DAGs into one fused
spatial pipeline (docs/program.md), carried over from ``repro.program``
(host numpy; ``program_reference`` is a torch twin of the reference's jnp
one).

    prog = hdiff_program(48, 64)                     # IR: fields + op DAG
    plan = lower(prog, workers=4, auto_capacity=True)  # ONE combined DFG
    rf   = route(place(plan, FabricTopology.mesh(16, 16), seed=0))
    res, fields = simulate_program(plan, {"inp": x}, CGRA, fabric=rf)
    # fields bit-match program_reference_np(prog, {"inp": x})
"""
from repro_torch.program.ir import CombineOp, StencilOp, StencilProgram
from repro_torch.program.library import (hdiff_program, laplacian_2d,
                                         two_stage_heat)
from repro_torch.program.lower import (ProgramPlan, field_leads, lower,
                                       simulate_program)
from repro_torch.program.oracle import program_reference, program_reference_np

__all__ = ["CombineOp", "StencilOp", "StencilProgram", "hdiff_program",
           "laplacian_2d", "two_stage_heat", "ProgramPlan", "field_leads",
           "lower", "simulate_program", "program_reference",
           "program_reference_np"]
