"""Quickstart on the PyTorch port: the paper's pipeline end to end.

1. define a stencil (spec)            4. roofline-select workers (§VI)
2. map it onto the CGRA (§III)        5. cycle-simulate + validate (§VIII)
3. emit the DFG (dot + assembly, §V)  6. run the CUDA kernel K1 on the card

The counterpart of ``examples/quickstart.py``: the same spec and seed, on
``repro_torch``.  Step 6 launches the hand-written 1D stencil kernel on a
CUDA device and raises without one; ``--device cpu`` runs it through the
kernel's plain PyTorch version instead.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
                                                        [--dot stencil1d.dot]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import CGRA, analyze, map_1d, simulate
from repro_torch.core.reference import stencil_reference_np
from repro_torch.core.spec import StencilSpec
from repro_torch.kernels import stencil1d


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where step 6 runs: cuda (the kernel) or cpu (its "
                         "plain version)")
    ap.add_argument("--dot", default=None,
                    help="write the DFG as a graphviz file here")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    # 1. a 5-pt smoothing stencil on a 6000-point grid
    spec = StencilSpec((6000,), (2,), ((0.1, 0.2, 0.4, 0.2, 0.1),),
                       dtype="float64")

    # 2-4. roofline -> workers -> CGRA mapping
    roof = analyze(spec, CGRA)
    print(f"AI={roof.arithmetic_intensity:.3f} flops/byte; "
          f"achievable {roof.achievable_gflops:.0f} GFLOPS ({roof.bound}-bound); "
          f"w*={roof.workers}")
    plan = map_1d(spec, workers=roof.workers)
    print(f"mapped: {plan.pe_counts}  ({plan.mac_pes} MAC-class PEs)")
    print(plan.dfg.to_assembly().splitlines()[0])

    # 5. simulate and validate against the oracle
    x = np.random.default_rng(0).normal(size=6000)
    res = simulate(plan, x, CGRA)
    ref = stencil_reference_np(x, spec)
    print(f"simulated: {res.summary()}")
    print(f"matches oracle: {np.allclose(res.output, ref)} "
          f"(loads == grid size: {res.loads == 6000})")

    # 6. K1 on the card (backend="cuda" insists on the kernel), or its plain
    #    version on the CPU, fp32
    xf = torch.tensor(x[None], dtype=torch.float32).to(dev)
    backend = "cuda" if dev.type == "cuda" else "auto"
    y = stencil1d(xf, spec.coeffs[0], backend=backend)[0].cpu().numpy()
    where = "cuda kernel" if dev.type == "cuda" else "plain version (cpu)"
    print(f"{where} max err vs simulated: "
          f"{float(np.abs(y - res.output).max())}")
    print(f"{where} max err vs oracle: {float(np.abs(y - ref).max())}")

    if args.dot:
        with open(args.dot, "w") as f:
            f.write(plan.dfg.to_dot())
        print(f"DFG written to {args.dot} (render with graphviz)")


if __name__ == "__main__":
    main()
