"""The paper's §VI oil/gas seismic stencil (49-pt, rx=ry=12, 960x449) run
through every layer of the PyTorch port on one host and its card:

  roofline (§VI) -> CGRA mapping (§III-B) -> cycle simulation (§VIII,
  reduced grid) -> the CUDA kernel K3 -> fused-timestep variant (§IV).

The counterpart of ``examples/seismic_stencil2d.py`` (the same specs, seeds
and printed checks), on ``repro_torch``: K3 runs on the card with the
port's shared-memory block planner, and the fused-timestep roofline is the
H100 SXM's.  Without a card it raises; ``--device cpu`` runs K3's plain
PyTorch version instead.

Run:  PYTHONPATH=src python examples/seismic_stencil2d_torch.py [--device cpu]
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import CGRA, H100_SXM, analyze, map_2d, simulate
from repro_torch.core.reference import stencil_reference_np
from repro_torch.core.spec import paper_stencil_2d
from repro_torch.kernels.stencil2d.ops import plan_2d_blocks, stencil2d


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where K3 runs: cuda (the kernel) or cpu (its "
                         "plain version)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    spec = paper_stencil_2d()                       # 960x449, r=12, fp64
    roof = analyze(spec, CGRA)
    print(f"[roofline] AI={roof.arithmetic_intensity:.2f} -> "
          f"{roof.achievable_gflops:.0f} GFLOPS on CGRA (w*={roof.workers}); "
          f"paper: 559 GFLOPS, 5 workers")

    # cycle-accurate simulation at 1/16 grid (utilization is scale-stable)
    small = paper_stencil_2d(ny=113, nx=240, r=12)
    plan = map_2d(small, workers=5)
    x = np.random.default_rng(0).normal(size=small.grid_shape)
    t0 = time.time()
    res = simulate(plan, x, CGRA)
    ok = bool(np.allclose(res.output, stencil_reference_np(x, small)))
    print(f"[simulate] {res.summary()}  exact={ok}  ({time.time()-t0:.1f}s)"
          f"  paper: 77-78% of peak")

    # K3, fp32, with the shared-memory block planner (§III-B Blocking);
    # backend="cuda" insists on the kernel
    spec32 = paper_stencil_2d(dtype="float32")
    blocks = plan_2d_blocks(449, 960, 12, 12, timesteps=1)
    xf = torch.tensor(np.random.default_rng(1).normal(size=(1, 449, 960)),
                      dtype=torch.float32).to(dev)
    backend = "cuda" if dev.type == "cuda" else "auto"
    y = stencil2d(xf, spec32.coeffs[0], spec32.coeffs[1], backend=backend,
                  block=blocks)
    ref = stencil_reference_np(xf[0].cpu().numpy(), spec32)
    err = float(np.abs(y[0].cpu().numpy() - ref).max())
    where = "cuda" if dev.type == "cuda" else "plain version (cpu)"
    print(f"[{where}] blocks={blocks} max err={err:.2e}")

    # fused timesteps: where does the seismic stencil turn compute-bound?
    for t in (1, 2, 4):
        st = dataclasses.replace(spec32, timesteps=t)
        r = analyze(st, H100_SXM)
        print(f"[fusion T={t}] AI={r.arithmetic_intensity:6.2f} -> "
              f"{r.achievable_gflops/1000:6.2f} TFLOPS on H100 SXM "
              f"({r.bound})")
    return {"exact": ok, "cycles": res.cycles, "blocks": list(blocks),
            "max_abs_err": err}


def lint_plans():
    """Static-verifier hook
    (``python -m repro_torch.analysis.lint examples/*_torch.py``)."""
    yield map_2d(paper_stencil_2d(ny=30, nx=48, r=12), workers=8)


if __name__ == "__main__":
    main()
