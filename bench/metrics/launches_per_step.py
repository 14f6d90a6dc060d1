"""Kernel launches per time step over the window: the change in the port's
launch counter (repro_torch.kernels._build.LAUNCHES) over the steps done."""
UNIT = "launches/step"


def read(r):
    steps = r.window.calls * r.cell.timesteps
    return r.window.launches / steps if steps and r.window.launches else None
