"""The port stands alone and never falls back: importing it loads no jax and
nothing of ``repro``; a kernel that cannot run raises instead of quietly
running its plain version.  CPU only; no jax needed."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import _build, stencil1d, stencil2d, stencil3d
from repro_torch.kernels.stencil1d.kernel import stencil1d_kernel
from repro_torch.kernels.stencil1d.ops import plan_1d_blocks
from repro_torch.kernels.stencil2d.kernel import stencil2d_kernel
from repro_torch.kernels.stencil2d.ops import plan_2d_blocks
from repro_torch.kernels.stencil3d.kernel import stencil3d_kernel

SRC = Path(__file__).resolve().parents[1] / "src"
C1 = (0.25, 0.5, 0.25)
CY, CX = (0.1, 0.6, 0.1), (0.1, 0.0, 0.1)


def test_import_loads_no_jax_and_no_repro():
    code = ("import json, sys, repro_torch, repro_torch.core, repro_torch.kernels;"
            "print(json.dumps(sorted(m for m in sys.modules"
            " if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))))")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_sources_import_no_jax_and_no_repro():
    root = SRC.parent
    paths = sorted((SRC / "repro_torch").rglob("*.py"))
    paths += [root / "chip_smoke.py", root / "tests" / "test_torch_cuda.py"]
    for path in paths:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                root = words[1].split(".")[0]
                assert root not in ("jax", "jaxlib", "repro"), (path, line)


@pytest.mark.parametrize("op,args", [
    (stencil1d, (torch.zeros(2, 64), C1)),
    (stencil2d, (torch.zeros(1, 16, 16), CY, CX)),
    (stencil3d, (torch.zeros(1, 8, 8, 8), CY, CX, CX)),
])
def test_cuda_backend_on_cpu_tensor_raises(op, args):
    with pytest.raises(ValueError, match="CUDA tensor"):
        op(*args, backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        op(*args, backend="pallas")


@pytest.mark.parametrize("wrapper,args,kw", [
    (stencil1d_kernel, (torch.zeros(2, 64, dtype=torch.float64), C1), {}),
    (stencil2d_kernel, (torch.zeros(1, 16, 16, dtype=torch.float64), CY, CX), {}),
    (stencil3d_kernel, (torch.zeros(1, 8, 8, 8, dtype=torch.float64), CY, CX, CX),
     {"block": (8, 8, 8)}),
])
def test_float64_into_a_kernel_wrapper_raises(wrapper, args, kw):
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        wrapper(*args, **kw)


def test_cpu_wrappers_run_the_plain_version_and_count_nothing():
    before = dict(_build.LAUNCHES)
    x = torch.randn(2, 64)
    y = stencil1d_kernel(x, C1, timesteps=2)
    assert y.shape == x.shape and torch.isfinite(y).all()
    assert dict(_build.LAUNCHES) == before


def test_unknown_variant_raises():
    with pytest.raises(ValueError, match="variant"):
        stencil1d(torch.zeros(2, 64), C1, variant="tensor")


def test_missing_nvcc_raises_clearly(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_library_paths_are_keyed_by_source():
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert names == ["stencil1d", "stencil2d", "stencil3d"]
    paths = {_build._lib_path(n) for n in names}
    assert len(paths) == 3
    assert all(p.parent == _build.BUILD_DIR for p in paths)


@pytest.mark.parametrize("ny,nx,r,t,want", [
    (449, 960, 12, 1, (32, 128)),     # the paper's seismic stencil
    (449, 960, 12, 4, (32, 128)),     # ... fused 4 steps: ~208 KB of 227 KB
    (64, 128, 1, 1, (32, 128)),
    (40, 48, 3, 1, (32, 64)),
])
def test_plan_2d_blocks_fits_the_h100(ny, nx, r, t, want):
    from repro_torch.kernels.stencil2d.kernel import smem_bytes
    by, bx = plan_2d_blocks(ny, nx, r, r, t)
    assert (by, bx) == want
    assert smem_bytes(r, r, t, by, bx) <= _build.H100_SMEM_PER_BLOCK


def test_plan_2d_blocks_refuses_what_cannot_fit():
    with pytest.raises(ValueError, match="shared memory"):
        plan_2d_blocks(4096, 4096, 12, 12, 40)


@pytest.mark.parametrize("variant", ["vpu", "mxu"])
def test_plan_1d_blocks(variant):
    from repro_torch.kernels.stencil1d.kernel import smem_bytes
    assert plan_1d_blocks(194400, 1, 8, 1, variant) == (1, 1024)
    bb, bn = plan_1d_blocks(194400, 1024, 8, 4, variant)
    assert (bb, bn) == (4, 1024)
    assert smem_bytes(variant, 8, 4, bb, bn) <= _build.H100_SMEM_PER_BLOCK
    assert plan_1d_blocks(200, 3, 1, 3, variant) == (3, 256)
    with pytest.raises(ValueError, match="shared memory"):
        plan_1d_blocks(10 ** 7, 1, 8, 4000, variant)
