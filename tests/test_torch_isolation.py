"""The port stands alone and never falls back: importing it loads no jax and
nothing of ``repro``; a kernel that cannot run raises instead of quietly
running its plain version.  CPU only; no jax needed."""
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import list_archs
from repro_torch.kernels import (_build, causal_conv1d,
                                 sliding_window_attention, stencil1d,
                                 stencil2d, stencil3d)
from repro_torch.kernels.conv1d.kernel import conv1d_kernel
from repro_torch.kernels.stencil1d.kernel import stencil1d_kernel
from repro_torch.kernels.stencil1d.ops import plan_1d_blocks
from repro_torch.kernels.stencil2d.kernel import stencil2d_kernel
from repro_torch.kernels.stencil2d.ops import plan_2d_blocks
from repro_torch.kernels.stencil3d.kernel import stencil3d_kernel
from repro_torch.kernels.swa.kernel import swa_kernel
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.registry import build_model, input_arrays
from repro_torch.models.transformer import LM

SRC = Path(__file__).resolve().parents[1] / "src"
C1 = (0.25, 0.5, 0.25)
CY, CX = (0.1, 0.6, 0.1), (0.1, 0.0, 0.1)


def test_import_loads_no_jax_and_no_repro():
    """Every module of the port, the LM path's entry points named first."""
    code = ("import importlib, json, pkgutil, sys, repro_torch;"
            "import repro_torch.core, repro_torch.kernels, repro_torch.models,"
            " repro_torch.serving, repro_torch.launch.serve,"
            " repro_torch.configs, repro_torch.core.simulator,"
            " repro_torch.fabric, repro_torch.analysis,"
            " repro_torch.telemetry, repro_torch.program,"
            " repro_torch.explore, repro_torch.core.engine.cuda_engine,"
            " repro_torch.kernels.simbatch.kernel, repro_torch.train.optim,"
            " repro_torch.train.train_step, repro_torch.data.pipeline,"
            " repro_torch.checkpoint.manager,"
            " repro_torch.distributed.collectives, repro_torch.launch.train;"
            "[importlib.import_module(m.name) for m in pkgutil.walk_packages("
            "repro_torch.__path__, 'repro_torch.')];"
            "print(json.dumps(sorted(m for m in sys.modules"
            " if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))));"
            "print(json.dumps(sorted(m for m in sys.modules"
            " if m.startswith('repro_torch.'))))")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    foreign, loaded = (json.loads(line)
                       for line in out.stdout.strip().splitlines()[-2:])
    assert foreign == []
    # the walk reached the CGRA model's modules
    for mod in ("core.roofline", "core.temporal", "core.dfg",
                "core.mapping.nd", "core.engine.vector", "core.simulator",
                "fabric.route", "analysis.static_verify",
                "telemetry.attribution", "core.engine.cuda_engine",
                "kernels.simbatch.kernel", "kernels.simbatch.ref",
                "program.lower", "program.oracle", "explore.search",
                "explore.space", "telemetry.metrics", "telemetry.report",
                "telemetry.trace", "analysis.lint", "testing.minihyp",
                "models.rwkv6", "models.encdec", "models.mlp",
                "models.registry", "configs.whisper_tiny",
                "configs.granite_moe_3b_a800m", "configs.qwen2_vl_2b",
                "train.optim", "train.train_step", "data.pipeline",
                "checkpoint.manager", "distributed.collectives",
                "launch.train", "distributed.halo", "distributed.sharding",
                "launch.mesh"):
        assert f"repro_torch.{mod}" in loaded


def test_sources_import_no_jax_and_no_repro():
    root = SRC.parent
    paths = sorted((SRC / "repro_torch").rglob("*.py"))
    paths += [root / "chip_smoke.py", root / "tests" / "test_torch_cuda.py",
              root / "tests" / "test_torch_cgra_model.py",
              root / "tests" / "test_torch_engine_batch.py",
              root / "tests" / "test_torch_property.py",
              root / "tests" / "test_torch_distributed.py",
              root / "tests" / "torch_distributed_cases.py"]
    paths += sorted((root / "examples").glob("*_torch.py"))
    assert len([p for p in paths if p.parent.name == "examples"]) == 7
    paths += sorted((root / "scripts").glob("*.py"))
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
    (causal_conv1d, (torch.zeros(1, 8, 4), torch.zeros(4, 4))),
    (sliding_window_attention, (torch.zeros(1, 2, 8, 16),
                                torch.zeros(1, 1, 8, 16),
                                torch.zeros(1, 1, 8, 16))),
])
def test_cuda_backend_on_cpu_tensor_raises(op, args):
    kw = {"window": 4} if op is sliding_window_attention else {}
    with pytest.raises(ValueError, match="CUDA tensor"):
        op(*args, backend="cuda", **kw)
    with pytest.raises(ValueError, match="unknown backend"):
        op(*args, backend="pallas", **kw)


@pytest.mark.parametrize("wrapper,args,kw", [
    (stencil1d_kernel, (torch.zeros(2, 64, dtype=torch.float64), C1), {}),
    (stencil2d_kernel, (torch.zeros(1, 16, 16, dtype=torch.float64), CY, CX), {}),
    (stencil3d_kernel, (torch.zeros(1, 8, 8, 8, dtype=torch.float64), CY, CX, CX),
     {"block": (8, 8, 8)}),
    (conv1d_kernel, (torch.zeros(1, 8, 4, dtype=torch.float64),
                     torch.zeros(4, 4, dtype=torch.float64)), {}),
    (swa_kernel, (torch.zeros(1, 2, 8, 16, dtype=torch.float64),
                  torch.zeros(1, 1, 8, 16, dtype=torch.float64),
                  torch.zeros(1, 1, 8, 16, dtype=torch.float64)),
     {"window": 4}),
    (causal_conv1d, (torch.zeros(1, 8, 4, dtype=torch.float64),
                     torch.zeros(4, 4, dtype=torch.float64)), {}),
    (sliding_window_attention, (torch.zeros(1, 2, 8, 16, dtype=torch.float64),
                                torch.zeros(1, 1, 8, 16, dtype=torch.float64),
                                torch.zeros(1, 1, 8, 16, dtype=torch.float64)),
     {"window": 4}),
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


def test_lm_wrappers_check_shapes_and_taps():
    with pytest.raises(ValueError, match="taps"):
        conv1d_kernel(torch.zeros(1, 8, 4), torch.zeros(4, 5))
    with pytest.raises(ValueError, match="Hq % Hkv"):
        swa_kernel(torch.zeros(1, 3, 8, 16), torch.zeros(1, 2, 8, 16),
                   torch.zeros(1, 2, 8, 16), window=4)
    with pytest.raises(ValueError, match="window"):
        swa_kernel(torch.zeros(1, 2, 8, 16), torch.zeros(1, 1, 8, 16),
                   torch.zeros(1, 1, 8, 16), window=0)


def test_swa_smem_fits_the_h100_at_head_dim_256():
    """bf16: Q (128 rows) and two stages of K and V (64 rows each) of 256
    bf16, and 1024 B of alignment; f32: Q (64 rows) and two stages of K
    and V (32 rows each) of 256 f32, the 8 warps' P fragments and their
    rows' tile max."""
    from repro_torch.kernels.swa.kernel import smem_bytes
    assert smem_bytes(256) == 2 * (128 + 4 * 64) * 256 + 1024 == 197_632
    assert smem_bytes(256, torch.bfloat16) == 197_632 <= _build.H100_SMEM_PER_BLOCK
    assert smem_bytes(256, torch.float32) == 213_504 <= _build.H100_SMEM_PER_BLOCK


def test_train_modules_import_no_jax_and_no_repro():
    """The training slice's modules on their own, in a fresh interpreter."""
    code = ("import json, sys, repro_torch.train.optim,"
            " repro_torch.train.train_step, repro_torch.data.pipeline,"
            " repro_torch.checkpoint.manager,"
            " repro_torch.distributed.collectives, repro_torch.launch.train;"
            "print(json.dumps(sorted(m for m in sys.modules"
            " if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'ml_dtypes'))))")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_train_cli_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    """launch.train runs on the card by default and raises without one;
    nothing falls back to the CPU."""
    from repro_torch.launch import train
    assert train.parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        train.main(["--reduced", "--steps", "1"])
    code = ("import torch, repro_torch.launch.train as t;"
            "torch.cuda.is_available = lambda: False;"
            "t.main(['--reduced', '--steps', '1'])")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "no CUDA device" in out.stderr


def test_swa_backward_launchers_refuse_cpu_tensors():
    """swa_bwd_dq and swa_bwd_dkdv launch kernels only; the wrapper with a
    plain version for CPU tensors is swa_bwd_kernel."""
    from repro_torch.kernels.swa.kernel import (swa_bwd_dkdv, swa_bwd_dq,
                                                swa_bwd_kernel)
    q, kv = torch.zeros(1, 2, 8, 16), torch.zeros(1, 1, 8, 16)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        swa_bwd_dq(q, kv, kv, q, q, window=4)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        swa_bwd_dkdv(q, kv, kv, q, lse, lse, window=4)
    assert [g.shape for g in swa_bwd_kernel(q, kv, kv, q, q, window=4)] == \
        [q.shape, kv.shape, kv.shape]
    assert dict(_build.LAUNCHES) == before


def test_lm_ops_differentiate_through_their_autograd_functions():
    """K5's and K6's ops are autograd Functions whose backward runs the
    kernels on CUDA tensors; on CPU tensors they take gradients through the
    plain versions (nothing refuses a tensor that requires grad)."""
    from repro_torch.kernels.conv1d.ops import CausalConv1d
    from repro_torch.kernels.swa.ops import SlidingWindowAttention
    x = torch.randn(1, 8, 4, requires_grad=True)
    y = causal_conv1d(x, torch.randn(4, 4))
    assert y.grad_fn.name() == CausalConv1d.__name__ + "Backward"
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    kv = torch.randn(1, 1, 8, 16)
    out = sliding_window_attention(q, kv, kv, window=4)
    assert out.grad_fn.name() == SlidingWindowAttention.__name__ + "Backward"
    before = dict(_build.LAUNCHES)
    (out.sum() + y.sum()).backward()
    assert x.grad.shape == x.shape and q.grad.shape == q.shape
    assert dict(_build.LAUNCHES) == before
    assert not hasattr(_build, "check_no_grad")


def test_serve_cli_needs_a_gpu_unless_asked_for_the_cpu():
    code = ("import torch, repro_torch.launch.serve as s;"
            "torch.cuda.is_available = lambda: False;"
            "s.main(['--reduced'])")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "no CUDA device" in out.stderr


@pytest.mark.parametrize("arch", list_archs())
def test_serve_cli_needs_a_gpu_for_every_arch(monkeypatch, arch):
    """Every family's entry point runs on the card by default and raises
    without one; nothing falls back to the CPU."""
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        serve.main(["--reduced", "--arch", arch])


def test_model_entry_points_default_to_the_card():
    for fn in (build_model, input_arrays, LM, EncDecLM):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_serve_cli_refuses_the_audio_family(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--reduced", "--device", "cpu",
                       "--arch", "whisper-tiny"]) == 1
    assert "decoder-only" in capsys.readouterr().out


def test_unknown_variant_raises():
    with pytest.raises(ValueError, match="variant"):
        stencil1d(torch.zeros(2, 64), C1, variant="tensor")


def test_missing_nvcc_raises_clearly(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def _fake_nvcc(monkeypatch, tmp_path, body: str) -> Path:
    """A shell script in place of ``nvcc`` and a build directory of its own.
    In ``body``, ``$out`` is the ``-o`` path (the library's temp file) and
    ``$LOG`` the log beside the library, which a concurrent build of the
    same source would write."""
    script = tmp_path / "nvcc"
    script.write_text(
        "#!/bin/sh\n"
        'out=""\n'
        'while [ $# -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; shift; done\n'
        'LOG="${out%.*.tmp}.log"\n' + body)
    script.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(script))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "build").mkdir()
    return tmp_path / "build"


def test_failed_build_raises_with_its_own_output(monkeypatch, tmp_path):
    """The error quotes this build's nvcc output, although another build of
    the same source rewrote the log beside the library meanwhile, and
    leaves no temp file behind."""
    build_dir = _fake_nvcc(monkeypatch, tmp_path, (
        'echo "error: fake failure in $$"\n'
        'echo "another process\'s log" > "$LOG"\n'
        'exit 2\n'))
    lib = _build._lib_path("conv1d")
    with pytest.raises(RuntimeError, match="exit 2") as err:
        _build.build("conv1d")
    assert "error: fake failure in" in str(err.value)
    assert "another process's log" not in str(err.value)
    assert not lib.exists()
    assert [p.name for p in build_dir.iterdir()] == [
        lib.with_suffix(".log").name]


def test_good_build_moves_library_and_log_into_place(monkeypatch, tmp_path):
    """Each process writes nvcc's output to a log of its own (named by pid,
    like the library's temp file) and a good build moves both beside each
    other: the log in place is this build's, whatever another build wrote
    there meanwhile, and another process's temp log is left alone."""
    build_dir = _fake_nvcc(monkeypatch, tmp_path, (
        'echo "ptxas info    : Used 42 registers, pid $$"\n'
        'echo "another process\'s log" > "$LOG"\n'
        'echo library > "$out"\n'))
    other = _build._lib_path("swa").with_suffix(".1.log.tmp")
    other.write_text("a build in process 1")
    _build.build("conv1d", "swa")
    names = sorted(p.name for p in build_dir.iterdir())
    want = sorted([other.name] + [_build._lib_path(n).with_suffix(s).name
                                  for n in ("conv1d", "swa")
                                  for s in (".so", ".log")])
    assert names == want
    assert _build._lib_path("conv1d").read_text() == "library\n"
    log = _build.build_log("conv1d")
    assert "Used 42 registers" in log and "another process" not in log
    assert other.read_text() == "a build in process 1"


def test_library_paths_are_keyed_by_source():
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert names == ["conv1d", "simbatch", "stencil1d", "stencil2d",
                     "stencil3d", "swa", "swa_bwd"]
    paths = {_build._lib_path(n) for n in names}
    assert len(paths) == 7
    assert all(p.parent == _build.BUILD_DIR for p in paths)


@pytest.mark.parametrize("ny,nx,r,t,want", [
    (449, 960, 12, 1, (128, 128)),    # the paper's seismic stencil: 97,280 B
    (449, 960, 12, 4, (16, 128)),     # ... fused 4 steps: 230,400 of 232,448 B
    (64, 128, 1, 1, (64, 128)),
    (40, 48, 3, 1, (64, 64)),
])
def test_plan_2d_blocks_fits_the_h100(ny, nx, r, t, want):
    from repro_torch.kernels.stencil2d.kernel import smem_bytes
    by, bx = plan_2d_blocks(ny, nx, r, r, t)
    assert (by, bx) == want
    assert smem_bytes(r, r, t, by, bx) <= _build.H100_SMEM_PER_BLOCK


def test_plan_2d_blocks_refuses_what_cannot_fit():
    with pytest.raises(ValueError, match="shared memory"):
        plan_2d_blocks(4096, 4096, 12, 12, 40)


@pytest.mark.parametrize("variant,one_row,fused", [
    # vpu: up to 4 rows by up to 2048 columns, two blocks an SM
    ("vpu", (1, 2048), (4, 1024)),
    # mxu: 16 rows (an mma's) by up to 512 columns, two blocks an SM
    ("mxu", (1, 512), (16, 256)),
])
def test_plan_1d_blocks(variant, one_row, fused):
    from repro_torch.kernels.stencil1d.kernel import smem_bytes
    assert plan_1d_blocks(194400, 1, 8, 1, variant) == one_row
    bb, bn = plan_1d_blocks(194400, 1024, 8, 4, variant)
    assert (bb, bn) == fused
    assert smem_bytes(variant, 8, 4, bb, bn) <= _build.H100_SMEM_PER_BLOCK
    assert plan_1d_blocks(200, 3, 1, 3, variant) == (3, 256)
    with pytest.raises(ValueError, match="shared memory"):
        plan_1d_blocks(10 ** 7, 1, 8, 4000, variant)


def test_library_paths_cover_the_shared_header(monkeypatch, tmp_path):
    """An edit to csrc/common.cuh rebuilds every kernel."""
    for p in _build.CSRC.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._lib_path("swa")
    with open(tmp_path / "common.cuh", "a") as fh:
        fh.write("// edited\n")
    assert _build._lib_path("swa") != before


@pytest.mark.parametrize("header", ["common.cuh", "wgmma.cuh", "tf32.cuh"])
def test_library_paths_cover_every_header(monkeypatch, tmp_path, header):
    """An edit to any shared header in csrc/ changes the library path of
    every source, so no stale library is loaded after it."""
    assert header in {p.name for p in _build.CSRC.glob("*.cuh")}
    for p in _build.CSRC.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    names = sorted(p.stem for p in tmp_path.glob("*.cu"))
    before = {n: _build._lib_path(n) for n in names}
    with open(tmp_path / header, "a") as fh:
        fh.write("// edited\n")
    assert all(_build._lib_path(n) != before[n] for n in names)


def test_chip_smoke_lm_limits_refuse_a_wrong_kernel():
    """chip_smoke.py's K5/K6 limits pass the bf16 rounding of the op and
    refuse a lost key tile and outputs 5% off, which the 3e-2 absolute
    limit alone lets through where |out| is small."""
    sys.path.insert(0, str(SRC.parent))
    import chip_smoke
    from repro_torch.kernels.conv1d.ref import conv1d_ref
    from repro_torch.kernels.swa.ops import swa_plain
    g = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    q, k, v = (torch.randn(shape, generator=g).to(bf) for shape in
               ((1, 4, 1024, 64), (1, 1, 1024, 64), (1, 1, 1024, 64)))
    want = swa_plain(q, k, v, window=512)
    assert chip_smoke.lm_error("swa", bf, want.clone(), want)[0]
    v_lost = v.clone()
    v_lost[:, :, 480:512] = 0                   # one 32-key tile lost
    assert not chip_smoke.lm_error("swa", bf,
                                   swa_plain(q, k, v_lost, window=512),
                                   want)[0]
    off = (want.float()[:, :, 600:] * 1.05).to(bf)  # past the early queries
    good, err, rel = chip_smoke.lm_error("swa", bf, off, want[:, :, 600:])
    assert not good and err < 3e-2 and rel > 1e-2
    x, w, b = (torch.randn(shape, generator=g).to(bf)
               for shape in ((2, 300, 64), (4, 64), (64,)))
    assert chip_smoke.lm_error("conv1d", bf, causal_conv1d(x, w, b),
                               conv1d_ref(x, w, b))[0]


def test_chip_smoke_grad_limits_refuse_a_wrong_gradient():
    """chip_smoke.py's GRAD_TOL passes the bf16 rounding of K6's and K5's
    gradients and a gradient that is 0 by the algebra (window 1: dq = 0),
    and refuses one 5% off, one with a key's gradient lost and a
    non-finite one."""
    sys.path.insert(0, str(SRC.parent))
    import chip_smoke
    from repro_torch.kernels.conv1d.ref import conv1d_bwd_ref
    from repro_torch.kernels.swa.ref import swa_bwd_ref
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(shape, generator=g) for shape in
                   ((1, 4, 300, 32), (1, 1, 300, 32), (1, 1, 300, 32),
                    (1, 4, 300, 32)))
    want = swa_bwd_ref(q, k, v, do, window=64)
    bf = [w.to(torch.bfloat16) for w in swa_bwd_ref(
        *(t.to(torch.bfloat16) for t in (q, k, v)), do.to(torch.bfloat16),
        window=64)]
    for got, w in zip(bf, want):
        assert chip_smoke.grad_error("swa", torch.bfloat16, got,
                                     w.to(torch.bfloat16),
                                     do.to(torch.bfloat16))[0]
    dq1 = swa_bwd_ref(q, k, v, do, window=1)[0]
    assert chip_smoke.grad_error("swa", torch.float32, dq1 + 1e-7, dq1,
                                 do)[0]
    assert not chip_smoke.grad_error("swa", torch.float32, want[0] * 1.05,
                                     want[0], do)[0]
    lost = want[1].clone()
    lost[:, :, 100] = 0
    assert not chip_smoke.grad_error("swa", torch.float32, lost, want[1],
                                     do)[0]
    nan = want[2].clone()
    nan[0, 0, 0, 0] = float("nan")
    assert not chip_smoke.grad_error("swa", torch.float32, nan, want[2],
                                     do)[0]
    x, w, b, dy = (torch.randn(shape, generator=g) for shape in
                   ((2, 300, 64), (4, 64), (64,), (2, 300, 64)))
    for got in conv1d_bwd_ref(x, w, b, dy):
        assert chip_smoke.grad_error("conv1d", torch.float32, got, got, dy)[0]
        assert not chip_smoke.grad_error("conv1d", torch.float32, got * 1.05,
                                         got, dy)[0]


@pytest.mark.parametrize("arch", list_archs())
def test_chip_smoke_decode_error_holds_every_family_on_the_cpu(arch):
    """chip_smoke.py's ``families`` check at each reduced config: decode
    token by token against the forward (vlm with M-RoPE positions, audio
    with the cross K/V primed) within 5e-4; a decode without its cache
    fails it."""
    sys.path.insert(0, str(SRC.parent))
    import chip_smoke
    from repro_torch.configs import ShapeSpec, get_reduced_config
    cfg = get_reduced_config(arch)
    model = build_model(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    inp = input_arrays(cfg, ShapeSpec("smoke", 8, 2, "prefill"), seed=1,
                       device="cpu")
    err = chip_smoke.decode_error(model, cfg, inp["tokens"], inp.get("frames"))
    assert err < chip_smoke.DECODE_TOL
    # a decode that forgets its cache every token fails the check
    decode = model.decode
    model.decode = lambda cache, toks, **kw: decode(model.init_cache(2, 8),
                                                    toks, **kw)
    assert chip_smoke.decode_error(model, cfg, inp["tokens"],
                                   inp.get("frames")) > chip_smoke.DECODE_TOL


def _heat_items(n=2):
    import numpy as np
    from repro_torch.core import map_2d
    from repro_torch.core.spec import heat_2d
    spec = heat_2d(10, 20, dtype="float64")
    x = np.random.default_rng(0).normal(size=spec.grid_shape)
    return [(map_2d(spec, workers=2), x) for _ in range(n)]


def test_cuda_engine_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    """simulate_batch, simulate(engine="cuda") and the tuner's batched stage
    1 default to the card and raise without one; nothing runs the plain
    version unless the caller passes device="cpu"."""
    from repro_torch.core import CGRA, simulate
    from repro_torch.core.simulator import simulate_batch
    from repro_torch.explore import Budget, SpaceOptions, explore
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        simulate_batch(_heat_items(), CGRA)
    (plan, x), = _heat_items(1)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        simulate(plan, x, CGRA, engine="cuda")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        explore(plan.spec, CGRA, options=SpaceOptions(workers=(2,),
                                                      fabrics=()),
                budget=Budget(batch_size=4))
    got = simulate_batch(_heat_items(), CGRA, device="cpu")
    assert [r.cycles for r in got] == [
        simulate(p, x, CGRA, engine="vector").cycles for p, x in _heat_items()]


def test_failed_k7_build_raises(monkeypatch, tmp_path):
    """A K7 build that fails raises with nvcc's output from the build and
    from the barrier-only instance's loader; nothing falls back."""
    from repro_torch.kernels.simbatch import kernel as k7
    _fake_nvcc(monkeypatch, tmp_path, 'echo "error: no sm_90a"\nexit 1\n')
    monkeypatch.setattr(_build, "_libs", {})
    before = dict(_build.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc failed on simbatch.cu"):
        _build.build("simbatch")
    with pytest.raises(RuntimeError, match="error: no sm_90a"):
        k7.barrier_ms(64, 10, "cuda")
    assert dict(_build.LAUNCHES) == before
