"""Host-side planning of the K1, K2, K3, K4 and K6 kernels, and the
arithmetic of the K2 and K6 tensor-core paths, on the CPU (no jax, no card).

- K1's shared memory (its taps, two raw tiles and the output tile in the
  grid's type, two f32 sweep buffers for T > 1) and the tiles
  ``plan_1d_blocks`` picks for it; the instance that runs a set of taps
  and the compacted taps the generic instance sums.
- K2's shared memory (the split band, two raw tiles and the output tile in
  the grid's type, two f32 sweep buffers for T > 1) and the tiles
  ``plan_1d_blocks`` picks for it, against the H100's opt-in 232,448 B per block; an emulation of its
  3xTF32 split (``cvt.rna`` to TF32, the small products summed apart) held
  to the f32 limit of 2e-5 over fused sweeps, which plain TF32 misses.

- Shared memory of K6 (bf16 tensor-core and f32 layouts; its backward's
  bf16 and f32 layouts) and of K3 (one buffer at T = 1, two with margins for fused
  sweeps) against the H100's opt-in 232,448 B per block; the parts K6's
  backward splits a group's heads into, and its fold of their partial
  sums.
- The compacted tap list K3 takes: ascending order kept, zero taps dropped,
  laid out as ``struct Taps`` of ``csrc/stencil2d.cu``.
- K4's ring of haloed planes against the same limit, its block rule, the
  tiles that ``DEFAULT_BLOCK``, ``fit_block`` and ``_auto_block`` give, the
  instance that runs a set of taps, and its tap struct (``struct Taps`` of
  ``csrc/stencil3d.cu``).
- K5's launch plan: the vector instance for K <= 4 at whole 16-byte rows
  and aligned tensors, the generic one otherwise, and the run, threads and
  rows in flight for the model's shape and the edge cases; a torch
  emulation of K5's bf16 double rounding (sum cast to bf16, bias added in
  f32, cast again) held to ``chip_smoke.py``'s limits.  K5's backward:
  its plan (instance, run, rows in flight, threads; the workspace under 5%
  of x and dy; more runs than a grid's y extent) and an emulation of its
  order of operations, with fmaf's exact bits, held to ``GRAD_TOL``, its
  dx bit for bit K5 on the time-reversed gradient (the card's tests hold
  the kernel's bits to this emulation).
- K7's planner: the ``ITEMS`` instance and threads of the paper's 2D
  stage-1 lanes (w = 1-5 and 16) and the heat2d sweep's, and an instance
  for every lane whose state fitted one block's shared memory when K7 kept
  every node's and edge's state there.
- A torch emulation of where K6's bf16 path rounds (bf16 products summed in
  f32, the scale on the f32 scores, an online softmax over 64-key tiles, P
  rounded to bf16 before an f32 P·V) held to ``chip_smoke.py``'s limits
  against the plain version, so the design fits the limits before any run
  on the card; and one of K6's bf16 backward (bf16 products summed in f32,
  P and dS rounded to bf16 before dV, dK and dQ) held to its ``GRAD_TOL``
  against the vector-Jacobian product of the plain version; and one of
  K6's f32 backward (every product in 3xTF32) held to the f32
  ``GRAD_TOL``, which one TF32 product a product misses.
"""
import math
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, sliding_window_attention
from repro_torch.kernels.conv1d import kernel as k5
from repro_torch.kernels.conv1d.ref import conv1d_bwd_ref, conv1d_ref
from repro_torch.kernels.stencil1d import kernel as k2
from repro_torch.kernels.stencil1d.ops import plan_1d_blocks
from repro_torch.kernels.stencil1d.ref import stencil1d_ref
from repro_torch.kernels.stencil2d import kernel as k3
from repro_torch.kernels.stencil2d.ops import plan_2d_blocks
from repro_torch.kernels.stencil3d import kernel as k4
from repro_torch.kernels.stencil3d.ops import (DEFAULT_BLOCK, _auto_block,
                                               fit_block)
from repro_torch.kernels.swa import kernel as k6
from repro_torch.kernels.swa.ops import swa_plain
from repro_torch.kernels.swa.ref import (swa_bwd_fold_ref, swa_bwd_ref,
                                        swa_ref)

ROOT = Path(__file__).resolve().parents[1]
LIMIT = _build.H100_SMEM_PER_BLOCK


@pytest.mark.parametrize("r,t,itemsize,bb,bn,want", [
    # the paper's r = 8 at the planned (16, 512): K = 24; two raw tiles of
    # 544 columns loaded for 528 needed, rows of 548 words (16 B past a
    # multiple of 128); the output tile, rows of 520 words (32 B past)
    (8, 1, 4, 16, 512, 4 * (2 * 32 + 16 * (2 * 548 + 520))),        # 103,680
    (8, 1, 2, 16, 512, 4 * (2 * 32 + 16 * (2 * 292 + 260))),        # 54,272
    # T = 4: and two f32 sweep buffers of 356 / 612 floats a row
    (8, 4, 4, 16, 256, 4 * (2 * 32 + 16 * (2 * 356 + 264 + 2 * 356))),
    (8, 4, 4, 16, 512, 4 * (2 * 32 + 16 * (2 * 612 + 520 + 2 * 612))),
    # block_b rounds up to 16 rows; r = 13 is generic (K = 40)
    (13, 1, 4, 3, 128, 4 * (2 * 48 + 16 * (2 * 196 + 136))),
    (2, 2, 2, 9, 128, 4 * (2 * 24 + 16 * (2 * 100 + 68 + 2 * 164))),
])
def test_stencil1d_mxu_smem(r, t, itemsize, bb, bn, want):
    got = k2.smem_bytes("mxu", r, t, bb, bn, itemsize)
    assert got == want <= LIMIT


@pytest.mark.parametrize("n", [77, 200, 5003, 194400])
@pytest.mark.parametrize("batch", [1, 7, 16, 1024])
@pytest.mark.parametrize("r,t", [(1, 1), (8, 1), (8, 4), (13, 2), (4, 40)])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_plan_1d_blocks_mxu_fits(n, batch, r, t, itemsize):
    """K2's tile: at most 16 rows (all of a short batch), a power of two
    from 128 to 512 columns, no wider than the row needs, within one
    block's budget, and two blocks an SM where a 128-column tile allows
    it."""
    bb, bn = plan_1d_blocks(n, batch, r, t, "mxu", itemsize=itemsize)
    assert bb == min(batch, 16)
    assert bn in (128, 256, 512) and (bn == 128 or bn < 2 * n)
    smem = k2.smem_bytes("mxu", r, t, bb, bn, itemsize)
    assert smem <= LIMIT
    half = (LIMIT - 1024) // 2
    if k2.smem_bytes("mxu", r, t, bb, 128, itemsize) <= half:
        assert smem <= half
        assert (bn == 512 or bn >= n
                or k2.smem_bytes("mxu", r, t, bb, 2 * bn, itemsize) > half)


def test_plan_1d_blocks_mxu_deployment_tile():
    """(1024, 194400) at r = 8, T = 1: 16 x 512 in both types, two blocks
    an SM by shared memory in f32 and four in bf16; the tile reads
    (512 + 16) / 512 of its outputs."""
    for itemsize, blocks in ((4, 2), (2, 4)):
        assert plan_1d_blocks(194400, 1024, 8, 1, "mxu",
                              itemsize=itemsize) == (16, 512)
        smem = k2.smem_bytes("mxu", 8, 1, 16, 512, itemsize)
        assert blocks * (smem + 1024) <= LIMIT + 1024


@pytest.mark.parametrize("r,t,itemsize,bb,bn,want", [
    # the paper's r = 8 at the planned (4, 2048): 17 tap pairs in 144 B; two
    # raw tiles of 2064 columns, rows of 2084 words (16 B past a multiple of
    # 128); the output tile, rows of 2056 words (32 B past)
    (8, 1, 4, 4, 2048, 144 + 4 * 4 * (2 * 2084 + 2056)),            # 99,728
    (8, 1, 2, 4, 2048, 144 + 4 * 4 * (2 * 1060 + 1028)),            # 50,512
    # T = 4 at the planned (4, 1024): the halo 32, and two f32 sweep
    # buffers of 1092 floats a row
    (8, 4, 4, 4, 1024, 144 + 4 * 4 * (2 * 1092 + 1032 + 2 * 1092)),
    # r = 13 (generic): the halo rounds up to 16 columns, 27 pairs in 224 B
    (13, 1, 4, 3, 128, 224 + 4 * 3 * (2 * 164 + 136)),
    # one row of odd width: 88 columns loaded for 8 + 77 + 3
    (1, 3, 2, 1, 77, 32 + 4 * (2 * 68 + 68 + 2 * 100)),
])
def test_stencil1d_vpu_smem(r, t, itemsize, bb, bn, want):
    got = k2.smem_bytes("vpu", r, t, bb, bn, itemsize)
    assert got == want <= LIMIT


@pytest.mark.parametrize("n", [77, 200, 5003, 194400])
@pytest.mark.parametrize("batch", [1, 7, 16, 1024])
@pytest.mark.parametrize("r,t", [(1, 1), (8, 1), (8, 4), (13, 2), (4, 40)])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_plan_1d_blocks_vpu_fits(n, batch, r, t, itemsize):
    """K1's tile: at most 4 rows (all of a short batch, one row for a batch
    of one), a power of two from 128 to 2048 columns, no wider than the row
    needs, within one block's budget, and two blocks an SM where a
    128-column tile allows it."""
    bb, bn = plan_1d_blocks(n, batch, r, t, "vpu", itemsize=itemsize)
    assert bb == min(batch, 4)
    assert bn in (128, 256, 512, 1024, 2048) and (bn == 128 or bn < 2 * n)
    smem = k2.smem_bytes("vpu", r, t, bb, bn, itemsize)
    assert smem <= LIMIT
    half = (LIMIT - 1024) // 2
    if k2.smem_bytes("vpu", r, t, bb, 128, itemsize) <= half:
        assert smem <= half
        assert (bn == 2048 or bn >= n
                or k2.smem_bytes("vpu", r, t, bb, 2 * bn, itemsize) > half)


def test_plan_1d_blocks_vpu_deployment_tile():
    """(1024, 194400) at r = 8, T = 1: 4 x 2048 in both types, two blocks
    an SM by shared memory in f32 and four in bf16; the tile reads
    (2048 + 16) / 2048 of its outputs; the paper's batch of one gets a
    one-row tile."""
    for itemsize, blocks in ((4, 2), (2, 4)):
        assert plan_1d_blocks(194400, 1024, 8, 1, "vpu",
                              itemsize=itemsize) == (4, 2048)
        smem = k2.smem_bytes("vpu", 8, 1, 4, 2048, itemsize)
        assert blocks * (smem + 1024) <= LIMIT + 1024
        assert plan_1d_blocks(194400, 1, 8, 1, "vpu",
                              itemsize=itemsize) == (1, 2048)


_PAPER_1D = tuple(float(c) for c in np.linspace(0.02, 0.1, 17))


@pytest.mark.parametrize("coeffs,want", [
    (_PAPER_1D, 8),                                    # all 17 non-zero
    (_PAPER_1D[:4] + (0.0,) + _PAPER_1D[5:], 0),       # one zero tap
    (_PAPER_1D[:8] + (-0.0,) + _PAPER_1D[9:], 0),      # a negative zero
    (_PAPER_1D[:16] + (1e-50,), 0),                    # zero in float32
    (tuple(float(c) for c in np.linspace(0.01, 0.1, 27)), 0),   # r = 13
    ((0.25, 0.5, 0.25), 0),                            # r = 1
    (tuple(float(c) for c in np.linspace(0.1, 0.5, 9)), 0),     # r = 4
])
def test_stencil1d_vpu_instance(coeffs, want):
    """The compile-time instance runs r = 8 with every tap non-zero as the
    kernel gets them (float32); a zero tap or any other radius runs the
    generic one."""
    assert k2.instance(coeffs) == want


@pytest.mark.parametrize("coeffs,offsets", [
    ((0.1, 0.0, -0.5, 0.0, 0.2), [0, 2, 4]),
    ((0.0, 0.0, 1.5), [2]),
    ((0.0, 0.0, 0.0), []),
    (_PAPER_1D, list(range(17))),
])
def test_stencil1d_vpu_pack_taps(coeffs, offsets):
    """K1's compacted taps: zero taps dropped, each kept tap's offset and
    float32 value as int32 pairs, in ascending order."""
    packed = k2.pack_taps(coeffs)
    assert packed.dtype == np.int32 and packed.shape == (len(offsets), 2)
    assert packed[:, 0].tolist() == offsets
    np.testing.assert_array_equal(
        packed[:, 1].copy().view(np.float32),
        np.asarray([coeffs[k] for k in offsets], dtype=np.float32))


def _tf32(v: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero."""
    b = v.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def emulate_k2(x: torch.Tensor, coeffs, timesteps: int,
               split: bool = True) -> torch.Tensor:
    """K2's arithmetic in torch (a test helper, never on the main path):
    each sweep's input and the taps split into TF32 parts, x_hi·c_hi summed
    apart from x_lo·c_hi + x_hi·c_lo, the two added, in f32; ``split=False``
    is plain TF32 (x_hi·c_hi alone)."""
    r = (len(coeffs) - 1) // 2
    n = x.shape[-1]
    c = torch.tensor(coeffs, dtype=torch.float32)
    ch = _tf32(c)
    cl = _tf32(c - ch)
    idx = torch.arange(n)
    out = x.float()
    for t in range(1, timesteps + 1):
        xh = _tf32(out)
        xl = _tf32(out - xh)
        ph, pl = (torch.nn.functional.pad(v, (r, r)) for v in (xh, xl))
        big = torch.zeros_like(out)
        small = torch.zeros_like(out)
        for k in range(2 * r + 1):
            big = big + ch[k] * ph[..., k:k + n]
            if split:
                small = small + ch[k] * pl[..., k:k + n] + cl[k] * ph[..., k:k + n]
        valid = (idx >= r * t) & (idx < n - r * t)
        out = torch.where(valid, big + small, 0.0)
    return out.to(x.dtype)


@pytest.mark.parametrize("b,n,r,t,shrinks", [
    # the card tests' 40 fused sweeps: taps of norm 1/3 shrink the values to
    # ~1e-14, so there plain TF32 passes too
    (2, 3000, 4, 40, True), (4, 4096, 8, 4, False), (3, 2000, 13, 2, False)])
def test_k2_split_keeps_the_f32_limit(b, n, r, t, shrinks):
    """3xTF32 holds 2e-5 against the plain version, over fused sweeps and
    at the paper's taps; plain TF32 does not where the values keep their
    size."""
    rng = np.random.default_rng(r)
    if r == 8:
        from repro_torch.core import paper_stencil_1d
        coeffs = paper_stencil_1d(dtype="float32").coeffs[0]
    else:
        coeffs = tuple((rng.normal(size=2 * r + 1) / (2 * r + 1)).tolist())
    x = torch.from_numpy(rng.normal(size=(b, n)).astype(np.float32))
    want = stencil1d_ref(x, coeffs, t)
    err = (emulate_k2(x, coeffs, t) - want).abs().max().item()
    assert err <= 2e-5, err
    plain = (emulate_k2(x, coeffs, t, split=False) - want).abs().max().item()
    assert shrinks or (plain > 2e-5 and plain > 20 * err), (plain, err)


@pytest.mark.parametrize("d,want", [(256, 197_632), (18, 50_176),
                                    (40, 50_176), (64, 50_176),
                                    (65, 99_328), (128, 99_328)])
def test_swa_tensor_core_smem(d, want):
    """2 B x (128 Q rows + 2 stages x 64 K + 64 V rows) x (D zero-filled to
    64, 128 or 256), and 1024 B to align the swizzled tiles."""
    dp = 64 if d <= 64 else 128 if d <= 128 else 256
    assert k6.smem_bytes(d, torch.bfloat16) == 2 * 384 * dp + 1024 == want
    assert want <= LIMIT


SWA_F32_SMEM = {1: 66_048, 18: 66_048, 40: 66_048, 64: 66_048,
                65: 115_200, 128: 115_200, 256: 213_504}


@pytest.mark.parametrize("d", [1, 18, 40, 64, 65, 128, 256])
def test_swa_f32_smem_fits(d):
    """swa.cu's f32_smem: 4 B x (64 Q rows + 2 stages x (32 K + 32 V rows))
    x (D zero-filled to 64, 128 or 256), then the 8 warps' P fragments (2
    k-steps x 8 u32 x 32 lanes) and each warp's 16 rows' tile max."""
    dp = 64 if d <= 64 else 128 if d <= 128 else 256
    got = k6.smem_bytes(d, torch.float32)
    assert got == 4 * dp * (64 + 4 * 32) + 4 * 8 * (512 + 16) \
        == SWA_F32_SMEM[d]
    assert (k6.F32_BLOCK_Q, k6.F32_BLOCK_K, k6.F32_WARPS) == (64, 32, 8)
    assert got <= LIMIT


@pytest.mark.parametrize("d,want", [(32, (58_880, 67_584)),
                                    (40, (58_880, 67_584)),
                                    (64, (58_880, 67_584)),
                                    (128, (116_224, 116_736)),
                                    (256, (230_912, 215_040))])
def test_swa_bwd_tensor_core_smem_fits(d, want):
    """K6's bf16 backward (swa_bwd.cu's dq_smem and dkdv_smem; D
    zero-filled to Dp = 64, 128 or 256): dq 2 B x (128 Q + 128 dO + 2 x 64 K
    + 64 V rows) x Dp, the rows' f32 D and 1024 B to align the swizzled
    tiles; dkdv 2 B x (64 K + 64 V + 2 stages x (64 Q + 64 dO) rows) x Dp,
    two stages of 64 f32 LSE and D, the 64 x 64 f32 Pᵀ and 1024 B."""
    got = k6.bwd_smem_bytes(d, torch.bfloat16)
    dp = 64 if d <= 64 else 128 if d <= 128 else 256
    assert got["swa_bwd_dq"] == 2 * dp * 448 + 4 * 128 + 1024 == want[0]
    assert got["swa_bwd_dkdv"] == (2 * dp * 384 + 4 * 4 * 64 + 4 * 64 * 64
                                   + 1024) == want[1]
    assert max(want) <= LIMIT


@pytest.mark.parametrize("d,want", [(18, (66_816, 53_504)),
                                    (40, (66_816, 53_504)),
                                    (64, (66_816, 53_504)),
                                    (128, (115_968, 102_656)),
                                    (256, (214_272, 200_960))])
def test_swa_bwd_f32_smem_fits(d, want):
    """K6's f32 backward (swa_bwd.cu's f32_dq_smem and f32_dkdv_smem; f32
    tiles, D zero-filled to Dp = 64, 128 or 256): dq 4 B x (64 Q + 64 dO +
    2 x 32 key rows) x Dp, the 8 warps' dS fragments (512 u32 each), the
    64 rows' D and the 8 warps' (max, sum) of 16 rows; dkdv 4 B x (64 K +
    64 V + 2 stages x (16 Q + 16 dO) rows) x Dp, two stages of 16 LSE and
    D, and the 4 warps' Pᵀ fragments (256 f32 each)."""
    got = k6.bwd_smem_bytes(d, torch.float32)
    dp = 64 if d <= 64 else 128 if d <= 128 else 256
    assert got["swa_bwd_dq"] == 4 * dp * 192 + 4 * (8 * 512 + 64 + 256) \
        == want[0]
    assert got["swa_bwd_dkdv"] == 4 * dp * 192 + 4 * (64 + 1024) == want[1]
    assert max(want) <= LIMIT


@pytest.mark.parametrize("b,hkv,s,group,want", [
    (1, 1, 4096, 10, 2),        # the model's: 64 key tiles, 128 blocks
    (1, 1, 4097, 10, 2),
    (2, 1, 4096, 10, 1),        # 128 key tiles already
    (1, 1, 65, 10, 10),         # two key tiles: every head a part
    (1, 2, 300, 3, 3),
    (1, 1, 8192, 3, 1),
])
def test_swa_bwd_parts_fill_the_card(b, hkv, s, group, want):
    """swa_bwd_dkdv splits a group's heads into the most parts that keep
    its blocks within 132, at least 1 and at most the group, from the
    shapes alone."""
    parts = k6.bwd_parts(b, hkv, s, group)
    assert parts == want
    blocks = b * hkv * -(-s // 64)
    assert parts == 1 or blocks * parts <= k6.PARTS_BLOCKS


def test_swa_bwd_f32_fold_sums_the_parts_in_order():
    """f32 partial sums fold to f32 (swa_bwd_dkdv writes bwd_parts partial
    sums in both types): the parts added in order, no cast."""
    g = torch.Generator().manual_seed(4)
    part = torch.randn(2, 2, 1, 1, 70, 256, generator=g)
    k = torch.empty(1, 1, 70, 256)
    dk, dv = k6.swa_bwd_fold(part, k, k)
    assert dk.dtype == dv.dtype == torch.float32
    assert torch.equal(dk, part[0, 0] + part[0, 1])
    assert torch.equal(dv, part[1, 0] + part[1, 1])
    assert k6.bwd_parts(1, 1, 4096, 10) == 2       # the model's, bf16


@pytest.mark.parametrize("b,hkv,s,group,want", [
    (1, 1, 4096, 10, 6),        # the model's: 64 key tiles, 384 blocks
    (2, 1, 4096, 10, 3),
    (1, 1, 65, 10, 10),         # every head a part, at most the group
    (1, 2, 300, 3, 3),
    (1, 1, 8192, 3, 3),
    (4, 8, 4096, 1, 1),
])
def test_swa_bwd_f32_parts_even_out_the_bands(b, hkv, s, group, want):
    """In f32 swa_bwd_dkdv splits a group's (head, query tile) steps into
    the most parts that keep its blocks within 3 x 132 (F32_PARTS_WAVES
    waves of the H100's SMs), from the shapes alone: the key tiles' bands
    differ in length, and more, shorter blocks even out the SMs' shares."""
    parts = k6.bwd_parts(b, hkv, s, group, torch.float32)
    assert parts == want
    blocks = b * hkv * -(-s // 64)
    assert parts == 1 or blocks * parts <= k6.F32_PARTS_WAVES * k6.PARTS_BLOCKS


def test_swa_bwd_fold_sums_the_parts_in_order():
    """On a CPU tensor the fold runs its plain version: the parts added in
    order, one f32 addition at a time, then one cast to bf16."""
    g = torch.Generator().manual_seed(3)
    part = torch.randn(2, 3, 1, 2, 70, 40, generator=g) * 100
    k = torch.empty(1, 2, 70, 40, dtype=torch.bfloat16)
    dk, dv = k6.swa_bwd_fold(part, k, k)
    for got, plane in ((dk, part[0]), (dv, part[1])):
        assert got.dtype == torch.bfloat16 and got.shape == k.shape
        assert torch.equal(got, (plane[0] + plane[1] + plane[2]).to(
            torch.bfloat16))
    assert all(torch.equal(a, b) for a, b in zip(
        (dk, dv), swa_bwd_fold_ref(part, torch.bfloat16)))
    with pytest.raises(ValueError, match="partial sums"):
        k6.swa_bwd_fold(part[:, :, :, :1], k, k)


@pytest.mark.parametrize("ry,rx,t,by,bx,want", [
    (12, 12, 1, 128, 128, 4 * 152 * 160),             # 97,280: 2 blocks an SM
    (12, 12, 4, 16, 128, 4 * 2 * 120 * 240),          # 230,400
    (1, 1, 1, 64, 128, 4 * 66 * 144),
    (3, 1, 2, 8, 32, 4 * 2 * (8 + 12 + 8) * (32 + 2 * (8 + 8))),
])
def test_stencil2d_smem(ry, rx, t, by, bx, want):
    """T = 1: one buffer of (by + 2ry) rows x (bx + 2·pad8(rx)) columns;
    T > 1: two, each with 8 margin columns a side and 8 rows below."""
    assert k3.smem_bytes(ry, rx, t, by, bx) == want


@pytest.mark.parametrize("ny,nx,r,t", [(449, 960, 12, 1), (449, 960, 12, 4),
                                       (113, 240, 12, 4), (4096, 4096, 1, 1),
                                       (300, 517, 2, 3), (16, 8, 1, 1)])
def test_plan_2d_blocks_tiles(ny, nx, r, t):
    """Tiles are multiples of 8 (the kernel's chunks and micro-tiles), no
    larger than 128 x 128, fit the H100, and cannot double in y without
    leaving the budget or outgrowing the grid."""
    by, bx = plan_2d_blocks(ny, nx, r, r, t)
    assert by % 8 == 0 and bx % 8 == 0 and by <= 128 and bx <= 128
    assert k3.smem_bytes(r, r, t, by, bx) <= LIMIT
    assert (by >= min(ny, 128)
            or k3.smem_bytes(r, r, t, 2 * by, bx) > LIMIT)


def test_plan_2d_blocks_cuts_the_halo_share():
    """At the paper's r = 12, T = 1 the 128 x 128 tile reads 1.48x its
    outputs, against 2.08x at a 32 x 128 tile."""
    by, bx = plan_2d_blocks(449, 960, 12, 12, 1)
    assert (by, bx) == (128, 128)
    assert (by + 24) * (bx + 32) / (by * bx) == pytest.approx(1.484, abs=1e-3)
    assert (32 + 24) * (128 + 24) / (32 * 128) == pytest.approx(2.078, abs=1e-3)


@pytest.mark.parametrize("coeffs,offsets,values", [
    ((0.1, 0.0, 0.5, 0.0, 0.2), [0, 2, 4], [0.1, 0.5, 0.2]),
    ((0.0, 0.0, 0.0), [], []),
    ((-0.25, 1.0, -0.25), [0, 1, 2], [-0.25, 1.0, -0.25]),
    ((0.0, 3.0, 0.0, 0.0, 0.0, -1.0, 0.0), [1, 5], [3.0, -1.0]),
])
def test_compact_taps_keeps_order_and_drops_zeros(coeffs, offsets, values):
    got_o, got_v = k3.compact_taps(coeffs)
    assert got_o == offsets and got_v == values
    assert all(a < b for a, b in zip(got_o, got_o[1:]))


def test_pack_taps_lays_out_struct_taps():
    """ny, nx, oy[128], ox[128], cy[128], cx[128] (compacted), then the
    dense dy[128], dx[128]: the field order of csrc/stencil2d.cu."""
    rng = np.random.default_rng(3)
    cy = rng.normal(size=25)
    cx = rng.normal(size=25)
    cy[7] = cx[12] = cx[20] = 0.0
    buf = k3.pack_taps(tuple(cy.tolist()), tuple(cx.tolist()))
    n = k3.MAX_TAPS
    assert buf.dtype == np.int32 and buf.size == 2 + 6 * n
    f = buf.view(np.float32)
    assert (buf[0], buf[1]) == (24, 23)
    assert buf[2:2 + 24].tolist() == [k for k in range(25) if k != 7]
    assert buf[2 + n:2 + n + 23].tolist() == [k for k in range(25)
                                              if k not in (12, 20)]
    np.testing.assert_array_equal(f[2 + 2 * n:2 + 2 * n + 24],
                                  cy[cy != 0].astype(np.float32))
    np.testing.assert_array_equal(f[2 + 3 * n:2 + 3 * n + 23],
                                  cx[cx != 0].astype(np.float32))
    np.testing.assert_array_equal(f[2 + 4 * n:2 + 4 * n + 25],
                                  cy.astype(np.float32))
    np.testing.assert_array_equal(f[2 + 5 * n:2 + 5 * n + 25],
                                  cx.astype(np.float32))
    assert not buf[2 + 24:2 + n].any() and not f[2 + 4 * n + 25:2 + 5 * n].any()
    assert not f[2 + 5 * n + 25:].any()


def test_pack_taps_refuses_more_than_the_struct_holds():
    with pytest.raises(ValueError, match="taps per axis"):
        k3.pack_taps((0.1,) * 129, (0.1,) * 3)


@pytest.mark.parametrize("r,itemsize,by,bx,queued,want", [
    # the (2, 2, 2) instance at the default block: 2 + 1 + 2 slots of
    # 36 x 136 f32 (two blocks an SM) or of 36 x 144 bf16
    ((2, 2, 2), 4, 32, 128, True, 5 * 36 * 136 * 4),        # 97,920
    ((2, 2, 2), 2, 32, 128, True, 5 * 36 * 144 * 2),        # 51,840
    ((1, 1, 1), 4, 32, 128, True, 4 * 34 * 136 * 4),        # 73,984
    ((1, 1, 1), 2, 32, 128, True, 4 * 34 * 144 * 2),        # 39,168
    # the generic instance keeps all 2rz + 1 planes of the z taps, also at
    # r = 2 for taps off the star pattern
    ((2, 2, 2), 4, 32, 128, False, 7 * 36 * 136 * 4),       # 137,088
    ((2, 1, 3), 4, 32, 128, False, 7 * 34 * 136 * 4),       # 129,472
    ((3, 3, 3), 2, 32, 128, False, 9 * 38 * 144 * 2),       # 98,496
    ((4, 4, 4), 4, 16, 128, False, 11 * 24 * 136 * 4),      # 143,616
    ((2, 2, 2), 4, 16, 64, True, 5 * 20 * 72 * 4),
])
def test_stencil3d_smem(r, itemsize, by, bx, queued, want):
    """Ring slots x (by + 2ry) rows x (bx + 2px) columns in the grid's type,
    px being rx rounded up to one 16-byte chunk."""
    assert k4.smem_bytes(*r, by, bx, itemsize, queued) == want <= LIMIT


@pytest.mark.parametrize("rz,queued", [(1, True), (2, True), (3, False),
                                       (2, False), (1, False), (0, False)])
def test_stencil3d_ring_slots(rz, queued):
    """The compile-time instances hold the planes still to be centres; the
    generic one every plane of the z taps; both the planes in flight."""
    held = rz if queued else 2 * rz
    assert k4.ring_slots(rz, queued) == held + 1 + k4.AHEAD


def _star(r: int, cz: float = 0.1) -> tuple[tuple[float, ...], ...]:
    """The taps of ``star_3d``'s pattern at radius ``r``: the y and x centres
    zero, every other tap non-zero."""
    side = tuple(0.0 if k == r else 0.1 for k in range(2 * r + 1))
    return (cz,) * (2 * r + 1), side, side


@pytest.mark.parametrize("taps,want", [
    (_star(1), 1), (_star(2), 2), (_star(3), 0),
    # a non-zero y or x centre, a zero z tap or another zero tap: generic
    (((0.1,) * 5,) * 3, 0),
    ((_star(2)[0], (0.1, 0.0, 0.0, 0.0, 0.1), _star(2)[2]), 0),
    (((0.1, 0.0, 0.1, 0.1, 0.1),) + _star(2)[1:], 0),
    # unequal radii
    ((_star(2)[0], _star(1)[1], _star(2)[2]), 0),
    # a z tap that is zero only in float32, as the kernel gets it
    (_star(1, 1e-50), 0),
])
def test_stencil3d_instance(taps, want):
    """Only the star pattern at radius 1 or 2 runs a compile-time instance,
    which sums its taps without a zero test."""
    assert k4.instance(*taps) == want


def test_stencil3d_default_block():
    """The default tile is legal, fits both instances and the generic one at
    r = 2 in both types, reads at most 1.35x the grid at r = 2 (f32) and
    gives 512^3 about four waves of two blocks on each of the H100's 132
    SMs."""
    k4.check_block(DEFAULT_BLOCK)
    bz, by, bx = DEFAULT_BLOCK
    for r in k4.INSTANCES:
        for itemsize in (4, 2):
            for queued in (True, False):
                assert fit_block(DEFAULT_BLOCK, (r,) * 3, itemsize, LIMIT,
                                 queued) == DEFAULT_BLOCK
    assert 2 * k4.smem_bytes(2, 2, 2, by, bx, 4, True) <= LIMIT
    reads = (bz + 4) * (by + 4) * (bx + 8) / (bz * by * bx)
    assert reads == pytest.approx(1.345, abs=1e-3)
    blocks = (512 // bz) * (512 // by) * (512 // bx)
    assert blocks == 1024 and blocks >= 2 * 2 * 132


@pytest.mark.parametrize("block", [(5, 3, 32), (4, 8, 12), (0, 8, 32),
                                   (4, 64, 128), (4, 0, 8), (4, 4, 4)])
def test_stencil3d_refuses_illegal_blocks(block):
    with pytest.raises(ValueError, match="must be"):
        k4.check_block(block)


@pytest.mark.parametrize("block", [(1, 4, 8), (5, 4, 32), (8, 16, 128),
                                   (64, 32, 128), (7, 4, 1024), (3, 64, 64)])
def test_stencil3d_takes_legal_blocks(block):
    k4.check_block(block)


@pytest.mark.parametrize("shape", [(512, 512, 512), (64, 64, 256),
                                   (37, 19, 70), (3, 20, 64), (16, 16, 8)])
@pytest.mark.parametrize("r", [(1, 1, 1), (2, 2, 2), (2, 1, 3), (5, 5, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("budget", [LIMIT, 60_000, 20_000])
@pytest.mark.parametrize("star", [False, True])
def test_stencil3d_auto_block_is_legal_and_fits(shape, r, dtype, budget,
                                                star):
    """``_auto_block`` gives only tiles the kernel takes, within the budget
    of the instance that runs the taps, also where the planner shrinks
    toward (1, 1, 1) under a tight budget or the grid is no wider than its
    halo; it refuses only where not even a 4 x 8 column tile fits."""
    cs = [tuple(0.0 if star and a and j == k else 0.1
                for j in range(2 * k + 1)) for a, k in enumerate(r)]
    queued = k4.instance(*cs) > 0
    assert queued == (star and r in ((1, 1, 1), (2, 2, 2)))
    itemsize = 4 if dtype == "float32" else 2
    if k4.smem_bytes(*r, 4, 8, itemsize, queued) > budget:
        with pytest.raises(ValueError, match="shared memory"):
            _auto_block(shape, *cs, dtype, budget)
        return
    block = _auto_block(shape, *cs, dtype, budget)
    k4.check_block(block)
    assert k4.smem_bytes(*r, *block[1:], itemsize, queued) <= budget


@pytest.mark.parametrize("r,itemsize,want", [
    ((4, 4, 4), 4, (32, 16, 128)), ((8, 8, 8), 4, (32, 4, 128)),
    ((8, 8, 8), 2, (32, 16, 128)), ((31, 1, 1), 4, (32, 4, 128)),
])
def test_fit_block_halves_the_default_for_wide_halos(r, itemsize, want):
    assert fit_block(DEFAULT_BLOCK, r, itemsize, LIMIT) == want
    assert k4.smem_bytes(*r, *want[1:], itemsize) <= LIMIT


def test_fit_block_refuses_what_cannot_fit():
    with pytest.raises(ValueError, match="4 x 8 column tile"):
        fit_block(DEFAULT_BLOCK, (30, 30, 30), 4, LIMIT)


def test_stencil3d_pack_taps_lays_out_struct_taps():
    """nz, ny, nx, oz/oy/ox[64] (compacted, ascending), cz/cy/cx[64], then
    the dense dz/dy/dx[64]: the field order of csrc/stencil3d.cu."""
    rng = np.random.default_rng(5)
    cz, cy, cx = rng.normal(size=7), rng.normal(size=3), rng.normal(size=9)
    cz[0] = cz[4] = cy[1] = cx[4] = cx[8] = 0.0
    buf = k4.pack_taps(*(tuple(c.tolist()) for c in (cz, cy, cx)))
    n = k4.MAX_TAPS
    assert buf.dtype == np.int32 and buf.size == 3 + 9 * n
    f = buf.view(np.float32)
    assert buf[:3].tolist() == [5, 2, 7]
    for axis, c in enumerate((cz, cy, cx)):
        keep = np.flatnonzero(c)
        o = 3 + axis * n
        v = 3 + (3 + axis) * n
        d = 3 + (6 + axis) * n
        assert buf[o:o + len(keep)].tolist() == keep.tolist()
        assert not buf[o + len(keep):o + n].any()
        np.testing.assert_array_equal(f[v:v + len(keep)],
                                      c[keep].astype(np.float32))
        assert not f[v + len(keep):v + n].any()
        np.testing.assert_array_equal(f[d:d + len(c)], c.astype(np.float32))
        assert not f[d + len(c):d + n].any()


def test_stencil3d_pack_taps_refuses_radius_past_31():
    k4.pack_taps((0.1,) * 63, (0.1,) * 3, (0.1,) * 3)
    with pytest.raises(ValueError, match="radius <= 31"):
        k4.pack_taps((0.1,) * 3, (0.1,) * 65, (0.1,) * 3)


def emulate_k6_bf16(q, k, v, *, window: int, tile: int = 64):
    """K6's bf16 arithmetic in torch (a test helper, never on the main
    path): q·k of bf16 values summed in f32, times 1/sqrt(D) in f32, masked
    to -1e30, an online softmax over 64-key tiles in f32, the probabilities
    rounded to bf16 against the running max, then P·V summed in f32; l sums
    the unrounded probabilities and is floored at 1e-30."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    qf = q.float()
    kf = k.repeat_interleave(group, dim=1).float()
    vf = v.repeat_interleave(group, dim=1).float()
    scale = 1.0 / math.sqrt(d)
    m = torch.full((b, hq, s, 1), -1e30)
    l = torch.zeros((b, hq, s, 1))
    acc = torch.zeros((b, hq, s, d))
    i = torch.arange(s)[:, None]
    for k0 in range(0, s, tile):
        j = torch.arange(k0, min(k0 + tile, s))[None, :]
        sc = (qf @ kf[:, :, k0:k0 + tile].transpose(-1, -2)) * scale
        mask = (j <= i) & (j > i - window)
        sc = torch.where(mask, sc, torch.tensor(-1e30))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.where(mask, torch.exp(sc - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).float() @ vf[:, :, k0:k0 + tile]
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def test_k6_bf16_rounding_fits_chip_smoke_limits():
    """D = 256, window 512, S = 1100, GQA 2:1: the emulated kernel within
    chip_smoke.py's bf16 limits of the plain version (3e-2 elementwise,
    1e-2 norm-relative)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    rng = np.random.default_rng(0)
    bf = torch.bfloat16
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(bf)
               for shape in ((1, 2, 1100, 256), (1, 1, 1100, 256),
                             (1, 1, 1100, 256)))
    want = swa_plain(q, k, v, window=512)
    got = emulate_k6_bf16(q, k, v, window=512)
    good, err, rel = chip_smoke.lm_error("swa", bf, got, want)
    assert good, (err, rel)
    assert err <= chip_smoke.LM_TOL["swa"][bf][0]
    assert rel <= chip_smoke.REL_TOL[("swa", bf)]
    # the rounding of P is visible: the emulation is not the plain version
    assert err > 0


def emulate_k6_bwd_bf16(q, k, v, dout, *, window: int):
    """K6's bf16 backward arithmetic in torch (a test helper, never on the
    main path): products of bf16 values summed in f32; the rows' LSE of the
    f32 scores (scale in f32); P = exp(S - LSE) and dS = P (dP - D) in f32,
    D = rowsum(dO * O) with O the bf16 forward output
    (:func:`emulate_k6_bf16`); P and dS rounded to bf16 before dV = Pᵀ dO,
    dK = scale dSᵀ Q and dQ = scale dS K, each summed in f32 (dK and dV
    over the group's heads) and cast to bf16 once."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    bf = torch.bfloat16
    qf, gf = q.float(), dout.float()
    kf = k.repeat_interleave(group, dim=1).float()
    vf = v.repeat_interleave(group, dim=1).float()
    scale = 1.0 / math.sqrt(d)
    i = torch.arange(s)[:, None]
    j = torch.arange(s)[None, :]
    mask = (j <= i) & (j > i - window)
    sc = ((qf @ kf.transpose(-1, -2)) * scale).masked_fill(~mask, -math.inf)
    p = torch.exp(sc - torch.logsumexp(sc, -1, keepdim=True))
    o = emulate_k6_bf16(q, k, v, window=window).float()
    delta = (gf * o).sum(-1, keepdim=True)
    ds = p * (gf @ vf.transpose(-1, -2) - delta)
    pb, dsb = p.to(bf).float(), ds.to(bf).float()
    dq = (dsb @ kf) * scale
    dk = ((dsb.transpose(-1, -2) @ qf) * scale).view(b, hkv, group, s, d)
    dv = (pb.transpose(-1, -2) @ gf).view(b, hkv, group, s, d)
    return dq.to(bf), dk.sum(2).to(bf), dv.sum(2).to(bf)


def test_k6_bwd_bf16_rounding_fits_grad_tol():
    """D = 256, GQA 4:1, S = 600, window 256: the emulated bf16 backward
    within chip_smoke.py's GRAD_TOL of the vector-Jacobian product of the
    plain version (swa_bwd_ref), and the rounding of P and dS visible."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    rng = np.random.default_rng(1)
    bf = torch.bfloat16
    q, k, v, dout = (
        torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(bf)
        for shape in ((1, 4, 600, 256), (1, 1, 600, 256), (1, 1, 600, 256),
                      (1, 4, 600, 256)))
    got = emulate_k6_bwd_bf16(q, k, v, dout, window=256)
    want = swa_bwd_ref(q, k, v, dout, window=256)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == bf
        good, err, rel = chip_smoke.grad_error("swa", bf, g, w, dout)
        assert good, (name, err, rel)
        # the rounding of P and dS is visible: not the plain version
        assert err > 0, name


def _tf32_rz(v: torch.Tensor) -> torch.Tensor:
    """An f32 value as the tensor cores read a TF32 operand: its top 19
    bits (10 mantissa bits, truncated)."""
    return (v.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm3(a: torch.Tensor, b: torch.Tensor, split: bool = True
         ) -> torch.Tensor:
    """a @ b as swa_bwd.cu's mma.sync computes it in 3xTF32: both operands
    split (``split``: hi = rna(x), ``_tf32``; lo = x - hi, exact, read by
    the tensor cores as ``_tf32_rz``), then a_lo·b_hi + a_hi·b_lo +
    a_hi·b_hi, the products exact, summed in f32; ``split=False``: one TF32
    product, a_hi·b_hi."""
    ah, bh = _tf32(a), _tf32(b)
    out = ah @ bh
    if split:
        out = (_tf32_rz(a - ah) @ bh + ah @ _tf32_rz(b - bh)) + out
    return out


def emulate_k6_bwd_f32(q, k, v, dout, *, window: int, split: bool = True):
    """K6's f32 backward arithmetic in torch (a test helper, never on the
    main path): S = Q Kᵀ and dP = dO Vᵀ in 3xTF32 (``_mm3``), the rows'
    LSE of S times the scale, P = exp(S scale - LSE) and dS = P (dP - D) in
    f32 with D = rowsum(dO * O), O the plain f32 forward; dQ = scale dS K,
    dK = scale dSᵀ Q and dV = Pᵀ dO in 3xTF32, dK and dV summed over the
    group's heads.  ``split=False``: every product one TF32 product."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    kf = k.repeat_interleave(group, dim=1)
    vf = v.repeat_interleave(group, dim=1)
    scale = 1.0 / math.sqrt(d)
    i = torch.arange(s)[:, None]
    j = torch.arange(s)[None, :]
    mask = (j <= i) & (j > i - window)
    sc = (_mm3(q, kf.transpose(-1, -2), split) * scale).masked_fill(
        ~mask, -math.inf)
    p = torch.exp(sc - torch.logsumexp(sc, -1, keepdim=True))
    delta = (dout * swa_plain(q, k, v, window=window)).sum(-1, keepdim=True)
    ds = p * (_mm3(dout, vf.transpose(-1, -2), split) - delta)
    dq = _mm3(ds, kf, split) * scale
    dk = (_mm3(ds.transpose(-1, -2), q, split) * scale).view(b, hkv, group,
                                                             s, d)
    dv = _mm3(p.transpose(-1, -2), dout, split).view(b, hkv, group, s, d)
    return dq, dk.sum(2), dv.sum(2)


def test_k6_bwd_f32_split_fits_grad_tol():
    """D = 256, GQA 4:1, S = 600, window 256: the emulated 3xTF32 backward
    within chip_smoke.py's f32 GRAD_TOL of the vector-Jacobian product of
    the plain version (swa_bwd_ref), and one TF32 product a product would
    miss it, which is why every operand is split."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    rng = np.random.default_rng(2)
    q, k, v, dout = (
        torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        for shape in ((1, 4, 600, 256), (1, 1, 600, 256), (1, 1, 600, 256),
                      (1, 4, 600, 256)))
    want = swa_bwd_ref(q, k, v, dout, window=256)
    got = emulate_k6_bwd_f32(q, k, v, dout, window=256)
    one = emulate_k6_bwd_f32(q, k, v, dout, window=256, split=False)
    for name, g, w, g1 in zip(("dq", "dk", "dv"), got, want, one):
        assert g.shape == w.shape and g.dtype == w.dtype == torch.float32
        good, err, rel = chip_smoke.grad_error("swa", torch.float32, g, w,
                                               dout)
        assert good, (name, err, rel)
        good1, err1, rel1 = chip_smoke.grad_error("swa", torch.float32, g1, w,
                                                  dout)
        assert not good1 and rel1 > 10 * rel, (name, rel1, rel)


def emulate_k6_fwd_f32(q, k, v, *, window: int, split: bool = True,
                       tile: int = 32):
    """K6's f32 forward arithmetic in torch (a test helper, never on the
    main path): S = Q Kᵀ in 3xTF32 (``_mm3``), times scale·log2e in f32,
    masked to -1e30; an online softmax over the kernel's 32-key tiles in f32
    (m the running max over the tile's keys, alpha = 2^(m_old - m_new), P
    = 2^(S - m_new) and 0 where masked, l = l·alpha + ΣP); the accumulator
    rescaled by alpha, then P·V of the tile's keys in 3xTF32 added to it;
    out = acc / max(l, 1e-30).  ``split=False``: every product one TF32
    product."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    kf = k.repeat_interleave(group, dim=1)
    vf = v.repeat_interleave(group, dim=1)
    scale_log2 = torch.tensor((1.0 / math.sqrt(d)) * math.log2(math.e),
                              dtype=torch.float32)
    neg = torch.tensor(-1e30)
    m = torch.full((b, hq, s, 1), -1e30)
    l = torch.zeros((b, hq, s, 1))
    acc = torch.zeros((b, hq, s, d))
    i = torch.arange(s)[:, None]
    for k0 in range(0, s, tile):
        j = torch.arange(k0, min(k0 + tile, s))[None, :]
        mask = (j <= i) & (j > i - window)
        sc = _mm3(q, kf[:, :, k0:k0 + tile].transpose(-1, -2), split)
        sc = torch.where(mask, sc * scale_log2, neg)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.where(mask, torch.exp2(sc - m_new), 0.0)
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _mm3(p, vf[:, :, k0:k0 + tile], split)
        m = m_new
    return acc / l.clamp_min(1e-30)


def test_k6_fwd_f32_split_fits_the_f32_limit():
    """D = 256, GQA 4:1, S = 777, window 256: the emulated 3xTF32 forward
    within the f32 limit (2e-5, chip_smoke.LM_TOL) of the plain version
    (swa_ref), and one TF32 product a product would miss it, which is why
    every operand is split."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               for shape in ((1, 4, 777, 256), (1, 1, 777, 256),
                             (1, 1, 777, 256)))
    want = swa_ref(q, k, v, window=256)
    tol = chip_smoke.LM_TOL["swa"][torch.float32][0]
    got = emulate_k6_fwd_f32(q, k, v, window=256)
    err = (got - want).abs().max().item()
    assert got.shape == want.shape and got.dtype == torch.float32
    assert err <= tol, err
    one = (emulate_k6_fwd_f32(q, k, v, window=256, split=False)
           - want).abs().max().item()
    assert one > tol and one > 10 * err, (one, err)


def test_swa_takes_strided_views_on_cpu():
    """The model hands over (B, S, H, D) projections viewed as (B, H, S, D);
    the result equals that of contiguous copies."""
    g = torch.Generator().manual_seed(1)
    q = torch.randn(1, 70, 4, 32, generator=g)
    kv = torch.randn(1, 70, 2, 32, generator=g)
    got = sliding_window_attention(q.transpose(1, 2), kv.transpose(1, 2),
                                   kv.transpose(1, 2), window=16)
    want = sliding_window_attention(q.transpose(1, 2).contiguous(),
                                    kv.transpose(1, 2).contiguous(),
                                    kv.transpose(1, 2).contiguous(), window=16)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


SMS = 132   # the H100 SXM's SMs


@pytest.mark.parametrize("itemsize", [2, 4])
def test_conv1d_plan_model_shape(itemsize):
    """RecurrentGemma-2B's prefill, x (2, 4096, 2560), K = 4: the vector
    instance over runs of 8 with 8 rows in flight in blocks of 64 threads,
    which divide a row's 320 bf16 / 640 f32 chunks: 163,840 / 327,680
    threads."""
    p = k5.plan(2, 4096, 2560, 4, itemsize, SMS, True)
    assert p == k5.Plan(4, 8, 64, 8)
    assert (2560 * itemsize // 16) % p.threads == 0


@pytest.mark.parametrize("b,s,c,k,itemsize,aligned,want", [
    *((2, 4096, 2560, k, 2, True, k) for k in (1, 2, 3, 4)),
    (2, 4096, 2560, 5, 2, True, 0),        # K past the vector instances
    (1, 100, 2561, 4, 2, True, 0),         # rows not whole 16-byte chunks
    (1, 100, 2562, 4, 4, True, 0),
    (1, 100, 2564, 4, 4, True, 4),
    (1, 100, 2560, 4, 2, False, 0),        # x, w or y off a 16-byte boundary
    (2, 3, 200, 4, 4, True, 4),            # S shorter than K
    (1, 1, 9, 1, 4, True, 0),
    (1, 37, 5, 32, 4, True, 0),
])
def test_conv1d_plan_instance(b, s, c, k, itemsize, aligned, want):
    p = k5.plan(b, s, c, k, itemsize, SMS, aligned)
    assert p.instance == want
    if want == 0:
        assert p == k5.Plan(0, k5.GENERIC_RUN, k5.GENERIC_THREADS, 1)


@pytest.mark.parametrize("b,s,c,itemsize", [
    (1, 1, 8, 2), (1, 3, 64, 4), (2, 4096, 2560, 2), (2, 4096, 2560, 4),
    (1, 4096, 2560, 2), (1, 512, 2560, 2), (32, 32768, 2560, 2),
    (1, 100, 4096, 4), (7, 1001, 128, 2), (1, 10 ** 6, 8, 2),
    (1, 64, 1000, 4)])
def test_conv1d_plan_run_fills_the_card(b, s, c, itemsize):
    """The run is RUN, or the longest power of two under it whose grid
    gives every SM MIN_THREADS_PER_SM threads (1 where none does); rows in
    flight never pass the run."""
    p = k5.plan(b, s, c, 4, itemsize, SMS, True)
    chunks = c * itemsize // 16
    budget = SMS * k5.MIN_THREADS_PER_SM

    def grid(run):
        return b * chunks * -(-s // run)
    assert p.instance == 4 and p.run.bit_count() == 1 and p.run <= k5.RUN
    assert p.run == 1 or grid(p.run) >= budget
    assert p.run == k5.RUN or grid(2 * p.run) < budget
    assert p.ahead == min(k5.AHEAD, p.run) and p.ahead in k5.AHEADS
    assert p.threads == k5.THREADS


def emulate_k5(x: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor | None = None) -> torch.Tensor:
    """K5's arithmetic in torch (a test helper, never on the main path):
    fmaf in tap order from 0 (each product and sum in float64, rounded once
    to float32: fmaf's result but for rare double roundings), the sum cast
    to x.dtype, then the bias added in float32 and cast again."""
    kk, s = w.shape[0], x.shape[1]
    xp = torch.nn.functional.pad(x.double(), (0, 0, kk - 1, 0))
    acc = torch.zeros(x.shape, dtype=torch.float32)
    for k in range(kk):
        acc = (xp[:, k:k + s] * w[k].double() + acc.double()).float()
    y = acc.to(x.dtype)
    return y if b is None else (y.float() + b.float()).to(x.dtype)


def test_k5_bf16_double_rounding_fits_chip_smoke_limits():
    """bf16 at the model's conv width: the emulated kernel with its bias
    within chip_smoke.py's conv1d limits (8e-2 plus one quantum) of the
    plain version, which adds the bias before its one cast; without the
    bias, within them too.  The second rounding is visible."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    rng = np.random.default_rng(0)
    bf = torch.bfloat16
    x, w, b = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(bf) * scale
               for shape, scale in (((2, 512, 256), 4), ((4, 256), 1),
                                    ((256,), 4)))
    got, want = emulate_k5(x, w, b), conv1d_ref(x, w, b)
    good, err, _ = chip_smoke.lm_error("conv1d", bf, got, want)
    assert good, err
    assert err > 0
    good, err, _ = chip_smoke.lm_error("conv1d", bf, emulate_k5(x, w),
                                       conv1d_ref(x, w))
    assert good, err


def test_k5_f32_emulation_keeps_the_f32_limit():
    """f32: the fmaf chain and the plain version's rounded products agree
    within chip_smoke.py's 2e-5, with the bias added after the sum."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    rng = np.random.default_rng(1)
    x, w, b = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               for shape in ((2, 512, 256), (4, 256), (256,)))
    good, err, _ = chip_smoke.lm_error("conv1d", torch.float32,
                                       emulate_k5(x, w, b),
                                       conv1d_ref(x, w, b))
    assert good, err


# -- K5's backward: its plan and its order of operations ----------------------
@pytest.mark.parametrize("itemsize", [2, 4])
def test_conv1d_plan_bwd_model_shape(itemsize):
    """RecurrentGemma-2B's training shape, x (1, 4096, 2560), K = 4: the
    vector instance over runs of 32 in blocks of 128 threads, 2 bf16 / 4
    f32 rows a block of loads; its workspace of f32 partial sums (a row of K + 1
    sums a channel for each block of runs) stays under 5% of x and dy."""
    p = k5.plan_bwd(1, 4096, 2560, 4, itemsize, True)
    assert p == k5.BwdPlan(4, k5.BWD_RUN, k5.BWD_THREADS,
                           k5.BWD_AHEAD[itemsize])
    assert p.ahead in k5.AHEADS and p.ahead <= p.run
    assert p.threads % 32 == 0 and p.threads <= k5.MAX_THREADS
    part = k5.bwd_groups(p, 1, 4096) * 5 * 2560 * 4
    assert part <= 0.05 * 2 * 4096 * 2560 * itemsize


@pytest.mark.parametrize("b,s,c,k,itemsize,aligned,want", [
    *((1, 4096, 2560, k, 2, True, k) for k in (1, 2, 3, 4)),
    (1, 4096, 2560, 7, 2, True, 0),        # K past the vector instances
    (1, 100, 2561, 4, 2, True, 0),         # rows not whole 16-byte chunks
    (1, 100, 2562, 4, 4, True, 0),
    (1, 100, 2564, 4, 4, True, 4),
    (1, 100, 2560, 4, 2, False, 0),        # off a 16-byte boundary
    (3, 2, 64, 4, 2, True, 4),             # S shorter than K
])
def test_conv1d_plan_bwd_instance(b, s, c, k, itemsize, aligned, want):
    p = k5.plan_bwd(b, s, c, k, itemsize, aligned)
    assert p.instance == want
    if want == 0:
        assert p == k5.BwdPlan(0, k5.BWD_GENERIC_RUN,
                               k5.BWD_GENERIC_THREADS, 1)


@pytest.mark.parametrize("b,s,c,itemsize", [
    (64, 65536, 16, 2), (1, 10 ** 7, 8, 4), (1024, 4096, 2560, 2)])
def test_conv1d_plan_bwd_takes_more_than_65535_runs(b, s, c, itemsize):
    """The grid is flattened over x: more runs than a grid's y extent
    (65,535) plan and fit the launcher's limit of 2^31 - 1 blocks."""
    p = k5.plan_bwd(b, s, c, 4, itemsize, True)
    runs = b * -(-s // p.run)
    cblocks = -(-(c * itemsize // 16) // 32)
    assert runs > 65_535
    assert k5.bwd_groups(p, b, s) == -(-runs // (p.threads // 32))
    assert k5.bwd_groups(p, b, s) * cblocks < 2 ** 31


def fmaf(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fmaf's bits on float32 tensors (a test helper): the product is exact
    in float64, TwoSum gives the float64 sum's rounding error, and a sum
    that lands exactly halfway between two floats goes to the side of its
    error, so the result is the exact a * b + c rounded once."""
    a, b, c = a.double(), b.double(), c.double()
    p = a * b
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    r = s.float()
    rd = r.double()
    other = torch.nextafter(r, torch.where(s > rd, math.inf, -math.inf
                                           ).float())
    tie = (s != rd) & ((rd + other.double()) * 0.5 == s) & (err != 0)
    side = torch.where(err > 0, torch.maximum(r, other),
                       torch.minimum(r, other))
    return torch.where(tie, side, r)


def test_fmaf_rounds_once():
    """The helper where a float64 sum rounds twice: a * b + c lies just
    below the midpoint of two floats, the float64 sum on it, and a cast to
    float32 would take the even float above; fmaf gives the one below."""
    ulp = 2.0 ** -23
    a = torch.tensor([2.0 ** -24 * (1 + ulp)])
    b = torch.tensor([1 - ulp])
    c = torch.tensor([1 + ulp])
    # a * b + c = 1 + ulp + ulp / 2 - 2^-70
    twice = (a.double() * b.double() + c.double()).float().item()
    assert twice == 1 + 2 * ulp
    assert fmaf(a, b, c).item() == 1 + ulp
    assert fmaf(-a, b, -c).item() == -(1 + ulp)
    assert fmaf(a, b, torch.tensor([1.0])).item() == 1.0


def emulate_k5_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K5 without a bias, with fmaf's exact bits: the chain in tap order
    from 0 over the zero-padded input, cast once to x's type."""
    kk, s = w.shape[0], x.shape[1]
    xp = torch.nn.functional.pad(x.float(), (0, 0, kk - 1, 0))
    acc = torch.zeros(x.shape)
    for k in range(kk):
        acc = fmaf(xp[:, k:k + s], w[k].float().expand_as(acc), acc)
    return acc.to(x.dtype)


def emulate_k5_bwd(x, dy, w, b, plan):
    """K5's backward (csrc/conv1d.cu, conv1d_bwd_launch) in its order of
    operations under ``plan`` (a test helper, never on the main path):
    dx[u] as fmaf over dy[u+K-1-k] in tap order from 0, cast once; each
    thread's run of positions, x[u] paired with dy[u+j] (j = K-1-k, pairs
    past S-1 skipped) in an fmaf chain a tap and dy[u] added for db, all
    from 0 in float32; the threads of a block (``threads // 32``
    consecutive runs) added in slot order; the blocks' rows as
    ``SUM_CHAINS`` strided chains joined by a fixed tree; cast to w's and
    b's types.  Returns (dx, dw, db)."""
    bs, s, c = x.shape
    kk = w.shape[0]
    run, rows = plan.run, plan.threads // 32
    xf, gf, wf = x.float(), dy.float(), w.float()
    gp = torch.nn.functional.pad(gf, (0, 0, 0, kk - 1))
    acc = torch.zeros(x.shape)
    for k in range(kk):
        acc = fmaf(gp[:, kk - 1 - k:kk - 1 - k + s], wf[k].expand_as(acc),
                   acc)
    dx = acc.to(x.dtype)
    rpr = -(-s // run)
    runs = bs * rpr
    bidx = torch.arange(runs) // rpr
    s0 = torch.arange(runs) % rpr * run
    xq = torch.nn.functional.pad(xf, (0, 0, 0, rpr * run - s))
    gq = torch.nn.functional.pad(gf, (0, 0, 0, rpr * run - s + kk))
    sums = torch.zeros(kk + 1, runs, c)          # by tap, then db
    for i in range(run):
        u = s0 + i
        live = (u < s)[:, None]
        xv = xq[bidx, u]
        for j in range(kk):
            pair = (u + j < s)[:, None]
            sums[kk - 1 - j] = torch.where(
                pair, fmaf(xv, gq[bidx, u + j], sums[kk - 1 - j]),
                sums[kk - 1 - j])
        sums[kk] = torch.where(live, sums[kk] + gq[bidx, u], sums[kk])
    groups = -(-runs // rows)
    sums = torch.nn.functional.pad(sums, (0, 0, 0, groups * rows - runs))
    sums = sums.reshape(kk + 1, groups, rows, c)
    part = torch.zeros(kk + 1, groups, c)
    for t in range(rows):
        part = part + sums[:, :, t]
    chains = [torch.zeros(kk + 1, c) for _ in range(k5.SUM_CHAINS)]
    for r in range(groups):
        chains[r % k5.SUM_CHAINS] = chains[r % k5.SUM_CHAINS] + part[:, r]
    while len(chains) > 1:
        h = len(chains) // 2
        chains = [chains[t] + chains[t + h] for t in range(h)]
    total = chains[0]
    return (dx, total[:kk].to(w.dtype),
            None if b is None else total[kk].to(b.dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,c,k,bias,aligned", [
    (1, 512, 2560, 4, True, True),     # a cut of the model's training shape
    (2, 100, 64, 4, True, True),       # S not a multiple of the run
    (3, 2, 64, 4, True, True),         # S < K
    (3, 77, 264, 3, False, True),      # B = 3, K = 3
    (2, 70, 48, 1, True, True),        # K = 1
    (2, 150, 40, 7, True, True),       # the generic instance: K = 7
    (2, 200, 36, 4, False, False),     # and unaligned
])
def test_k5_bwd_emulation_fits_grad_tol(dtype, b, s, c, k, bias, aligned):
    """The kernel's order of operations, emulated on the CPU, within
    chip_smoke.py's GRAD_TOL of the vector-Jacobian product of the plain
    version; its dx bit for bit K5 (fmaf chain) on the time-reversed
    gradient, and in bf16, whose products are exact in f32, the plain
    version on it."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(7)
    x, dy = (torch.from_numpy(rng.normal(size=(b, s, c)).astype(np.float32)
                              ).to(dt) for _ in range(2))
    w = torch.from_numpy(rng.normal(size=(k, c)).astype(np.float32)).to(dt)
    bb = (torch.from_numpy(rng.normal(size=c).astype(np.float32)).to(dt)
          if bias else None)
    plan = k5.plan_bwd(b, s, c, k, x.element_size(), aligned)
    assert (plan.instance == 0) == (k > k5.VEC_TAPS or not aligned)
    got = emulate_k5_bwd(x, dy, w, bb, plan)
    want = conv1d_bwd_ref(x, w, bb, dy)
    for g, ww in zip(got, want):
        if ww is None:
            assert g is None
            continue
        good, err, rel = chip_smoke.grad_error("conv1d", dt, g, ww, dy)
        assert good, (err, rel)
    flipped = emulate_k5_fwd(dy.flip(1), w).flip(1)
    assert torch.equal(got[0], flipped)
    if dt == torch.bfloat16:
        assert torch.equal(got[0], conv1d_ref(dy.flip(1), w).flip(1))


# -- K7: the batched cycle engine's planner -----------------------------------
@pytest.mark.parametrize("nodes,edges,n_mem,items,threads", [
    (105, 152, 2, 1, 160), (209, 304, 4, 1, 320), (313, 456, 6, 1, 480),
    (417, 608, 8, 1, 608), (521, 760, 10, 1, 768),    # paper 2D, w = 1-5
    (1665, 2432, 32, 4, 608),                          # paper 2D, w = 16
    (17, 20, 2, 1, 64), (28, 35, 2, 1, 64), (65, 80, 8, 1, 96),
    (163, 210, 12, 1, 224)])                           # heat_2d(48, 96) sweep
def test_k7_plan(nodes, edges, n_mem, items, threads):
    """The smallest instance that holds the lane: warp 0 and one thread a
    non-memory node, or one an edge, in whole warps; the paper's w = 16
    lane is past 1,024 threads at ITEMS 1."""
    from repro_torch.kernels.simbatch import kernel as k7
    p = k7.plan(nodes, edges, n_mem)
    assert (p.items, p.threads) == (items, threads)
    assert threads <= k7.INSTANCES[items] and threads % 32 == 0
    assert all(k7.lane_threads(nodes, edges, n_mem, i) > k7.INSTANCES[i]
               for i in k7.INSTANCES if i < items)
    assert p.smem == k7.smem_bytes(nodes, edges, n_mem) <= LIMIT


def test_k7_instances_match_the_kernel_source():
    """The planner's instance table is the one the kernel is built with
    (``csrc/simbatch.cu``: ``SIMBATCH_INSTANCES``, each instance's
    ``__launch_bounds__``)."""
    from repro_torch.kernels.simbatch import kernel as k7
    src = (ROOT / "src/repro_torch/csrc/simbatch.cu").read_text()
    table = re.search(r"#define SIMBATCH_INSTANCES\(X\) (.*)", src).group(1)
    built = {int(i): int(t)
             for i, t in re.findall(r"X\((\d+), (\d+)\)", table)}
    assert built == k7.INSTANCES


def _smem_state_in_shared(nodes: int, edges: int, n_mem: int) -> int:
    """A lane's shared memory when K7 kept all its state there: int32 qlen
    and maxocc a edge and the sentinel, int32 fires and sel and uint8
    active and flags a node and the sentinel, the memory nodes' eligibility
    words and one counter."""
    used = 8 * (edges + 1) + 10 * (nodes + 1)
    return -(-used // 4) * 4 + 4 * -(-n_mem // 32) + 4


def test_k7_every_lane_that_fitted_gets_an_instance():
    """Every lane whose state fitted one block when K7 kept it all in
    shared memory has an instance now, in less shared memory: up to
    29,052 edges or 23,243 nodes, ITEMS 32 at 1,024 threads.  Lanes as
    compiled plans make them: each memory node has its own address node
    and an edge from it, so nodes and edges are at least twice the memory
    nodes."""
    from repro_torch.kernels.simbatch import kernel as k7
    sizes = [2, 3, 32, 33, 100, 1000, 1024, 1025, 3072, 3073, 4096, 4097,
             8000, 16000, 23243, 29052, 29053]
    held = 0
    for nodes in sizes:
        for edges in sizes:
            for n_mem in {1, 32, 33, nodes // 4, nodes // 2}:
                if not (1 <= n_mem and 2 * n_mem <= min(nodes, edges)):
                    continue
                if _smem_state_in_shared(nodes, edges, n_mem) > LIMIT:
                    continue
                p = k7.plan(nodes, edges, n_mem)
                assert p is not None, (nodes, edges, n_mem)
                assert p.threads <= k7.INSTANCES[p.items]
                assert p.smem <= _smem_state_in_shared(nodes, edges, n_mem)
                held += 1
    assert held > 100
    assert k7.plan(29052, 29052, 1).items == 32
    assert k7.plan(32768 + 1, 100, 1) is None
