#!/usr/bin/env python3
"""Drive the PyTorch port's stencil main path, its CGRA model with the
tuner's batched stage 1, its RecurrentGemma-2B serving and training paths,
the other LM families, its multi-device stencils, its data- and
tensor-parallel trainer, its FSDP over the data axis and its decode of a
model split over the model axis on one NVIDIA GPU (H100), then its
multi-pod dry run on the host's CPU.

    PYTHONPATH=src python3 chip_smoke.py [--device cuda:0] [--seed 0]

1. Builds the hand-written CUDA kernels from ``src/repro_torch/csrc`` (K1-K7
   and the backward of K5 and K6; one ``nvcc`` per source, in parallel).
2. Drives the main path through the public ops (``stencil1d_from_spec``,
   ``stencil2d_from_spec``, ``stencil3d``) with every launch count zeroed just
   before and read just after: the paper's §VI shapes in f32 (1D 17-pt
   N=194400 through both variants, 2D 49-pt 449x960 at T=1 and T=4, 3D
   ``star_3d(64, 64, 256, r=2)``), then deployment sizes (1D 1024 x 194400,
   2D 256 x 449 x 960, 3D 512^3) in f32 and bf16, and the seismic T=4 2D
   sweep on 16 x 449 x 960 in bf16.
3. Holds every output against the kernel's plain PyTorch version on the card
   (tolerance: f32 2e-5, bf16 3e-2, the TOL table of tests/test_kernels.py),
   and the paper shapes also against the numpy oracle on the host.
4. Times each kernel at its deployment shape (median of CUDA-event times
   after warm-up) beside its plain version, a cuDNN convolution yardstick
   (``library_ms``; TF32 off) and its bound, prints one JSON line per case,
   the ``kernels`` JSON line (each stencil row also with its bf16 time and
   bound, the K5/K6 rows and their backward's with their f32 ones), the
   registers and spills that ``ptxas`` reported for K1-K6 and the backward
   kernels in the build's own log, the
   card's name and power limit, and last ``{"ok": true, "device": {...}}``.
   Before the ``kernels`` line, K4's generic instance (every radius or
   pattern of taps but the star pattern at (1, 1, 1) and (2, 2, 2), which
   run compile-time instances) is checked against the plain version and
   timed once at ``star_3d(512, 512, 512, r=3)`` in f32 and bf16
   (``generic_3d_r3`` lines); so are K2 and K1 at T = 4 on (1024, 194400)
   in f32 (``deploy_1d_mxu_t4``, where 3xTF32's error adds up over fused
   sweeps, and ``deploy_1d_vpu_t4``) and their generic instances at r = 13
   on (1024, 194400) in f32 and bf16 (``generic_1d_r13`` lines, told apart
   by ``kernel``; K2's radii 1-8 and K1's r = 8 with all 17 taps non-zero
   run compile-time instances).
5. The CGRA phase (``cgra_phase``): the paper's cases at their own sizes
   (1D 17-pt N=194400 and 2D 49-pt 449x960 at w* from the §VI roofline on
   the CGRA, ``heat_3d(64, 64, 64)`` at w=8; the 2D case at 32x64 when the
   other two simulations take more than half of ``CGRA_SIM_BUDGET_S``) are
   mapped and simulated on the host with the vector engine and held
   against the numpy oracle; the same inputs, cast to f32, go through K1
   and K2 (1D), K3 (2D) and K4 (3D) on the card with the launch counts
   zeroed just before and read just after (each of K1-K4 must launch), and
   each output is held within 2e-5 of the simulated one and of the oracle
   (``phase: "cgra"`` lines).  Interp and vector must agree bit for bit on
   the quickstart spec and ``paper_stencil_1d(n=2400)``
   (``cgra_interp_vector``); the paper-size 1D plan is placed and routed on
   a 16x16 mesh, and the n=2400 plan simulated routed and ideal must give
   the same output bits, routed no faster (``cgra_fabric``).  After the
   timing of the paper shapes, ``cgra_roofline`` lines put the §VI
   roofline of the 1D and 2D paper cases at f32 on the CGRA, the V100 and
   this H100 part beside what K1, K2 and K3 achieved there.
6. The ``cgra_batch`` phase (``cgra_batch_phase``): K7, the batched cycle
   engine.  With the launch counts zeroed, benchmarks/run.py's tuner
   sweep at full size (``heat_2d(48, 96)``, temporal 1-2, capacities
   auto/unbounded, the full grid and ``tile_candidates`` at 2 and 8 KiB, 2
   workload sweeps: 84 configs, of which pruning keeps 30) runs through
   ``explore(..., budget=Budget(batch_size=32))`` on the card, then again
   sequentially with the vector engine: per-config cycles and the Pareto
   front must be identical.  ``K7Watch`` records what the sweep's own
   calls of K7's wrapper took and returned, and times their launches
   (CUDA events): every lane's final carry must equal its plain version's
   on the card, on the same lanes, in every field (max difference 0).
   Then the paper's 2D 449x960 stage-1 sweep (workers 1-5, capacities
   auto/unbounded: 10 lanes) runs as one ``simulate_batch`` launch: every
   lane's output within 1e-9 of the numpy oracle; the analytic seed lane
   (w = 5, auto) equal to the ``cgra`` phase's vector result in cycles,
   fires, loads/stores/flops and output bits, and its w = 5 unbounded lane
   (the ``cgra`` phase's own plan) in every observable; the other 8 lanes
   equal in every observable to the vector engine, run on the same inputs
   in ``VECTOR_WORKERS`` worker processes; meanwhile the launch's own
   lanes and carries are held to K7's plain version on the card in every
   field (max difference 0).  Prints configs/s of both
   paths, K7's device ms, its instance (``ITEMS``, threads) and barriers a
   cycle, ns per simulated cycle, host packing and value-pass seconds
   apart, and K7's bound: the largest over a launch's lanes of the lane's
   cycles x ``K7_FLOOR_BARRIERS`` (1) barrier a cycle x one barrier's time
   at the lane's ``bound_threads`` (one thread per two nodes or edges,
   fixed apart from K7's planner), measured by a barrier-only instance of
   the kernel.  K7's row of the ``kernels`` line carries the registers and
   spills of each ``ITEMS`` instance (``ptxas_by_items``).
7. The LM phase (``lm_phase``): K5 (causal conv1d) and K6 (sliding-window
   attention) at RecurrentGemma-2B's shapes in f32 and bf16 (K6 on the
   (B, S, H, D) projections viewed as (B, H, S, D), as the prefill hands
   them over, its output in q's layout) against their
   plain versions (tolerance: conv1d f32 2e-5, bf16 8e-2 plus one bf16
   quantum, the kernel alone and the op with its bias; swa f32 2e-5, bf16
   3e-2 and a norm-relative error of at most 1e-2), the op's fused bias
   also bit for bit against the kernel followed by the bias in f32, timed
   beside the plain version, one library call (``F.conv1d`` with
   ``groups=C``; ``scaled_dot_product_attention`` with a band mask) and the
   bound.  K5 is timed with a cold L2 (a read of ``FLUSH_L2`` times the L2
   before each call, then a sleeping kernel while the call is issued, both
   outside the events): its kernel cold and warm (min /
   median / max), the op with its bias, the plain version and the library
   call; its row carries the launch ``plan`` chose (``instance``).  Then
   ``make_prefill`` of the full 26-layer model (d_model 2560, f32 weights,
   bf16 activations) on tokens (2, 4096), which must launch K5 18 times
   and K6 8 times; then the kernel-free check (``LM.decode`` token
   by token against ``LM.forward``, f32 activations, 5 layers, S = 2112, so
   the window and the ring buffer wrap); then ``BatchEngine`` at full width
   and depth answering 4 requests on 2 slots.  One prefill and one decode
   step run again under ``torch.profiler`` for the device's busy time by
   kernel group and its idle share.

8. The ``families`` phase (``families_phase``, ~20 s): the other LM
   families, whose paths run no hand-written kernel (full attention, the
   MoE and the WKV recurrence are plain PyTorch, as the reference runs
   them outside any Pallas kernel).  Granite-MoE-3B-A800M at its published
   width and depth (32 layers, d_model 1536, 40 experts top-8, f32
   weights, bf16 activations): ``make_prefill`` on (2, 4096) tokens, whose
   logits must be finite and (2, 4096, 49155) f32, timed (median of 3
   synchronised calls) with its peak memory, then under ``torch.profiler``
   split into matmuls, the MoE's dispatch and combine (the model's
   ``MOE_DISPATCH`` ranges), attention softmax, copies and casts and other
   elementwise kernels, with the idle share; ``BatchEngine`` answering 4
   requests on 2 slots and a decode step's profile; decode token by token
   against the forward on (2, 32) tokens (dropless, f32 activations)
   within 5e-4.  Then tinyllama-1.1b, qwen2.5-3b, qwen3-32b,
   command-r-plus-104b, qwen2-vl-2b (patches and M-RoPE positions),
   rwkv6-7b and granite-moe-1b-a400m at full width and 2 layers, and
   whisper-tiny whole: a (1, 256) prefill (finite logits of the right
   shape, timed) and decode against forward over 8 tokens within 5e-4.
   Last, the WKV recurrence alone at rwkv6-7b's heads, (1, 256) and
   (2, 4096) (``families_wkv`` lines).

8a. The ``train`` phase (``train_phase``, ~35 s), between the LM and the
   ``families`` phases: K5's and K6's backward at RecurrentGemma-2B's
   shapes on (1, 4096) tokens in f32 and bf16, through the ops' autograd
   (dx, dw and db in one launch of ``conv1d_bwd``, dx bit for bit K5 on
   the flipped gradient, two calls bit-equal; dq, dk, dv as
   ``swa_bwd_dq`` and ``swa_bwd_dkdv``, the latter's partial sums added
   by ``swa_bwd_fold``) against the vector-Jacobian products of their
   plain versions (``GRAD_TOL``; the fold bit for bit against its own),
   each timed beside its plain version, a library call (the one backward
   of ``F.conv1d`` with ``groups=C`` for x, w and b; of
   ``scaled_dot_product_attention`` with a band mask) and its bound (K6's
   f32 ones with the peak that sets them, ``ops_bound``), K6's rows also with ``sum_ms`` (every launch of
   its backward) beside ``library_bwd_ms`` (the one library backward of
   q, k and v); then one period (3 layers) at full width, bf16 activations:
   the loss's gradients and one ``make_train_step`` through the kernels
   and again through the plain versions (``train_step_check``); then the
   whole model (26 layers, d_model 2560, f32 weights) trained for
   ``TRAIN_STEPS`` steps on ``SyntheticLM`` markov batches of (1, 4096)
   with remat "dots", the launch counts zeroed just before and read just
   after (each step must launch K5 36 times, ``conv1d_bwd`` 18, K6 16,
   ``swa_bwd_dq``, ``swa_bwd_dkdv`` and ``swa_bwd_fold`` 8:
   ``train_launches``), losses,
   step ms, tokens/s and peak memory printed, and one more step under
   ``torch.profiler`` (matmuls, the kernels, the optimizer and the loss's
   forward by their profiler ranges, casts, the rest; idle share); last
   ``python -m repro_torch.launch.train --arch tinyllama-1.1b --reduced
   --steps 8 --ckpt-every 3`` in this process, its checkpoints after step
   3 deleted and the same command with ``--resume``, whose losses for
   steps 3-7 must equal the first run's bit for bit.

9. The ``observe`` phase (``observe_phase``, ~10 s): the CGRA model's
   observability and its gates; the steps that launch kernels run with the
   launch counts zeroed just before and read just after.  ``lint``: the lint CLI's
   ``lint_paths`` over the five ``examples/*_torch.py`` walkthroughs (7
   plans, 2 routed, 0 failed).  ``trace``: a batched ``explore`` of
   ``heat_2d(24, 48)`` on the card (``device=None``, one K7 launch) with a
   ``Telemetry`` sink, written with ``write_trace`` into ``build/`` and
   validated as read back from disk (measured spans = ``n_measured`` > 0);
   then the routed ``paper_stencil_2d(ny=30, nx=48, r=12)`` simulated with
   the vector engine and a sink, its trace validated from disk and
   ``render_report``'s first bottleneck row printed.
   ``seismic_example``: ``examples/seismic_stencil2d_torch.py``'s ``main``
   on the card, which must launch K3: its error against the oracle within
   2e-5 and its 1/16-grid simulation exact.

10. The ``distributed`` phase (``distributed_phase``, ~30 s): the
   multi-device slice on the one card.  ``DIST_RANKS`` (4) gloo ranks,
   spawned by ``run_local_world``, share the card; each holds its shard of
   the grid (made on the card from ``--seed``) as a DTensor and runs each
   distributed stencil, which exchanges halos through the host (gloo reads
   host memory) and sweeps its haloed shard with K1, K3 or K4: the paper's
   17-pt 1D (r = 8) on 2^26 points, T = 4, 4 strips; the seismic 49-pt 2D
   (r = 12) on 8192 x 8192, T = 4, mesh (2, 2); ``star_3d`` r = 2 on 512^3,
   T = 2, z and y over (2, 2); all f32.  One fused block runs with the
   launch counts zeroed just before and read just after on every rank (K1
   1, K3 1, K4 2); the result is gathered on rank 0 through the host and
   held to the single-device op on the whole grid and to the oracle
   (``core/reference.py`` on the card) within 2e-5, its bit-equality to
   the op printed; a fused block is timed barrier to barrier (exchange
   included), then the exchanges alone and every rank's op on a haloed
   shard alone, the same way, and the op on the whole grid alone
   (``distributed`` lines, with ``halo_bytes_per_step`` and whether gloo
   takes CUDA tensors in an all-reduce).  Then this process is the one
   rank of an NCCL world: ``distributed_stencil2d`` on a (1, 1) mesh
   (2048 x 2048, K3 once, bit-equal to the op) and ``int8_psum`` on the
   card (``distributed_nccl``; with no peer, NCCL's point-to-point
   exchange between two cards stays unrun on a one-card machine).

11. The ``train_parallel`` phase (``train_parallel_phase``): the trainer's
   parallel slice.  One period (3 layers) of RecurrentGemma-2B at full
   width (d_model 2560, vocab 256,000, 10/1 heads of 256, lru_width 2560,
   d_ff 7680), f32 weights, bf16 activations, remat "dots", trained
   ``PAR_STEPS`` (3) steps of ``SyntheticLM`` markov batches of (2, 4096)
   through ``launch.train.run``: in this process (one rank), then in a
   2-rank gloo world sharing the card (``run_local_world``) at (D, M) =
   (2, 1) and at (1, 2), each run's memory freed before the next.  For
   each layout: the losses beside the one-rank run's within
   ``PAR_LOSS_RTOL`` (1e-3, relative), every rank's K5, ``conv1d_bwd``,
   K6 and K6-bwd launches in each step (counts zeroed just before and
   read just after) equal to ``train_launches`` for 3 layers, its
   parameter elements equal to ``resolve_spec``'s split, step ms, peak
   memory and the bytes all-reduced per step over the data and the model
   group (``tensor_parallel.wire_bytes``).  Then Granite-MoE-3B-A800M at
   full width (d_model 1536, 40 experts top-8 of d_ff 512, 24/8 heads,
   vocab 49,155), 2 layers, the same types and remat, on (2, 2048): one
   rank, then 2 gloo ranks at (1, 2) (20 experts and 12 heads a rank, the
   vocabulary whole), held the same way, no kernel launched
   (``PAR_CASES``).  Then RWKV-6-7B at full width (d_model 4096, 64 WKV
   heads of 64, d_ff 14,336, vocab 65,536), 2 layers, the same types and
   remat, on (2, 1024): one rank, then 2 gloo ranks at (1, 2) (32 heads,
   7,168 d_ff columns and 32,768 vocabulary rows a rank), held the same
   way, no kernel launched.  Then whisper-tiny whole (4 encoder and 4
   decoder layers, d_model 384, 6 heads of 64, d_ff 1,536, vocab 51,865,
   1,500 frames a row), the same types and remat, on (2, 4096): one rank,
   then 2 gloo ranks at (1, 2) (3 heads of every attention, the cross
   K/V's too, and 768 d_ff columns a rank, the vocabulary whole), held
   the same way, no kernel launched.  Then qwen2-vl-2b at full width
   (d_model 1536, 12/2 heads of 128 with q/k/v biases, M-RoPE, d_ff
   8,960, vocab 151,936 tied), 2 layers, the same types and remat, on
   (2, 4096) tokens alone (text-only M-RoPE positions, as the trainer
   feeds them): one rank, then 2 gloo ranks at (1, 2) (6 heads, 1 KV
   head, 4,480 d_ff columns and 75,968 vocabulary rows a rank), held the
   same way, no kernel launched.  Gloo carries every collective through the
   host; NCCL between cards stays unmeasured on one card
   (``train_parallel_note``).

11a. The ``split_decode`` phase (``split_decode_phase``): decode of a
   model split over the model axis.  RecurrentGemma-2B at full width, one
   period (rglru, rglru, local), tinyllama-1.1b and Granite-MoE-3B-A800M
   at full width, 2 layers, all f32 weights and activations, each decoding
   ``SPLIT_TOKENS`` (64) seeded tokens a row of a batch of 2 from an empty
   cache through ``make_decode_step``: in this process (one rank), then on
   2 gloo ranks sharing the card at (1, 2), each rank's weights and cache
   (``LM.init_cache`` under ``mesh_context``) its slices by the rules.
   RecurrentGemma's ring of 2048 slots is split over its positions (1024
   a rank), its 10 heads 5 a rank, its RG-LRU width 1280 a rank (layout
   (b)); tinyllama's cache over its 4 KV heads, 2 a rank (layout (a));
   Granite's over its 8 KV heads, 4 a rank (layout (a)), 20 of its 40
   experts a rank.  RWKV-6-7B at full width, 2 layers: its WKV state
   ``s`` over its 64 heads, 32 a rank, the token-shift states whole.
   whisper-tiny whole (4 decoder layers, f32): its self caches over the 6
   KV heads, 3 a rank (layout (a)), its cross K/V primed from the whole
   model's ``_cross_kv`` of seeded frames and placed by
   ``tensor_parallel.shard_cache`` over the 1,500 frames, 750 a rank,
   with 3 of the 6 heads a rank (layout (b): the queries gathered, the
   partials merged by log-sum-exp).  qwen2-vl-2b at full width, 2
   layers, f32, its M-RoPE positions (3, B, 1) from ``make_decode_step``:
   its cache over its 2 KV heads, 1 a rank, as ``wk`` and ``bk`` are
   (layout (a)), 6 of its 12 heads a rank, the greedy token from
   ``vocab_parallel_argmax`` over 75,968 rows a rank.  Each case's logits, gathered, within ``SPLIT_TOL`` (1e-3) of one
   rank's at every step, the greedy tokens equal, each rank's cache
   layout the rules' and no kernel launched; ms a step, one rank against
   two, and the bytes and calls a step per mesh axis
   (``tensor_parallel.WIRE``) on ``split_decode`` lines.

11b. The ``fsdp`` phase (``fsdp_phase``): FSDP over ``data``, parameters
   and AdamW moments laid out by ``DEFAULT_RULES`` (each ``"fsdp"`` dim
   over ``data``), gathered a layer at a time, gradients
   reduce-scattered.  One period of RecurrentGemma-2B at full width (f32
   weights, bf16 activations, remat "dots", (2, 4096) tokens) on 2 gloo
   ranks sharing the card at (2, 1), then whisper-tiny whole on 4 at
   (2, 2) (FSDP with the model split): in each rank one
   ``make_train_step`` from the same seeded weights and batch with FSDP
   off (the trainer's rules) and on.  The FSDP loss must equal FSDP-off's
   bit for bit, every updated parameter lie within ``FSDP_RTOL`` (1e-5)
   of FSDP-off's same slice relative to the leaf's largest element, each
   rank launch K5, K6 and their backward ``train_launches`` times (none
   for whisper), carry over ``data`` the bytes and calls
   ``fsdp_wire_want`` works out from the shapes and over ``model``
   FSDP-off's, and hold the parameter and moment bytes that
   ``resolve_spec`` places under ``DEFAULT_RULES``; whisper's decode
   (f32, ``FSDP_DECODE_TOKENS`` greedy steps from a primed cache) with
   FSDP on and off gives equal tokens and logits within 1e-5.  Step ms
   both ways on ``fsdp`` lines (FSDP off first, after an untimed pass of
   the loss's gradients).

12. The ``dryrun`` phase (``dryrun_phase``, ~20-40 s on the host's CPU):
   ``launch.dryrun.run_cell`` in a subprocess with the card hidden, on
   eight cells of the single production mesh (16 x 16 = 256 ranks):
   tinyllama-1.1b x train_4k, recurrentgemma-2b x prefill_32k,
   recurrentgemma-2b x train_4k, recurrentgemma-2b x decode_32k,
   granite-moe-3b-a800m x train_4k (40 experts over 16 ranks: each
   expert whole with 32 of its 512 d_ff columns) and rwkv6-7b x train_4k
   (4 WKV heads a rank) and whisper-tiny x train_4k (96 of its 1,536
   d_ff columns a rank, its 6 heads, 1,500 frames and 51,865 rows whole)
   and qwen2-vl-2b x train_4k (its 12 heads and 2 KV heads whole, 560 of
   the MLP's 8,960 columns and 9,496 of the 151,936 vocabulary rows a
   rank; the last three's counts must equal ``DRYRUN_COUNTS``, the CPU
   records the repo's tests run on), each
   run as rank 0 of a fake process group on meta tensors at published
   width and depth.  Each record's
   ``ok``, flops, bytes, parameter and collective bytes a device and its
   roofline step time (the H100's datasheet peaks) go on a ``dryrun``
   line; the K5/K6 launches that the wrappers counted on meta must equal
   what the lm phase's prefill (K5 18, K6 8), one step of the train
   phase (K5 36, ``conv1d_bwd`` 18, K6 16, each K6-bwd kernel 8) and the
   split_decode phase's decode (none) launched on the card, and
   tinyllama's, granite's, rwkv6's, whisper's and qwen2-vl's must be
   none.  A second CPU subprocess, beside the first, counts on meta
   (``launch.dryrun.count_memory``, ``meta_memory_counts``) the memory
   of three steps the card runs, each built by the card's own builder
   (``prefill_setup``, ``train_setup``, ``fsdp_setup``): the lm phase's
   prefill, the train phase's second step and rank 0 of the fsdp
   phase's RecurrentGemma step, each of which the card read around the
   step (``card_memory``: the caching allocator's requested bytes, their
   peak less the reading before, ``max_memory_allocated`` beside them).
   A ``memory`` line each: the counted arguments must equal the card's
   inputs' bytes and the counted temp come within 2% or 64 MiB of the
   card's, whichever is larger.

Any build error, launch error, mismatch or kernel that its path did not
launch exits non-zero without the last line.  Needs a CUDA device: without
one it exits non-zero before doing anything.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import importlib.util
import io
import json
import math
import multiprocessing
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import distribute_tensor

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import ShapeSpec, get_config  # noqa: E402
from repro_torch.core import (CGRA, H100_PCIE, H100_SXM, V100,  # noqa: E402
                              StencilSpec, analyze, heat_2d, heat_3d, map_nd,
                              paper_stencil_1d, paper_stencil_2d, simulate,
                              star_3d, stencil_reference_np)
from repro_torch.core.engine import cuda_engine  # noqa: E402
from repro_torch.core.simulator import simulate_batch  # noqa: E402
from repro_torch.explore import (Budget, SpaceOptions, as_target,  # noqa: E402
                                 enumerate_space, explore, prune_space,
                                 tile_candidates)
from repro_torch.fabric import FabricTopology, place, route  # noqa: E402
from repro_torch.kernels import (causal_conv1d,  # noqa: E402
                                 sliding_window_attention,
                                 stencil1d_from_spec, stencil2d_from_spec,
                                 stencil3d)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.conv1d.kernel import (conv1d_kernel,  # noqa: E402
                                              launch_plan)
from repro_torch.kernels.conv1d.kernel import (conv1d_bwd,  # noqa: E402
                                              conv1d_bwd_work, conv1d_work)
from repro_torch.kernels.conv1d.ref import conv1d_bwd_ref, conv1d_ref  # noqa: E402
from repro_torch.kernels.simbatch import kernel as k7  # noqa: E402
from repro_torch.kernels.simbatch.ref import simbatch_plain  # noqa: E402
from repro_torch.kernels.stencil1d.ref import stencil1d_ref  # noqa: E402
from repro_torch.kernels.stencil2d.ref import stencil2d_ref  # noqa: E402
from repro_torch.kernels.stencil3d.ref import stencil3d_ref  # noqa: E402
from repro_torch.kernels.swa.kernel import (band_pairs,  # noqa: E402
                                            swa_bwd_dkdv_partial,
                                            swa_bwd_dq, swa_bwd_fold,
                                            swa_bwd_fold_work,
                                            swa_bwd_kernel, swa_bwd_work,
                                            swa_work)
from repro_torch.kernels.swa.ops import swa_plain  # noqa: E402
from repro_torch.kernels.swa.ref import (swa_bwd_fold_ref,  # noqa: E402
                                         swa_bwd_ref, swa_ref)
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import attention as model_attention  # noqa: E402
from repro_torch.models import rglru as model_rglru  # noqa: E402
from repro_torch.train.optim import OptConfig, init_opt_state  # noqa: E402
from repro_torch.train.train_step import (LOSS_RANGE,  # noqa: E402
                                          OPTIMIZER_RANGE, make_loss_fn,
                                          make_train_step)
from repro_torch.analysis.lint import lint_paths  # noqa: E402
from repro_torch.core.reference import stencil_reference  # noqa: E402
from repro_torch.distributed import tensor_parallel as tp  # noqa: E402
from repro_torch.distributed.collectives import int8_psum  # noqa: E402
from repro_torch.distributed.halo import (distributed_stencil1d,  # noqa: E402
                                          distributed_stencil2d,
                                          distributed_stencil3d,
                                          halo_bytes_per_step, halo_exchange)
from repro_torch.distributed.halo import sweep as dist_sweep  # noqa: E402
from repro_torch.distributed.sharding import (DEFAULT_RULES,  # noqa: E402
                                              PartitionSpec,
                                              make_mesh_compat, mesh_context,
                                              named_sharding, placements,
                                              resolve_spec, shard_offsets)
from repro_torch.launch.dryrun import (count_memory,  # noqa: E402
                                       fake_world, tensor_leaves)
from repro_torch.launch.mesh import (make_local_mesh,  # noqa: E402
                                     run_local_world)
from repro_torch.telemetry import (Telemetry, bottleneck_table,  # noqa: E402
                                   render_report, validate_trace,
                                   write_trace)
from repro_torch.models.mlp import MOE_DISPATCH  # noqa: E402
from repro_torch.models.rwkv6 import _wkv_scan as wkv_scan  # noqa: E402
from repro_torch.models.mlp import capacity as moe_capacity  # noqa: E402
from repro_torch.models.registry import build_model, input_arrays  # noqa: E402
from repro_torch.serving.engine import BatchEngine, Request  # noqa: E402
from repro_torch.serving.serve_step import (make_decode_step,  # noqa: E402
                                            make_prefill)

TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# (atol, rtol) of K5/K6 against their plain versions, elementwise.  conv1d
# in bf16: tests/test_kernels.py:122's 8e-2, and one bf16 quantum (2^-7 |y|)
# beside it, as in tests/test_torch_cuda.py: the op adds the bias after the
# kernel's cast to bf16, the plain version before its one cast, and the
# kernel's fmaf chain and the plain version's rounded products may round to
# neighbouring bf16 values.
LM_TOL = {"conv1d": {torch.float32: (2e-5, 0.0), torch.bfloat16: (8e-2, 2**-7)},
          "swa": {torch.float32: (2e-5, 0.0), torch.bfloat16: (3e-2, 0.0)}}
# swa in bf16: past the first few hundred queries |out| is about 0.03, as
# large as the 3e-2 above, so the output is also held to a limit scaled to
# it: ||y - plain|| / ||plain|| <= 1e-2, which a fault that moves the
# outputs by 10% fails.
REL_TOL = {("swa", torch.bfloat16): 1e-2}
# K5's and K6's backward against the vector-Jacobian products of their
# plain versions, per gradient (dx, dw, db; dq, dk, dv), set before the
# first run on the card: (norm-relative ||g - want|| / ||want||, largest
# |g - want| over largest |want|).  f32: 1e-5, and the forward's 2e-5 scaled
# to the gradient's size; bf16: 1e-2, and the forward's bf16 bars (conv1d
# 8e-2, swa 3e-2) scaled alike: a gradient sums thousands of products, so
# its size, not 1, sets the scale of a rounding.
GRAD_TOL = {("conv1d", torch.float32): (1e-5, 2e-5),
            ("conv1d", torch.bfloat16): (1e-2, 8e-2),
            ("swa", torch.float32): (1e-5, 2e-5),
            ("swa", torch.bfloat16): (1e-2, 3e-2)}
# decode against forward at full width: the bar of tests/test_models.py
DECODE_TOL = 5e-4
# Datasheet peaks (dense, no sparsity): HBM bytes/s, FP32 (non-tensor)
# flop/s, BF16 and TF32 tensor-core flop/s of the two H100 parts; the first
# two from the roofline's machines.
H100 = {"sxm": H100_SXM, "pcie": H100_PCIE}
PEAKS = {part: (H100[part].bw_gbps * 1e9, H100[part].peak_gflops * 1e9, bf16,
                tf32)
         for part, bf16, tf32 in (("sxm", 989e12, 494.5e12),
                                  ("pcie", 756e12, 378e12))}


def ops_bound(flops: float, dtype: torch.dtype, part: str
              ) -> tuple[float, str]:
    """Least ms for ``flops`` of matrix products in ``dtype``, and the peak
    that sets it: bf16 at the BF16 tensor-core peak; f32 the lesser of the
    FP32 CUDA cores' and of three TF32 products each (3xTF32, the least an
    f32-accurate product takes on the tensor cores)."""
    _, fp32, bf16, tf32 = PEAKS[part]
    if dtype == torch.bfloat16:
        return flops / bf16 * 1e3, "bf16 tensor cores"
    return min((flops / fp32 * 1e3, "FP32 cores"),
               (3 * flops / tf32 * 1e3, "3xTF32 tensor cores"))
ARCH = "recurrentgemma-2b"
PREFILL_BATCH, PREFILL_SEQ = 2, 4096      # cut from prefill_32k's (32, 32768)
DECODE_LAYERS, DECODE_SEQ = 5, 2112       # one period + the 2-layer tail
PREFILL_LAUNCHES = {"conv1d": 18, "swa": 8}
# what the lm and train phases launched on the card: the prefill's
# launches and one train step's (the dryrun phase holds its meta tally to
# them)
ON_CARD: dict[str, dict[str, int]] = {}
# the steps whose memory the dryrun phase counts on meta and holds to the
# card's (MEM_ON_CARD, filled by the lm, train and fsdp phases): the
# prefill, one step of the whole model's training, rank 0 of the FSDP
# step at (2, 1); the counted temp within MEMORY_RTOL of the card's or
# MEMORY_ATOL bytes, whichever is larger, the arguments equal
MEMORY_STEPS = ("prefill", "train", "fsdp")
MEM_ON_CARD: dict[str, dict[str, int]] = {}
MEMORY_RTOL, MEMORY_ATOL = 0.02, 64 << 20


def card_memory(step, inputs, dev: torch.device) -> tuple:
    """``step()`` once, the caching allocator read around it: (what it
    returned, its record).  ``argument``: the bytes of the step's
    ``inputs`` (Σ numel × element size); ``temp``: the peak of the bytes
    requested (before the allocator rounds them) less those requested
    just before the step; ``allocated_peak``: ``max_memory_allocated``
    over the step, whole blocks (the allocator's peaks are reset for
    the step)."""
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_stats(dev)["requested_bytes.all.current"]
    torch.cuda.reset_peak_memory_stats(dev)
    out = step()
    torch.cuda.synchronize(dev)
    peak = torch.cuda.memory_stats(dev)["requested_bytes.all.peak"]
    return out, {"argument": _build.nbytes(*tensor_leaves(inputs)),
                 "temp": peak - before, "requested_before": before,
                 "allocated_peak": torch.cuda.max_memory_allocated(dev)}
KERNELS = {   # kernel -> (route, source, the TPU kernel it replaces)
    "stencil1d_vpu": ("cuda", "src/repro_torch/csrc/stencil1d.cu",
                      "src/repro/kernels/stencil1d/kernel.py:147"),
    "stencil1d_mxu": ("cuda", "src/repro_torch/csrc/stencil1d.cu",
                      "src/repro/kernels/stencil1d/kernel.py:158"),
    "stencil2d": ("cuda", "src/repro_torch/csrc/stencil2d.cu",
                  "src/repro/kernels/stencil2d/kernel.py:103"),
    "stencil3d": ("cuda", "src/repro_torch/csrc/stencil3d.cu",
                  "src/repro/kernels/stencil3d/kernel.py:97"),
    "conv1d": ("cuda", "src/repro_torch/csrc/conv1d.cu",
               "src/repro/kernels/conv1d/kernel.py:55"),
    "swa": ("cuda", "src/repro_torch/csrc/swa.cu",
            "src/repro/kernels/swa/kernel.py:99"),
    # no pallas_call: the jax.jit of the vmapped lax.while_loop(_cycle_step)
    "simbatch": ("cuda", "src/repro_torch/csrc/simbatch.cu",
                 "src/repro/core/engine/jax_engine.py:409"),
    # the backward of K5 and K6: no TPU counterpart
    "conv1d_bwd": ("cuda", "src/repro_torch/csrc/conv1d.cu",
                   "none: the JAX package defines no backward (it takes "
                   "autodiff of src/repro/kernels/conv1d/kernel.py:55)"),
    "swa_bwd_dq": ("cuda", "src/repro_torch/csrc/swa_bwd.cu",
                   "none: the JAX package defines no backward (it takes "
                   "autodiff of src/repro/kernels/swa/kernel.py:99)"),
    "swa_bwd_dkdv": ("cuda", "src/repro_torch/csrc/swa_bwd.cu",
                     "none: the JAX package defines no backward (it takes "
                     "autodiff of src/repro/kernels/swa/kernel.py:99)"),
    # the fixed-order sum of swa_bwd_dkdv's partial dK and dV
    "swa_bwd_fold": ("cuda", "src/repro_torch/csrc/swa_bwd.cu",
                     "none: the JAX package defines no backward (it takes "
                     "autodiff of src/repro/kernels/swa/kernel.py:99)"),
}
STENCIL_KERNELS = ("stencil1d_vpu", "stencil1d_mxu", "stencil2d", "stencil3d")
# sources whose register use and spills are printed from the build's log
PTXAS_SOURCES = ("conv1d", "swa", "swa_bwd", "stencil1d", "stencil2d",
                 "stencil3d", "simbatch")
# K5 is timed with a cold L2: its bf16 input at the model's shape (42 MB)
# fits the 50 MB L2, so launches on the same buffers find part of it there,
# and only a cold time stands against a bound that counts HBM bytes.  A read
# of FLUSH_L2 times the L2 between launches evicts it.
FLUSH_L2 = 4
# cycles of the kernel that holds the card after the flush while a cold
# call is issued (~0.5 ms)
COLD_SLEEP_CYCLES = 1_000_000
# the generic instances of K4 and of K1 and K2, timed at a radius that is
# not a compile-time one
GENERIC_3D_RADIUS = 3
GENERIC_1D_RADIUS = 13


@dataclasses.dataclass
class Case:
    name: str
    kernel: str
    spec: object          # the StencilSpec (grid_shape is one grid of the batch)
    x: torch.Tensor
    variant: str = "vpu"
    timed: bool = False   # the kernel's row in the `kernels` line
    y: torch.Tensor | None = None

    def run(self) -> torch.Tensor:
        """The public op a user calls."""
        if self.spec.ndim == 1:
            return stencil1d_from_spec(self.x, self.spec, variant=self.variant,
                                       backend="cuda")
        if self.spec.ndim == 2:
            return stencil2d_from_spec(self.x, self.spec, backend="cuda")
        return stencil3d(self.x, *self.spec.coeffs,
                         timesteps=self.spec.timesteps, backend="cuda")

    def plain(self) -> torch.Tensor:
        """The kernel's plain PyTorch version on the same inputs."""
        c, t = self.spec.coeffs, self.spec.timesteps
        if self.spec.ndim == 1:
            return stencil1d_ref(self.x, c[0], t)
        if self.spec.ndim == 2:
            return stencil2d_ref(self.x, c[0], c[1], t)
        return stencil3d_ref(self.x, *c, t)

    def library(self) -> torch.Tensor:
        """Yardstick: T cuDNN convolutions with the taps as a dense
        cross-shaped kernel and zero padding r (no rim mask).  In 2D and 3D
        the dense kernel does (2r+1)^2 / (2r+1)^3 taps, so it is loose."""
        spec = self.spec
        size = tuple(2 * r + 1 for r in spec.radii)
        w = torch.zeros(size, dtype=torch.float32)
        for ax, (r, coeffs) in enumerate(zip(spec.radii, spec.coeffs)):
            for k, c in enumerate(coeffs):
                idx = list(spec.radii)
                idx[ax] = k
                w[tuple(idx)] += c
        w = w.to(self.x.device, self.x.dtype)[None, None]
        conv = (F.conv1d, F.conv2d, F.conv3d)[spec.ndim - 1]
        out = self.x.reshape(-1, 1, *self.x.shape[-spec.ndim:])
        for _ in range(spec.timesteps):
            out = conv(out, w, padding=tuple(spec.radii))
        return out

    def bound(self, part: str) -> tuple[float, str]:
        """Least time (ms) the card could take for the function, whatever
        the kernel: one read and one write of the grids at HBM rate, or one
        FMA per non-zero tap per point and sweep at the FP32 datasheet rate."""
        bw, fp32 = PEAKS[part][:2]
        n = self.x.numel()
        nbytes = 2 * n * self.x.element_size()
        taps = sum(1 for cs in self.spec.coeffs for c in cs if c != 0.0)
        flops = 2 * taps * n * self.spec.timesteps
        t_bytes, t_ops = nbytes / bw * 1e3, flops / fp32 * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def read_ptxas(names) -> list[dict]:
    """Registers and spill bytes of every kernel instance in the ``nvcc``
    log kept beside each built library (``_build.NVCC_FLAGS`` has
    ``-Xptxas -v``); kernels are named as mangled, without the source's
    anonymous namespace and the argument list."""
    rows = []
    for name in names:
        for line in _build.build_log(name).splitlines():
            m = re.search(r"Compiling entry function '(\S+?)(?:EEv\S*)?'", line)
            if m:
                kernel = re.sub(r"^_ZN\d+_GLOBAL__N_\w+?_cu_[0-9a-f]{8}\d+", "",
                                m.group(1))
                rows.append({"source": f"{name}.cu", "kernel": kernel})
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m and rows:
                rows[-1]["spill_stores"] = int(m.group(1))
                rows[-1]["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and rows:
                rows[-1]["registers"] = int(m.group(1))
    return rows


def event_times(fn, reps: int, warmup: int = 2,
                flush: torch.Tensor | None = None) -> list[float]:
    """CUDA-event times (ms) of ``reps`` calls of ``fn`` after ``warmup``.
    With ``flush`` (:func:`l2_flush`), the whole buffer is read before each
    call, outside the events: the call finds none of its inputs in the L2,
    and no dirty lines there whose write-back it would pay for.  A sleeping
    kernel then holds the card while the call is issued, so the events
    hold the call's device time, not its wrapper's host time (a K5 launch
    takes longer to issue than the read of the buffer takes)."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        if flush is not None:
            flush.sum()
            torch.cuda._sleep(COLD_SLEEP_CYCLES)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in zip(starts, ends)]


def median_ms(fn, reps: int, warmup: int = 2) -> float:
    return statistics.median(event_times(fn, reps, warmup))


# cycles of the kernel that holds the device while queued calls are issued
# (~10 ms: longer than the host takes to issue QUEUED_REPS calls)
QUEUE_SLEEP_CYCLES = 20_000_000
QUEUED_REPS = 20


def queued_ms(fn, reps: int = QUEUED_REPS, warmup: int = 2) -> float:
    """Device ms of one call of ``fn`` whose kernel is shorter than its
    wrapper's host time: ``reps`` calls issued behind a sleeping kernel
    between one pair of CUDA events, so the events time the device's work
    and not the host's."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def l2_flush(dev: torch.device) -> torch.Tensor:
    """A device buffer of FLUSH_L2 times the card's L2, for cold timing."""
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    return torch.ones(FLUSH_L2 * l2 // 4, dtype=torch.float32, device=dev)


def spread(times: list[float]) -> dict:
    return {"min": min(times), "median": statistics.median(times),
            "max": max(times)}


def make_cases(dev: torch.device, seed: int) -> list[Case]:
    gen = torch.Generator(device=dev).manual_seed(seed)

    def grid(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    s1 = paper_stencil_1d(dtype="float32")                 # N=194400, r=8
    s2 = paper_stencil_2d(dtype="float32")                 # 449 x 960, r=12
    s2t4 = dataclasses.replace(s2, timesteps=4)
    s3 = star_3d(64, 64, 256, r=2, dtype="float32")
    s3d = star_3d(512, 512, 512, r=2, dtype="float32")
    bf16 = torch.bfloat16
    cases = [
        Case("paper_1d_vpu", "stencil1d_vpu", s1, grid(s1.grid_shape)),
        Case("paper_1d_mxu", "stencil1d_mxu", s1, grid(s1.grid_shape), "mxu"),
        Case("paper_2d_t1", "stencil2d", s2, grid(s2.grid_shape)),
        Case("paper_2d_t4", "stencil2d", s2t4, grid(s2.grid_shape)),
        Case("paper_3d", "stencil3d", s3, grid(s3.grid_shape)),
        Case("deploy_1d_vpu", "stencil1d_vpu", s1, grid((1024, 194400)),
             timed=True),
        Case("deploy_1d_mxu", "stencil1d_mxu", s1, grid((1024, 194400)), "mxu",
             timed=True),
        Case("deploy_2d", "stencil2d", s2, grid((256, 449, 960)), timed=True),
        Case("deploy_3d", "stencil3d", s3d, grid(s3d.grid_shape), timed=True),
        Case("deploy_1d_vpu_bf16", "stencil1d_vpu", s1,
             grid((1024, 194400), bf16)),
        Case("deploy_1d_mxu_bf16", "stencil1d_mxu", s1,
             grid((1024, 194400), bf16), "mxu"),
        Case("deploy_2d_bf16", "stencil2d", s2, grid((256, 449, 960), bf16)),
        Case("deploy_3d_bf16", "stencil3d", s3d, grid(s3d.grid_shape, bf16)),
        Case("seismic_2d_t4_bf16", "stencil2d", s2t4, grid((16, 449, 960), bf16)),
    ]
    return cases


def generic_3d(dev: torch.device, seed: int, part: str,
               failures: list[str]) -> None:
    """K4's generic instance at ``star_3d(512, 512, 512, r=3)``, f32 and
    bf16: checked against the plain version, timed, one line each."""
    spec = star_3d(512, 512, 512, r=GENERIC_3D_RADIUS, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    for dtype in (torch.float32, torch.bfloat16):
        case = Case(f"generic_3d_r{GENERIC_3D_RADIUS}", "stencil3d", spec,
                    torch.randn(spec.grid_shape, generator=gen,
                                device=dev).to(dtype))
        err = (case.run().float() - case.plain().float()).abs().max().item()
        ok = err <= TOL[dtype]
        if not ok:
            failures.append(f"{case.name} {dtype}: err vs plain {err}, tol "
                            f"{TOL[dtype]}")
        bound_ms, bound_by = case.bound(part)
        print(json.dumps({"case": case.name, "kernel": case.kernel,
                          "shape": list(case.x.shape),
                          "dtype": str(dtype).removeprefix("torch."),
                          "radii": list(spec.radii), "max_abs_err": err,
                          "tol": TOL[dtype], "ms": median_ms(case.run, reps=10),
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "ok": ok}))
        del case
        torch.cuda.empty_cache()


def stencil1d_lines(dev: torch.device, seed: int, part: str,
                    failures: list[str]) -> None:
    """K2, then K1, on (1024, 194400) at T = 4 in f32 (the paper's 17-pt
    taps: K2's compile-time instance, and K1's), and the generic instances
    at r = 13 in f32 and bf16: checked against the plain version, timed,
    one line each."""
    spec = dataclasses.replace(paper_stencil_1d(dtype="float32"), timesteps=4)
    rng = np.random.default_rng(seed + GENERIC_1D_RADIUS)
    taps = tuple((rng.normal(size=2 * GENERIC_1D_RADIUS + 1)
                  / (2 * GENERIC_1D_RADIUS + 1)).tolist())
    wide = dataclasses.replace(spec, radii=(GENERIC_1D_RADIUS,),
                               coeffs=(taps,), timesteps=1)
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    for variant in ("mxu", "vpu"):
        for name, sp, dtype in ((f"deploy_1d_{variant}_t4", spec,
                                 torch.float32),
                                (f"generic_1d_r{GENERIC_1D_RADIUS}", wide,
                                 torch.float32),
                                (f"generic_1d_r{GENERIC_1D_RADIUS}", wide,
                                 torch.bfloat16)):
            case = Case(name, f"stencil1d_{variant}", sp,
                        torch.randn((1024, 194400), generator=gen,
                                    device=dev).to(dtype), variant)
            y = case.run()
            finite = bool(torch.isfinite(y).all())
            err = (y.float() - case.plain().float()).abs().max().item()
            ok = finite and err <= TOL[dtype]
            if not ok:
                failures.append(f"{name} {case.kernel} {dtype}: finite "
                                f"{finite}, err vs plain {err}, tol "
                                f"{TOL[dtype]}")
            del y
            bound_ms, bound_by = case.bound(part)
            print(json.dumps({"case": name, "kernel": case.kernel,
                              "shape": list(case.x.shape),
                              "dtype": str(dtype).removeprefix("torch."),
                              "radius": sp.radii[0],
                              "timesteps": sp.timesteps,
                              "max_abs_err": err, "tol": TOL[dtype],
                              "ms": median_ms(case.run, reps=10),
                              "bound_ms": bound_ms, "bound_by": bound_by,
                              "ok": ok}))
            del case
            torch.cuda.empty_cache()


def lm_error(case_kernel: str, dtype: torch.dtype, y: torch.Tensor,
             want: torch.Tensor) -> tuple[bool, float, float]:
    """(within the limits, max |y - want|, ||y - want|| / ||want||)."""
    if y.shape != want.shape or y.dtype != want.dtype:
        return False, float("inf"), float("inf")
    yf, wf = y.float(), want.float()
    diff = (yf - wf).abs()
    err = diff.max().item()
    rel = (torch.linalg.vector_norm(diff)
           / torch.linalg.vector_norm(wf)).item()
    atol, rtol = LM_TOL[case_kernel][dtype]
    good = (bool(torch.isfinite(y).all())
            and bool((diff <= atol + rtol * wf.abs()).all())
            and rel <= REL_TOL.get((case_kernel, dtype), float("inf")))
    return good, err, rel


def grad_error(kernel: str, dtype: torch.dtype, g: torch.Tensor,
               want: torch.Tensor, upstream: torch.Tensor
               ) -> tuple[bool, float, float]:
    """(within GRAD_TOL, max |g - want|, ||g - want|| / max(||want||,
    ||upstream|| / 10)) of one gradient, ``upstream`` the output's gradient
    it came from; also refuses a wrong shape or type and a non-finite value.
    A gradient smaller than a tenth of the upstream one (one that is 0 by
    the algebra, as dq and dk at S = 1 or window 1, where dS = P (dP - D)
    cancels) is held against that tenth: its rounding scales with the
    products that cancel, not with itself."""
    if g.shape != want.shape or g.dtype != want.dtype:
        return False, float("inf"), float("inf")
    gf, wf, uf = g.float(), want.float(), upstream.float()
    diff = (gf - wf).abs()
    err = diff.max().item() if diff.numel() else 0.0
    scale = max(wf.abs().max().item() if wf.numel() else 0.0,
                uf.abs().max().item() / 10)
    rel = (torch.linalg.vector_norm(diff).item()
           / max(torch.linalg.vector_norm(wf).item(),
                 torch.linalg.vector_norm(uf).item() / 10))
    rel_tol, max_tol = GRAD_TOL[(kernel, dtype)]
    good = (bool(torch.isfinite(g).all()) and rel <= rel_tol
            and err <= max_tol * scale)
    return good, err, rel


@dataclasses.dataclass
class LMCase:
    """K5 or K6 at the model's shapes."""
    kernel: str
    dtype: torch.dtype
    args: tuple
    window: int = 0
    bias: torch.Tensor | None = None    # conv1d: the (C,) bias the op adds

    def run(self) -> torch.Tensor:
        """The kernel's wrapper (conv1d without the bias the op adds after)."""
        if self.kernel == "conv1d":
            return conv1d_kernel(*self.args)
        return sliding_window_attention(*self.args, window=self.window,
                                        backend="cuda")

    def op(self) -> torch.Tensor:
        """conv1d as the model calls it: one launch, the bias fused."""
        return causal_conv1d(*self.args, self.bias, backend="cuda")

    def plain(self) -> torch.Tensor:
        if self.kernel == "conv1d":
            return conv1d_ref(*self.args)
        return swa_plain(*(a.contiguous() for a in self.args),
                         window=self.window)

    def library(self) -> torch.Tensor:
        """Yardstick only: one PyTorch call for the same function."""
        if self.kernel == "conv1d":
            x, w = self.args
            k, c = w.shape
            y = F.conv1d(x.transpose(1, 2), w.T[:, None, :], groups=c,
                         padding=k - 1)
            return y[..., :x.shape[1]].transpose(1, 2)
        q, k, v = self.args
        s = q.shape[2]
        i = torch.arange(s, device=q.device)[:, None]
        j = torch.arange(s, device=q.device)[None, :]
        band = (j <= i) & (j > i - self.window)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=band,
                                              enable_gqa=True)

    def bound(self, part: str) -> tuple[float, str, str]:
        """(ms, "bytes" or "operations", the peak the operations' time is
        taken at)."""
        bw, fp32 = PEAKS[part][:2]
        if self.kernel == "conv1d":        # the wrappers' own counts
            ops, nbytes = conv1d_work(*self.args)
            t_ops, peak = ops / fp32 * 1e3, "FP32 cores"
        else:
            ops, nbytes = swa_work(*self.args[:2], self.window)
            t_ops, peak = ops_bound(ops, self.dtype, part)
        t_bytes = nbytes / bw * 1e3
        if t_bytes >= t_ops:
            return t_bytes, "bytes", peak
        return t_ops, "operations", peak


def lm_kernel_cases(dev: torch.device, seed: int) -> list[LMCase]:
    cfg = get_config(ARCH)
    b, s = PREFILL_BATCH, PREFILL_SEQ
    c, kk = cfg.lru_width, cfg.conv_width
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)
        cases.append(LMCase("conv1d", dtype, (rnd(b, s, c), rnd(kk, c)),
                            bias=rnd(c)))
        # (B, S, H, D) viewed as (B, H, S, D), as attend_local passes them
        cases.append(LMCase("swa", dtype, tuple(
            rnd(b, s, h, d).transpose(1, 2) for h in (hq, hkv, hkv)),
            cfg.window))
    return cases


def time_host(fn, reps: int) -> float:
    """Median wall ms of ``fn`` ending in a synchronise, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# kernel-name groups of the profile, first match wins; the MoE's dispatch
# and combine are told apart by the model's profiler range (MOE_DISPATCH)
PROFILE_GROUPS = (
    ("K6 swa backward", ("swa_bwd_",)),
    ("K5 conv1d backward (dx, dw, db)", ("conv1d_bwd_",)),
    ("K6 swa", ("swa_wgmma_kernel", "swa_f32_kernel")),
    ("K5 conv1d", ("conv1d_vec_kernel", "conv1d_generic_kernel")),
    ("attention softmax", ("softmax",)),
    ("matmul", ("gemm", "xmma", "cutlass", "gemv", "splitk", "nvjet")),
    ("copy/cast", ("copy", "cat", "memcpy", "memset", "fill")),
    ("reduce", ("reduce",)),
)
MOE_GROUP = "moe dispatch/combine"
# profiler ranges whose kernels form a group of their own (the loss's
# forward: its backward kernels go by their names)
RANGE_GROUPS = {MOE_DISPATCH: MOE_GROUP, OPTIMIZER_RANGE: "optimizer",
                LOSS_RANGE: "loss (forward)"}


def device_profile(fn) -> dict:
    """One run of ``fn`` under ``torch.profiler``: wall ms, the device's busy
    ms (the kernels' own device time; one stream) and idle share, the busy
    ms split into ``RANGE_GROUPS`` (every kernel launched inside the
    model's ``MOE_DISPATCH`` ranges, the train step's optimizer and loss
    ranges) and, for every other kernel, its name's group of
    ``PROFILE_GROUPS`` or elementwise, and the
    ten kernels that took most.  ``busy_ms_by_device_events`` sums the
    device events themselves: it must agree with the walk."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups: dict[str, list] = {}
    kernels: dict[tuple[str, str], list] = {}

    def walk(ev, label):
        label = RANGE_GROUPS.get(ev.name, label)
        for k in ev.kernels:
            if k.name in RANGE_GROUPS:
                continue
            n = k.name.lower()
            group = label or next((g for g, words in PROFILE_GROUPS
                                   if any(w in n for w in words)),
                                  "elementwise")
            for acc in (groups.setdefault(group, [0.0, 0]),
                        kernels.setdefault((group, k.name[:90]), [0.0, 0])):
                acc[0] += k.duration / 1e3
                acc[1] += 1
        for ch in ev.cpu_children:
            walk(ch, label)

    events = prof.events()
    for ev in events:
        if ev.device_type.name == "CPU" and ev.cpu_parent is None:
            walk(ev, None)
    busy_ms = sum(g[0] for g in groups.values())
    by_events = sum(e.self_device_time_total for e in events
                    if e.device_type.name == "CUDA"
                    and e.name not in RANGE_GROUPS) / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "busy_ms_by_device_events": by_events,
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "by_group": {k: {"ms": v[0], "launches": v[1],
                             "share": v[0] / busy_ms if busy_ms else 0.0}
                         for k, v in sorted(groups.items(),
                                            key=lambda kv: -kv[1][0])},
            "top_kernels": [{"group": g, "kernel": n, "ms": v[0],
                             "launches": v[1]}
                            for (g, n), v in sorted(
                                kernels.items(), key=lambda kv: -kv[1][0])[:10]]}


def prefill_setup(dev: torch.device, seed: int) -> tuple:
    """The lm phase's prefill of RecurrentGemma-2B, (PREFILL_BATCH,
    PREFILL_SEQ), on ``dev``; on meta, for the dryrun phase's count, its
    weights unset: (the model, the prefill to call, its inputs: the
    parameters and the batch)."""
    cfg = get_config(ARCH)
    model = build_model(cfg, device=dev)
    if dev.type != "meta":
        model.init(torch.Generator(device=dev).manual_seed(seed))
    batch = input_arrays(cfg, ShapeSpec("prefill_chip", PREFILL_SEQ,
                                        PREFILL_BATCH, "prefill"), seed,
                         device=dev)
    prefill = make_prefill(model, cfg)
    return model, (lambda: prefill(batch)), (list(model.parameters()), batch)


def lm_phase(dev: torch.device, seed: int, part: str,
             failures: list[str]) -> list[dict]:
    """K5/K6 at the model's shapes, then prefill, serving and the
    kernel-free decode check of recurrentgemma-2b; returns the K5/K6 rows of
    the ``kernels`` line, whose launches are the prefill's."""
    cfg = get_config(ARCH)

    # -- K5/K6 at the model's shapes against their plain versions ---------
    cases = lm_kernel_cases(dev, seed)
    errs = {}
    with torch.inference_mode():
        for case in cases:
            checks = [("kernel", case.run(), case.plain())]
            if case.bias is not None:       # the op as the model calls it
                fused = case.op()
                checks.append(("op with bias", fused,
                               conv1d_ref(*case.args, case.bias)))
                # the fused bias has the bits of the kernel and a bias
                # added after it, in f32, as the op added it before
                unfused = (case.run().float()
                           + case.bias.float()).to(case.dtype)
                exact = torch.equal(fused, unfused)
                if not exact:
                    failures.append(f"conv1d op {case.dtype}: fused bias "
                                    "differs from the kernel + bias")
                print(json.dumps({
                    "case": "model_conv1d", "kernel": "conv1d",
                    "checked": "fused bias against kernel + bias",
                    "dtype": str(case.dtype).removeprefix("torch."),
                    "bit_exact": exact, "ok": exact}))
            for what, y, want in checks:
                good, err, rel = lm_error(case.kernel, case.dtype, y, want)
                # K6 writes its output in q's layout, which the prefill reads
                layout_ok = (case.kernel != "swa"
                             or y.stride() == case.args[0].stride())
                good = good and layout_ok
                errs.setdefault((case.kernel, case.dtype), err)
                atol, rtol = LM_TOL[case.kernel][case.dtype]
                rel_tol = REL_TOL.get((case.kernel, case.dtype))
                if not good:
                    failures.append(f"{case.kernel} {what} {case.dtype}: max "
                                    f"err vs plain {err} (atol {atol}, rtol "
                                    f"{rtol}), rel err {rel} (tol {rel_tol}), "
                                    f"output in q's layout {layout_ok}")
                print(json.dumps({
                    "case": f"model_{case.kernel}", "kernel": case.kernel,
                    "checked": what,
                    "shape": [list(a.shape) for a in case.args],
                    "dtype": str(case.dtype).removeprefix("torch."),
                    "max_abs_err": err, "atol": atol, "rtol": rtol,
                    "rel_err": rel, "rel_tol": rel_tol,
                    "strides": list(y.stride()), "ok": good}))

    # -- prefill at published width and depth, counted ---------------------
    model, prefill, (params, batch) = prefill_setup(dev, seed)
    n_params = sum(p.numel() for p in params)
    torch.cuda.synchronize()
    _build.reset_launches()
    logits = prefill()
    torch.cuda.synchronize()
    launches = {k: _build.LAUNCHES.get(k, 0) for k in PREFILL_LAUNCHES}
    ON_CARD["prefill"] = launches
    want_shape = (PREFILL_BATCH, PREFILL_SEQ, cfg.vocab_size)
    finite = bool(torch.isfinite(logits).all())
    ok = (launches == PREFILL_LAUNCHES and tuple(logits.shape) == want_shape
          and logits.dtype == torch.float32 and finite)
    if not ok:
        failures.append(f"prefill: launches {launches} (want "
                        f"{PREFILL_LAUNCHES}), logits {tuple(logits.shape)} "
                        f"{logits.dtype}, finite {finite}")
    del logits
    # a second call, the first's costs held, its memory read for the
    # dryrun phase's count on meta
    logits, MEM_ON_CARD["prefill"] = card_memory(prefill, (params, batch),
                                                 dev)
    del logits
    ms = time_host(prefill, reps=3)
    tokens = PREFILL_BATCH * PREFILL_SEQ
    print(json.dumps({"phase": "prefill", "arch": ARCH,
                      "layers": cfg.num_layers, "d_model": cfg.d_model,
                      "params": n_params, "param_dtype": cfg.param_dtype,
                      "dtype": cfg.dtype, "tokens": list(batch["tokens"].shape),
                      "reduced": "seq 4096 and batch 2, cut from prefill_32k's "
                                 "(32, 32768): its f32 logits alone are 1 TB",
                      "launches": launches, "logits_finite": finite,
                      "ms": ms, "tokens_per_s": tokens / ms * 1e3, "ok": ok}))
    print(json.dumps({"phase": "prefill_profile",
                      **device_profile(prefill)}))

    # -- serving at full width and depth -----------------------------------
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               size=8).tolist(), max_new=8)
            for i in range(4)]
    engine = BatchEngine(model, cfg, batch_slots=2, cache_len=128)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = engine.run(reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    n_tok = sum(len(r.out) for r in done)
    ok = len(done) == 4 and all(r.done and len(r.out) == 8 for r in done)
    if not ok:
        failures.append(f"serving: {len(done)}/4 requests completed")
    print(json.dumps({"phase": "serve", "arch": ARCH, "requests": len(reqs),
                      "completed": len(done), "slots": 2, "prompt": 8,
                      "max_new": 8, "tokens": n_tok, "steps": engine.step_count,
                      "s": serve_s, "tokens_per_s": n_tok / serve_s,
                      "ok": ok}))
    step = make_decode_step(model, cfg)
    cache = model.init_cache(2, 128)
    one = torch.zeros((2, 1), dtype=torch.int64, device=dev)
    print(json.dumps({"phase": "decode_step_profile", "batch": 2,
                      **device_profile(lambda: step(cache, one, 0))}))
    del cache
    del model, engine, prefill, params
    torch.cuda.empty_cache()

    # -- kernel-free check: decode token by token against forward -----------
    cfg5 = dataclasses.replace(cfg, num_layers=DECODE_LAYERS, dtype="float32")
    m5 = build_model(cfg5, device=dev)
    m5.init(torch.Generator(device=dev).manual_seed(seed + 1))
    toks = torch.as_tensor(np.random.default_rng(seed + 1).integers(
        0, cfg5.vocab_size, size=(1, DECODE_SEQ)), device=dev)
    with torch.inference_mode():
        full, _ = m5(toks)
        cache = m5.init_cache(1, DECODE_SEQ)
        _build.reset_launches()
        err = torch.zeros((), device=dev)
        t0 = time.perf_counter()
        for t in range(DECODE_SEQ):
            lg, cache = m5.decode(cache, toks[:, t:t + 1])
            err = torch.maximum(err, (lg[:, 0] - full[:, t]).abs().max())
        err = err.item()
        decode_s = time.perf_counter() - t0
    decode_launches = sum(_build.LAUNCHES.values())
    ok = err <= DECODE_TOL and decode_launches == 0
    if not ok:
        failures.append(f"decode vs forward: max err {err} (tol {DECODE_TOL}), "
                        f"{decode_launches} kernel launches in decode")
    print(json.dumps({"phase": "decode_vs_forward", "arch": ARCH,
                      "layers": DECODE_LAYERS, "d_model": cfg5.d_model,
                      "dtype": cfg5.dtype, "seq": DECODE_SEQ,
                      "window": cfg5.window,
                      "reduced": f"depth cut to {DECODE_LAYERS} layers (one "
                                 "period + the 2-layer tail)",
                      "max_abs_err": err, "tol": DECODE_TOL,
                      "decode_launches": decode_launches,
                      "decode_ms_per_token": decode_s / DECODE_SEQ * 1e3,
                      "ok": ok}))
    del m5, full, cache
    torch.cuda.empty_cache()

    # -- timing of K5/K6 (not counted above) -------------------------------
    # K5 cold (every time of it; FLUSH_L2), its warm time beside it
    rows = []
    timed = {}
    flush = l2_flush(dev)
    with torch.inference_mode():
        for case in cases:
            k5 = case.kernel == "conv1d"
            cold = flush if k5 else None
            times = event_times(case.run, 20, flush=cold)
            t = {"ms": statistics.median(times),
                 "plain_ms": statistics.median(event_times(case.plain, 5,
                                                           flush=cold)),
                 "library_ms": statistics.median(event_times(case.library, 5,
                                                             flush=cold))}
            if k5:
                warm = event_times(case.run, 20)
                t.update(cold=spread(times), warm=spread(warm),
                         ms_warm=statistics.median(warm),
                         op_ms=statistics.median(event_times(case.op, 20,
                                                             flush=flush)),
                         instance=dataclasses.asdict(
                             launch_plan(*case.args)))
            t["bound_ms"], t["bound_by"], t["bound_peak"] = case.bound(part)
            dt = str(case.dtype).removeprefix("torch.")
            # the yardstick computes the same function (printed, not gated)
            library_err = (case.library().float()
                           - case.plain().float()).abs().max().item()
            print(json.dumps({"case": f"model_{case.kernel}_{dt}", **t,
                              "library_err": library_err}))
            timed[(case.kernel, case.dtype)] = t
    del flush
    for case in cases:
        if case.dtype != torch.bfloat16:        # the prefill's type is bf16
            continue
        t = timed[(case.kernel, case.dtype)]
        f32 = timed[(case.kernel, torch.float32)]
        route, source, replaces = KERNELS[case.kernel]
        rows.append({
            "name": case.kernel, "route": route, "source": source,
            "replaces": replaces, "launches": launches[case.kernel],
            "dtype": "bfloat16", "max_abs_err": errs[(case.kernel, case.dtype)],
            "tol": LM_TOL[case.kernel][case.dtype][0],
            "max_abs_err_f32": errs[(case.kernel, torch.float32)],
            "tol_f32": LM_TOL[case.kernel][torch.float32][0],
            **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")},
            **{k: t[k] for k in ("ms_warm", "op_ms", "instance") if k in t},
            "ms_f32": f32["ms"], "bound_ms_f32": f32["bound_ms"],
            "bound_by_f32": f32["bound_by"], "bound_peak_f32": f32["bound_peak"],
            "library_ms_f32": f32["library_ms"],
            **{f"{k}_f32": f32[k] for k in ("ms_warm", "op_ms") if k in f32},
            "shape": [list(a.shape) for a in case.args], "part": part})
    return rows


# -- training: K5's and K6's backward, a whole step, RecurrentGemma-2B -------
TRAIN_BATCH, TRAIN_SEQ = 1, 4096          # S twice K6's window
TRAIN_STEPS = 4                           # timed; one more runs profiled
TRAIN_REMAT = "dots"
STEP_LAYERS = 3                           # one period: rglru, rglru, local
# a whole step through the kernels against the same step through the plain
# versions, bf16 activations at full width (set before the first run on
# the card): loss relative 1e-3, each gradient leaf norm-relative 5e-2, and
# each leaf of the first moment after the step, (1 - b1) x the clipped
# gradient the step took, at the same bar.  The updated weights hold
# nothing: a first Adam step from zero moments moves each element by
# lr * g / |g|, so any two gradients leave the weights within 2 x lr.
STEP_LOSS_RTOL, STEP_GRAD_RTOL = 1e-3, 5e-2
TRAIN_CLI_ARGS = ("--arch", "tinyllama-1.1b", "--reduced", "--steps", "8",
                  "--ckpt-every", "3", "--log-every", "1")
TRAIN_CLI_RESUME_STEP = 3
GRAD_NAMES = {"conv1d": ("dx", "dw", "db"), "swa": ("dq", "dk", "dv")}


def train_launches(cfg, remat: str) -> dict[str, int]:
    """Launches of each LM kernel in one train step: the forward's K5 and
    K6 once a layer, again where remat reruns the layer's forward in the
    backward pass (a ctypes launch is no aten op, so selective remat
    recomputes it too), and each backward once a layer (K5's one launch
    for dx, dw and db; K6's fold of its partial dK and dV too)."""
    kinds = [cfg.kind_of_layer(i) for i in range(cfg.num_layers)]
    n_rec, n_loc = kinds.count("rglru"), kinds.count("local")
    fwd = 1 if remat == "none" else 2
    return {"conv1d": n_rec * fwd, "conv1d_bwd": n_rec,
            "swa": n_loc * fwd, "swa_bwd_dq": n_loc, "swa_bwd_dkdv": n_loc,
            "swa_bwd_fold": n_loc}


@dataclasses.dataclass
class BwdCase:
    """K5's or K6's backward at the model's shapes: args are the forward's
    inputs and last the output's gradient."""
    kernel: str
    dtype: torch.dtype
    args: tuple
    window: int = 0

    def forward(self, *leaves):
        if self.kernel == "conv1d":
            return causal_conv1d(*leaves, backend="cuda")
        return sliding_window_attention(*leaves, window=self.window,
                                        backend="cuda")

    def op_grads(self) -> tuple:
        """The op's autograd: the kernels' path the model takes."""
        leaves = [a.detach().requires_grad_() for a in self.args[:-1]]
        return torch.autograd.grad(self.forward(*leaves), leaves,
                                   self.args[-1])

    def plain(self) -> tuple:
        if self.kernel == "conv1d":
            return conv1d_bwd_ref(*self.args[:3], self.args[3])
        return swa_bwd_ref(*self.args[:3], self.args[3], window=self.window)


def bwd_cases(dev: torch.device, seed: int) -> list[BwdCase]:
    cfg = get_config(ARCH)
    b, s = TRAIN_BATCH, TRAIN_SEQ
    c, kk = cfg.lru_width, cfg.conv_width
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)
        cases.append(BwdCase("conv1d", dtype, (rnd(b, s, c), rnd(kk, c),
                                               rnd(c), rnd(b, s, c))))
        # (B, S, H, D) viewed as (B, H, S, D), as attend_local passes them
        cases.append(BwdCase("swa", dtype, tuple(
            rnd(b, s, h, d).transpose(1, 2) for h in (hq, hkv, hkv, hq)),
            cfg.window))
    return cases


def bwd_timings(case: BwdCase, part: str, flush) -> dict[str, dict]:
    """ms (median of CUDA events), plain ms, library ms and bound of each
    backward kernel of ``case``; K5's whole backward also with whether two
    calls gave equal bits."""
    bw, fp32 = PEAKS[part][:2]

    def bound(flops, nb, dtype=None):
        """(ms, "bytes" or "operations", the operations' peak): ``dtype``
        for matrix products (``ops_bound``), else FP32 cores."""
        t_ops, peak = (ops_bound(flops, dtype, part) if dtype is not None
                       else (flops / fp32 * 1e3, "FP32 cores"))
        t_bytes = nb / bw * 1e3
        return ((t_bytes, "bytes", peak) if t_bytes >= t_ops
                else (t_ops, "operations", peak))

    def med(fn, reps, cold=None):
        return statistics.median(event_times(fn, reps, flush=cold))

    out = {}
    if case.kernel == "conv1d":
        x, w, bb, dy = case.args
        k, c = w.shape
        # the library's whole backward: one autograd.grad of the grouped
        # conv for x, w and b together
        leaves = [x.transpose(1, 2).detach().requires_grad_(),
                  w.T[:, None, :].detach().requires_grad_(),
                  bb.detach().requires_grad_()]
        lib = F.conv1d(*leaves, groups=c, padding=k - 1)[..., :x.shape[1]]
        dyt = dy.transpose(1, 2)
        first = conv1d_bwd(x, dy, w, bb)
        again = conv1d_bwd(x, dy, w, bb)
        out["conv1d_bwd"] = dict(
            ms=med(lambda: conv1d_bwd(x, dy, w, bb), 20, flush),
            plain_ms=med(lambda: conv1d_bwd_ref(x, w, bb, dy), 5, flush),
            library_ms=med(lambda: torch.autograd.grad(
                lib, leaves, dyt, retain_graph=True), 5, flush),
            bound=bound(*conv1d_bwd_work(x, w, bb)),
            bit_equal_twice=all(torch.equal(a, b)
                                for a, b in zip(first, again)),
            # dx keeps the bits of K5 on the time-reversed gradient
            dx_equals_k5_flipped=torch.equal(first[0], conv1d_kernel(
                dy.flip(1).contiguous(), w).flip(1)))
        return out
    q, k, v, do = case.args
    b, hq, s, d = q.shape
    pairs = band_pairs(s, case.window) * b * hq * 2 * d    # flops a product
    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    o = sliding_window_attention(q, k, v, window=case.window, backend="cuda")
    _, lse, delta = swa_bwd_dq(q, k, v, o, do, window=case.window)
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    band = (j <= i) & (j > i - case.window)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    lib = F.scaled_dot_product_attention(*leaves, attn_mask=band,
                                         enable_gqa=True)
    plain = swa_ref(*leaves, window=case.window)
    # the whole backward: every launch (dq, dkdv and the fold) against the
    # one library backward of q, k and v
    whole = dict(
        sum_ms=med(lambda: swa_bwd_kernel(q, k, v, o, do,
                                          window=case.window), 5),
        library_bwd_ms=med(lambda: torch.autograd.grad(
            lib, leaves, do, retain_graph=True), 5))
    # swa_bwd_dkdv is timed alone, on partial sums, and its fold apart
    for name, wrt, fn in (
            ("swa_bwd_dq", leaves[:1],
             lambda: swa_bwd_dq(q, k, v, o, do, window=case.window)),
            ("swa_bwd_dkdv", leaves[1:],
             lambda: swa_bwd_dkdv_partial(q, k, v, do, lse, delta,
                                          window=case.window))):
        out[name] = dict(
            ms=med(fn, 5),
            plain_ms=med(lambda: torch.autograd.grad(
                plain, wrt, do, retain_graph=True), 3),
            library_ms=med(lambda: torch.autograd.grad(
                lib, wrt, do, retain_graph=True), 5),
            bound=bound(*swa_bwd_work(name, q, k, case.window), case.dtype),
            # the whole backward's own bound: 5 products (QK^T, dO V^T,
            # dP K, dS^T Q, P^T dO); the split without atomics adds two
            whole_bound_ms=bound(5 * pairs, nbytes(q, k, v, o, do, q, k, v),
                                 case.dtype)[0], **whole)
    part = swa_bwd_dkdv_partial(q, k, v, do, lse, delta, window=case.window)
    got, want = swa_bwd_fold(part, k, v), swa_bwd_fold_ref(part, k.dtype)
    err = max((g.float() - w.float()).abs().max().item()
              for g, w in zip(got, want))
    # a ~13 µs kernel: timed queued, as its wrapper's host time is longer
    out["swa_bwd_fold"] = dict(
        ms=queued_ms(lambda: swa_bwd_fold(part, k, v)),
        plain_ms=queued_ms(lambda: swa_bwd_fold_ref(part, k.dtype)),
        library_ms=None, max_abs_err=err,
        bound=bound(*swa_bwd_fold_work(part, k)), **whole)
    return out


@contextlib.contextmanager
def plain_lm_ops():
    """The model's K5 and K6 call sites bound to their plain versions (and
    autograd through them) for the whole-step comparison; restored after."""
    saved = model_rglru.causal_conv1d, model_attention.sliding_window_attention
    model_rglru.causal_conv1d = conv1d_ref
    model_attention.sliding_window_attention = swa_plain
    try:
        yield
    finally:
        (model_rglru.causal_conv1d,
         model_attention.sliding_window_attention) = saved


def whole_step_check(dev: torch.device, seed: int,
                     failures: list[str]) -> None:
    """One period of RecurrentGemma-2B at full width, bf16 activations, on
    (1, 4096): the loss's gradients and one make_train_step through the
    kernels, and again through the plain versions, from the same weights
    and batch."""
    cfg = dataclasses.replace(get_config(ARCH), num_layers=STEP_LAYERS)
    opt_cfg = OptConfig(warmup_steps=1, total_steps=2)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                                  seed=seed, pattern="markov"))
    batch = {k: torch.as_tensor(v, dtype=torch.int64, device=dev)
             for k, v in data.next_batch().items()}
    res = {}
    for path in ("kernels", "plain"):
        model = build_model(cfg, device=dev)
        model.init(torch.Generator(device=dev).manual_seed(seed + 2))
        ctx = plain_lm_ops() if path == "plain" else contextlib.nullcontext()
        with ctx:
            _build.reset_launches()
            total, (loss, aux) = make_loss_fn(model, cfg, TRAIN_REMAT)(batch)
            grads = torch.autograd.grad(total, list(model.parameters()))
            params = dict(model.named_parameters())
            opt = init_opt_state(params, opt_cfg)
            opt, met = make_train_step(model, cfg, opt_cfg,
                                       remat=TRAIN_REMAT)(opt, batch)
            torch.cuda.synchronize()
            launches = {k: _build.LAUNCHES.get(k, 0)
                        for k in train_launches(cfg, TRAIN_REMAT)}
        res[path] = dict(loss=float(loss.detach()), aux=float(aux.detach()),
                         step_loss=float(met["loss"]),
                         grads=dict(zip(params, grads)), launches=launches,
                         m=opt.m)
        del model, opt, params, grads
    k, p = res["kernels"], res["plain"]

    def norm_rel(got, want):
        return {n: (torch.linalg.vector_norm(g.float() - want[n].float())
                    / torch.linalg.vector_norm(want[n].float())).item()
                for n, g in got.items()}
    rels, m_rels = norm_rel(k["grads"], p["grads"]), norm_rel(k["m"], p["m"])
    worst, worst_m = max(rels, key=rels.get), max(m_rels, key=m_rels.get)
    want = {n: 2 * c for n, c in train_launches(cfg, TRAIN_REMAT).items()}
    loss_rel = abs(k["loss"] - p["loss"]) / abs(p["loss"])
    ok = (loss_rel <= STEP_LOSS_RTOL and k["aux"] == p["aux"] == 0.0
          and k["step_loss"] == k["loss"] and rels[worst] <= STEP_GRAD_RTOL
          and m_rels[worst_m] <= STEP_GRAD_RTOL and k["launches"] == want
          and sum(p["launches"].values()) == 0)
    if not ok:
        failures.append(f"train_step_check: loss {k['loss']} vs plain "
                        f"{p['loss']} (rel {loss_rel}), worst gradient "
                        f"{worst} rel {rels[worst]}, worst first moment "
                        f"{worst_m} rel {m_rels[worst_m]}, "
                        f"launches {k['launches']} "
                        f"(want {want}), plain path {p['launches']}")
    print(json.dumps({
        "phase": "train_step_check", "arch": ARCH, "layers": STEP_LAYERS,
        "d_model": cfg.d_model, "dtype": cfg.dtype,
        "tokens": [TRAIN_BATCH, TRAIN_SEQ], "remat": TRAIN_REMAT,
        "loss": k["loss"], "loss_plain": p["loss"], "loss_rel": loss_rel,
        "loss_rtol": STEP_LOSS_RTOL, "aux": k["aux"],
        "worst_grad": worst, "worst_grad_rel": rels[worst],
        "grad_rtol": STEP_GRAD_RTOL,
        "median_grad_rel": statistics.median(rels.values()),
        "worst_moment": worst_m, "worst_moment_rel": m_rels[worst_m],
        "launches": k["launches"], "launches_plain_path": p["launches"],
        "ok": ok}))
    del res, k, p
    torch.cuda.empty_cache()


def train_setup(dev: torch.device, seed: int, steps: int) -> tuple:
    """The train phase's RecurrentGemma-2B at its published width and
    depth on ``dev``, AdamW for TRAIN_STEPS + 1 steps and ``steps``
    SyntheticLM markov batches of (TRAIN_BATCH, TRAIN_SEQ); on meta, for
    the dryrun phase's count, its weights unset: (the model, its
    parameters, the optimizer's state, the step function, the
    batches)."""
    cfg = get_config(ARCH)
    model = build_model(cfg, device=dev)
    if dev.type != "meta":
        model.init(torch.Generator(device=dev).manual_seed(seed))
    params = dict(model.named_parameters())
    opt_cfg = OptConfig(warmup_steps=2, total_steps=TRAIN_STEPS + 1)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                                  seed=seed, pattern="markov"))
    batches = [{k: torch.as_tensor(v, dtype=torch.int64, device=dev)
                for k, v in data.next_batch().items()}
               for _ in range(steps)]
    return (model, params, init_opt_state(params, opt_cfg),
            make_train_step(model, cfg, opt_cfg, remat=TRAIN_REMAT), batches)


def full_training(dev: torch.device, seed: int,
                  failures: list[str]) -> dict[str, int]:
    """RecurrentGemma-2B at its published width and depth trains on
    SyntheticLM markov batches of (1, 4096) for TRAIN_STEPS counted, timed
    steps, then one more under torch.profiler; returns the counted steps'
    launches."""
    cfg = get_config(ARCH)
    model, params, state, step_fn, batches = train_setup(dev, seed,
                                                         TRAIN_STEPS + 1)
    n_params = sum(p.numel() for p in params.values())
    opt = [state]
    del state
    losses, times = [], []

    def step(batch):
        opt[0], met = step_fn(opt[0], batch)
        losses.append(float(met["loss"]))        # synchronises
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    peak = 0            # over every step: card_memory resets the count
    for i, batch in enumerate(batches[:TRAIN_STEPS]):
        t0 = time.perf_counter()
        if i == 1:      # the second step's memory, for the dryrun phase
            peak = torch.cuda.max_memory_allocated(dev)
            _, MEM_ON_CARD["train"] = card_memory(
                lambda: step(batch), (params, opt[0], batch), dev)
        else:
            step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {k: _build.LAUNCHES.get(k, 0)
                for k in train_launches(cfg, TRAIN_REMAT)}
    ON_CARD["train"] = {k: n // TRAIN_STEPS for k, n in launches.items()}
    peak = max(peak, torch.cuda.max_memory_allocated(dev))
    want = {k: TRAIN_STEPS * n for k, n in
            train_launches(cfg, TRAIN_REMAT).items()}
    step_ms = statistics.median(times[1:])
    finite = all(np.isfinite(losses))
    ok = finite and launches == want
    if not ok:
        failures.append(f"train: losses {losses}, launches {launches} "
                        f"(want {want})")
    print(json.dumps({
        "phase": "train", "arch": ARCH, "layers": cfg.num_layers,
        "d_model": cfg.d_model, "params": n_params,
        "param_dtype": cfg.param_dtype, "dtype": cfg.dtype,
        "tokens": [TRAIN_BATCH, TRAIN_SEQ], "data": "SyntheticLM markov",
        "remat": TRAIN_REMAT, "steps": TRAIN_STEPS, "losses": losses,
        "step_ms": times, "step_ms_median_after_first": step_ms,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3,
        "peak_gb": peak / 1e9, "launches": launches,
        "launches_per_step": train_launches(cfg, TRAIN_REMAT),
        "reduced": "batch 1 of train_4k's (256, 4096): one card; depth "
                   "and width as published", "ok": ok}))
    prof = device_profile(lambda: step(batches[-1]))
    print(json.dumps({"phase": "train_step_profile", "loss": losses[-1],
                      **prof}))
    del model, params, opt, step_fn, batches
    torch.cuda.empty_cache()
    return launches


def train_cli_resume(failures: list[str]) -> None:
    """launch.train on the card: 8 steps with a checkpoint every 3, the
    checkpoints after step 3 deleted, the same command with --resume: its
    losses for steps 3-7 must equal the first run's, bit for bit."""
    ck = ROOT / "build" / "chip_train_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    argv = [*TRAIN_CLI_ARGS, "--ckpt-dir", str(ck)]
    t0 = time.perf_counter()
    rc1, first = train_cli.run(argv)
    steps = CheckpointManager(str(ck)).all_steps()
    for st in steps:
        if st > TRAIN_CLI_RESUME_STEP:
            shutil.rmtree(ck / f"step_{st:08d}")
    rc2, again = train_cli.run([*argv, "--resume"])
    same = again == first[TRAIN_CLI_RESUME_STEP:]
    diff = max((abs(a - b) for a, b in zip(again,
                                           first[TRAIN_CLI_RESUME_STEP:])),
               default=float("inf"))
    ok = rc1 == rc2 == 0 and same and all(np.isfinite(first))
    if not ok:
        failures.append(f"train CLI resume: rc {rc1} {rc2}, losses {first} "
                        f"then {again} (max diff {diff})")
    print(json.dumps({"phase": "train_cli_resume", "argv": argv,
                      "checkpoints": steps, "losses": first,
                      "resumed_from": TRAIN_CLI_RESUME_STEP,
                      "losses_resumed": again, "bit_equal": same,
                      "max_diff": diff, "s": time.perf_counter() - t0,
                      "ok": ok}))
    shutil.rmtree(ck, ignore_errors=True)


def train_phase(dev: torch.device, seed: int, part: str,
                failures: list[str]) -> list[dict]:
    """K5's and K6's backward at RecurrentGemma-2B's shapes against their
    plain versions, timed; a whole step against the plain versions; the
    full model trained; the CLI resumed.  Returns the backward kernels'
    rows of the ``kernels`` line, their launches the full training's."""
    t_phase = time.perf_counter()
    errs, timed = {}, {}
    flush = l2_flush(dev)
    for case in bwd_cases(dev, seed):
        dt = str(case.dtype).removeprefix("torch.")
        got, want = case.op_grads(), case.plain()
        for name, g, w in zip(GRAD_NAMES[case.kernel], got, want):
            good, err, rel = grad_error(case.kernel, case.dtype, g, w,
                                        case.args[-1])
            kernel = {"dx": "conv1d_bwd", "dw": "conv1d_bwd",
                      "db": "conv1d_bwd", "dq": "swa_bwd_dq",
                      "dk": "swa_bwd_dkdv", "dv": "swa_bwd_dkdv"}[name]
            errs[(kernel, case.dtype)] = max(errs.get((kernel, case.dtype),
                                                      0.0), err)
            rel_tol, max_tol = GRAD_TOL[(case.kernel, case.dtype)]
            if not good:
                failures.append(f"{kernel} {name} {dt}: max err {err}, rel "
                                f"{rel} (tol {rel_tol}, {max_tol} x max)")
            print(json.dumps({
                "case": f"train_{case.kernel}_bwd", "kernel": kernel,
                "grad": name, "shape": list(g.shape), "dtype": dt,
                "max_abs_err": err, "rel_err": rel, "rel_tol": rel_tol,
                "max_tol_scaled": max_tol, "ok": good}))
        del got, want
        t = bwd_timings(case, part, flush)
        for kernel, row in t.items():
            row["bound_ms"], row["bound_by"], row["bound_peak"] = row.pop("bound")
            print(json.dumps({"case": f"train_{kernel}_{dt}", **row}))
            timed[(kernel, case.dtype)] = row
            if row.get("max_abs_err", 0.0) != 0.0:     # the fold: exact
                failures.append(f"{kernel} {dt}: max err "
                                f"{row['max_abs_err']} against its plain "
                                "version (want 0)")
            for check in ("bit_equal_twice", "dx_equals_k5_flipped"):
                if not row.get(check, True):
                    failures.append(f"{kernel} {dt}: {check} is false")
        torch.cuda.empty_cache()
    del flush
    torch.cuda.empty_cache()
    if failures:
        return []
    whole_step_check(dev, seed, failures)
    launches = full_training(dev, seed, failures)
    train_cli_resume(failures)
    rows = []
    for kernel in ("conv1d_bwd", "swa_bwd_dq", "swa_bwd_dkdv",
                   "swa_bwd_fold"):
        t = timed[(kernel, torch.bfloat16)]
        f32 = timed[(kernel, torch.float32)]
        route, source, replaces = KERNELS[kernel]
        rows.append({
            "name": kernel, "route": route, "source": source,
            "replaces": replaces, "launches": launches[kernel],
            "dtype": "bfloat16",
            "max_abs_err": t.get("max_abs_err",
                                 errs.get((kernel, torch.bfloat16))),
            "tol": (0.0 if kernel == "swa_bwd_fold" else
                    GRAD_TOL[(kernel.split("_")[0], torch.bfloat16)]),
            "max_abs_err_f32": f32.get("max_abs_err",
                                       errs.get((kernel, torch.float32))),
            **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")},
            "bound_peak": t["bound_peak"],
            **{f"{k}_f32": f32[k] for k in ("ms", "plain_ms", "library_ms",
                                            "bound_ms", "bound_by",
                                            "bound_peak")},
            **({"whole_bound_ms": t["whole_bound_ms"],
                "whole_bound_ms_f32": f32["whole_bound_ms"]}
               if "whole_bound_ms" in t else {}),
            **({"sum_ms": t["sum_ms"], "library_bwd_ms": t["library_bwd_ms"],
                "sum_ms_f32": f32.get("sum_ms"),
                "library_bwd_ms_f32": f32.get("library_bwd_ms")}
               if "sum_ms" in t else {}),
            "shape": [TRAIN_BATCH, TRAIN_SEQ], "part": part})
    print(json.dumps({"phase": "train_wall",
                      "s": time.perf_counter() - t_phase}))
    return rows


# -- the other LM families: dense, MoE, RWKV-6, VLM, enc-dec -----------------
# No hand-written kernel lies on these paths (the reference runs them as XLA
# einsums, the port as PyTorch ones): the phase shows that the published
# widths build, prefill, decode and serve on the card.
FAMILY_ARCH = "granite-moe-3b-a800m"      # full width and depth
FAMILY_PREFILL = (2, 4096)                # cut from prefill_32k's (32, 32768)
FAMILY_DECODE = (2, 32)                   # B·S = 64: the forward is dropless
FAMILY_CASES = ("tinyllama-1.1b", "qwen2.5-3b", "qwen3-32b",
                "command-r-plus-104b", "qwen2-vl-2b", "rwkv6-7b",
                "granite-moe-1b-a400m", "whisper-tiny")
FAMILY_LAYERS = 2                         # whisper-tiny runs whole
FAMILY_SEQ = 256
FAMILY_DECODE_TOKENS = 8
def decode_error(model, cfg, toks: torch.Tensor,
                 frames: torch.Tensor | None = None) -> float:
    """Max |logits| difference of ``model.decode`` token by token against
    one forward over ``toks`` (B, S): vlm on the text path with the M-RoPE
    positions of tests/test_models.py, audio with the cross K/V primed from
    the encoder output."""
    b, s = toks.shape
    vlm = cfg.family == "vlm"
    with torch.inference_mode():
        if cfg.family == "audio":
            full, _ = model(toks, frames)
            cache = model.init_cache(b, s)
            enc = model.encode(frames)
            kv = [model._cross_kv(bp, enc) for bp in model.dec]
            cache["cross_k"] = torch.stack([k for k, _ in kv])
            cache["cross_v"] = torch.stack([v for _, v in kv])
        else:
            pos = (torch.arange(s, device=toks.device).expand(3, b, s)
                   if vlm else None)
            full, _ = model(toks, positions=pos)
            cache = model.init_cache(b, s)
        err = torch.zeros((), device=toks.device)
        for t in range(s):
            kw = ({"positions": torch.full((3, b, 1), t, dtype=torch.int32,
                                           device=toks.device)}
                  if vlm else {})
            lg, cache = model.decode(cache, toks[:, t:t + 1], **kw)
            err = torch.maximum(err, (lg[:, 0] - full[:, t]).abs().max())
    return err.item()


def family_model(cfg, dev: torch.device, seed: int):
    model = build_model(cfg, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(seed))
    return model


def param_stats(model) -> dict:
    return {"params": sum(p.numel() for p in model.parameters()),
            "param_bytes": sum(p.numel() * p.element_size()
                               for p in model.parameters())}


def families_phase(dev: torch.device, seed: int,
                   failures: list[str]) -> None:
    """Granite-MoE-3B-A800M at full width and depth (prefill, its profile
    split, serving, decode against forward), then every other new family at
    full width and ``FAMILY_LAYERS`` layers (whisper-tiny whole): a (1, 256)
    prefill and decode against forward over 8 tokens."""
    t_phase = time.perf_counter()
    cfg = get_config(FAMILY_ARCH)
    model = family_model(cfg, dev, seed)
    b, s = FAMILY_PREFILL
    batch = input_arrays(cfg, ShapeSpec("families", s, b, "prefill"), seed,
                         device=dev)
    prefill = make_prefill(model, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)   # the weights and the rest
    _build.reset_launches()
    logits = prefill(batch)
    torch.cuda.synchronize()
    launches = sum(_build.LAUNCHES.values())
    peak = torch.cuda.max_memory_allocated(dev) - resident
    want = (b, s, cfg.vocab_size)
    finite = bool(torch.isfinite(logits).all())
    ok = (tuple(logits.shape) == want and logits.dtype == torch.float32
          and finite)
    if not ok:
        failures.append(f"families {FAMILY_ARCH} prefill: logits "
                        f"{tuple(logits.shape)} {logits.dtype} (want {want} "
                        f"float32), finite {finite}")
    del logits
    ms = time_host(lambda: prefill(batch), reps=3)
    print(json.dumps({
        "phase": "families_prefill", "arch": FAMILY_ARCH,
        "layers": cfg.num_layers, "d_model": cfg.d_model,
        "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
        "experts": cfg.num_experts, "top_k": cfg.experts_per_token,
        "group": cfg.moe_group_size,
        "capacity": moe_capacity(cfg.moe_group_size, cfg),
        **param_stats(model), "param_dtype": cfg.param_dtype,
        "dtype": cfg.dtype, "tokens": [b, s],
        "reduced": "seq 4096 and batch 2, cut from prefill_32k's "
                   "(32, 32768): its f32 logits alone are 206 GB",
        "logits_shape": list(want), "logits_finite": finite,
        "kernel_launches": launches, "resident_bytes": resident,
        "prefill_peak_bytes": peak, "ms": ms,
        "tokens_per_s": b * s / ms * 1e3, "ok": ok}))
    print(json.dumps({"phase": "families_prefill_profile",
                      "arch": FAMILY_ARCH,
                      **device_profile(lambda: prefill(batch))}))
    del prefill, batch

    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               size=8).tolist(), max_new=8)
            for i in range(4)]
    engine = BatchEngine(model, cfg, batch_slots=2, cache_len=128)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = engine.run(reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    n_tok = sum(len(r.out) for r in done)
    ok = len(done) == 4 and all(r.done and len(r.out) == 8 for r in done)
    if not ok:
        failures.append(f"families {FAMILY_ARCH} serving: {len(done)}/4 "
                        "requests completed")
    print(json.dumps({"phase": "families_serve", "arch": FAMILY_ARCH,
                      "requests": len(reqs), "completed": len(done),
                      "slots": 2, "prompt": 8, "max_new": 8, "tokens": n_tok,
                      "steps": engine.step_count, "s": serve_s,
                      "tokens_per_s": n_tok / serve_s, "ok": ok}))
    step = make_decode_step(model, cfg)
    cache = model.init_cache(2, 128)
    one = torch.zeros((2, 1), dtype=torch.int64, device=dev)
    print(json.dumps({"phase": "families_decode_step_profile",
                      "arch": FAMILY_ARCH, "batch": 2,
                      **device_profile(lambda: step(cache, one, 0))}))
    del model, engine, cache
    torch.cuda.empty_cache()

    # decode against forward with f32 activations (the bar of PERF.md §2)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = family_model(cfg32, dev, seed)
    b, s = FAMILY_DECODE
    toks = input_arrays(cfg32, ShapeSpec("families_decode", s, b, "prefill"),
                        seed + 1, device=dev)["tokens"]
    t0 = time.perf_counter()
    err = decode_error(model, cfg32, toks)
    ok = err <= DECODE_TOL
    if not ok:
        failures.append(f"families {FAMILY_ARCH} decode vs forward: max err "
                        f"{err} (tol {DECODE_TOL})")
    print(json.dumps({"phase": "families_decode_vs_forward",
                      "arch": FAMILY_ARCH, "layers": cfg32.num_layers,
                      "d_model": cfg32.d_model, "dtype": cfg32.dtype,
                      "tokens": [b, s], "dropless": b * s <= 64,
                      "max_abs_err": err, "tol": DECODE_TOL,
                      "s": time.perf_counter() - t0, "ok": ok}))
    del model
    torch.cuda.empty_cache()

    for arch in FAMILY_CASES:
        t0 = time.perf_counter()
        full = get_config(arch)
        cfg = (full if full.family == "audio"
               else dataclasses.replace(full, num_layers=FAMILY_LAYERS))
        model = family_model(cfg, dev, seed)
        stats = param_stats(model)
        batch = input_arrays(cfg, ShapeSpec("families", FAMILY_SEQ, 1,
                                            "prefill"), seed, device=dev)
        prefill = make_prefill(model, cfg)
        logits = prefill(batch)
        torch.cuda.synchronize()
        want = (1, FAMILY_SEQ, cfg.vocab_size)
        finite = bool(torch.isfinite(logits).all())
        prefill_ok = (tuple(logits.shape) == want and finite
                      and logits.dtype == torch.float32)
        build_s = time.perf_counter() - t0
        del logits
        prefill_ms = time_host(lambda: prefill(batch), reps=3)
        del model, prefill, batch
        torch.cuda.empty_cache()

        cfg32 = dataclasses.replace(cfg, dtype="float32")
        model = family_model(cfg32, dev, seed)
        inp = input_arrays(cfg32, ShapeSpec("families_decode",
                                            FAMILY_DECODE_TOKENS, 1,
                                            "prefill"), seed + 1, device=dev)
        err = decode_error(model, cfg32, inp["tokens"], inp.get("frames"))
        del model, inp
        torch.cuda.empty_cache()
        ok = prefill_ok and err <= DECODE_TOL
        if not ok:
            failures.append(f"families {arch}: prefill logits {want} finite "
                            f"{prefill_ok}, decode vs forward max err {err} "
                            f"(tol {DECODE_TOL})")
        print(json.dumps({
            "phase": "families", "arch": arch, "family": cfg.family,
            "layers": cfg.num_layers, "encoder_layers": cfg.encoder_layers,
            "published_layers": full.num_layers, "d_model": cfg.d_model,
            "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
            "head_dim": cfg.resolved_head_dim, "vocab": cfg.vocab_size,
            "experts": cfg.num_experts, "mrope": cfg.mrope_sections,
            **stats, "prefill_tokens": [1, FAMILY_SEQ],
            "logits_ok": prefill_ok, "build_and_first_prefill_s": build_s,
            "prefill_ms": prefill_ms,
            "decode_tokens": FAMILY_DECODE_TOKENS, "max_abs_err": err,
            "tol": DECODE_TOL, "wall_s": time.perf_counter() - t0,
            "ok": ok}))
    wkv_lines(dev, seed)
    print(json.dumps({"phase": "families_wall",
                      "s": time.perf_counter() - t_phase}))


def wkv_lines(dev: torch.device, seed: int) -> None:
    """RWKV-6's WKV recurrence alone (the plain loop over the sequence) at
    rwkv6-7b's heads (64 of 64 channels): the families phase's (1, 256) and
    one layer of a (2, 4096) prefill."""
    cfg = get_config("rwkv6-7b")
    h, n = cfg.num_heads, cfg.resolved_head_dim
    g = torch.Generator(device=dev).manual_seed(seed)
    for b, s in ((1, FAMILY_SEQ), FAMILY_PREFILL):
        r, k, v = (torch.randn(b, s, h, n, generator=g, device=dev)
                   for _ in range(3))
        w = torch.rand(b, s, h, n, generator=g, device=dev)
        u = torch.randn(h, n, generator=g, device=dev)
        s0 = torch.zeros(b, h, n, n, device=dev)
        with torch.inference_mode():
            ms = time_host(lambda: wkv_scan(r, k, v, w, u, s0), reps=3)
        print(json.dumps({"phase": "families_wkv", "arch": "rwkv6-7b",
                          "shape": [b, s, h, n], "steps": s, "ms": ms,
                          "us_per_step": ms / s * 1e3}))


# -- the CGRA model (host numpy) held against K1-K4 on the card ---------------
# The three paper cases' simulations take 35-40 s of host CPU, the 2D one
# about as long as the 1D and 3D together: when those two take more than
# CGRA_SIM_BUDGET_S / 2, the three would pass the budget, and the 2D case
# runs at benchmarks/fabric_bench.py's reduced grid and workers instead.
CGRA_SIM_BUDGET_S = 90.0
CGRA_REDUCED_2D = ((32, 64), 8)
CGRA_ORACLE_TOL = 1e-9        # simulated (float64) against the numpy oracle
CGRA_MESH = (16, 16)


@dataclasses.dataclass
class CgraCase:
    name: str
    spec: StencilSpec     # the simulated spec, float64
    workers: int
    kernels: tuple        # (kernel, variant) pairs the card runs it through
    reduced: bool = False
    x: np.ndarray | None = None
    res: object = None    # the SimResult
    plan: object = None   # the simulated MappingPlan
    host_s: float = 0.0
    oracle: np.ndarray | None = None
    card: dict = dataclasses.field(default_factory=dict)


def cgra_simulate(case: CgraCase, seed: int) -> None:
    """Map and simulate one case with the vector engine, on the host."""
    case.x = np.random.default_rng(seed).normal(size=case.spec.grid_shape)
    case.plan = map_nd(case.spec, workers=case.workers)
    t0 = time.perf_counter()
    case.res = simulate(case.plan, case.x, CGRA, engine="vector")
    case.host_s = time.perf_counter() - t0
    case.oracle = stencil_reference_np(case.x, case.spec)


def cgra_simulations(seed: int) -> list[CgraCase]:
    """The paper's cases at their own sizes: 1D and 2D at w* from the §VI
    roofline on the CGRA, ``heat_3d(64, 64, 64)`` at w = 8."""
    s1, s2 = paper_stencil_1d(), paper_stencil_2d()
    cases = [CgraCase("paper_1d", s1, analyze(s1, CGRA).workers,
                      (("stencil1d_vpu", "vpu"), ("stencil1d_mxu", "mxu"))),
             CgraCase("heat_3d", heat_3d(64, 64, 64, dtype="float64"), 8,
                      (("stencil3d", "vpu"),))]
    for i, case in enumerate(cases):
        cgra_simulate(case, seed + i)
    reduced = sum(c.host_s for c in cases) > CGRA_SIM_BUDGET_S / 2
    w2 = analyze(s2, CGRA).workers
    if reduced:
        (ny, nx), w2 = CGRA_REDUCED_2D
        s2 = paper_stencil_2d(ny, nx)
    case = CgraCase("paper_2d", s2, w2, (("stencil2d", "vpu"),),
                    reduced=reduced)
    cgra_simulate(case, seed + 2)
    return cases[:1] + [case] + cases[1:]


def sim_fingerprint(plan, res) -> tuple:
    """Every observable of a simulation that interp and vector share."""
    return (res.cycles, res.fires, res.loads, res.stores, res.flops,
            res.max_queue_total, res.output.tobytes(),
            {n.name: n.fires for n in plan.dfg.nodes})


def cgra_phase(dev: torch.device, seed: int,
               failures: list[str]) -> list[CgraCase]:
    """Simulate the paper's cases, run the same inputs (cast to f32) through
    K1-K4 with the launches counted, hold the card against the simulation
    and the oracle; then interp against vector, and the network-aware mode.
    Returns the simulated cases."""
    cases = cgra_simulations(seed)
    for case in cases:
        err = float(np.abs(case.res.output - case.oracle).max())
        if err > CGRA_ORACLE_TOL:
            failures.append(f"cgra {case.name}: simulated vs oracle {err}")
    # -- the card, on the simulated inputs: counted ------------------------
    _build.reset_launches()
    outs = {}
    for case in cases:
        x32 = torch.tensor(case.x, dtype=torch.float32, device=dev)
        spec32 = dataclasses.replace(case.spec, dtype="float32")
        for kernel, variant in case.kernels:
            outs[(case.name, kernel)] = Case(case.name, kernel, spec32, x32,
                                             variant).run()
    torch.cuda.synchronize()
    launches = {k: _build.LAUNCHES.get(k, 0) for k in STENCIL_KERNELS}
    failures += [f"cgra: {k} not launched" for k, n in launches.items()
                 if n == 0]
    tol = TOL[torch.float32]
    for case in cases:
        for kernel, _variant in case.kernels:
            y = outs[(case.name, kernel)].double().cpu().numpy()
            e_sim = float(np.abs(y - case.res.output).max())
            e_oracle = float(np.abs(y - case.oracle).max())
            case.card[kernel] = {"err_vs_sim": e_sim,
                                 "err_vs_oracle": e_oracle}
            if not (np.isfinite(y).all() and e_sim <= tol
                    and e_oracle <= tol):
                failures.append(f"cgra {case.name} {kernel}: card vs "
                                f"simulated {e_sim}, vs oracle {e_oracle}, "
                                f"tol {tol}")
        r = case.res
        print(json.dumps({
            "phase": "cgra", "case": case.name,
            "grid": list(case.spec.grid_shape),
            "radii": list(case.spec.radii), "reduced": case.reduced,
            "workers": case.workers, "cycles": r.cycles, "loads": r.loads,
            "stores": r.stores, "flops": r.flops,
            "sim_gflops": r.gflops, "roofline_share": r.pct_of_roofline,
            "compute_peak_share": r.pct_of_compute_peak,
            "host_sim_s": case.host_s,
            "sim_err_vs_oracle": float(np.abs(r.output - case.oracle).max()),
            "card": case.card, "tol": tol,
            "launches": {k: launches[k] for k, _ in case.kernels}}))
    del outs
    # -- interp against vector, bit for bit --------------------------------
    quick = StencilSpec((6000,), (2,), ((0.1, 0.2, 0.4, 0.2, 0.1),),
                        dtype="float64")
    for name, spec in (("quickstart", quick),
                       ("paper_1d_2400", paper_stencil_1d(n=2400))):
        w = analyze(spec, CGRA).workers
        x = np.random.default_rng(seed).normal(size=spec.grid_shape)
        prints, walls = {}, {}
        for engine in ("interp", "vector"):
            plan = map_nd(spec, workers=w)
            t0 = time.perf_counter()
            res = simulate(plan, x, CGRA, engine=engine)
            walls[engine] = time.perf_counter() - t0
            prints[engine] = sim_fingerprint(plan, res)
        same = prints["interp"] == prints["vector"]
        if not same:
            failures.append(f"cgra_interp_vector {name}: engines differ")
        print(json.dumps({"phase": "cgra_interp_vector", "case": name,
                          "workers": w, "cycles": res.cycles,
                          "identical": same, "host_s": walls}))
    # -- network-aware mode --------------------------------------------------
    paper = cases[0]
    t0 = time.perf_counter()
    rf = route(place(map_nd(paper.spec, workers=paper.workers),
                     FabricTopology.mesh(*CGRA_MESH), seed=0))
    place_s = time.perf_counter() - t0
    st = rf.stats()
    spec = paper_stencil_1d(n=2400)
    x = np.random.default_rng(seed).normal(size=2400)
    ideal = simulate(map_nd(spec, workers=paper.workers), x, CGRA,
                     engine="vector")
    plan = map_nd(spec, workers=paper.workers)
    routed = simulate(plan, x, CGRA, engine="vector",
                      fabric=route(place(plan, FabricTopology.mesh(*CGRA_MESH),
                                         seed=0)))
    same = routed.output.tobytes() == ideal.output.tobytes()
    ok = same and routed.cycles >= ideal.cycles
    if not ok:
        failures.append(f"cgra_fabric: routed output identical {same}, "
                        f"cycles routed {routed.cycles} ideal {ideal.cycles}")
    print(json.dumps({
        "phase": "cgra_fabric", "mesh": list(CGRA_MESH), "seed": 0,
        "paper_1d": {k: st[k] for k in ("pes_used", "edges_routed",
                                         "hops_mean", "hops_max",
                                         "max_channel_load",
                                         "channel_capacity",
                                         "link_utilization")},
        "place_route_host_s": place_s, "reduced_1d": list(spec.grid_shape),
        "cycles_ideal": ideal.cycles, "cycles_routed": routed.cycles,
        "token_hops": routed.fabric["token_hops"],
        "outputs_identical": same, "ok": ok}))
    return cases


def cgra_roofline_lines(paper_ms: dict, part: str) -> None:
    """The §VI roofline of the 1D and 2D paper cases at f32, the type the
    card ran, on the CGRA, the V100 and this H100 part, beside what K1 (and
    K2) and K3 achieved at the paper shape.  Claims nothing."""
    timed = (("paper_1d", paper_stencil_1d(dtype="float32"),
              {"stencil1d_vpu": "paper_1d_vpu",
               "stencil1d_mxu": "paper_1d_mxu"}),
             ("paper_2d", paper_stencil_2d(dtype="float32"),
              {"stencil2d": "paper_2d_t1"}))
    for name, spec, kernels in timed:
        flops = spec.total_flops()
        card = {}
        for kernel, case_name in kernels.items():
            ms = paper_ms[case_name]
            gflops = flops / (ms * 1e-3) / 1e9
            card[kernel] = {"ms": ms, "gflops": gflops}
        roofs = {}
        for m in (CGRA, V100, H100[part]):
            rep = analyze(spec, m)
            roofs[m.name] = {
                "ai": rep.arithmetic_intensity,
                "bw_bound_gflops": rep.bw_bound_gflops,
                "compute_bound_gflops": rep.compute_bound_gflops,
                "achievable_gflops": rep.achievable_gflops,
                "bound": rep.bound, "workers": rep.workers}
        share = {k: v["gflops"] / roofs[H100[part].name]["achievable_gflops"]
                 for k, v in card.items()}
        print(json.dumps({"phase": "cgra_roofline", "case": name,
                          "grid": list(spec.grid_shape), "dtype": "float32",
                          "flops": flops, "roofline": roofs, "card": card,
                          "card_share_of_h100_roofline": share}))


# -- the batched cycle engine (K7) and the tuner's stage 1 on the card ---------
# benchmarks/run.py's stage-1 tuner sweep at full size (its non-smoke branch):
# heat_2d(48, 96), temporal 1-2, capacities auto/unbounded, full-grid and
# plan_blocks tiles at 2 and 8 KiB, two workload sweeps, stage 1 only.
SWEEP_BATCH = 32
SWEEP_BUDGETS = (2048, 8192)
CARRY_FIELDS = ("qlen", "maxocc", "fires", "active", "credit", "cycles",
                "status")
# K7's floor counts one block barrier a simulated cycle: a cycle needs one
# exchange across the block, since each node's eligibility reads queue
# lengths that other threads wrote the cycle before.  Nothing else needs
# the block barrier: the memory arbiter fits one warp (ballots), a queue
# length can be kept as a push count and a pop count, each written by one
# end, in buffers indexed by the cycle (so one barrier parts a cycle's
# writes from the next one's reads), and "any fired" and the completed
# cmp count can ride the barrier's reduction and such buffers.  K7 itself
# pays k7.BARRIERS_PER_CYCLE.
K7_FLOOR_BARRIERS = 1
# worker processes that run the paper 2D sweep's other lanes through the
# vector engine while the card's results are checked
VECTOR_WORKERS = 4
VECTOR_TIMEOUT_S = 600


class K7Watch:
    """What the main path hands K7 and what it gets back, observed without
    changing it: each ``k7.simbatch`` call's lanes, ``max_cycles``, result
    and host seconds, its launch's CUDA-event ms, and the seconds of the
    value pass (``cuda_engine._finalize``) that follows it."""

    def __enter__(self) -> "K7Watch":
        self.calls: list[dict] = []
        self._saved = simbatch, launch, finalize = (
            k7.simbatch, k7.launch, cuda_engine._finalize)

        def watched_simbatch(lanes, max_cycles, device):
            call = {"lanes": lanes, "max_cycles": max_cycles, "events": [],
                    "value_pass_s": 0.0}
            self.calls.append(call)
            t0 = time.perf_counter()
            call["out"] = simbatch(lanes, max_cycles, device)
            call["wall_s"] = time.perf_counter() - t0
            return call["out"]

        def watched_launch(d, max_cycles):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            launch(d, max_cycles)
            end.record()
            self.calls[-1]["events"].append((start, end))
            self.calls[-1].update(items=d.packed.items,
                                  threads=d.packed.threads,
                                  smem=d.packed.smem)

        def watched_finalize(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return finalize(*args, **kwargs)
            finally:
                self.calls[-1]["value_pass_s"] += time.perf_counter() - t0

        k7.simbatch, k7.launch, cuda_engine._finalize = (
            watched_simbatch, watched_launch, watched_finalize)
        return self

    def __exit__(self, *exc) -> None:
        k7.simbatch, k7.launch, cuda_engine._finalize = self._saved
        torch.cuda.synchronize()
        for call in self.calls:
            call["ms"] = sum(s.elapsed_time(e) for s, e in call["events"])


def carry_diff(cp, got: dict, want: dict) -> float:
    """Largest difference of two final carries over every field (K7's
    unpadded lane against the plain version's padded one)."""
    nN, nE = cp.n_nodes, cp.n_edges
    cut = {"qlen": nE + 1, "maxocc": nE, "fires": nN, "active": nN}
    err = 0.0
    for k in CARRY_FIELDS:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        if k in cut:
            a, b = a[:cut[k]], b[:cut[k]]
            if a.shape != b.shape:
                return float("inf")
        err = max(err, float(np.abs(a.astype(np.float64)
                                    - b.astype(np.float64)).max(initial=0)))
    return err


def bound_threads(nodes: int, edges: int) -> int:
    """The thread count at which a lane's barriers are timed for K7's
    bound: one thread per two of its nodes or edges (whichever are more),
    whole warps, 32 to 1,024.  Fixed here, apart from K7's own planner, so
    that the bound does not move with the kernel's design."""
    want = -(-max(nodes, edges) // 2)
    return min(1024, max(32, -(-want // 32) * 32))


def k7_bound(lanes, carries, dev) -> tuple[float, dict]:
    """K7's floor on one launch (ms), and the ns a barrier took at each
    thread count: the lanes run side by side, so the launch takes at least
    its slowest lane's chain of ``K7_FLOOR_BARRIERS`` barriers a cycle at
    that lane's :func:`bound_threads`, each chain timed by the barrier-only
    instance of the kernel."""
    longest: dict[int, int] = {}
    for (cp, _), c in zip(lanes, carries):
        t = bound_threads(cp.n_nodes, cp.n_edges)
        longest[t] = max(longest.get(t, 1), int(c["cycles"]))
    ms = {t: k7.barrier_ms(t, K7_FLOOR_BARRIERS * n, dev)
          for t, n in longest.items()}
    return max(ms.values()), {t: ms[t] * 1e6 / (K7_FLOOR_BARRIERS * n)
                              for t, n in longest.items()}


def sim_digest(plan, res) -> tuple:
    """``sim_fingerprint`` with the output bits as their SHA-256."""
    *head, out, fires = sim_fingerprint(plan, res)
    return (*head, hashlib.sha256(out).hexdigest(), fires)


def vector_digest(spec, config, x: np.ndarray) -> tuple:
    """One stage-1 lane of ``spec``'s sweep through the vector engine, in a
    worker process: the plan built from ``config`` as the tuner builds it."""
    plan = as_target(spec).build(config)
    return sim_digest(plan, simulate(plan, x, CGRA, engine="vector"))


def cgra_batch_phase(dev: torch.device, seed: int, cgra_cases: list,
                     failures: list[str]) -> dict:
    """The tuner's batched stage 1 on the card through K7, against the
    sequential vector engine, and each of its launches against K7's plain
    version; then the paper's 2D stage-1 sweep as one launch, every lane
    against the oracle and the vector engine (the w = 5 lanes against the
    ``cgra`` phase's result).  Returns K7's row of the ``kernels`` line."""
    # -- the tuner sweep, counted: explore with Budget(batch_size=32) -------
    heat = heat_2d(48, 96, dtype="float64")
    opts = SpaceOptions(
        temporal=(1, 2), capacities=("auto", "unbounded"),
        tiles=(None,) + tuple(t for t in tile_candidates(heat, SWEEP_BUDGETS)
                              if t is not None), fabrics=())
    target = as_target(heat, workload_timesteps=2)
    configs, analytic = enumerate_space(target, CGRA, opts)
    kept, _log = prune_space(target, CGRA, configs, opts, keep=analytic)
    # one launch on a small lane first, so that the timed launches below
    # do not include loading K7 and setting its shared-memory limit
    small = heat_2d(16, 16, dtype="float64")
    simulate_batch([(map_nd(small, workers=2), np.zeros(small.grid_shape))],
                   CGRA, device=dev)
    with K7Watch() as watch:
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        bat = explore(heat, CGRA, options=opts,
                      budget=Budget(batch_size=SWEEP_BATCH),
                      workload_timesteps=2, engine="vector", device=dev)
        torch.cuda.synchronize()
        bat_s = time.perf_counter() - t0
        sweep_launches = _build.LAUNCHES.get("simbatch", 0)
    t0 = time.perf_counter()
    seq = explore(heat, CGRA, options=opts, budget=Budget(),
                  workload_timesteps=2, engine="vector")
    seq_s = time.perf_counter() - t0

    def by_config(points):
        return {json.dumps(p.config.canonical(), sort_keys=True):
                (p.sim_cycles, p.cycles, p.pes) for p in points}

    same_cycles = by_config(bat.ideal_points) == by_config(seq.ideal_points)
    front_of = lambda r: sorted(p.objectives() for p in r.front)  # noqa: E731
    same_front = front_of(bat) == front_of(seq)
    n = len(seq.ideal_points)
    watched = sum(len(c["lanes"]) for c in watch.calls)
    ok = (same_cycles and same_front and n == len(kept) and sweep_launches
          == -(-n // SWEEP_BATCH) == len(watch.calls) and watched == n
          and not bat.failures and not seq.failures)
    if not ok:
        failures.append(f"cgra_batch sweep: cycles identical {same_cycles}, "
                        f"fronts identical {same_front}, {n} of {len(kept)} "
                        f"configs measured, {sweep_launches} K7 launches of "
                        f"{watched} lanes, failures {bat.failures[:2]} "
                        f"{seq.failures[:2]}")

    # -- the sweep's own launches, K7 against its plain version on the card --
    chunks, err, plain_ms, bound_ms, cycles_max = [], 0.0, 0.0, 0.0, 0
    for call in watch.calls:
        refused = [str(o) for o in call["out"] if isinstance(o, Exception)]
        if refused:
            failures.append(f"cgra_batch: K7 refused lanes: {refused[:2]}")
            continue
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        want = simbatch_plain(call["lanes"], call["max_cycles"], dev)
        end.record()
        end.synchronize()
        p_ms = start.elapsed_time(end)
        e = max(carry_diff(cp, g, w) for (cp, _), g, w
                in zip(call["lanes"], call["out"], want))
        longest = max(int(g["cycles"]) for g in call["out"])
        b_ms, barrier_ns = k7_bound(call["lanes"], call["out"], dev)
        err, plain_ms, bound_ms = max(err, e), plain_ms + p_ms, bound_ms + b_ms
        cycles_max = max(cycles_max, longest)
        chunks.append({"lanes": len(call["lanes"]), "items": call["items"],
                       "threads": call["threads"], "smem": call["smem"],
                       "barriers_per_cycle": k7.BARRIERS_PER_CYCLE,
                       "longest_cycles": longest, "ms": call["ms"],
                       "ns_per_cycle": call["ms"] * 1e6 / longest,
                       "plain_ms": p_ms, "bound_ms": b_ms,
                       "barrier_ns": barrier_ns,
                       "host_pack_copy_s": call["wall_s"] - call["ms"] / 1e3,
                       "host_value_pass_s": call["value_pass_s"],
                       "max_abs_err": e})
    if err != 0.0:
        failures.append(f"cgra_batch: K7 differs from its plain version by "
                        f"{err}")
    sweep_ms = sum(c["ms"] for c in chunks)
    print(json.dumps({
        "phase": "cgra_batch", "case": "heat2d_stage1_sweep",
        "grid": list(heat.grid_shape), "configs": len(configs),
        "kept": len(kept), "measured": n, "batch_size": SWEEP_BATCH,
        "launches": sweep_launches, "cycles_identical": same_cycles,
        "front_identical": same_front, "front": front_of(seq),
        "batched_wall_s": bat_s, "sequential_vector_wall_s": seq_s,
        "batched_configs_per_s": n / bat_s,
        "sequential_configs_per_s": n / seq_s,
        "sim_cycles_total": sum(p.sim_cycles for p in seq.ideal_points),
        "chunks": chunks, "k7_max_abs_err_vs_plain": err, "ok": ok}))

    # -- the paper's 2D sweep: one launch, counted --------------------------
    s2 = paper_stencil_2d()
    t2 = as_target(s2)
    opts2 = SpaceOptions(capacities=("auto", "unbounded"), fabrics=())
    cfg2, analytic2 = enumerate_space(t2, CGRA, opts2)
    kept2, _ = prune_space(t2, CGRA, cfg2, opts2, keep=analytic2)
    case2 = next(c for c in cgra_cases if c.name == "paper_2d")
    if case2.reduced:          # the cgra phase ran 32x64: simulate it here
        case2 = CgraCase("paper_2d", s2, analyze(s2, CGRA).workers, ())
        cgra_simulate(case2, seed + 2)
    t0 = time.perf_counter()
    plans2 = [t2.build(c) for c in kept2]
    build_s = time.perf_counter() - t0
    with K7Watch() as watch2:
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        res2 = simulate_batch([(pl, case2.x) for pl in plans2], CGRA,
                              device=dev)
        torch.cuda.synchronize()
        batch_s = time.perf_counter() - t0
        paper_launches = _build.LAUNCHES.get("simbatch", 0)
    seed_i = kept2.index(analytic2)
    same_i = kept2.index(dataclasses.replace(analytic2, capacity="unbounded"))
    # every other lane through the vector engine, in worker processes,
    # while the card's lanes are checked against the oracle and the bound
    # is measured; the longest (fewest workers) first
    others = sorted((i for i in range(len(kept2)) if i not in (seed_i, same_i)),
                    key=lambda i: kept2[i].workers)
    pool = multiprocessing.get_context("spawn").Pool(VECTOR_WORKERS)
    try:
        pending = {i: pool.apply_async(vector_digest, (s2, kept2[i], case2.x))
                   for i in others}
        want = case2.res
        rows, errs = [], []
        for cfg, pl, r in zip(kept2, plans2, res2):
            if isinstance(r, Exception):
                errs.append(f"{cfg.canonical()}: {type(r).__name__}: {r}")
                continue
            o_err = float(np.abs(r.output - case2.oracle).max())
            if not o_err <= CGRA_ORACLE_TOL:
                errs.append(f"{cfg.canonical()}: {o_err} from the oracle")
            rows.append({"workers": cfg.workers, "capacity": cfg.capacity,
                         "cycles": r.cycles, "status": "finished",
                         "gflops": r.gflops, "roofline_share":
                         r.pct_of_roofline, "oracle_err": o_err})
        seed_res, same_res = res2[seed_i], res2[same_i]
        seed_ok = (not isinstance(seed_res, Exception)
                   and (seed_res.cycles, seed_res.fires, seed_res.loads,
                        seed_res.stores, seed_res.flops,
                        seed_res.output.tobytes())
                   == (want.cycles, want.fires, want.loads, want.stores,
                       want.flops, want.output.tobytes()))
        plan_ok = (not isinstance(same_res, Exception)
                   and sim_fingerprint(plans2[same_i], same_res)
                   == sim_fingerprint(case2.plan, want))
        call2 = watch2.calls[-1]
        bound2, barrier_ns2 = (k7_bound(call2["lanes"], call2["out"], dev)
                               if not errs else (float("nan"), {}))
        longest2 = max((r["cycles"] for r in rows), default=0)
        # the launch against K7's plain version on the card, in every field,
        # while the workers run the vector engine
        err2, plain2_ms = float("inf"), float("nan")
        if not errs:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            want2 = simbatch_plain(call2["lanes"], call2["max_cycles"], dev)
            end.record()
            end.synchronize()
            plain2_ms = start.elapsed_time(end)
            err2 = max(carry_diff(cp, g, w) for (cp, _), g, w
                       in zip(call2["lanes"], call2["out"], want2))
        t0 = time.perf_counter()
        vector_differs = [
            kept2[i].canonical() for i in others
            if isinstance(res2[i], Exception)
            or pending[i].get(timeout=VECTOR_TIMEOUT_S)
            != sim_digest(plans2[i], res2[i])]
        vector_wait_s = time.perf_counter() - t0
    finally:
        pool.terminate()
        pool.join()
    ok = (not errs and seed_ok and plan_ok and paper_launches == 1
          and len(watch2.calls) == 1 and not vector_differs
          and analytic2.workers == case2.workers and err2 == 0.0)
    if not ok:
        failures.append(f"cgra_batch paper_2d: lane errors {errs}, seed lane "
                        f"(w={analytic2.workers}, auto) equal {seed_ok}, same "
                        f"plan equal {plan_ok}, lanes unlike the vector "
                        f"engine {vector_differs}, {paper_launches} launches, "
                        f"K7 differs from its plain version by {err2}")
    print(json.dumps({
        "phase": "cgra_batch", "case": "paper_2d_stage1_sweep",
        "grid": list(s2.grid_shape), "configs": len(cfg2),
        "lanes": rows, "launches": paper_launches,
        "seed": analytic2.canonical(), "seed_cycles": seed_res.cycles
        if seed_ok else None, "cgra_phase_cycles": want.cycles,
        "seed_equal_to_cgra_phase": seed_ok,
        "same_plan_equal_to_cgra_phase": plan_ok,
        "other_lanes_equal_to_vector": not vector_differs,
        "vector_lanes": len(others), "vector_wait_s": vector_wait_s,
        "host_build_s": build_s, "simulate_batch_s": batch_s,
        "cgra_phase_vector_s": case2.host_s,
        "k7_ms": call2["ms"], "k7_items": call2.get("items"),
        "k7_threads": call2.get("threads"), "k7_smem": call2.get("smem"),
        "barriers_per_cycle": k7.BARRIERS_PER_CYCLE,
        "k7_max_abs_err_vs_plain": err2, "plain_ms": plain2_ms,
        "longest_cycles": longest2,
        "ns_per_cycle": call2["ms"] * 1e6 / max(longest2, 1),
        "bound_ms": bound2, "barrier_ns": barrier_ns2,
        "host_pack_copy_s": call2["wall_s"] - call2["ms"] / 1e3,
        "host_value_pass_s": call2["value_pass_s"], "ok": ok}))

    # registers and spills of each ITEMS instance of the main path's kernel
    # (not the clocked one)
    instances = {}
    for r in read_ptxas(("simbatch",)):
        m = re.match(r"simbatch_kernelILi(\d+)ELi\d+ELb0E", r["kernel"])
        if m:
            instances[int(m.group(1))] = {
                k: r.get(k) for k in ("registers", "spill_stores",
                                      "spill_loads")}
    route, source, replaces = KERNELS["simbatch"]
    return {"name": "simbatch", "route": route, "source": source,
            "replaces": replaces,
            "launches": sweep_launches + paper_launches,
            "max_abs_err": max(err, err2), "tol": 0.0,
            "ms": sweep_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations", "library_ms": None,
            "barriers_per_cycle": k7.BARRIERS_PER_CYCLE,
            "bound_barriers_per_cycle": K7_FLOOR_BARRIERS,
            "instance": {"heat2d": [[c["items"], c["threads"]]
                                    for c in watch.calls],
                         "paper_2d": [call2.get("items"),
                                      call2.get("threads")]},
            "ptxas_by_items": instances,
            "shape": f"{n} heat2d 48x96 stage-1 lanes in "
                     f"{len(chunks)} launch(es), longest {cycles_max} cycles",
            "paper_2d_ms": call2["ms"], "paper_2d_bound_ms": bound2,
            "paper_2d_plain_ms": plain2_ms,
            "paper_2d_max_abs_err": err2}


ROOT = Path(__file__).resolve().parent
WALKTHROUGHS = ("quickstart", "fabric_heat1d", "hdiff_program",
                "heat3d_fabric", "seismic_stencil2d")
LINT_PLANS = 7            # 1 + 2 + 1 + 2 + 1, as the reference's examples


def traced_from_disk(tel: Telemetry, name: str) -> tuple[dict, int]:
    """Write ``tel``'s Perfetto trace into ``build/`` and validate the file
    as read back: (the object read back, its non-metadata event count)."""
    path = ROOT / "build" / f"{name}.trace.json"
    path.parent.mkdir(exist_ok=True)
    write_trace(tel, str(path))
    obj = json.loads(path.read_text())
    return obj, validate_trace(obj)


def observe_phase(seed: int, failures: list[str]) -> None:
    """The CGRA model's observability on its user-facing entry points: the
    lint CLI over the walkthroughs, a traced batched tuner sweep through K7
    and a traced routed simulation, and the seismic walkthrough through K3.
    The steps that launch kernels run with the launch counts zeroed just
    before and read just after."""
    # -- lint: the walkthroughs' plans through the static verifier ---------
    t0 = time.perf_counter()
    out = io.StringIO()
    n_plans, n_failed = lint_paths(
        [str(ROOT / "examples" / f"{n}_torch.py") for n in WALKTHROUGHS],
        out=out)
    routed = out.getvalue().count("(routed)")
    ok = (n_plans, n_failed, routed) == (LINT_PLANS, 0, 2)
    if not ok:
        failures.append(f"observe lint: {n_plans} plans, {n_failed} failed, "
                        f"{routed} routed:\n{out.getvalue()}")
    print(json.dumps({"phase": "lint", "n_plans": n_plans,
                      "n_failed": n_failed, "routed": routed,
                      "s": time.perf_counter() - t0, "ok": ok}))

    # -- trace: a batched tuner sweep on the card, with a sink -------------
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    tel = Telemetry()
    res = explore(heat_2d(24, 48, dtype="float64"), CGRA,
                  options=SpaceOptions(workers=(1, 2, 3, 4, 6),
                                       temporal=(1, 2),
                                       capacities=("auto", "unbounded")),
                  budget=Budget(batch_size=32), telemetry=tel, device=None)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    k7_launches = _build.LAUNCHES.get("simbatch", 0)
    obj, n_events = traced_from_disk(tel, "observe_sweep")
    spans = [e for e in obj["traceEvents"]
             if e["ph"] == "X" and e.get("cat") == "tuner"
             and e["args"].get("outcome") == "measured"]
    wall_s = time.perf_counter() - t0
    n_measured = res.stats["n_measured"]
    ok = (len(spans) == n_measured > 0 and k7_launches == 1
          and not res.failures)
    if not ok:
        failures.append(f"observe trace: {len(spans)} measured spans, "
                        f"n_measured {n_measured}, {k7_launches} K7 "
                        f"launches, failures {res.failures[:2]}")
    print(json.dumps({"phase": "trace", "case": "heat2d_24x48_stage1_sweep",
                      "events": len(obj["traceEvents"]),
                      "validated_events": n_events,
                      "measured_spans": len(spans),
                      "n_measured": n_measured, "k7_launches": k7_launches,
                      "sweep_s": sweep_s, "wall_s": wall_s, "ok": ok}))

    #    ... and a routed simulation with the vector engine
    t0 = time.perf_counter()
    spec = paper_stencil_2d(ny=30, nx=48, r=12)
    plan = map_nd(spec, workers=8)
    fab = route(place(plan, FabricTopology.mesh(16, 16), seed=0))
    tel = Telemetry()
    sim = simulate(plan, np.random.default_rng(seed).normal(size=(30, 48)),
                   CGRA, fabric=fab, engine="vector", telemetry=tel)
    obj, n_events = traced_from_disk(tel, "observe_paper_2d_routed")
    report = render_report(tel)
    top = bottleneck_table(tel).splitlines()[2].strip()
    totals = tel.totals()
    ok = (n_events > 0 and totals["cycles"] == sim.cycles
          and report.startswith("telemetry: ") and top
          and top != "(no stalls recorded)")
    if not ok:
        failures.append(f"observe trace (routed paper 2D): {n_events} "
                        f"events, sink cycles {totals['cycles']} against "
                        f"{sim.cycles}, top bottleneck {top!r}")
    print(json.dumps({"phase": "trace", "case": "paper_2d_30x48_routed",
                      "cycles": sim.cycles, "events": len(obj["traceEvents"]),
                      "validated_events": n_events,
                      "token_hops": totals["token_hops"],
                      "top_bottleneck": top,
                      "wall_s": time.perf_counter() - t0, "ok": ok}))

    # -- the seismic walkthrough on the card: K3 ---------------------------
    path = ROOT / "examples" / "seismic_stencil2d_torch.py"
    mod_spec = importlib.util.spec_from_file_location("_seismic_walkthrough",
                                                      path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    got = mod.main(["--device", "cuda"])
    torch.cuda.synchronize()
    k3 = _build.LAUNCHES.get("stencil2d", 0)
    tol = TOL[torch.float32]
    ok = got["exact"] and got["max_abs_err"] <= tol and k3 >= 1
    if not ok:
        failures.append(f"observe seismic_example: exact {got['exact']}, "
                        f"K3 error {got['max_abs_err']} (tol {tol}), "
                        f"{k3} K3 launches")
    print(json.dumps({"phase": "seismic_example", "exact": got["exact"],
                      "cycles": got["cycles"], "blocks": got["blocks"],
                      "max_abs_err": got["max_abs_err"], "tol": tol,
                      "k3_launches": k3, "s": time.perf_counter() - t0,
                      "ok": ok}))


# -- the multi-device slice: gloo ranks sharing the card ----------------------
DIST_RANKS = 4
DIST_REPS = 5                 # timed fused blocks a case, after one warm-up
DIST_TIMEOUT_S = 300
NCCL_GRID = (2048, 2048)      # the one-rank NCCL world's 2D grid
DIST_BUILD = {1: distributed_stencil1d, 2: distributed_stencil2d,
              3: distributed_stencil3d}


def dist_cases() -> list[tuple]:
    """(name, spec, mesh shape, mesh axes, kernel, its launches a fused
    block): each past the L2, in f32."""
    return [
        ("1d_17pt", dataclasses.replace(
            paper_stencil_1d(n=2 ** 26, dtype="float32"), timesteps=4),
         (4,), ("data",), "stencil1d_vpu", 1),
        ("2d_49pt_seismic", dataclasses.replace(
            paper_stencil_2d(8192, 8192, dtype="float32"), timesteps=4),
         (2, 2), ("pod", "data"), "stencil2d", 1),
        ("3d_star_r2", dataclasses.replace(
            star_3d(512, 512, 512, r=2, dtype="float32"), timesteps=2),
         (2, 2), ("pod", "data"), "stencil3d", 2),
    ]


def barrier_ms(fn) -> list[float]:
    """ms of ``fn`` run by every rank at once, barrier to barrier (the card
    synchronised before the second), ``DIST_REPS`` times after a warm-up."""
    times = []
    for _ in range(DIST_REPS + 1):
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        times.append((time.perf_counter() - t0) * 1e3)
    return times[1:]


def dist_rank(seed: int) -> dict:
    """One of ``DIST_RANKS`` gloo ranks on the card.  Each case: the whole
    grid from ``seed`` on the card, this rank's shard as a DTensor, one
    fused block with the launch counts zeroed just before and read just
    after, ``DIST_REPS`` blocks timed barrier to barrier (exchange
    included), then the exchanges alone and the sweeps of a haloed shard
    alone; the result gathered on rank 0 through the host and held there
    to the single-device op and the oracle, the op timed alone."""
    dev = torch.device("cuda", torch.cuda.current_device())
    rank, world = dist.get_rank(), dist.get_world_size()
    # does the installed gloo take CUDA tensors in an all-reduce?  (found
    # out and printed only: the port stages gloo's payloads on the host)
    probe = torch.ones(1, device=dev)
    try:
        dist.all_reduce(probe)
        gloo_cuda = probe.item() == world
    except RuntimeError as e:
        gloo_cuda = f"{type(e).__name__}: {str(e)[:160]}"
    out = {"gloo_cuda_all_reduce": gloo_cuda, "cases": []}
    for name, spec, shape, axes, kernel, _ in dist_cases():
        mesh = make_mesh_compat(shape, axes)
        place = placements(PartitionSpec(*axes), mesh)
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn(spec.grid_shape, generator=gen, device=dev)
        xd = distribute_tensor(x, mesh, place, src_data_rank=None)
        step = DIST_BUILD[spec.ndim](spec, mesh,
                                     axes[0] if spec.ndim == 1 else axes)
        torch.cuda.synchronize()
        _build.reset_launches()
        y = step(xd)
        torch.cuda.synchronize()
        row = {"launches": _build.LAUNCHES.get(kernel, 0),
               "block_ms": barrier_ms(lambda: step(xd))}
        # the exchanges alone: each mesh axis's halo_exchange on the shard
        local = xd.to_local()
        halos = [(d, spec.radii[d] * spec.timesteps, mesh.get_group(a))
                 for d, a in enumerate(axes)]
        row["exchange_ms"] = barrier_ms(lambda: [
            halo_exchange(local, halo, group, axis)
            for axis, halo, group in halos])
        # the sweeps alone: each rank's op on a haloed shard at once
        ext = torch.zeros([n + 2 * h if d < len(axes) else n for d, (n, h)
                           in enumerate(zip(local.shape, (
                               r * spec.timesteps for r in spec.radii)))],
                          device=dev)
        row["sweep_ms"] = barrier_ms(lambda: dist_sweep(ext, spec))
        del ext
        local = y.to_local().cpu()
        starts = [None] * world
        dist.all_gather_object(starts, shard_offsets(
            local.shape, mesh, place, mesh.get_coordinate()))
        parts = [torch.empty_like(local) for _ in range(world)] if rank == 0 \
            else None
        dist.gather(local, parts, dst=0)
        if rank == 0:
            full = torch.full(spec.grid_shape, float("nan"), device=dev)
            for start, part in zip(starts, parts):
                full[tuple(slice(a, a + n) for a, n in
                           zip(start, part.shape))] = part.to(dev)
            single = dist_sweep(x, spec)
            oracle = stencil_reference(x, spec)
            row.update({
                "err_single": (full - single).abs().max().item(),
                "err_oracle": (full - oracle).abs().max().item(),
                "bit_equal_single": torch.equal(full, single),
                "single_ms": median_ms(lambda: dist_sweep(x, spec),
                                       reps=DIST_REPS)})
            del full, single, oracle
        dist.barrier()                  # the others wait while rank 0 checks
        out["cases"].append(row)
        del x, xd, y, step
        torch.cuda.empty_cache()
    return out


def nccl_rank(seed: int) -> dict:
    """The one rank of an NCCL world on the card: ``distributed_stencil2d``
    on a (1, 1) mesh and ``int8_psum`` run NCCL's side of the transport
    rule.  With no peer, no point-to-point message is sent."""
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh_compat((1, 1), ("pod", "data"))
    spec = dataclasses.replace(paper_stencil_2d(*NCCL_GRID, dtype="float32"),
                               timesteps=4)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(spec.grid_shape, generator=gen, device=dev)
    xd = distribute_tensor(x, mesh, placements(PartitionSpec("pod", "data"),
                                               mesh), src_data_rank=None)
    _build.reset_launches()
    y = distributed_stencil2d(spec, mesh)(xd).to_local()
    torch.cuda.synchronize()
    k3_launches = _build.LAUNCHES.get("stencil2d", 0)
    single = stencil2d_from_spec(x, spec)
    q = torch.randn(1 << 20, generator=gen, device=dev)
    got = int8_psum(q, mesh.get_group("data"))
    scale = torch.clamp(q.abs().max(), min=1e-12) / 127.0
    want = torch.clamp(torch.round(q / scale), -127, 127).to(
        torch.int8).float() * scale
    torch.cuda.synchronize()
    return {"backend": dist.get_backend(), "k3_launches": k3_launches,
            "on_card": y.is_cuda and got.is_cuda,
            "err_single": (y - single).abs().max().item(),
            "bit_equal_single": torch.equal(y, single),
            "psum_err": (got - want).abs().max().item()}


def distributed_phase(seed: int, failures: list[str]) -> None:
    """The multi-device slice on the one card: ``DIST_RANKS`` gloo ranks
    (``run_local_world``), each sweeping its haloed shard with K1, K3 or K4
    (``dist_rank``), then a one-rank NCCL world in this process
    (``nccl_rank``)."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_local_world(dist_rank, DIST_RANKS, seed,
                            timeout=DIST_TIMEOUT_S)
    world_s = time.perf_counter() - t0
    tol = TOL[torch.float32]
    for i, (name, spec, shape, axes, kernel, per_block) in enumerate(
            dist_cases()):
        rows = [r["cases"][i] for r in ranks]
        head = rows[0]
        launches = [r["launches"] for r in rows]
        ok = (head["err_single"] <= tol and head["err_oracle"] <= tol
              and launches == [per_block] * DIST_RANKS)
        if not ok:
            failures.append(f"distributed {name}: error {head['err_single']} "
                            f"from the single-device op, "
                            f"{head['err_oracle']} from the oracle (tol "
                            f"{tol}), {kernel} launches per rank {launches}")
        shards = shape + (1,) * (spec.ndim - len(shape))
        print(json.dumps({
            "phase": "distributed", "case": name, "ranks": DIST_RANKS,
            "backend": "gloo", "mesh": dict(zip(axes, shape)),
            "grid": list(spec.grid_shape), "radii": list(spec.radii),
            "timesteps": spec.timesteps, "dtype": spec.dtype,
            "halo_bytes_per_step": halo_bytes_per_step(spec, shards),
            "kernel": kernel, "launches_per_rank_per_block": launches,
            "max_abs_err_vs_single": head["err_single"],
            "max_abs_err_vs_oracle": head["err_oracle"], "tol": tol,
            "bit_equal_single": head["bit_equal_single"],
            "block_ms": statistics.median(head["block_ms"]),
            "block_ms_spread": spread(head["block_ms"]),
            "single_ms": head["single_ms"],
            "exchange_ms": statistics.median(head["exchange_ms"]),
            "sweep_ms": statistics.median(head["sweep_ms"]),
            "gloo_cuda_all_reduce": ranks[0]["gloo_cuda_all_reduce"],
            "ok": ok}))
    # this process is the one rank: no spawn, no second import of the script
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(
            str(Path(tmp) / "store"), 1), rank=0, world_size=1)
        try:
            got = nccl_rank(seed)
        finally:
            dist.destroy_process_group()
    ok = (got["backend"] == "nccl" and got["on_card"]
          and got["k3_launches"] == 1 and got["err_single"] <= tol
          and got["psum_err"] == 0.0)
    if not ok:
        failures.append(f"distributed nccl: {got}")
    print(json.dumps({
        "phase": "distributed_nccl", "ranks": 1, "grid": list(NCCL_GRID),
        **got, "tol": tol,
        "note": "one rank has no peer: NCCL's point-to-point exchange "
                "between two cards is not run on a one-card machine",
        "ok": ok}))
    print(json.dumps({"phase": "distributed_wall", "gloo_world_s": world_s,
                      "nccl_world_s": time.perf_counter() - t1,
                      "s": time.perf_counter() - t0}))


# -- the trainer's parallel slice: data and tensor parallel on the card -------
PAR_STEPS = 3
MOE_ARCH = "granite-moe-3b-a800m"
RWKV_ARCH = "rwkv6-7b"
WHISPER_ARCH = "whisper-tiny"
VLM_ARCH = "qwen2-vl-2b"
# name -> (arch, layers, (batch, seq), layouts (data, model) of 2 gloo
# ranks).  RecurrentGemma-2B's one period through K5, K6 and their
# backward; Granite-MoE-3B-A800M's 2 layers at (1, 2): 20 of its 40
# experts (EP) and 12 of its 24 heads a rank, its 49,155-row vocabulary
# (odd) whole, no kernel on its path; RWKV-6-7B's 2 layers at (1, 2): 32
# of its 64 WKV heads a rank, no kernel on its path, at seq 1024 (the WKV
# loop keeps ~6 MB of f32 state a step for the backward of a layer);
# whisper-tiny whole (4 + 4 layers) at (1, 2): 3 of its 6 heads a rank in
# every attention, the cross K/V made from the rank's heads, 768 of its
# 1,536 d_ff columns, its 51,865-row vocabulary (odd) whole, 1,500 frames
# a row, no kernel on its path; qwen2-vl-2b's 2 layers at (1, 2): 6 of
# its 12 heads, 1 of its 2 KV heads, 4,480 of its 8,960 d_ff columns and
# 75,968 of its 151,936 vocabulary rows a rank, tokens alone (text-only
# M-RoPE positions), no kernel on its path
PAR_CASES = {ARCH: (ARCH, STEP_LAYERS, (2, 4096), ((2, 1), (1, 2))),
             MOE_ARCH: (MOE_ARCH, 2, (2, 2048), ((1, 2),)),
             RWKV_ARCH: (RWKV_ARCH, 2, (2, 1024), ((1, 2),)),
             WHISPER_ARCH: (WHISPER_ARCH, 4, (2, 4096), ((1, 2),)),
             VLM_ARCH: (VLM_ARCH, 2, (2, 4096), ((1, 2),))}
PAR_TIMEOUT_S = 600
# each step's loss of a layout against the one-rank run's, relative, set
# before the first run on the card: bf16 activations at full width, where
# a split product (summed in f32 across ranks) or a half batch (another
# cuBLAS tiling) rounds some outputs differently; the whole-step check's
# bar for the kernels against their plain versions
PAR_LOSS_RTOL = 1e-3


def par_argv(name: str, seed: int, data: int, model: int) -> list[str]:
    """launch.train's command for PAR_CASES[name] at full width, cut in
    depth, f32 weights, bf16 activations."""
    arch, layers, (batch, seq), _ = PAR_CASES[name]
    return ["--arch", arch, "--override", f"num_layers={layers}",
            "--steps", str(PAR_STEPS), "--batch", str(batch), "--seq",
            str(seq), "--remat", TRAIN_REMAT, "--data-pattern", "markov",
            "--seed", str(seed), "--log-every", "1", "--ckpt-every", "0",
            "--data-par", str(data), "--model-par", str(model)]


def par_config(name: str):
    arch, layers = PAR_CASES[name][:2]
    return dataclasses.replace(get_config(arch), num_layers=layers)


def predicted_elements(mdl, data: int, model: int, rules=None) -> int:
    """Parameter elements a rank holds at (data, model): each spec divided
    by the mesh axes that ``resolve_spec`` splits it over under ``rules``
    (by default the trainer's, FSDP off)."""
    sizes = {"data": data, "model": model}
    rules = rules or {**DEFAULT_RULES, **tp.FSDP_OFF}
    total = 0
    for spec in mdl.specs().values():
        parts = resolve_spec(spec.shape, spec.logical,
                             SimpleNamespace(shape=sizes), rules)
        total += math.prod(spec.shape) // math.prod(
            sizes[a] for part in parts if part
            for a in ((part,) if isinstance(part, str) else part))
    return total


def par_run(name: str, seed: int, data: int, model: int) -> dict:
    """One rank of launch.train on PAR_CASES[name] at (data, model),
    instrumented around each step: the kernels' launches, the bytes
    all-reduced per mesh axis (the counts zeroed just before the step and
    read just after), the step's host ms (it ends in the loss's read,
    which synchronises) and peak memory; the rank's parameter elements
    against ``resolve_spec``'s."""
    cfg = par_config(name)
    rec = {"launches": [], "ms": [], "wire": [], "peak_gb": [], "aux": []}

    def before(step):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        tp.reset_wire()

    def after(step, info):
        torch.cuda.synchronize()
        rec["launches"].append({k: n for k, n in _build.LAUNCHES.items()
                                if n})
        rec["wire"].append(tp.wire_bytes())
        rec["ms"].append(info["seconds"] * 1e3)
        rec["aux"].append(info["aux"])
        rec["peak_gb"].append(torch.cuda.max_memory_allocated() / 1e9)
        if "elements" not in rec:
            rec["elements"] = sum(p.numel()
                                  for p in info["model"].parameters())
            rec["predicted"] = predicted_elements(info["model"], data, model)
    rc, losses = train_cli.run(par_argv(name, seed, data, model),
                               before_step=before, after_step=after)
    rec.update(rc=rc, losses=losses,
               rank=dist.get_rank() if dist.is_initialized() else 0)
    return rec


def train_parallel_phase(seed: int, failures: list[str]) -> None:
    """The trainer's parallel slice on the one card: each PAR_CASES case at
    full width trained PAR_STEPS steps through ``launch.train.run`` in
    this process (one rank), then in a 2-rank gloo world sharing the card
    at each of its layouts; each layout's losses against the one-rank
    run's, its launches (``train_launches``: RecurrentGemma's K5, K6 and
    their backward; none on the MoE's path), elements, step ms, peak
    memory and bytes all-reduced on every rank."""
    t0 = time.perf_counter()
    for name, (arch, layers, (batch, seq), layouts) in PAR_CASES.items():
        t_case = time.perf_counter()
        cfg = par_config(name)
        want = {k: n for k, n in train_launches(cfg, TRAIN_REMAT).items()
                if n}
        torch.cuda.empty_cache()
        runs = {(1, 1): [par_run(name, seed, 1, 1)]}
        torch.cuda.empty_cache()
        for d, m in layouts:
            runs[(d, m)] = run_local_world(par_run, d * m, name, seed, d, m,
                                           timeout=PAR_TIMEOUT_S)
            torch.cuda.empty_cache()
        one = runs[(1, 1)][0]["losses"]
        for (d, m), ranks in runs.items():
            rels = [max(abs(a - b) / abs(b)
                        for a, b in zip(r["losses"], one)) for r in ranks]
            launched = all(step == want for r in ranks
                           for step in r["launches"])
            elements_ok = all(r["elements"] == r["predicted"]
                              for r in ranks)
            same = all(r["losses"] == ranks[0]["losses"] for r in ranks)
            ok = (all(r["rc"] == 0 and len(r["losses"]) == PAR_STEPS
                      and np.isfinite(r["losses"]).all() for r in ranks)
                  and max(rels) <= PAR_LOSS_RTOL and launched and elements_ok
                  and same)
            if not ok:
                failures.append(
                    f"train_parallel {name} {(d, m)}: losses "
                    f"{[r['losses'] for r in ranks]} against one rank's "
                    f"{one} (rel {rels}, tol {PAR_LOSS_RTOL}), launches "
                    f"{[r['launches'] for r in ranks]} (want {want} a "
                    "step), elements "
                    f"{[(r['elements'], r['predicted']) for r in ranks]}")
            wire = [{a: [w.get(a, {}).get("bytes", 0) for w in r["wire"]]
                     for a in ("data", "model")} for r in ranks]
            print(json.dumps({
                "phase": "train_parallel", "arch": arch, "layers": layers,
                "d_model": cfg.d_model, "param_dtype": cfg.param_dtype,
                "dtype": cfg.dtype, "tokens": [batch, seq],
                "remat": TRAIN_REMAT, "data": d, "model": m, "ranks": d * m,
                "backend": "gloo" if d * m > 1 else None,
                "losses": ranks[0]["losses"], "losses_one_rank": one,
                "loss_rel": max(rels), "loss_rtol": PAR_LOSS_RTOL,
                "aux": ranks[0]["aux"],
                "launches_per_step": [r["launches"] for r in ranks],
                "launches_want": want,
                "elements": [r["elements"] for r in ranks],
                "elements_predicted": [r["predicted"] for r in ranks],
                "step_ms": [r["ms"] for r in ranks],
                "step_ms_median_after_first": [
                    statistics.median(r["ms"][1:]) for r in ranks],
                "peak_gb": [max(r["peak_gb"]) for r in ranks],
                "wire_bytes_per_step": wire,
                "wire_calls_per_step": [[{a: c["calls"]
                                          for a, c in w.items()}
                                         for w in r["wire"]] for r in ranks],
                "ok": ok}))
        print(json.dumps({"phase": "train_parallel_case_wall", "arch": arch,
                          "s": time.perf_counter() - t_case}))
    print(json.dumps({
        "phase": "train_parallel_note",
        "note": "gloo ranks share the one card and all-reduce through the "
                "host; NCCL between cards is not measured on a one-card "
                "machine"}))
    print(json.dumps({"phase": "train_parallel_wall",
                      "s": time.perf_counter() - t0}))


# -- decode of a model split over the model axis, on the card ----------------
SPLIT_MESH = (1, 2)                     # (data, model): 2 gloo ranks
SPLIT_BATCH, SPLIT_TOKENS = 2, 64
# name -> (arch, layers, cache_len).  RecurrentGemma-2B's one period: its
# 2048-slot ring split over positions (1024 a rank), 5 of its 10 heads and
# 1280 of the RG-LRU's 2560 channels a rank, layout (b).  tinyllama-1.1b
# at 2 layers: its cache split over the 4 KV heads (2 a rank), as wk is,
# layout (a); Granite-MoE-3B-A800M at 2 layers: its cache over its 8 KV
# heads (4 a rank), 12 of its 24 heads and 20 of its 40 experts a rank
# (EP), its vocabulary whole, layout (a); RWKV-6-7B at 2 layers: its WKV
# state over its 64 heads (32 a rank), no KV cache (cache_len unused);
# whisper-tiny whole (4 decoder layers): its self caches over the 6 KV
# heads (3 a rank), layout (a), its cross K/V, primed from the whole
# model's ``_cross_kv`` of seeded frames and placed by ``shard_cache``,
# over the 1,500 frames (750 a rank) with 3 of its 6 heads a rank, layout
# (b); qwen2-vl-2b at 2 layers: its cache over its 2 KV heads (1 a
# rank), 6 of its 12 heads a rank, M-RoPE positions (3, B, 1) from
# make_decode_step, layout (a)
SPLIT_CASES = {"recurrentgemma-2b": (ARCH, STEP_LAYERS, 2048),
               "tinyllama-1.1b": ("tinyllama-1.1b", 2, 128),
               MOE_ARCH: (MOE_ARCH, 2, 128),
               RWKV_ARCH: (RWKV_ARCH, 2, 128),
               WHISPER_ARCH: (WHISPER_ARCH, 4, 128),
               VLM_ARCH: (VLM_ARCH, 2, 128)}
# each step's logits of the split decode against one rank's, absolute,
# set before the first run on the card: f32 activations at full width,
# where a split product sums its parts in another order and cuBLAS may
# tile the halves differently (train_parallel's bar)
SPLIT_TOL = 1e-3
SPLIT_TIMEOUT_S = 600


def split_layout_want(cfg, cache_len: int, m: int, col: int) -> list:
    """``cache_layout`` of the rank at ``col`` of a model axis of ``m``
    under the rules: the KV cache split over KV heads where ``m`` divides
    them, else over its positions; the RG-LRU state over its channels;
    the RWKV state over its heads, the token-shift states whole; the
    encoder-decoder's cross K (L, B, T, KV, hd) over the frames where
    ``m`` divides them, else over the KV heads, else whole."""
    out, b, hd = [], SPLIT_BATCH, cfg.resolved_head_dim
    for i in range(cfg.num_layers):
        kind = cfg.kind_of_layer(i)
        if kind == "rwkv":
            d, h = cfg.d_model, cfg.num_heads
            out.append([[b, d], [b, d], [b, h // m, hd, hd]])
            continue
        if kind == "rglru":
            w = cfg.lru_width // m
            out.append([[b, w], [b, cfg.conv_width - 1, w]])
            continue
        slots = min(cache_len, cfg.window) if kind == "local" else cache_len
        kv = cfg.num_kv_heads
        out.append([[b, kv // m, slots, hd], 0, 0] if kv % m == 0 else
                   [[b, kv, slots // m, hd], col * slots // m, slots])
    if cfg.family == "audio":
        t, kv = cfg.encoder_seq, cfg.num_kv_heads
        out.append([cfg.num_layers, b, *((t // m, kv) if t % m == 0 else
                                         (t, kv // m) if kv % m == 0 else
                                         (t, kv)), hd])
    return out


def cache_layout(cache) -> list:
    """Per layer: a KV cache's (k's shape, start, capacity), an RG-LRU
    state's (h's shape, conv's shape) or an RWKV state's (shift_tm's,
    shift_cm's and s's shapes); the encoder-decoder's dict: its self
    caches', then the cross K's shape."""
    states = cache["self"] if isinstance(cache, dict) else cache
    out = [[list(c.k.shape), c.start, c.capacity]
           if isinstance(c, model_attention.KVCache)
           else [list(t.shape) for t in c] for c in states]
    if isinstance(cache, dict):
        out.append(list(cache["cross_k"].shape))
    return out


def heads_of(mdl) -> int:
    """The query heads (WKV heads for RWKV) that the first layer with
    heads holds on this rank."""
    if not hasattr(mdl, "layers"):                      # encoder-decoder
        return mdl.dec[0].self["wq"].shape[1]
    blk = [b for b in mdl.layers if b.kind in ("attn", "local", "rwkv")][0]
    return (blk.rwkv["u"].shape[0] if blk.kind == "rwkv"
            else blk.attn["wq"].shape[1])


def primed_cache(mdl, cfg, seed: int, cache_len: int) -> dict:
    """The encoder-decoder's whole cache of SPLIT_BATCH rows: the self
    caches empty, the cross K/V the whole model's ``_cross_kv`` of seeded
    frames on the card."""
    dev = mdl.embed.device
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    frames = torch.randn((SPLIT_BATCH, cfg.encoder_seq, cfg.d_model),
                         device=dev, generator=gen)
    with torch.inference_mode():
        cache = mdl.init_cache(SPLIT_BATCH, cache_len)
        enc = mdl.encode(frames)
        kv = [mdl._cross_kv(bp, enc) for bp in mdl.dec]
        cache["cross_k"] = torch.stack([k for k, _ in kv])
        cache["cross_v"] = torch.stack([v for _, v in kv])
    return cache


def split_decode_run(seed: int, data: int, model: int) -> dict:
    """Every SPLIT_CASES case at full width, f32 activations, decoding
    SPLIT_TOKENS seeded tokens a row from an empty cache through
    ``make_decode_step``: in this process as one rank at (1, 1), else as a
    rank of a gloo world at (data, model), its weights and cache
    (``LM.init_cache`` under ``mesh_context``) its slices.  Per case: each
    step's host ms (synchronised), one step's bytes and calls per mesh
    axis (``tensor_parallel.WIRE``, zeroed just before the step), the
    kernels launched in the decode (counts zeroed just before it), the
    cache's layout and heads a rank; rank 0 also the logits and tokens,
    gathered whole, on the host.  The encoder-decoder's cache is
    :func:`primed_cache`, placed by ``tensor_parallel.shard_cache``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_local_mesh(data, model) if data * model > 1 else None
    rank = dist.get_rank() if mesh is not None else 0
    out = {}
    for name, (arch, layers, cache_len) in SPLIT_CASES.items():
        cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                                  dtype="float32")
        mdl = family_model(cfg, dev, seed)
        primed = (primed_cache(mdl, cfg, seed, cache_len)
                  if cfg.family == "audio" else None)
        if mesh is not None:
            if primed is not None:
                primed = tp.shard_cache(primed, mesh)
            tp.shard_parameters(mdl, tp.parameter_layout(mdl, mesh), mesh)
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        toks = torch.randint(0, cfg.vocab_size, (SPLIT_BATCH, SPLIT_TOKENS),
                             device=dev, generator=gen)
        rows = cols = None
        if mesh is not None:
            rows = named_sharding(tuple(toks.shape), ("batch", None), mesh)
            cols = named_sharding((SPLIT_BATCH, SPLIT_TOKENS, cfg.vocab_size),
                                  ("batch", None, "vocab"), mesh)
            toks = tp.shard_of(toks, mesh, rows)
        ms, logits, nxt = [], [], []
        with (mesh_context(mesh) if mesh is not None
              else contextlib.nullcontext()):
            step = make_decode_step(mdl, cfg)
            cache = (mdl.init_cache(SPLIT_BATCH, cache_len)
                     if primed is None else primed)
            layout = cache_layout(cache)
            torch.cuda.synchronize()
            _build.reset_launches()
            for t in range(SPLIT_TOKENS):
                tp.reset_wire()
                t0 = time.perf_counter()
                n, lg, cache = step(cache, toks[:, t:t + 1], t)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                wire = tp.wire_bytes()
                logits.append(lg)
                nxt.append(n)
            launches = {k: n for k, n in _build.LAUNCHES.items() if n}
        logits, nxt = torch.cat(logits, 1), torch.cat(nxt, 1)
        if mesh is not None:
            logits = tp.whole_of(logits, mesh, cols)
            nxt = tp.whole_of(nxt, mesh, rows)
        rec = {"ms": ms, "wire": wire, "launches": launches,
               "layout": layout, "rank": rank,
               "heads": heads_of(mdl),
               "experts": (list(mdl.layers[0].mlp["wi_gate"].shape)
                           if cfg.num_experts else None)}
        if rank == 0:
            rec.update(logits=logits.cpu(), tokens=nxt.cpu())
        out[name] = rec
        del mdl, cache, logits, primed
        torch.cuda.empty_cache()
    return out


def split_decode_phase(seed: int, failures: list[str]) -> None:
    """Decode of a model split over the model axis on the one card: each
    SPLIT_CASES case through ``split_decode_run`` in this process (one
    rank), then on 2 gloo ranks sharing the card at SPLIT_MESH; each
    case's logits within SPLIT_TOL of one rank's at every step, its greedy
    tokens equal, its cache split as the rules place it, no kernel
    launched (decode's conv and attention are the reference's einsums,
    ``ON_CARD["decode"]``, which the dry run's decode cell is held to);
    ms a step and the bytes and calls a step per mesh axis printed."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    one = split_decode_run(seed, 1, 1)
    torch.cuda.empty_cache()
    d, m = SPLIT_MESH
    ranks = run_local_world(split_decode_run, d * m, seed, d, m,
                            timeout=SPLIT_TIMEOUT_S)
    torch.cuda.empty_cache()
    ON_CARD["decode"] = one[ARCH]["launches"]
    for name, (arch, layers, cache_len) in SPLIT_CASES.items():
        cfg = get_config(arch)
        want, got = one[name], ranks[0][name]
        shape = (SPLIT_BATCH, SPLIT_TOKENS, cfg.vocab_size)
        err = (got["logits"] - want["logits"]).abs().max().item()
        same = bool(torch.equal(got["tokens"], want["tokens"]))
        finite = bool(torch.isfinite(got["logits"]).all())
        heads = [r[name]["heads"] for r in ranks]
        layouts = [r[name]["layout"] for r in ranks]
        experts = [r[name]["experts"] for r in ranks]
        e, f = cfg.num_experts, cfg.d_ff
        # the rules: the experts split where m divides them (EP), else d_ff
        experts_want = [None if not e else [e // m, cfg.d_model, f]
                        if e % m == 0 else [e, cfg.d_model, f // m]] * m
        lcfg = dataclasses.replace(cfg, num_layers=layers)
        ok = (err <= SPLIT_TOL and same and finite
              and tuple(got["logits"].shape) == shape
              and heads == [cfg.num_heads // m] * m
              and experts == experts_want
              and layouts == [split_layout_want(lcfg, cache_len, m, c)
                              for c in range(m)]
              and all(r[name]["launches"] == {} for r in ranks)
              and want["launches"] == {})
        if not ok:
            failures.append(
                f"split_decode {name} {(d, m)}: max logit difference "
                f"{err} (tol {SPLIT_TOL}), tokens equal {same}, finite "
                f"{finite}, shape {tuple(got['logits'].shape)}, heads a "
                f"rank {heads}, experts a rank {experts} (want "
                f"{experts_want}), layouts {layouts} against one rank's "
                f"{want['layout']}, launches "
                f"{[r[name]['launches'] for r in ranks]} and one rank's "
                f"{want['launches']} (want none)")
        print(json.dumps({
            "phase": "split_decode", "arch": arch, "layers": layers,
            "d_model": cfg.d_model, "dtype": "float32",
            "batch": SPLIT_BATCH, "tokens": SPLIT_TOKENS,
            "cache_len": cache_len, "data": d, "model": m,
            "ranks": d * m, "backend": "gloo", "heads_per_rank": heads,
            "experts_per_rank": experts,
            "cache_layout": layouts, "cache_layout_one_rank":
                want["layout"],
            "max_abs_logit_diff": err, "tol": SPLIT_TOL,
            "tokens_equal": same,
            "step_ms_one_rank": statistics.median(want["ms"][1:]),
            "step_ms": [statistics.median(r[name]["ms"][1:])
                        for r in ranks],
            "first_step_ms": [want["ms"][0]] + [r[name]["ms"][0]
                                                for r in ranks],
            "wire_per_step": [r[name]["wire"] for r in ranks],
            "launches": [r[name]["launches"] for r in ranks],
            "ok": ok}))
    print(json.dumps({"phase": "split_decode_wall",
                      "s": time.perf_counter() - t0}))


# -- FSDP over data on the card -----------------------------------------------
# name -> (arch, layers, (batch, seq), (data, model)).  RecurrentGemma-2B's
# one period at full width through K5, K6 and their backward at (2, 1):
# every weight's "fsdp" dim (d_model) split over the 2 data ranks, its
# tied 256,000 x 2,560 f32 table too (1.3 GB a rank, gathered whole twice
# a step through the host); whisper-tiny whole at (2, 2): FSDP with the
# model split (3 of its 6 heads, 768 of its 1,536 d_ff columns a rank),
# encoder, decoder and cross-attention, no kernel on its path
FSDP_CASES = {ARCH: (ARCH, STEP_LAYERS, (2, 4096), (2, 1)),
              WHISPER_ARCH: (WHISPER_ARCH, 4, (2, 4096), (2, 2))}
FSDP_DECODE_TOKENS = 4          # whisper's greedy steps, f32 activations
FSDP_CACHE_LEN = 128
# bars, set before the first run: the forward does not change, so each
# step's loss equals FSDP-off's bit for bit at D = 2; after the update
# every parameter within FSDP_RTOL of FSDP-off's, relative to the leaf's
# largest element (the clipping norm sums in another order); decoded
# tokens equal, logits within FSDP_LOGITS_TOL
FSDP_RTOL = 1e-5
FSDP_LOGITS_TOL = 1e-5
FSDP_TIMEOUT_S = 600


def fsdp_wire_want(mdl, cfg, data: int, model: int) -> dict:
    """Bytes and calls over ``data`` of one FSDP training step under remat,
    worked out from the shapes: every weight that ``DEFAULT_RULES`` split
    over ``data`` gathered whole in f32 (its model slice) once a forward,
    again where remat reruns its layer (every layer but whisper's
    encoder's), the tied table twice (the lookup and the logits); each
    forward gather's gradient reduce-scattered in f32; the other leaves'
    gradients all-reduced in buckets of at most ``BUCKET_BYTES``, the loss
    and the aux loss (4 B each); the clipping norm's sum over ``data``, 4 B
    for each group of leaves split over the same axes that ``data``
    splits."""
    sizes = {"data": data, "model": model}
    moved = calls = 0
    rest, groups = [], set()
    for name, spec in mdl.specs().items():
        parts = resolve_spec(spec.shape, spec.logical,
                             SimpleNamespace(shape=sizes), DEFAULT_RULES)
        axes = frozenset(a for part in parts if part
                         for a in ((part,) if isinstance(part, str) else part)
                         if sizes[a] > 1)
        local = math.prod(spec.shape) // math.prod(sizes[a] for a in axes)
        groups.add(axes)
        if "data" not in axes:
            rest.append(4 * local)
            continue
        uses = 2 if name == "embed" and cfg.tie_embeddings else 1
        again = 1 if name.startswith("enc.") or name in ("embed",
                                                         "unembed") else 2
        moved += 4 * local * data * uses * (again + 1)
        calls += uses * (again + 1)
    buckets, size = 0, None
    for b in rest:
        if size is None or size + b > tp.BUCKET_BYTES:
            buckets, size = buckets + 1, b
        else:
            size += b
    norm = sum(1 for g in groups if "data" in g)
    return {"bytes": moved + sum(rest) + 8 + 4 * norm,
            "calls": calls + buckets + 2 + norm}


def fsdp_setup(name: str, seed: int, rules, mesh, dev,
               whole: dict | None = None, warm: bool = False) -> tuple:
    """FSDP_CASES[name]'s model on ``dev`` from the weights ``whole``
    (None on meta, for the dryrun phase's count: unset), laid out by
    ``rules`` on ``mesh``, this rank's slice of the batch, and AdamW's
    state and the step function, made under the mesh.  ``warm``: first
    the loss's gradients once, untimed, so that the step holds none of
    the process's first-call costs (the kernels' loading, cuBLAS, the
    allocator's first blocks): (the model, its parameters, the
    optimizer's state, the step function, the rank's inputs)."""
    arch, layers, (batch, seq), _ = FSDP_CASES[name]
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    mdl = build_model(cfg, device=dev)
    if whole is not None:
        mdl.load_state_dict(whole)
    tp.shard_parameters(mdl, tp.parameter_layout(mdl, mesh, rules), mesh)
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed + 1))
    glob = {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq),
                                    device=dev, generator=gen)}
    if cfg.family == "audio":
        glob["frames"] = torch.randn((batch, cfg.encoder_seq, cfg.d_model),
                                     device=dev, generator=gen) * 0.02
    step_in = {k: tp.shard_of(v, mesh, named_sharding(
        tuple(v.shape), ("batch",) + (None,) * (v.dim() - 1), mesh))
        for k, v in glob.items()}
    params = dict(mdl.named_parameters())
    opt_cfg = OptConfig(warmup_steps=1, total_steps=2)
    with mesh_context(mesh):
        if warm:
            total = make_loss_fn(mdl, cfg, TRAIN_REMAT)(step_in)[0]
            torch.autograd.grad(total, list(params.values()))
            del total
        return (mdl, params, init_opt_state(params, opt_cfg),
                make_train_step(mdl, cfg, opt_cfg, remat=TRAIN_REMAT),
                step_in)


def fsdp_step(name: str, seed: int, rules, whole: dict, mesh, dev,
              warm: bool = False) -> dict:
    """One make_train_step of FSDP_CASES[name] from the weights ``whole``
    laid out by ``rules`` on ``mesh``: the loss, the step's host ms (it
    ends in the loss's read), the kernels launched and the bytes and calls
    a mesh axis (counts zeroed just before the step and read just after),
    the rank's parameters after the update, parameter and moment bytes,
    the step's peak device memory and its record (:func:`card_memory`).
    ``warm``: see :func:`fsdp_setup`."""
    mdl, params, opt, fn, step_in = fsdp_setup(name, seed, rules, mesh, dev,
                                               whole, warm)
    with mesh_context(mesh):
        _build.reset_launches()
        tp.reset_wire()
        t0 = time.perf_counter()
        (opt, met), mem = card_memory(lambda: fn(opt, step_in),
                                      (params, opt, step_in), dev)
        loss = float(met["loss"])
        ms = (time.perf_counter() - t0) * 1e3
        launches = {k: n for k, n in _build.LAUNCHES.items() if n}
        wire = tp.wire_bytes()
        peak = mem["allocated_peak"] / 1e9
    return {"loss": loss, "ms": ms, "launches": launches, "wire": wire,
            "peak_gb": peak, "memory": mem,
            "params": {n: p.detach() for n, p in params.items()},
            "param_bytes": sum(p.numel() * p.element_size()
                               for p in params.values()),
            "moment_bytes": sum(t.numel() * t.element_size()
                                for t in [*opt.m.values(), *opt.v.values()]),
            "model": mdl}


def fsdp_decode(name: str, seed: int, rules, whole: dict, primed, mesh,
                dev) -> tuple:
    """FSDP_DECODE_TOKENS greedy steps of whisper-tiny (f32 activations)
    from the whole model's primed cache placed on ``mesh``, its weights
    laid out by ``rules``: (logits, tokens), gathered whole."""
    arch, layers = FSDP_CASES[name][:2]
    cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                              dtype="float32")
    mdl = build_model(cfg, device=dev)
    mdl.load_state_dict(whole)
    tp.shard_parameters(mdl, tp.parameter_layout(mdl, mesh, rules), mesh)
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    toks = torch.randint(0, cfg.vocab_size, (SPLIT_BATCH, FSDP_DECODE_TOKENS),
                         device=dev, generator=gen)
    rows = named_sharding(tuple(toks.shape), ("batch", None), mesh)
    cols = named_sharding((SPLIT_BATCH, FSDP_DECODE_TOKENS, cfg.vocab_size),
                          ("batch", None, "vocab"), mesh)
    toks = tp.shard_of(toks, mesh, rows)
    logits, nxt = [], []
    with mesh_context(mesh), torch.inference_mode():
        step = make_decode_step(mdl, cfg)
        cache = tp.shard_cache(primed, mesh)
        for t in range(FSDP_DECODE_TOKENS):
            n, lg, cache = step(cache, toks[:, t:t + 1], t)
            logits.append(lg)
            nxt.append(n)
    return (tp.whole_of(torch.cat(logits, 1), mesh, cols),
            tp.whole_of(torch.cat(nxt, 1), mesh, rows))


def fsdp_run(name: str, seed: int) -> dict:
    """One rank of FSDP_CASES[name]: the same training step from the same
    weights with FSDP off (the trainer's rules) and on (DEFAULT_RULES);
    each parameter of this rank after the update against FSDP-off's same
    slice, relative to that leaf's largest element; whisper's decode both
    ways.  The whole weights and FSDP-off's updated ones wait on the host,
    so that a rank's device holds one layout at a time."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    arch, layers, _, (d, m) = FSDP_CASES[name]
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    mesh = make_local_mesh(d, m)
    src = family_model(cfg, dev, seed)
    whole = {k: v.detach().cpu() for k, v in src.state_dict().items()}
    primed = None
    if cfg.family == "audio":
        f32 = dataclasses.replace(cfg, dtype="float32")
        src32 = build_model(f32, device=dev)
        src32.load_state_dict(whole)
        primed = primed_cache(src32, f32, seed, FSDP_CACHE_LEN)
        del src32
    del src
    torch.cuda.empty_cache()
    rec = {"rank": dist.get_rank()}
    off = fsdp_step(name, seed, None, whole, mesh, dev, warm=True)
    off_params = {n: p.cpu() for n, p in off.pop("params").items()}
    del off["model"]
    torch.cuda.empty_cache()
    on = fsdp_step(name, seed, DEFAULT_RULES, whole, mesh, dev)
    specs, data = on["model"].specs(), tp.mesh_axis("data", mesh)
    worst = 0.0
    for n, p in on.pop("params").items():
        want = off_params.pop(n).to(dev)
        scale = want.abs().max().item() or 1.0
        if p.shape != want.shape:                # this rank's data slice
            dim = tp.fsdp_dim(specs[n])
            want = want.narrow(dim, data.rank * p.shape[dim], p.shape[dim])
        worst = max(worst, (p - want).abs().max().item() / scale)
        del want
    rec["elements_predicted"] = predicted_elements(on["model"], d, m,
                                                   DEFAULT_RULES)
    rec["wire_want"] = fsdp_wire_want(on["model"], cfg, d, m)
    del on["model"], off_params
    torch.cuda.empty_cache()
    rec.update(off=off, on=on, param_rel=worst)
    if primed is not None:
        lo, to = fsdp_decode(name, seed, None, whole, primed, mesh, dev)
        lf, tf = fsdp_decode(name, seed, DEFAULT_RULES, whole, primed, mesh,
                             dev)
        rec["decode_err"] = (lf - lo).abs().max().item()
        rec["decode_tokens_equal"] = bool(torch.equal(tf, to))
        rec["decode_finite"] = bool(torch.isfinite(lf).all())
    return rec


def fsdp_phase(seed: int, failures: list[str]) -> None:
    """FSDP over ``data`` on the one card: each FSDP_CASES case on gloo
    ranks sharing the card (``fsdp_run``); each rank's FSDP step against
    its FSDP-off step from the same weights (the loss bit for bit, the
    updated parameters within FSDP_RTOL), the kernels each launched (K5, K6
    and their backward: ``train_launches``), the bytes and calls over
    ``data`` against ``fsdp_wire_want``, over ``model`` equal to
    FSDP-off's, the parameter and moment bytes against ``resolve_spec``
    under DEFAULT_RULES; whisper's decode both ways (tokens equal, logits
    within FSDP_LOGITS_TOL)."""
    t0 = time.perf_counter()
    for name, (arch, layers, (batch, seq), (d, m)) in FSDP_CASES.items():
        t_case = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        want = {k: n for k, n in train_launches(cfg, TRAIN_REMAT).items()
                if n}
        torch.cuda.empty_cache()
        ranks = run_local_world(fsdp_run, d * m, name, seed,
                                timeout=FSDP_TIMEOUT_S)
        torch.cuda.empty_cache()
        if name == ARCH:        # rank 0's FSDP step, for the dryrun phase
            MEM_ON_CARD["fsdp"] = ranks[0]["on"]["memory"]
        checks = []
        for r in ranks:
            on, off = r["on"], r["off"]
            model_on = {k: v for k, v in on["wire"].items() if k != "data"}
            model_off = {k: v for k, v in off["wire"].items()
                         if k != "data"}
            checks.append({
                "loss_equal": on["loss"] == off["loss"]
                and math.isfinite(on["loss"]),
                "params": r["param_rel"] <= FSDP_RTOL,
                "launches": on["launches"] == want == off["launches"],
                "wire_data": on["wire"].get("data") == r["wire_want"],
                "wire_model": model_on == model_off,
                "param_bytes": on["param_bytes"]
                == 4 * r["elements_predicted"],
                "moment_bytes": on["moment_bytes"]
                == 8 * r["elements_predicted"],
                "decode": "decode_err" not in r or (
                    r["decode_err"] <= FSDP_LOGITS_TOL
                    and r["decode_tokens_equal"] and r["decode_finite"])})
        ok = all(all(c.values()) for c in checks)
        if not ok:
            failures.append(f"fsdp {name} {(d, m)}: checks {checks}, ranks "
                            f"{[{k: v for k, v in r.items()} for r in ranks]}")
        print(json.dumps({
            "phase": "fsdp", "arch": arch, "layers": layers,
            "d_model": cfg.d_model, "param_dtype": cfg.param_dtype,
            "dtype": cfg.dtype, "tokens": [batch, seq], "remat": TRAIN_REMAT,
            "data": d, "model": m, "ranks": d * m, "backend": "gloo",
            "loss": [r["on"]["loss"] for r in ranks],
            "loss_fsdp_off": [r["off"]["loss"] for r in ranks],
            "param_rel": [r["param_rel"] for r in ranks],
            "param_rtol": FSDP_RTOL,
            "step_ms": [r["on"]["ms"] for r in ranks],
            "step_ms_fsdp_off": [r["off"]["ms"] for r in ranks],
            "peak_gb": [r["on"]["peak_gb"] for r in ranks],
            "peak_gb_fsdp_off": [r["off"]["peak_gb"] for r in ranks],
            "launches": [r["on"]["launches"] for r in ranks],
            "launches_want": want,
            "wire": [r["on"]["wire"] for r in ranks],
            "wire_fsdp_off": [r["off"]["wire"] for r in ranks],
            "wire_data_want": ranks[0]["wire_want"],
            "param_bytes": [r["on"]["param_bytes"] for r in ranks],
            "param_bytes_fsdp_off": [r["off"]["param_bytes"] for r in ranks],
            "moment_bytes": [r["on"]["moment_bytes"] for r in ranks],
            "elements_predicted": [r["elements_predicted"] for r in ranks],
            "decode_max_abs_logit_diff": [r.get("decode_err")
                                          for r in ranks],
            "decode_tokens_equal": [r.get("decode_tokens_equal")
                                    for r in ranks],
            "logits_tol": FSDP_LOGITS_TOL, "checks": checks, "ok": ok}))
        print(json.dumps({"phase": "fsdp_case_wall", "arch": arch,
                          "s": time.perf_counter() - t_case}))
    print(json.dumps({"phase": "fsdp_wall", "s": time.perf_counter() - t0}))


# -- the multi-pod dry run (launch/dryrun.py), on the CPU ---------------------
# Eight cells of the single mesh (16 x 16 = 256 ranks), each run as rank 0
# of a fake world on meta tensors in one subprocess with the card hidden;
# the RecurrentGemma cells' K5/K6 tally is held to what the lm, train and
# split_decode phases launched on the card (ON_CARD), and tinyllama's,
# granite's, rwkv6's, whisper's and qwen2-vl's must be empty.
DRYRUN_CELLS = (("tinyllama-1.1b", "train_4k", None),
                (ARCH, "prefill_32k", "prefill"), (ARCH, "train_4k", "train"),
                (ARCH, "decode_32k", "decode"),
                (MOE_ARCH, "train_4k", None),      # FF: 40 experts over 16
                (RWKV_ARCH, "train_4k", None),     # 4 WKV heads a rank
                (WHISPER_ARCH, "train_4k", None),  # d_ff over 16, the rest
                                                   # whole
                (VLM_ARCH, "train_4k", None))      # d_ff and the vocab
                                                   # over 16, heads whole
# cell -> the counts its record must give, as the CPU of the repo's tests
# gives them (``python -m repro_torch.launch.dryrun --arch rwkv6-7b
# --shape train_4k``, torch 2.13; whisper-tiny's and qwen2-vl-2b's the
# same way), laid out by DEFAULT_RULES (FSDP over data).  The collective
# bytes were worked out from the shapes before that run: FSDP-off's, plus
# each FSDP weight's model slice gathered in f32 (twice where remat reruns
# its layer; the tied table twice) and its gradient reduce-scattered once
# a forward gather, less the all-reduce of those gradients over data, plus
# 4 B a further sum of the clipping norm (rwkv6 4,093,640,704 +
# 2,113,929,216 - 2,113,929,204; whisper 211,823,616 + 191,179,776 -
# 111,515,128; qwen2-vl 1,927,839,744 + 1,022,263,296 - 963,919,864)
DRYRUN_COUNTS = {(RWKV_ARCH, "train_4k"): {
    "flops_per_device": 200_867_097_608_192.0,
    "bytes_per_device": 18_334_812_308_620.0,
    "collective_bytes_per_device": 317_838_901_080,
    "wkv_analytic_flops": 184_672_856_309_760.0},
    (WHISPER_ARCH, "train_4k"): {
    "flops_per_device": 19_646_718_148_608.0,
    "bytes_per_device": 1_521_966_770_636.0,
    "collective_bytes_per_device": 1_503_255_572},
    (VLM_ARCH, "train_4k"): {
    "flops_per_device": 279_475_132_563_456.0,
    "bytes_per_device": 18_109_421_279_044.0,
    "collective_bytes_per_device": 26_305_353_556}}
DRYRUN_TIMEOUT_S = 300
DRYRUN_CODE = """
import json, sys
from repro_torch.kernels import _build
from repro_torch.launch import dryrun
for arch, shape in json.loads(sys.argv[1]):
    rec = dryrun.run_cell(arch, shape, "single")
    print(json.dumps({"record": rec, "launches": {
        k: w["launches"] for k, w in _build.meta_work().items()}}), flush=True)
"""


MEMORY_CODE = """
import json
import chip_smoke
print(json.dumps(chip_smoke.meta_memory_counts()), flush=True)
"""


def meta_memory_counts(seed: int = 0) -> dict[str, dict]:
    """MEMORY_STEPS counted on meta (``launch.dryrun.count_memory``), each
    step built by the card's own builder: the lm phase's prefill of
    RecurrentGemma-2B (:func:`prefill_setup`), the train phase's step of
    the whole model (:func:`train_setup`), and rank 0 of the fsdp phase's
    step of one period at (2, 1), FSDP on (DEFAULT_RULES,
    :func:`fsdp_setup`), in a fake world of 2 ranks.  Over gloo the card
    stages each payload on the host and copies the result back, where the
    fake backend leaves it in place: the same device bytes, so the count
    takes no term for the transport (the all-gather's staging copy of its
    input, which the fake backend holds on meta and gloo on the host,
    lives only while the gathered parts are made, fewer bytes than the
    parts and their concatenation that follow)."""
    meta = torch.device("meta")
    out = {}
    _, prefill, inputs = prefill_setup(meta, seed)
    out["prefill"] = count_memory(prefill, inputs)[1]
    del prefill, inputs

    _, params, state, step_fn, (batch,) = train_setup(meta, seed, 1)
    out["train"] = count_memory(lambda: step_fn(state, batch),
                                (params, state, batch), params)[1]
    del params, state, step_fn, batch

    d, m = FSDP_CASES[ARCH][3]
    with fake_world(d * m):
        mesh = make_local_mesh(d, m, device="cpu")
        _, params, opt, fn, step_in = fsdp_setup(ARCH, seed, DEFAULT_RULES,
                                                 mesh, meta)
        with mesh_context(mesh):
            out["fsdp"] = count_memory(lambda: fn(opt, step_in),
                                       (params, opt, step_in), params)[1]
    return out


def memory_lines(counted: dict[str, dict], failures: list[str]) -> None:
    """Each of MEMORY_STEPS counted on meta against the card's reading
    (MEM_ON_CARD): a ``memory`` line each; arguments unequal or a temp
    past max(MEMORY_RTOL of the card's, MEMORY_ATOL) fails the phase.
    A step the card has not run (the phase run alone) is printed, not
    held; ``main`` runs every one."""
    total = torch.cuda.get_device_properties(0).total_memory
    for name in MEMORY_STEPS:
        mine, card = counted[name], MEM_ON_CARD.get(name)
        line = {"phase": "memory", "step": name,
                "counted": {k.removesuffix("_size_in_bytes")
                            .removesuffix("_memory_in_bytes"): v
                            for k, v in mine.items()
                            if k != "generated_code_size_in_bytes"},
                "card": card, "card_total_memory": total,
                "card_name": torch.cuda.get_device_name(0)}
        if card is None:        # the phase run alone: counted, not held
            print(json.dumps({**line, "ok": None}))
            continue
        gap = mine["temp_size_in_bytes"] - card["temp"]
        bar = max(MEMORY_RTOL * card["temp"], MEMORY_ATOL)
        args_equal = mine["argument_size_in_bytes"] == card["argument"]
        ok = args_equal and abs(gap) <= bar
        if not ok:
            failures.append(f"memory {name}: counted {mine}, card {card}, "
                            f"temp gap {gap} (bar {bar}), arguments equal "
                            f"{args_equal}")
        print(json.dumps({**line, "card_peak": card["argument"]
                          + card["temp"], "temp_gap": gap,
                          "temp_gap_rel": gap / card["temp"], "bar": bar,
                          "arguments_equal": args_equal, "ok": ok}))


def host_process(code: str, *argv: str) -> subprocess.Popen:
    """``python -c code argv`` started from the repo's root with the card
    hidden."""
    root = Path(__file__).resolve().parent
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "",
           "PYTHONPATH": os.pathsep.join(
               [str(root / "src")] + [p for p in [os.environ.get(
                   "PYTHONPATH")] if p])}
    return subprocess.Popen([sys.executable, "-c", code, *argv], cwd=root,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def dryrun_phase(failures: list[str]) -> None:
    """``launch.dryrun.run_cell`` on ``DRYRUN_CELLS`` in a CPU subprocess
    (no card, no jax): each record's ``ok``, flops, parameter and
    collective bytes a device and roofline step time printed
    (``dryrun`` lines), its K5/K6 launches on meta beside the card's;
    MEMORY_STEPS counted on meta in a second one, beside it, each held
    to the card's reading (``memory`` lines)."""
    t0 = time.perf_counter()
    cells = [[a, s] for a, s, _ in DRYRUN_CELLS]
    procs = [host_process(DRYRUN_CODE, json.dumps(cells)),
             host_process(MEMORY_CODE)]
    outs = []
    try:
        for p in procs:
            left = max(1.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - t0))
            outs.append(p.communicate(timeout=left) + (p.returncode,))
    except subprocess.TimeoutExpired:
        failures.append(f"dryrun: not done in {DRYRUN_TIMEOUT_S} s")
        return
    finally:
        for p in procs:
            p.kill()
            p.wait()
    (stdout, stderr, rc), (mem_out, mem_err, mem_rc) = outs
    lines = [json.loads(ln) for ln in stdout.splitlines()
             if ln.startswith("{")]
    if rc != 0 or len(lines) != len(DRYRUN_CELLS):
        failures.append(f"dryrun: exit {rc}, {len(lines)} of "
                        f"{len(DRYRUN_CELLS)} records:\n{stderr[-3000:]}")
        return
    if mem_rc != 0:
        failures.append(f"dryrun memory counts: exit {mem_rc}:\n"
                        f"{mem_err[-3000:]}")
        return
    for (arch, shape, on_card), out in zip(DRYRUN_CELLS, lines):
        rec, launches = out["record"], out["launches"]
        want = ON_CARD[on_card] if on_card else {}
        counts = DRYRUN_COUNTS.get((arch, shape), {})
        got_counts = {k: rec.get(k) for k in counts}
        ok = (rec["ok"] and rec["flops_per_device"] > 0
              and rec["param_bytes_per_device"] > 0 and launches == want
              and got_counts == counts)
        if not ok:
            failures.append(f"dryrun {arch} x {shape}: ok {rec['ok']}, "
                            f"flops {rec['flops_per_device']}, launches on "
                            f"meta {launches} (on the card {want}), counts "
                            f"{got_counts} (want {counts})")
        print(json.dumps({
            "phase": "dryrun", "arch": arch, "shape": shape,
            "mesh": rec["mesh"], "chips": rec["chips"], "ok": rec["ok"],
            "flops_per_device": rec["flops_per_device"],
            "bytes_per_device": rec["bytes_per_device"],
            "param_bytes_per_device": rec["param_bytes_per_device"],
            "collective_bytes_per_device":
                rec["collective_bytes_per_device"],
            "wkv_analytic_flops": rec["wkv_analytic_flops"],
            "memory_analysis": rec["memory_analysis"],
            "roofline_step_time_s": rec["roofline"]["step_time_s"],
            "roofline_dominant": rec["roofline"]["dominant"],
            "lower_s": rec["lower_s"], "launches_meta": launches,
            "launches_card": want, "counts_want": counts or None,
            "checks_ok": ok}))
    memory_lines(json.loads(mem_out.splitlines()[-1]), failures)
    print(json.dumps({"phase": "dryrun_wall",
                      "s": time.perf_counter() - t0}))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise SystemExit(f"chip_smoke.py needs a CUDA device (asked for "
                         f"{args.device}; torch.cuda.is_available() is "
                         f"{torch.cuda.is_available()})")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    name = torch.cuda.get_device_name(dev)
    part = "pcie" if "pcie" in name.lower() else "sxm"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()

    t_script = t0 = time.perf_counter()
    sources = sorted({Path(src).stem for _, src, _ in KERNELS.values()})
    _build.build(*sources)
    print(f"built {sources} in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ptxas": read_ptxas(PTXAS_SOURCES)}))
    cases = make_cases(dev, args.seed)
    torch.cuda.synchronize()

    # -- the main path, counted -------------------------------------------
    _build.reset_launches()
    t0 = time.perf_counter()
    for case in cases:
        case.y = case.run()
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {k: _build.LAUNCHES.get(k, 0) for k in STENCIL_KERNELS}
    print(f"main path: {len(cases)} calls in {main_s:.3f} s, launches {launches}")

    # -- correctness --------------------------------------------------------
    failures = [f"{k}: not launched on the main path"
                for k, n in launches.items() if n == 0]
    errs: dict[tuple[str, torch.dtype], float] = {}
    for case in cases:
        y, tol = case.y, TOL[case.x.dtype]
        ok_shape = y.shape == case.x.shape and y.dtype == case.x.dtype
        finite = bool(torch.isfinite(y).all())
        err = (y.float() - case.plain().float()).abs().max().item()
        key = (case.kernel, case.x.dtype)
        errs[key] = max(errs.get(key, 0.0), err)
        host_err = None
        if case.name.startswith("paper"):
            want = stencil_reference_np(case.x.cpu().numpy(), case.spec)
            host_err = float(np.abs(y.float().cpu().numpy() - want).max())
        good = ok_shape and finite and err <= tol and (host_err is None
                                                      or host_err <= tol)
        if not good:
            failures.append(f"{case.name}: shape/dtype ok {ok_shape}, finite "
                            f"{finite}, err vs plain {err}, err vs host "
                            f"oracle {host_err}, tol {tol}")
        print(json.dumps({"case": case.name, "kernel": case.kernel,
                          "shape": list(case.x.shape),
                          "dtype": str(case.x.dtype).removeprefix("torch."),
                          "timesteps": case.spec.timesteps,
                          "max_abs_err": err, "host_err": host_err,
                          "tol": tol, "ok": good}))
    if failures:
        print("\n".join(failures), file=sys.stderr)
        return 1

    # -- the CGRA model against K1-K4 (launches counted anew) ---------------
    cgra_cases = cgra_phase(dev, args.seed, failures)
    if failures:
        print("\n".join(failures), file=sys.stderr)
        return 1

    # -- K7: the tuner's batched stage 1 on the card (launches counted) ----
    k7_row = cgra_batch_phase(dev, args.seed, cgra_cases, failures)
    if failures:
        print("\n".join(failures), file=sys.stderr)
        return 1

    # -- the LM path: K5/K6, prefill, decode check, serving -----------------
    lm_rows = lm_phase(dev, args.seed, part, failures)
    if failures:
        print("\n".join(failures), file=sys.stderr)
        return 1

    # -- training: K5/K6 backward, a whole step, the full model, the CLI ----
    train_rows = train_phase(dev, args.seed, part, failures)
    if failures:
        print("\n".join(failures), file=sys.stderr)
        return 1

    # -- the other LM families (no hand-written kernel on their paths) -------
    families_phase(dev, args.seed, failures)
    if failures:
        print("\n".join(failures), file=sys.stderr)
        return 1

    # -- observability: lint, traces, the seismic walkthrough ---------------
    observe_phase(args.seed, failures)
    if failures:
        print("\n".join(failures), file=sys.stderr)
        return 1

    # -- the multi-device slice: 4 gloo ranks on the card, then NCCL -------
    distributed_phase(args.seed, failures)
    if failures:
        print("\n".join(failures), file=sys.stderr)
        return 1

    # -- the trainer's parallel slice: (2, 1) and (1, 2) on the card -------
    train_parallel_phase(args.seed, failures)
    if failures:
        print("\n".join(failures), file=sys.stderr)
        return 1

    # -- decode split over the model axis: one rank, then (1, 2) -----------
    split_decode_phase(args.seed, failures)
    if failures:
        print("\n".join(failures), file=sys.stderr)
        return 1

    # -- FSDP over data: RecurrentGemma-2B at (2, 1), whisper at (2, 2) -----
    fsdp_phase(args.seed, failures)
    if failures:
        print("\n".join(failures), file=sys.stderr)
        return 1

    # -- the multi-pod dry run on the CPU, its tally against the card's ----
    failures += [f"memory {n}: no reading on the card"
                 for n in MEMORY_STEPS if n not in MEM_ON_CARD]
    dryrun_phase(failures)
    if failures:
        print("\n".join(failures), file=sys.stderr)
        return 1

    # -- timing (launches here are not counted above) -----------------------
    timed, paper_ms = {}, {}
    for case in cases:
        if not case.name.startswith("deploy"):
            paper_ms[case.name] = median_ms(case.run, reps=20)
            print(json.dumps({"case": case.name, "ms": paper_ms[case.name]}))
            continue
        ms = median_ms(case.run, reps=20)
        plain_ms = median_ms(case.plain, reps=10)
        library_ms = median_ms(case.library, reps=10)
        bound_ms, bound_by = case.bound(part)
        print(json.dumps({"case": case.name, "ms": ms, "plain_ms": plain_ms,
                          "library_ms": library_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by}))
        timed[(case.kernel, case.x.dtype)] = (ms, plain_ms, library_ms,
                                              bound_ms, bound_by)
    cgra_roofline_lines(paper_ms, part)
    generic_3d(dev, args.seed, part, failures)
    stencil1d_lines(dev, args.seed, part, failures)
    if failures:
        print("\n".join(failures), file=sys.stderr)
        return 1
    rows = []
    for case in cases:
        if not case.timed:
            continue
        ms, plain_ms, library_ms, bound_ms, bound_by = timed[(case.kernel,
                                                              torch.float32)]
        bf = timed[(case.kernel, torch.bfloat16)]
        route, source, replaces = KERNELS[case.kernel]
        rows.append({
            "name": case.kernel, "route": route, "source": source,
            "replaces": replaces, "launches": launches[case.kernel],
            "dtype": "float32",
            "max_abs_err": errs[(case.kernel, torch.float32)],
            "tol": TOL[torch.float32],
            "max_abs_err_bf16": errs[(case.kernel, torch.bfloat16)],
            "tol_bf16": TOL[torch.bfloat16],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "ms_bf16": bf[0], "bound_ms_bf16": bf[3], "bound_by_bf16": bf[4],
            "shape": list(case.x.shape), "part": part})
    print(json.dumps({"phase": "script_wall",
                      "s": time.perf_counter() - t_script}))
    print(json.dumps({"kernels": rows + lm_rows + [k7_row] + train_rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}))   # the card it drove
    return 0


if __name__ == "__main__":
    sys.exit(main())
