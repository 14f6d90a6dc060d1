"""The port's dry run against the reference's (``repro.launch.dryrun``),
on ``tinyllama-1.1b x train_4k`` on the single production mesh, cut to one
layer of width 256 (``OVERRIDES``) and without the scan correction (one
layer has no scan to correct).

The reference runs in a subprocess: its module sets ``XLA_FLAGS`` for 512
host devices before jax starts, and this process keeps one.  It saves its
record and the optimized HLO text of its compile.

Equal: ``param_count``, ``param_bytes_per_device``, ``model_flops``, the
record's keys, ``configs.cells()``, the private copies ``_clone_cfg`` and
``_wkv_analytic_flops`` on every cell; ``analysis.hlo``'s
``collective_bytes`` and ``remat_duplication`` on that HLO text;
``analysis.rooflines``' ``dryrun_table`` and ``roofline_table`` on the
reference's records.  Not compared: times, memory analysis, bytes and
collective bytes (XLA's fused counts against the port's op-by-op ones).

Tolerance, set before the first run: ``flops_per_device`` within
``FLOPS_RTOL`` 0.2, relative to the reference's.  The port counts matrix
products (``FlopCounterMode``) and K5/K6's own operations; XLA's cost
analysis also counts every elementwise op and reduction, of which the
softmax over each head's (4096, 4096) scores is the largest here (a few
percent of the total at width 256), so the port's count is expected below
the reference's by that much.

The decode cell ``tinyllama-1.1b x decode_32k`` on the single mesh at the
same ``OVERRIDES`` (16 heads, 4 KV heads, head_dim 16): equal
``param_count``, ``param_bytes_per_device`` (27,648), ``model_flops``
(2.76824064e8) and keys.  Its ``flops_per_device`` and collective bytes
are printed beside the reference's (2.994448e7; 270,880 B, of which
208,384 B its FSDP all-gathers) and held, set before the first run, to
the counts worked out from the shapes.  A rank holds 8 of the 128 rows,
1 of the 16 query heads, all 4 KV heads (4 does not split 16 ways),
2,048 of the cache's 32,768 slots, 32 of the 512 MLP columns and 64 of
the 1,024 vocabulary rows, and of each weight 1/16 of its ``"fsdp"`` dim
(d_model 256) over ``data`` (``DEFAULT_RULES``); activations bf16:
- products (``DECODE_FLOPS``, 2·M·N·K each): wq 2·8·256·16 = 65,536; wk
  and wv 2·8·256·64 each, 524,288; every head's scores and weighted sum
  over the rank's slots, 2·(8·4·4)·2,048·16 each, 16,777,216; wo
  2·8·16·256 = 65,536; the MLP's three 2·8·256·32, 393,216; the logits
  2·8·256·64 = 262,144; in all 18,087,936;
- collectives (``DECODE_COLLECTIVES``, per device, f32 unless named):
  all-reduces of the embedding's rows 8·256·4 = 8,192 B, the softmax
  maxima 8·16·4 = 512, the rescaled outputs and sums (8·16·16 + 8·16)·4
  = 8,704, wo's and the MLP's partial sums 8,192 each, the greedy token's
  max (8·4 = 32) and min (int64, 8·8 = 64): 33,888 B in 7 calls; the
  all-gather of the query heads, 16 ranks' 8·16 bf16, 4,096 B in 1 call;
  FSDP's all-gathers over ``data`` of every weight's model slice in f32,
  as held: ``embed``'s 64 rows and ``unembed``'s 64 columns by 256,
  65,536 B each, wq and wo (one head) 16,384 each, wk and wv (4 KV heads)
  65,536 each, the MLP's three 256·32·4 = 32,768 each: 393,216 B in 9
  calls, 397,312 B of all-gathers in 10 calls in all.  The reference's
  compiled step (``hlo.txt``'s all-gathers) gathers in f32 too, but only
  wq, wo, the MLP's three and ``unembed``, 196,608 B in 6 calls of its
  208,384: XLA looks the tokens up in the rank's slice of ``embed``
  rather than gather the table, and multiplies by the rank's d_model
  slice of wk/wv, then moves the partial K/V activations; the port
  gathers every weight a layer uses before the layer runs.

The MoE cells ``granite-moe-1b-a400m x prefill_32k`` (32 experts: EP, 2 a
rank, the router split) and ``granite-moe-3b-a800m x prefill_32k`` (40
experts, which 16 does not divide: FF, every expert whole with 4 of its
64 ``d_ff`` columns, the router whole) on the single mesh at
``MOE_OVERRIDES`` (one layer, width 256, 16 heads, 8 KV heads, d_ff 64,
vocabulary 1,024): equal ``param_count``, ``param_bytes_per_device``,
``model_flops`` and keys (the reference's 2,040,576 / 50,304 /
1.80388626432e12 and 2,435,840 / 58,880 / 1.808181231616e12).  Their
``flops_per_device`` is held to the count worked out from the shapes
below (``MOE_FLOPS``; worked out after the port's first run, which gave
it to the flop), and the EP cell's also within ``FLOPS_RTOL`` of the
reference's 1.91715868672e11.  The FF cell's is 2.6x the reference's
1.93332363264e11 by design: GSPMD splits the dispatched tokens' capacity
over ``model`` (``expert_cap``), while every rank of the port dispatches
and combines every token and splits the experts' ``d_ff``.  Collective
bytes are printed beside the reference's (GSPMD all-gathers the
dispatched tokens; the port sums one partial output a layer) and held to
``MOE_COLLECTIVES``.  A rank holds 2 rows of 32,768 tokens: 128 groups
of g = 512, capacity C = int(512·8/E·1.25), 160 (E 32) or 128 (E 40);
activations bf16, the router and logits f32; 1 of the 16 query heads, wk
and wv whole (8 KV heads; the rank's head picks one); 64 of the 1,024
vocabulary rows.  Products (2·M·N·K each; T = 65,536 tokens):
- both cells: wq and wo 2·T·256·16 each, 1,073,741,824; wk and wv
  2·T·256·128 each, 8,589,934,592; the logits 2·T·256·64 = 2,147,483,648;
  the rank's head's scores and weighted sum 2·(2·1)·32,768²·16 each,
  137,438,953,472;
- EP (E_r = 2 experts of 32, C 160): the router, gathered,
  2·T·256·32 = 1,073,741,824; the narrowed one-hot dispatch
  2·128·512·8·2·160 = 335,544,320; ``xe`` and the combine
  2·128·512·2·160·256 each, 21,474,836,480; the experts' three
  2·2·(128·160)·256·64 each, 4,026,531,840; in all 176,160,768,000;
- FF (40 experts, 4 d_ff columns, C 128): the router 2·T·256·40 =
  1,342,177,280; the one-hot dispatch 2·128·512·8·40·128 =
  5,368,709,120; ``xe`` and the combine 2·128·512·40·128·256 each,
  343,597,383,680; the experts' three 2·40·(128·128)·256·4 each,
  4,026,531,840; in all 503,584,915,456.
Collectives (f32): all-reduces of the embedding's rows, wo's partial sums
and the MoE's partial output, T·256·4 = 67,108,864 B each, and the routed
fractions' mean over ``data`` (E·4 B): 201,326,720 (EP) and 201,326,752
(FF) in 4 calls; EP's all-gather of the router over ``model``, 256·32·4 =
32,768 B in 1 call.  FSDP's all-gathers over ``data`` (f32, as held),
each weight's model slice whole along d_model: the tied table's 64 rows
twice (lookup and logits), 65,536 B each; wq and wo (one head) 16,384
each; wk and wv (8 KV heads, whole over ``model``) 131,072 each; EP: the
router's 2 columns 2,048, each of the experts' three (2 experts)
2·256·64·4 = 131,072: 821,248 B in 10 calls (854,016 B of all-gathers
in 11 in all); FF: the router whole over ``model``, 40,960, each of the
experts' three (40 experts, 4 ``d_ff`` columns) 163,840: 958,464 B in 10
calls.
The RWKV cell ``rwkv6-7b x train_4k`` on the single mesh at
``RWKV_OVERRIDES`` (one layer, width 256, 16 WKV heads of 16, d_ff 512,
vocabulary 1,024): equal keys, ``param_count``,
``param_bytes_per_device``, ``model_flops`` and ``wkv_analytic_flops``.
Its ``flops_per_device`` and collective bytes are printed beside the
reference's and held to the counts worked out from the shapes before the
port's first run of this cell (``RWKV_FLOPS``, ``RWKV_COLLECTIVES``).
XLA's cost analysis counts its fused program, the ddlerp's elementwise
work included, and the port its products op by op, the recomputed ones
too, so the reference's flops are no bar here (the port's came out 1.10x
them).  A rank holds 16 of the 256 rows (T =
65,536 tokens), 1 of the 16 heads (16 of wr/wk/wv/wg's columns and of
wo's rows), 32 of d_ff's 512 columns, 16 of cm_wr's 256 and 64 of the
1,024 vocabulary rows; the step runs under remat "dots", which keeps the
matrix products' outputs and recomputes the batched ones.  Products
(2·M·N·K each), per token: ``tm_w1`` 2·256·160 = 81,920, ``tm_w2`` (a
batched product over the 5 streams) 2·5·32·256 = 81,920, ``w_lora1``
2·256·64 = 32,768, the rank's columns of ``w_lora2`` 2·64·16 = 2,048,
wr/wk/wv/wg 4·2·256·16 = 32,768, wo 2·16·256 = 8,192, ``cm_wk`` and
``cm_wv`` 2·256·32 each, 32,768, ``cm_wr`` 2·256·16 = 8,192, the logits
2·256·64 = 32,768: 313,344 a token forward, twice that backward, and
``tm_w2``'s 81,920 again in the recompute; the WKV step once (its other
4,095 steps are ``wkv_analytic_flops``), 2·16·16·16 = 8,192 forward,
twice that backward, once more recomputed: 65,536·1,021,952 + 32,768 =
66,974,679,040.  (The first run gave 62,411,276,288 and 3 all-reduces,
132,096 B, fewer: the meta step's output did not read the decay, so the
decay's LoRA had no backward, 2·(32,768 + 2,048) a token, and ``w0``,
``w_lora1`` and ``w_lora2`` no gradient to sum; ``rwkv6._wkv_scan`` now
reads the meta step's output from the state it updated.)  Collectives (f32): all-reduces of the embedding's rows,
wo's and the value half's partial sums (each twice: forward and
recompute), the gradients of the logits' input, of the time mix's input
and of the channel mix's two mixed inputs, T·256·4 = 67,108,864 B each
(9); the cross entropy's max, sum and target logit, 16·4,095·4 = 262,080
each (3); the time mix's 8 replicated parameters' gradients, 466,944 (8);
the global norm's sums over the axes that split its leaves, (model,
data), data alone (the LoRAs), model alone (``u``), 4 each (4); over
``data`` the gradients of the 3,344 elements FSDP does not split (the
mixes, ``w0``, ``u``'s slice, the norm scales), 13,376, the loss and the
aux loss, 4 each (3): 605,246,360 B in 27 calls; the receptance's
all-gathers, forward and recompute, 67,108,864 each, and FSDP's over
``data`` (f32, as held) of the layer's twelve weights' model slices,
``tm_w1`` and ``tm_w2`` 163,840 each, the LoRAs of the decay 65,536 each,
wr/wk/wv/wg 16,384 each, wo 16,384, ``cm_wk`` and ``cm_wv`` 32,768 each,
``cm_wr`` 16,384, 622,592 B, twice (forward and recompute), and of
``embed`` and ``unembed`` 65,536 each: 135,593,984 B in 28 calls; the
reduce-scatters of the gathered weights' gradients over ``data``, once a
forward gather, 753,664 B in 14 calls (the 188,416 gradient elements the
all-reduce over ``data`` no longer carries).

The whisper cell ``whisper-tiny x train_4k`` on the single mesh at full
width, cut to one encoder and one decoder layer (``WHISPER_OVERRIDES``):
equal keys, ``param_count``, ``param_bytes_per_device``, ``model_flops``
and ``wkv_analytic_flops``.  Its ``flops_per_device`` and collective
bytes are printed beside the reference's and held to the counts worked
out from the shapes (``WHISPER_FLOPS``, ``WHISPER_COLLECTIVES``).  On the
16-way model axis a rank holds 16 of the 256 rows (N = 65,536 decoder
tokens, F = 24,000 encoder frames), every attention whole (6 heads, which
16 does not divide), the cross K/V whole (6 KV heads), 96 of the MLPs'
1,536 ``d_ff`` columns and the whole 51,865-row tied vocabulary; the
decoder block runs under remat "dots" (the encoder is not
checkpointed, as the reference's is not), which keeps the matrix
products' outputs and recomputes the batched ones.  Products (2·M·N·K
each), forward:
- the encoder layer: wq, wk, wv and wo 2·F·384·384 each, 28,311,552,000;
  the scores and the weighted sum, 2·(16·6)·1,500²·64 each,
  55,296,000,000; the MLP's three 2·F·384·96, 5,308,416,000: in all
  88,915,968,000;
- the decoder layer: the self attention's wq, wk, wv and wo and the cross
  attention's wq and wo, 2·N·384·384 each, 115,964,116,992; the self
  scores and weighted sum, 2·(16·6)·4,096²·64 each, 412,316,860,416; the
  cross K/V, 2·F·384·384 each, 14,155,776,000; the cross scores and
  weighted sum, 2·(16·6)·4,096·1,500·64 each, 150,994,944,000; the MLP's
  three 2·N·384·96, 14,495,514,624: in all 707,927,212,032;
- the tied logits 2·N·384·51,865 = 2,610,450,923,520;
every product twice more in the backward, and the decoder's batched
ones once more in the recompute: 3·(88,915,968,000 + 707,927,212,032 +
2,610,450,923,520) + 563,311,804,416 = 10,785,194,115,072.  Collectives
(f32, all-reduces): the MLPs' partial sums and their inputs' gradients,
the encoder's F·384·4 = 36,864,000 B and the decoder's N·384·4 =
100,663,296 B, each twice; the global norm's 4; over ``data`` the rank's
21,909,504 gradient elements, 87,638,016, the loss and the aux loss, 4
each: 362,692,620 B in 8 calls with FSDP off.  (Worked out first as 9 calls and
463,355,916 B, with the decoder MLP's sum counted again in the
recompute: the checkpoint's recompute stops once it has remade the
tensors the backward saved, and no saved tensor follows the block's last
sum, so it is never rerun.)  With FSDP (``DEFAULT_RULES``): over
``data`` only the 2,688 norm-scale elements' gradients are all-reduced,
10,752 B, and the global norm sums over ``data`` alone (the attention
and the table), (model, data) (the MLPs): 3 calls of 4 B for 1; in all
275,065,364 B of all-reduces in 10 calls.  The all-gathers over ``data``
(f32, as held), each weight's model slice whole along d_model: the
encoder layer's wq, wk, wv and wo, 384·384·4 = 589,824 each, and MLP,
384·96·4 = 147,456 each, 2,801,664 B once; the decoder layer's self and
cross attention's eight 589,824 and MLP's three 147,456, 5,160,960 B,
twice (forward and recompute); the tied table, 51,865·384·4 =
79,664,640, twice (lookup and logits): 172,452,864 B in 31 calls.  The
reduce-scatters of their gradients, once a forward gather:
167,291,904 B in 20 calls.

The VLM cell ``qwen2-vl-2b x train_4k`` on the single mesh at full width,
cut to one layer (``VLM_OVERRIDES``): equal keys, ``param_count``,
``param_bytes_per_device``, ``model_flops`` and ``wkv_analytic_flops``.
Its ``flops_per_device`` and collective bytes are printed beside the
reference's and held to the counts worked out from the shapes before the
port's first run of this cell (``VLM_FLOPS``, ``VLM_COLLECTIVES``).  On
the 16-way model axis a rank holds 16 of the 256 rows (T = 65,536
tokens, the first 256 of each row the patches), the attention whole (12
heads and 2 KV heads, which 16 divides neither, their q/k/v biases too),
560 of the MLP's 8,960 ``d_ff`` columns and 9,496 of the tied
vocabulary's 151,936 rows; the block runs under remat "dots".  Products
(2·M·N·K each), forward: wq and wo 2·T·1,536·1,536 each,
309,237,645,312; wk and wv 2·T·1,536·256 each, 51,539,607,552; the
scores and the weighted sum, 2·(16·12)·4,096²·128 each,
824,633,720,832; the MLP's three 2·T·1,536·560, 112,742,891,520 each:
the layer 2,709,050,621,952; the tied logits 2·T·1,536·9,496 =
1,911,797,317,632; every product twice more in the backward and the
batched ones once more in the recompute: 3·4,620,847,939,584 +
1,649,267,441,664 = 15,511,811,260,416.  Collectives (f32, all-reduces):
the embedding's rows, the MLP's partial sum, and the gradients of the
logits' input and of the MLP's input, T·1,536·4 = 402,653,184 B each
(the MLP's sum, the block's last, is not rerun in the recompute); the
cross entropy's max, sum and target logit, 16·4,095·4 = 262,080 each;
the global norm's 4; over ``data`` the rank's 22,678,016 gradient
elements, 90,712,064, the loss and the aux loss, 4 each:
1,702,111,052 B in 11 calls with FSDP off.  With FSDP
(``DEFAULT_RULES``): over ``data`` only the 6,656 elements FSDP does not
split (the norm scales, the q/k/v biases), 26,624 B, and the global norm
over (model, data) and ``data`` alone: 3 calls of 4 B for 1; in all
1,611,425,620 B of all-reduces in 13 calls.  The all-gathers over
``data`` (f32, as held): wq and wo 1,536·12·128·4 = 9,437,184 each, wk
and wv 1,572,864 each, the MLP's three 1,536·560·4 = 3,440,640 each,
32,342,016 B, twice (forward and recompute); the table's 9,496 rows,
58,343,424, twice (lookup and logits): 181,370,880 B in 16 calls.  The
reduce-scatters of their gradients, once a forward gather:
149,028,864 B in 9 calls.

Every cell's parameters as the port holds them, laid out by
``DEFAULT_RULES`` on the production mesh of a fake world, add up to the
reference's ``param_bytes_per_device``.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")

from repro.analysis import hlo as ref_hlo  # noqa: E402
from repro.analysis import rooflines as ref_rooflines  # noqa: E402
from repro.configs import cells as ref_cells  # noqa: E402

from repro_torch.analysis import hlo, rooflines  # noqa: E402
from repro_torch.configs import SHAPES, cells, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CELL = ("tinyllama-1.1b", "train_4k", "single")
DECODE_CELL = ("tinyllama-1.1b", "decode_32k", "single")
OVERRIDES = {"num_layers": 1, "d_model": 256, "num_heads": 16,
             "num_kv_heads": 4, "d_ff": 512, "vocab_size": 1024}
FLOPS_RTOL = 0.2
DECODE_FLOPS = 18_087_936
DECODE_COLLECTIVES = {"by_op": {"all-reduce": 33_888, "all-gather": 397_312},
                      "counts": {"all-reduce": 7, "all-gather": 10}}
REF_TIMEOUT_S = 300
MOE_OVERRIDES = {"num_layers": 1, "d_model": 256, "num_heads": 16,
                 "num_kv_heads": 8, "d_ff": 64, "vocab_size": 1024}
# cell -> (layout, param_count, param_bytes_per_device, model_flops,
# flops_per_device from the shapes, collective bytes and calls)
MOE_CELLS = {
    ("granite-moe-1b-a400m", "prefill_32k", "single"): (
        "EP", 2_040_576, 50_304, 1.80388626432e12, 176_160_768_000,
        {"by_op": {"all-reduce": 201_326_720, "all-gather": 854_016},
         "counts": {"all-reduce": 4, "all-gather": 11}}),
    ("granite-moe-3b-a800m", "prefill_32k", "single"): (
        "FF", 2_435_840, 58_880, 1.808181231616e12, 503_584_915_456,
        {"by_op": {"all-reduce": 201_326_752, "all-gather": 958_464},
         "counts": {"all-reduce": 4, "all-gather": 10}}),
}

RWKV_CELL = ("rwkv6-7b", "train_4k", "single")
RWKV_OVERRIDES = {"num_layers": 1, "d_model": 256, "num_heads": 16,
                  "head_dim": 16, "d_ff": 512, "vocab_size": 1024}
RWKV_FLOPS = 66_974_679_040
WHISPER_CELL = ("whisper-tiny", "train_4k", "single")
WHISPER_OVERRIDES = {"num_layers": 1, "encoder_layers": 1}
WHISPER_FLOPS = 10_785_194_115_072
WHISPER_COLLECTIVES = {"by_op": {"all-reduce": 275_065_364,
                                  "all-gather": 172_452_864,
                                  "reduce-scatter": 167_291_904},
                       "counts": {"all-reduce": 10, "all-gather": 31,
                                  "reduce-scatter": 20}}
VLM_CELL = ("qwen2-vl-2b", "train_4k", "single")
VLM_OVERRIDES = {"num_layers": 1}
VLM_FLOPS = 15_511_811_260_416
VLM_COLLECTIVES = {"by_op": {"all-reduce": 1_611_425_620,
                              "all-gather": 181_370_880,
                              "reduce-scatter": 149_028_864},
                   "counts": {"all-reduce": 13, "all-gather": 16,
                              "reduce-scatter": 9}}
RWKV_COLLECTIVES = {"by_op": {"all-reduce": 605_246_360,
                              "all-gather": 135_593_984,
                              "reduce-scatter": 753_664},
                    "counts": {"all-reduce": 27, "all-gather": 28,
                               "reduce-scatter": 14}}

_REFERENCE = r"""
import dataclasses, json, sys
import repro.launch.dryrun as dr
from repro.configs import SHAPES, cells, get_config
texts = []
analyze = dr._analyze


def keep_text(compiled, chips):
    texts.append(compiled.as_text())
    return analyze(compiled, chips)


dr._analyze = keep_text
cell, overrides, out = json.loads(sys.argv[1])
rec = dr.run_cell(*cell, correction=False, overrides=overrides)
with open(out + "/record.json", "w") as f:
    json.dump(rec, f)
with open(out + "/hlo.txt", "w") as f:
    f.write(texts[0])
helpers = {"clone": [dataclasses.asdict(dr._clone_cfg(get_config(a), p))
                     for a, _ in cells() for p in (1, 2)],
           "wkv": [dr._wkv_analytic_flops(get_config(a), SHAPES[s])
                   for a, s in cells()]}
with open(out + "/helpers.json", "w") as f:
    json.dump(helpers, f)
"""


def _run_reference(out, cell, overrides=None):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE,
         json.dumps([cell, overrides or OVERRIDES, str(out)])], env=env,
        cwd=REPO,
        capture_output=True, text=True, timeout=REF_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return (json.loads((out / "record.json").read_text()),
            (out / "hlo.txt").read_text(),
            json.loads((out / "helpers.json").read_text()))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return _run_reference(tmp_path_factory.mktemp("dryrun_ref"), CELL)


@pytest.fixture(scope="module")
def ref_decode(tmp_path_factory):
    return _run_reference(tmp_path_factory.mktemp("dryrun_ref_decode"),
                          DECODE_CELL)[0]


@pytest.fixture(scope="module")
def port():
    return dryrun.run_cell(*CELL, overrides=OVERRIDES)


@pytest.fixture(scope="module")
def port_decode():
    return dryrun.run_cell(*DECODE_CELL, overrides=OVERRIDES)


@pytest.fixture(scope="module", params=list(MOE_CELLS), ids="__".join)
def moe_cell(request, tmp_path_factory):
    """(the cell, the reference's record, the port's) at MOE_OVERRIDES."""
    cell = request.param
    want = _run_reference(tmp_path_factory.mktemp("dryrun_ref_moe"), cell,
                          MOE_OVERRIDES)[0]
    return cell, want, dryrun.run_cell(*cell, correction=False,
                                       overrides=MOE_OVERRIDES)


@pytest.fixture(scope="module")
def rwkv_cell(tmp_path_factory):
    """(the reference's record, the port's) at RWKV_OVERRIDES."""
    want = _run_reference(tmp_path_factory.mktemp("dryrun_ref_rwkv"),
                          RWKV_CELL, RWKV_OVERRIDES)[0]
    return want, dryrun.run_cell(*RWKV_CELL, overrides=RWKV_OVERRIDES)


@pytest.fixture(scope="module")
def whisper_cell(tmp_path_factory):
    """(the reference's record, the port's) at WHISPER_OVERRIDES."""
    want = _run_reference(tmp_path_factory.mktemp("dryrun_ref_whisper"),
                          WHISPER_CELL, WHISPER_OVERRIDES)[0]
    return want, dryrun.run_cell(*WHISPER_CELL, overrides=WHISPER_OVERRIDES)


@pytest.fixture(scope="module")
def vlm_cell(tmp_path_factory):
    """(the reference's record, the port's) at VLM_OVERRIDES."""
    want = _run_reference(tmp_path_factory.mktemp("dryrun_ref_vlm"),
                          VLM_CELL, VLM_OVERRIDES)[0]
    return want, dryrun.run_cell(*VLM_CELL, overrides=VLM_OVERRIDES)


def test_vlm_counts_and_keys_equal(vlm_cell):
    want, got = vlm_cell
    assert got["ok"] and want["ok"]
    assert set(got) == set(want)
    for key in ("param_count", "param_bytes_per_device", "model_flops",
                "arch", "shape", "mesh", "kind", "chips", "ok",
                "wkv_analytic_flops"):
        assert got[key] == want[key], key


def test_vlm_flops_and_collectives_from_the_shapes(vlm_cell):
    want, got = vlm_cell
    print(f"qwen2-vl flops_per_device: port {got['flops_per_device']:.6e}, "
          f"reference {want['flops_per_device']:.6e}; collective bytes: "
          f"port {got['collective_bytes_per_device']} "
          f"{got['collective_by_op']} {got['collective_counts']}, "
          f"reference {want['collective_bytes_per_device']} "
          f"{want['collective_by_op']} {want['collective_counts']}")
    assert got["flops_per_device"] == VLM_FLOPS
    assert got["collective_by_op"] == VLM_COLLECTIVES["by_op"]
    assert got["collective_counts"] == VLM_COLLECTIVES["counts"]
    assert got["collective_bytes_per_device"] == sum(
        VLM_COLLECTIVES["by_op"].values())


def test_whisper_counts_and_keys_equal(whisper_cell):
    want, got = whisper_cell
    assert got["ok"] and want["ok"]
    assert set(got) == set(want)
    for key in ("param_count", "param_bytes_per_device", "model_flops",
                "arch", "shape", "mesh", "kind", "chips", "ok",
                "wkv_analytic_flops"):
        assert got[key] == want[key], key


def test_whisper_flops_and_collectives_from_the_shapes(whisper_cell):
    want, got = whisper_cell
    print(f"whisper flops_per_device: port {got['flops_per_device']:.6e}, "
          f"reference {want['flops_per_device']:.6e}; collective bytes: "
          f"port {got['collective_bytes_per_device']} "
          f"{got['collective_by_op']} {got['collective_counts']}, "
          f"reference {want['collective_bytes_per_device']} "
          f"{want['collective_by_op']} {want['collective_counts']}")
    assert got["flops_per_device"] == WHISPER_FLOPS
    assert got["collective_by_op"] == WHISPER_COLLECTIVES["by_op"]
    assert got["collective_counts"] == WHISPER_COLLECTIVES["counts"]
    assert got["collective_bytes_per_device"] == sum(
        WHISPER_COLLECTIVES["by_op"].values())


def test_rwkv_counts_and_keys_equal(rwkv_cell):
    want, got = rwkv_cell
    assert got["ok"] and want["ok"]
    assert set(got) == set(want)
    for key in ("param_count", "param_bytes_per_device", "model_flops",
                "arch", "shape", "mesh", "kind", "chips", "ok",
                "wkv_analytic_flops"):
        assert got[key] == want[key], key
    assert got["wkv_analytic_flops"] > 0


def test_rwkv_flops_and_collectives_from_the_shapes(rwkv_cell):
    want, got = rwkv_cell
    print(f"rwkv6 flops_per_device: port {got['flops_per_device']:.6e}, "
          f"reference {want['flops_per_device']:.6e}; wkv_analytic_flops "
          f"{got['wkv_analytic_flops']:.6e}; collective bytes: port "
          f"{got['collective_bytes_per_device']} {got['collective_by_op']} "
          f"{got['collective_counts']}, reference "
          f"{want['collective_bytes_per_device']} {want['collective_by_op']}"
          f" {want['collective_counts']}")
    assert got["flops_per_device"] == RWKV_FLOPS
    assert got["collective_by_op"] == RWKV_COLLECTIVES["by_op"]
    assert got["collective_counts"] == RWKV_COLLECTIVES["counts"]
    assert got["collective_bytes_per_device"] == sum(
        RWKV_COLLECTIVES["by_op"].values())


def test_moe_counts_and_keys_equal(moe_cell):
    cell, want, got = moe_cell
    _, count, pbytes, model_flops = MOE_CELLS[cell][:4]
    assert got["ok"] and want["ok"]
    assert set(got) == set(want)
    for key in ("param_count", "param_bytes_per_device", "model_flops",
                "arch", "shape", "mesh", "kind", "chips", "ok",
                "scan_correction", "wkv_analytic_flops"):
        assert got[key] == want[key], key
    assert (got["param_count"], got["param_bytes_per_device"],
            got["model_flops"]) == (count, pbytes, model_flops)


def test_moe_flops_and_collectives_from_the_shapes(moe_cell):
    cell, want, got = moe_cell
    layout, flops, coll = MOE_CELLS[cell][0], MOE_CELLS[cell][4], \
        MOE_CELLS[cell][5]
    print(f"{cell[0]} ({layout}) flops_per_device: port "
          f"{got['flops_per_device']:.6e}, reference "
          f"{want['flops_per_device']:.6e}, port / reference "
          f"{got['flops_per_device'] / want['flops_per_device']:.6f}; "
          f"collective bytes: port {got['collective_bytes_per_device']} "
          f"{got['collective_by_op']}, reference "
          f"{want['collective_bytes_per_device']} "
          f"{want['collective_by_op']}")
    assert got["flops_per_device"] == flops
    if layout == "EP":
        assert abs(flops - want["flops_per_device"]) <= \
            FLOPS_RTOL * want["flops_per_device"]
    assert got["collective_by_op"] == coll["by_op"]
    assert got["collective_counts"] == coll["counts"]
    assert got["collective_bytes_per_device"] == sum(coll["by_op"].values())


def test_counts_and_keys_equal(ref, port):
    want = ref[0]
    assert set(port) == set(want)
    for key in ("param_count", "param_bytes_per_device", "model_flops",
                "arch", "shape", "mesh", "kind", "chips", "ok",
                "scan_correction", "wkv_analytic_flops"):
        assert port[key] == want[key], key


def test_flops_per_device_within_tolerance(ref, port):
    want = ref[0]["flops_per_device"]
    got = port["flops_per_device"]
    print(f"flops_per_device: port {got:.6e}, reference {want:.6e}, "
          f"port / reference {got / want:.6f}")
    assert abs(got - want) <= FLOPS_RTOL * want


def test_decode_counts_and_keys_equal(ref_decode, port_decode):
    assert set(port_decode) == set(ref_decode)
    for key in ("param_count", "param_bytes_per_device", "model_flops",
                "arch", "shape", "mesh", "kind", "chips", "ok",
                "scan_correction", "wkv_analytic_flops"):
        assert port_decode[key] == ref_decode[key], key
    assert port_decode["param_bytes_per_device"] == 27_648
    assert port_decode["model_flops"] == 2.76824064e8


def test_decode_flops_and_collectives_from_the_shapes(ref_decode,
                                                      port_decode):
    got, want = port_decode, ref_decode
    print(f"decode flops_per_device: port {got['flops_per_device']:.6e}, "
          f"reference {want['flops_per_device']:.6e}; collective bytes: "
          f"port {got['collective_bytes_per_device']} "
          f"{got['collective_by_op']}, reference "
          f"{want['collective_bytes_per_device']} "
          f"{want['collective_by_op']}")
    assert got["flops_per_device"] == DECODE_FLOPS
    assert got["collective_by_op"] == DECODE_COLLECTIVES["by_op"]
    assert got["collective_counts"] == DECODE_COLLECTIVES["counts"]
    assert got["collective_bytes_per_device"] == sum(
        DECODE_COLLECTIVES["by_op"].values())


def _held_bytes(arch: str, overrides: dict, multi: bool = False) -> int:
    """The bytes of the parameters rank 0 holds, laid out by
    ``DEFAULT_RULES`` on a production mesh of a fake world, as
    ``dryrun.run_cell`` lays them out."""
    import dataclasses as dc

    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.distributed.sharding import DEFAULT_RULES
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.registry import build_model
    cfg = dc.replace(get_config(arch), **overrides)
    with dryrun.fake_world(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi, device="cpu")
        model = build_model(cfg, device="meta")
        tp.shard_parameters(model, tp.parameter_layout(
            model, mesh, DEFAULT_RULES), mesh)
        return sum(p.numel() * p.element_size() for p in model.parameters())


def test_held_parameter_bytes_equal_the_references(ref, ref_decode, moe_cell,
                                                   rwkv_cell, whisper_cell,
                                                   vlm_cell):
    """Each cell's parameters as a rank of the port holds them add up to
    the reference's ``param_bytes_per_device`` (and to the port's record,
    which ``run_cell`` checks against the layout it ran)."""
    cells = [(CELL, OVERRIDES, ref[0]), (DECODE_CELL, OVERRIDES, ref_decode),
             (moe_cell[0], MOE_OVERRIDES, moe_cell[1]),
             (RWKV_CELL, RWKV_OVERRIDES, rwkv_cell[0]),
             (WHISPER_CELL, WHISPER_OVERRIDES, whisper_cell[0]),
             (VLM_CELL, VLM_OVERRIDES, vlm_cell[0])]
    for (arch, _, mesh), overrides, want in cells:
        held = _held_bytes(arch, overrides, mesh == "multi")
        assert held == want["param_bytes_per_device"], (arch, held)


def test_cells_equal():
    assert cells() == ref_cells()


def test_private_copies_equal(ref):
    """The copies of ``_clone_cfg`` (every cell's config at 1 and 2
    periods) and ``_wkv_analytic_flops`` (every cell)."""
    want = ref[2]
    clone = [dataclasses.asdict(dryrun._clone_cfg(get_config(a), p))
             for a, _ in cells() for p in (1, 2)]
    assert json.loads(json.dumps(clone)) == want["clone"]
    assert [dryrun._wkv_analytic_flops(get_config(a), SHAPES[s])
            for a, s in cells()] == want["wkv"]


def test_hlo_helpers_equal_on_the_reference_hlo(ref):
    text = ref[1]
    got = hlo.collective_bytes(text)
    assert got == ref_hlo.collective_bytes(text)
    assert got["total_bytes"] > 0
    assert hlo.remat_duplication(text) == ref_hlo.remat_duplication(text)


def test_tables_equal_on_the_reference_records(ref):
    want = ref[0]
    failed = {"arch": "qwen2-vl-2b", "shape": "decode_32k", "mesh": "single",
              "ok": False, "error": "ValueError: not ported", "trace": ""}
    recs = [want, {**want, "mesh": "multi", "chips": 512}, failed]
    for mesh in ("single", "multi", None):
        assert (rooflines.dryrun_table(recs, mesh)
                == ref_rooflines.dryrun_table(recs, mesh))
    assert rooflines.roofline_table(recs) == ref_rooflines.roofline_table(
        recs)
