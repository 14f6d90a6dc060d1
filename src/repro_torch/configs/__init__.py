"""Architecture configs and the assigned input shapes (port of
``repro.configs``).

Each architecture the port can build has its own ``configs/<id>.py`` with the
exact published config; this module holds the :class:`ArchConfig` schema, the
shape table and the ``--arch`` registry, the same ten architectures as the
JAX package's.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


# Assigned LM shape set (the same four for every arch; applicability filtered
# by arch family, see cells()).
SHAPES: dict[str, ShapeSpec] = {
    "train_4k":    ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k":   ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads

    # attention options
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    window: int = 0                   # sliding-window size for "local" blocks
    mrope_sections: Optional[tuple[int, int, int]] = None   # M-RoPE (t,h,w)
    attn_logit_softcap: float = 0.0

    # block pattern, cycled over layers: "attn" | "local" | "rglru" | "rwkv"
    block_pattern: tuple[str, ...] = ("attn",)

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 512

    # recurrent blocks
    lru_width: int = 0                # 0 -> d_model
    conv_width: int = 4

    # encoder-decoder (audio) / frontend stubs
    encoder_layers: int = 0
    encoder_seq: int = 0
    vision_tokens: int = 0

    # misc
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    act: str = "silu"
    dtype: str = "bfloat16"           # activation/compute dtype
    param_dtype: str = "float32"
    sub_quadratic: bool = False       # may run long_500k
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def kind_of_layer(self, i: int) -> str:
        return self.block_pattern[i % len(self.block_pattern)]

    def supports_shape(self, shape: ShapeSpec) -> bool:
        if shape.name == "long_500k":
            return self.sub_quadratic
        return True

    def params_billion_estimate(self) -> float:
        """Rough N for 6*N*D roofline accounting (model body, active experts
        counted for MoE)."""
        d, f, L = self.d_model, self.d_ff, self.num_layers
        hd = self.resolved_head_dim
        attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + \
            self.num_heads * hd * d
        if self.num_experts:
            mlp = 3 * d * f * self.experts_per_token + d * self.num_experts
        else:
            mlp = 3 * d * f
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        enc = self.encoder_layers * (attn + 3 * d * f)
        return (L * (attn + mlp) + emb + enc) / 1e9


_REGISTRY: dict[str, str] = {
    "recurrentgemma-2b":    "repro_torch.configs.recurrentgemma_2b",
    "tinyllama-1.1b":       "repro_torch.configs.tinyllama_1_1b",
    "qwen3-32b":            "repro_torch.configs.qwen3_32b",
    "command-r-plus-104b":  "repro_torch.configs.command_r_plus_104b",
    "qwen2.5-3b":           "repro_torch.configs.qwen2_5_3b",
    "qwen2-vl-2b":          "repro_torch.configs.qwen2_vl_2b",
    "rwkv6-7b":             "repro_torch.configs.rwkv6_7b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b_a400m",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "whisper-tiny":         "repro_torch.configs.whisper_tiny",
}


def list_archs() -> list[str]:
    return sorted(_REGISTRY)


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; the port builds: {list_archs()}")
    return importlib.import_module(_REGISTRY[name]).CONFIG


def get_reduced_config(name: str) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; the port builds: {list_archs()}")
    return importlib.import_module(_REGISTRY[name]).reduced()


def cells() -> list[tuple[str, str]]:
    """All (arch, shape) dry-run cells, with family-based skips applied."""
    out = []
    for arch in list_archs():
        cfg = get_config(arch)
        for sname, sh in SHAPES.items():
            if cfg.supports_shape(sh):
                out.append((arch, sname))
    return out
