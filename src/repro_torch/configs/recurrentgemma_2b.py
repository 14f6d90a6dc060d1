"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2 ratio.

26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000, window 2048
[arXiv:2402.19427 (Griffin); hf google/recurrentgemma-2b].
Block pattern (rglru, rglru, local) cycled — two recurrent blocks per local
attention block.  Sub-quadratic: runs long_500k (LRU state is O(1), local
attention cache is window-bounded).
"""
import dataclasses

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
    head_dim=256, d_ff=7680, vocab_size=256_000,
    block_pattern=("rglru", "rglru", "local"), window=2048,
    lru_width=2560, conv_width=4, rope_theta=10_000.0,
    tie_embeddings=True, act="gelu", sub_quadratic=True,
    notes="Griffin-style hybrid; MQA on local-attn layers; RG-LRU c=8.")


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=6, d_model=64, num_heads=2, num_kv_heads=1,
        head_dim=32, d_ff=128, vocab_size=512, window=32, lru_width=64,
        dtype="float32")
