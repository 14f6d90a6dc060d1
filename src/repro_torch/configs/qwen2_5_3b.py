"""qwen2.5-3b [dense] — GQA, QKV bias.

36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936
[hf Qwen/Qwen2.5-3B; assignment dims].
Pure full attention -> long_500k skipped.
"""
from repro_torch.configs import ArchConfig
import dataclasses

CONFIG = ArchConfig(
    name="qwen2.5-3b", family="dense",
    num_layers=36, d_model=2048, num_heads=16, num_kv_heads=2,
    d_ff=11_008, vocab_size=151_936, qkv_bias=True,
    rope_theta=1_000_000.0, tie_embeddings=True, act="silu",
    sub_quadratic=False)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=160, vocab_size=512, dtype="float32")
