"""qwen3-32b [dense] — qk_norm, GQA.

64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936
[hf Qwen/Qwen3-32B family; config per assignment].
head_dim=128, QK-RMSNorm per head, no QKV bias (Qwen3 dropped biases).
Pure full attention -> long_500k skipped.
"""
from repro_torch.configs import ArchConfig
import dataclasses

CONFIG = ArchConfig(
    name="qwen3-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=64, num_kv_heads=8,
    head_dim=128, d_ff=25_600, vocab_size=151_936,
    qk_norm=True, qkv_bias=False, rope_theta=1_000_000.0,
    tie_embeddings=False, act="silu", sub_quadratic=False)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=160, vocab_size=512, dtype="float32")
