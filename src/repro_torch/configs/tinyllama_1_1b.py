"""tinyllama-1.1b [dense] — llama2-arch small.

22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000
[arXiv:2401.02385; hf TinyLlama/TinyLlama-1.1B].
Pure full attention -> long_500k skipped (quadratic).
"""
from repro_torch.configs import ArchConfig
import dataclasses

CONFIG = ArchConfig(
    name="tinyllama-1.1b", family="dense",
    num_layers=22, d_model=2048, num_heads=32, num_kv_heads=4,
    d_ff=5632, vocab_size=32_000, rope_theta=10_000.0,
    tie_embeddings=False, act="silu", sub_quadratic=False)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=160, vocab_size=512, dtype="float32")
