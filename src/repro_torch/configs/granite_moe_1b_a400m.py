"""granite-moe-1b-a400m [moe] — 32 experts top-8.

24L d_model=1024 16H (GQA kv=8) d_ff=512/expert vocab=49155, MoE 32e top-8
[hf ibm-granite/granite-3.0-1b-a400m-base].
GShard-style top-k routing with capacity factor; experts shard on the model
axis (EP).  Pure full attention -> long_500k skipped.
"""
from repro_torch.configs import ArchConfig
import dataclasses

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
    d_ff=512, vocab_size=49_155, num_experts=32, experts_per_token=8,
    rope_theta=10_000.0, tie_embeddings=True, act="silu",
    sub_quadratic=False)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=64, vocab_size=512, num_experts=4, experts_per_token=2,
        dtype="float32")
