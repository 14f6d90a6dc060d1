"""granite-moe-3b-a800m [moe] — 40 experts top-8.

32L d_model=1536 24H (GQA kv=8) d_ff=512/expert vocab=49155, MoE 40e top-8
[hf ibm-granite/granite-3.0-3b-a800m-base].
NOTE: the assignment line says "MoE 40e top-8" while its trailing comment says
32 experts; we follow the config line (40).  40 % 16 != 0, so EP falls back to
replicated experts with d_ff TP — exactly the divisibility-fallback case the
sharding rules exist for (DESIGN.md §7).
"""
from repro_torch.configs import ArchConfig
import dataclasses

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
    d_ff=512, vocab_size=49_155, num_experts=40, experts_per_token=8,
    rope_theta=10_000.0, tie_embeddings=True, act="silu",
    sub_quadratic=False)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=64, vocab_size=512, num_experts=4, experts_per_token=2,
        dtype="float32")
