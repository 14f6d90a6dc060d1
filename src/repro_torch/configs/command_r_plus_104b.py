"""command-r-plus-104b [dense] — GQA, no-bias.

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000
[hf CohereForAI/c4ai-command-r-plus; unverified tier per assignment].
Cohere ties input/output embeddings and uses parallel attn+FFN residual
blocks; we keep the standard sequential block (config dims are what is
assigned).  Pure full attention -> long_500k skipped.
"""
from repro_torch.configs import ArchConfig
import dataclasses

CONFIG = ArchConfig(
    name="command-r-plus-104b", family="dense",
    num_layers=64, d_model=12_288, num_heads=96, num_kv_heads=8,
    d_ff=33_792, vocab_size=256_000, rope_theta=75_000_000.0,
    qkv_bias=False, tie_embeddings=True, act="silu", sub_quadratic=False)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=96, num_heads=6, num_kv_heads=2,
        d_ff=256, vocab_size=512, dtype="float32")
