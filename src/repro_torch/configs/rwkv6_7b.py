"""rwkv6-7b [ssm] — Finch, data-dependent decay; attention-free.

32L d_model=4096 d_ff=14336 vocab=65536, head_dim=64 (64 WKV heads)
[arXiv:2404.05892; hf RWKV/rwkv-6-world-7b].
Recurrent (O(1)-state) -> runs long_500k.  The paper's stencil mapping applies
to the token-shift (radius-1 stencil); the WKV scan itself is a wavefront
recurrence (DESIGN.md §Arch-applicability).
"""
from repro_torch.configs import ArchConfig
import dataclasses

CONFIG = ArchConfig(
    name="rwkv6-7b", family="ssm",
    num_layers=32, d_model=4096, num_heads=64, num_kv_heads=64,
    head_dim=64, d_ff=14_336, vocab_size=65_536,
    block_pattern=("rwkv",), tie_embeddings=False, act="relu",
    sub_quadratic=True,
    notes="num_heads here = WKV heads (d_model / 64); attention-free.")


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=160, vocab_size=512, dtype="float32")
