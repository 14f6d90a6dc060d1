"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution (frontend stubbed).

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936
[arXiv:2409.12191; hf Qwen/Qwen2-VL-2B].
The vision tower is a STUB per the assignment: input_specs() supplies
precomputed patch embeddings (vision_tokens x d_model) that are scatter-merged
into the token stream; the backbone applies M-RoPE with (t, h, w) sections
(16, 24, 24) over head_dim=128.
"""
from repro_torch.configs import ArchConfig
import dataclasses

CONFIG = ArchConfig(
    name="qwen2-vl-2b", family="vlm",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
    head_dim=128, d_ff=8960, vocab_size=151_936, qkv_bias=True,
    rope_theta=1_000_000.0, mrope_sections=(16, 24, 24),
    vision_tokens=256, tie_embeddings=True, act="silu",
    sub_quadratic=False)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=160, vocab_size=512, vision_tokens=16,
        mrope_sections=(2, 3, 3), dtype="float32")
