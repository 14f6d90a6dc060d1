"""whisper-tiny [audio] — encoder-decoder, conv frontend stubbed.

4L encoder + 4L decoder, d_model=384 6H (MHA kv=6) d_ff=1536 vocab=51865
[arXiv:2212.04356; unverified tier].
The conv frontend is a STUB per the assignment: input_specs() provides
precomputed frame embeddings (encoder_seq=1500 x d_model).  Decode shapes
exercise the *decoder backbone* with the assigned KV length even though the
real model caps positions at 448 (DESIGN.md §Arch-applicability).
Full attention -> long_500k skipped.
"""
from repro_torch.configs import ArchConfig
import dataclasses

CONFIG = ArchConfig(
    name="whisper-tiny", family="audio",
    num_layers=4, d_model=384, num_heads=6, num_kv_heads=6,
    d_ff=1536, vocab_size=51_865, encoder_layers=4, encoder_seq=1500,
    rope_theta=0.0,              # whisper uses learned/sinusoidal positions
    tie_embeddings=True, act="gelu", sub_quadratic=False)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=512, encoder_layers=2, encoder_seq=32,
        dtype="float32")
