"""whisper-medium [audio enc-dec]: 24+24L d=1024 16H d_ff=4096 vocab=51865
[arXiv:2212.04356].  Conv/mel frontend STUBBED: input_specs provides
precomputed frame embeddings (B, 1500, D)."""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,        # decoder layers
    n_enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51865,
    mlp="gelu",
    enc_ctx=1500,
    tie_embeddings=True,
)

SMOKE = CONFIG.with_(
    name="whisper-smoke", n_layers=2, n_enc_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=512, enc_ctx=32, remat=False,
)

SHAPES = {
    "train_4k": "run",
    "prefill_32k": "run",      # decoder prefill against the 1500-frame encoder
    "decode_32k": "run",
    "long_500k": "skip:full-attention decoder; encoder context bounded at 1500 frames",
}
