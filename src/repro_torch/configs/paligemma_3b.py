"""paligemma-3b [vlm]: 18L d=2048 8H (MQA kv=1, d_head 256) d_ff=16384
vocab=257216 [arXiv:2407.07726].  SigLIP vision tower STUBBED: input_specs
provides precomputed patch embeddings (B, 256, D); prefix-LM mask over the
image prefix."""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_head=256,
    d_ff=16384,
    vocab=257216,
    mlp="swiglu",
    n_patches=256,
    tie_embeddings=True,
)

SMOKE = CONFIG.with_(
    name="paligemma-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=1,
    d_head=32, d_ff=256, vocab=512, n_patches=8, remat=False,
)

SHAPES = {
    "train_4k": "run",
    "prefill_32k": "run",
    "decode_32k": "run",
    "long_500k": "skip:pure full attention (DESIGN.md §Arch-applicability)",
}
