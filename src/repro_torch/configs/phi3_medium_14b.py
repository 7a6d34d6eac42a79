"""phi3-medium-14b [dense]: 40L d=5120 40H (GQA kv=10) d_ff=17920 vocab=100352
RoPE SwiGLU GQA [arXiv:2404.14219]."""

from repro_torch.models.common import ArchConfig

FULL_ATTENTION = True  # long_500k skipped (quadratic attention)

CONFIG = ArchConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab=100352,
    mlp="swiglu",
    rope_theta=10_000.0,
)

SMOKE = CONFIG.with_(
    name="phi3-medium-smoke", n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
    d_ff=256, vocab=512, remat=False,
)

SHAPES = {
    "train_4k": "run",
    "prefill_32k": "run",
    "decode_32k": "run",
    "long_500k": "skip:pure full attention — 500k dense KV is out of scope (DESIGN.md §Arch-applicability)",
}
