"""stablelm-1.6b [dense]: 24L d=2048 32H (kv=32) d_ff=5632 vocab=100352
[hf:stabilityai/stablelm-2-1_6b]."""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab=100352,
    mlp="swiglu",
)

SMOKE = CONFIG.with_(
    name="stablelm-smoke", n_layers=2, d_model=128, n_heads=8, n_kv_heads=8,
    d_ff=256, vocab=512, remat=False,
)

SHAPES = {
    "train_4k": "run",
    "prefill_32k": "run",
    "decode_32k": "run",
    "long_500k": "skip:pure full attention (DESIGN.md §Arch-applicability)",
}
