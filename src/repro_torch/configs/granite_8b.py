"""granite-8b [dense]: 36L d=4096 32H (GQA kv=8) d_ff=14336 vocab=49152
llama-arch SwiGLU [arXiv:2405.04324]."""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=49152,
    mlp="swiglu",
)

SMOKE = CONFIG.with_(
    name="granite8-smoke", n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
    d_ff=256, vocab=512, remat=False,
)

SHAPES = {
    "train_4k": "run",
    "prefill_32k": "run",
    "decode_32k": "run",
    "long_500k": "skip:pure full attention (DESIGN.md §Arch-applicability)",
}
