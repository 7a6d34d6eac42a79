"""granite-20b [dense]: 52L d=6144 48H (MQA kv=1) d_ff=24576 vocab=49152
[arXiv:2405.04324].  GPT-BigCode lineage: 2-matrix GELU MLP (the 20B param
count is only consistent with a non-gated FFN)."""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    mlp="gelu",
)

SMOKE = CONFIG.with_(
    name="granite20-smoke", n_layers=2, d_model=128, n_heads=8, n_kv_heads=1,
    d_ff=512, vocab=512, remat=False,
)

SHAPES = {
    "train_4k": "run",
    "prefill_32k": "run",
    "decode_32k": "run",
    "long_500k": "skip:pure full attention (DESIGN.md §Arch-applicability)",
}
