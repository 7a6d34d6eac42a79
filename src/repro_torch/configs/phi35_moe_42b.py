"""phi3.5-moe-42b-a6.6b [moe]: 32L d=4096 32H (kv=8) d_ff=6400, 16 experts
top-2 [hf:microsoft/Phi-3.5-MoE-instruct]."""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab=32064,
    n_experts=16,
    top_k=2,
    mlp="swiglu",
)

SMOKE = CONFIG.with_(
    name="phi35moe-smoke", n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
    d_ff=64, vocab=512, n_experts=4, top_k=2, remat=False,
)

SHAPES = {
    "train_4k": "run",
    "prefill_32k": "run",
    "decode_32k": "run",
    "long_500k": "skip:pure full attention (DESIGN.md §Arch-applicability)",
}
