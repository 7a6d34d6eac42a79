"""zamba2-1.2b [hybrid]: 38L d=2048, Mamba2 backbone + shared attention block
(32H kv=32, d_ff=8192) every 6 layers, ssm_state=64 [arXiv:2411.15242].
Per-application LoRA deltas of the shared block are omitted (DESIGN.md)."""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    d_state=64,
    expand=2,
    ssm_head_dim=64,
    attn_period=6,
    tie_embeddings=True,
)

SMOKE = CONFIG.with_(
    name="zamba2-smoke", n_layers=5, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=512, d_state=16, ssm_head_dim=16, attn_period=2, remat=False,
)

SHAPES = {
    "train_4k": "run",
    "prefill_32k": "run",
    "decode_32k": "run",
    "long_500k": "run",  # hybrid: SSM backbone + seq-sharded shared-attn KV
}
