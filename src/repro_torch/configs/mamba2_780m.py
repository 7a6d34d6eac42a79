"""mamba2-780m [ssm]: 48L d=1536 attn-free, ssm_state=128, SSD
[arXiv:2405.21060].  d_inner = 2*1536 = 3072, headdim 64 -> 48 SSD heads."""

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    d_state=128,
    expand=2,
    ssm_head_dim=64,
    tie_embeddings=True,
)

SMOKE = CONFIG.with_(
    name="mamba2-smoke", n_layers=2, d_model=64, vocab=512, d_state=16,
    ssm_head_dim=16, remat=False,
)

SHAPES = {
    "train_4k": "run",
    "prefill_32k": "run",
    "decode_32k": "run",
    "long_500k": "run",  # O(1) decode state — the sub-quadratic family
}
