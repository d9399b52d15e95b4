"""DeepSeekMoE-16B: fine-grained MoE, 2 shared + 64 routed top-6
[arXiv:2401.06066]."""
import dataclasses
from repro_torch.models.common import ModelCfg, MoECfg

CONFIG = ModelCfg(
    name="deepseek-moe-16b", family="moe", n_layers=28, d_model=2048,
    n_heads=16, n_kv=16, d_ff=1408, vocab=102400, d_head=128,
    moe=MoECfg(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2),
)
REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv=4, d_ff=64,
    vocab=512, d_head=32,
    moe=MoECfg(n_experts=8, top_k=2, d_ff_expert=64, n_shared=1))
