"""Mixtral-8x7B: 8 experts top-2, sliding-window attention
[arXiv:2401.04088]."""
import dataclasses
from repro_torch.models.common import ModelCfg, MoECfg

CONFIG = ModelCfg(
    name="mixtral-8x7b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv=8, d_ff=14336, vocab=32000, d_head=128,
    sliding_window=4096,
    moe=MoECfg(n_experts=8, top_k=2, d_ff_expert=14336, n_shared=0),
)
REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv=2, d_ff=256,
    vocab=512, d_head=32, sliding_window=64,
    moe=MoECfg(n_experts=4, top_k=2, d_ff_expert=256, n_shared=0))
