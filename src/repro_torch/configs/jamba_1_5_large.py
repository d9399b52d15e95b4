"""Jamba-1.5-Large (398B): Mamba+attention 1:7 interleave, MoE 16e top-2
every 2nd layer [arXiv:2403.19887]."""
import dataclasses
from repro_torch.models.common import ModelCfg, MoECfg

CONFIG = ModelCfg(
    name="jamba-1.5-large-398b", family="hybrid", n_layers=72, d_model=8192,
    n_heads=64, n_kv=8, d_ff=24576, vocab=65536, d_head=128,
    attn_every=8, d_state=16,
    moe=MoECfg(n_experts=16, top_k=2, d_ff_expert=24576, n_shared=0, every=2),
)
REDUCED = dataclasses.replace(
    CONFIG, n_layers=8, d_model=128, n_heads=4, n_kv=2, d_ff=256,
    vocab=512, d_head=32, attn_every=4,
    moe=MoECfg(n_experts=4, top_k=2, d_ff_expert=256, n_shared=0, every=2))
