"""Phi-3-medium-14B: dense, RoPE SwiGLU GQA kv=10 [arXiv:2404.14219]."""
import dataclasses
from repro_torch.models.common import ModelCfg

CONFIG = ModelCfg(
    name="phi3-medium-14b", family="dense", n_layers=40, d_model=5120,
    n_heads=40, n_kv=10, d_ff=17920, vocab=100352, d_head=128,
)
REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv=2, d_ff=256,
    vocab=512, d_head=32)
