"""Qwen2.5-32B: dense GQA kv=8, QKV bias [hf:Qwen/Qwen2.5]."""
import dataclasses
from repro_torch.models.common import ModelCfg

CONFIG = ModelCfg(
    name="qwen2.5-32b", family="dense", n_layers=64, d_model=5120,
    n_heads=40, n_kv=8, d_ff=27648, vocab=152064, d_head=128, qkv_bias=True,
)
REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv=2, d_ff=256,
    vocab=512, d_head=32)
