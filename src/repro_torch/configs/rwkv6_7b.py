"""RWKV-6 (Finch) 7B: attention-free, data-dependent decay
[arXiv:2404.05892]."""
import dataclasses
from repro_torch.models.common import ModelCfg

CONFIG = ModelCfg(
    name="rwkv6-7b", family="rwkv", n_layers=32, d_model=4096,
    n_heads=64, n_kv=64, d_ff=14336, vocab=65536, d_head=64,
)
REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=2, n_kv=2, d_ff=256,
    vocab=512, d_head=64)
