"""MiniCPM-2B: llama-like dense MHA, WSD LR schedule [arXiv:2404.06395]."""
import dataclasses
from repro_torch.models.common import ModelCfg

CONFIG = ModelCfg(
    name="minicpm-2b", family="dense", n_layers=40, d_model=2304,
    n_heads=36, n_kv=36, d_ff=5760, vocab=122753, d_head=64,
)
REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv=4, d_ff=256,
    vocab=512, d_head=32)
