"""Granite-34B-Code: llama-arch dense, MQA (kv=1) [arXiv:2405.04324]."""
import dataclasses
from repro_torch.models.common import ModelCfg

CONFIG = ModelCfg(
    name="granite-34b", family="dense", n_layers=88, d_model=6144,
    n_heads=48, n_kv=1, d_ff=24576, vocab=49152, d_head=128,
)
REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv=1, d_ff=256,
    vocab=512, d_head=32)
