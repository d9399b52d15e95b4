"""LLaVA-NeXT-34B backbone: dense GQA decoder; anyres vision tiling is a
STUB frontend (input_specs provides patch embeddings)
[hf:llava-hf/llava-v1.6]."""
import dataclasses
from repro_torch.models.common import ModelCfg

CONFIG = ModelCfg(
    name="llava-next-34b", family="vlm", n_layers=60, d_model=7168,
    n_heads=56, n_kv=8, d_ff=20480, vocab=64000, d_head=128, n_patches=576,
)
REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv=2, d_ff=256,
    vocab=512, d_head=32, n_patches=16)
