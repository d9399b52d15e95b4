"""Whisper-small: enc-dec, conv frontend STUB (input_specs provides frame
embeddings) [arXiv:2212.04356]."""
import dataclasses
from repro_torch.models.common import ModelCfg

CONFIG = ModelCfg(
    name="whisper-small", family="encdec", n_layers=12, d_model=768,
    n_heads=12, n_kv=12, d_ff=3072, vocab=51865, d_head=64, n_enc_layers=12,
)
REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv=4, d_ff=256,
    vocab=512, d_head=32, n_enc_layers=2)
