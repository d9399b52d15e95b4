"""Deterministic data pipeline with restart skip-ahead: the port of
``repro.data.pipeline`` (numpy, a copy: the same seed and step give the
same arrays, bit for bit).

Production shape: every host materializes only its shard of the global
batch; the stream is a pure function of (seed, step) so a restarted job
resumes mid-epoch exactly (fault tolerance requirement) and an elastically
re-meshed job (different dp size) re-shards consistently.

Sources: ``synthetic`` (zipfian token soup, default) and ``memmap`` (packed
uint16/uint32 token file produced by ``tools`` or any tokenizer)."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DataCfg:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    source: str = "synthetic"        # synthetic | memmap
    memmap_path: str | None = None
    n_patches: int = 0               # vlm prefix stub
    d_model: int = 0
    enc_frames: int = 0              # whisper stub


class TokenStream:
    """Stateless per-step batch generator: batch(step, host_slice)."""

    def __init__(self, cfg: DataCfg):
        self.cfg = cfg
        self._mm = None
        if cfg.source == "memmap":
            self._mm = np.memmap(cfg.memmap_path, dtype=np.uint32, mode="r")

    def batch(self, step: int, lo: int = 0, hi: int | None = None) -> dict:
        """Global-batch rows [lo, hi) for this host (hi=None -> all)."""
        cfg = self.cfg
        hi = cfg.global_batch if hi is None else hi
        n = hi - lo
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, lo]))
        if self._mm is not None:
            total = len(self._mm) - cfg.seq_len - 1
            starts = rng.integers(0, total, size=n)
            toks = np.stack([self._mm[s:s + cfg.seq_len + 1] for s in starts])
            toks = toks.astype(np.int32)
        else:
            # zipfian synthetic tokens: realistic rank-frequency curve
            z = rng.zipf(1.2, size=(n, cfg.seq_len + 1))
            toks = np.minimum(z - 1, cfg.vocab - 1).astype(np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.n_patches:
            out["prefix_embed"] = rng.normal(
                0, 0.02, size=(n, cfg.n_patches, cfg.d_model)).astype(np.float32)
        if cfg.enc_frames:
            out["enc_frames"] = rng.normal(
                0, 1.0, size=(n, cfg.enc_frames, cfg.d_model)).astype(np.float32)
        return out
