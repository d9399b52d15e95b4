"""The port's ``Server`` answers as the JAX reference's ``Server`` does.

Both registries are patched to serve the f32 reduced configs; the
port's model takes the reference server's weights through
``convert.from_jax_params``.  Greedy decoding must then give the same
tokens in the same number of steps.  Argmax is exact only where the top
two logits are apart, so the test asserts that every step of every
active slot has a top-2 gap above 1e-3, far above the 1e-4 the logits
may differ by; weight seed 39 is one whose gaps do so for RWKV-6,
Phi-3 and Jamba (its MoE layers inside Mamba blocks).  DeepSeek-MoE's
gaps at seed 39 fall to 5e-4, so it takes the first seed whose gaps all
clear 1e-3 (3); it routes every slot, the inactive ones too, with the
tokens the reference feeds them.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import configs as JC  # noqa: E402
from repro.launch import serve as JSERVE  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.launch import serve as TSERVE  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.train.step import make_serve_step  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SEED = 39
SEEDS = {"deepseek_moe_16b": 3}


@pytest.mark.parametrize("arch", ["rwkv6_7b", "phi3_medium_14b",
                                  "deepseek_moe_16b", "jamba_1_5_large"])
def test_server_matches_reference(arch, monkeypatch):
    jcfg = dataclasses.replace(JC.get_reduced(arch), dtype=jnp.float32)
    tcfg = dataclasses.replace(TC.get_reduced(arch), dtype=torch.float32)
    monkeypatch.setattr(JC, "get_reduced", lambda name: jcfg)
    monkeypatch.setattr(TC, "get_reduced", lambda name: tcfg)

    seed = SEEDS.get(arch, SEED)
    jsrv = JSERVE.Server(arch, slots=4, max_len=48, seed=seed)
    tsrv = TSERVE.Server(arch, device="cpu", slots=4, max_len=48, seed=seed)
    tsrv.model = convert.from_jax_params(
        tcfg, jax.tree.map(np.asarray, jsrv.params), device="cpu")
    tsrv.cache = tsrv.model.init_cache(4, 48)
    step = make_serve_step(tsrv.model)
    gaps = []

    def recording_step(cache, batch):
        logits, cache = step(cache, batch)
        top2 = logits[:, -1, :tcfg.vocab].topk(2, dim=-1).values
        gaps.append(float((top2[:, 0] - top2[:, 1])[
            torch.from_numpy(tsrv.active)].min()))
        return logits, cache
    tsrv.step = recording_step

    rng = np.random.default_rng(0)
    for rid in range(6):
        prompt = rng.integers(0, jcfg.vocab, size=rng.integers(4, 12))
        gen = int(rng.integers(6, 14))
        jsrv.submit(rid, prompt, gen)
        tsrv.submit(rid, prompt, gen)
    jstats, tstats = jsrv.run(), tsrv.run()

    assert min(gaps) > 1e-3
    assert tstats["steps"] == jstats["steps"] > 0
    assert tstats["requests"] == jstats["requests"] == 6
    assert tsrv.done == jsrv.done


def test_server_cuts_depth_keeping_widths():
    srv = TSERVE.Server("mixtral_8x7b", device="cpu", n_layers=1)
    full = TC.get_reduced("mixtral_8x7b")
    assert srv.cfg == dataclasses.replace(full, n_layers=1)
    assert len(srv.model.blocks) == 1
    assert len(srv.cache["layers"]) == 1


def test_server_refuses_the_encdec_family():
    """The reference's ``Server`` passes no ``enc_frames``, so its encoder
    has no input; the port's says so instead of serving Whisper."""
    with pytest.raises(ValueError, match="passes no enc_frames"):
        TSERVE.Server("whisper_small", device="cpu")


def test_server_defaults_to_the_card():
    if torch.cuda.is_available():
        assert TSERVE.Server("rwkv6_7b").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TSERVE.Server("rwkv6_7b")


def test_serve_cli_on_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--requests", "2"], env=env, capture_output=True, text=True,
        timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "[serve] 2 requests in" in out.stdout
    assert "tokens/s on cpu" in out.stdout
