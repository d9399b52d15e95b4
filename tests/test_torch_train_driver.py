"""The port's training driver and its pieces on the CPU: ``launch.train``
(restart resumes identically, the loss falls, compression runs), the
checkpoint manager (keep-N, atomic layout, bf16 round trip, leaves back
on their device), the watchdog, and the data pipeline equal to the
reference's bit for bit."""
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.data.pipeline import DataCfg as JDataCfg  # noqa: E402
from repro.data.pipeline import TokenStream as JTokenStream  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager, Watchdog  # noqa: E402
from repro_torch.data.pipeline import DataCfg, TokenStream  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402
from repro_torch.train import optim  # noqa: E402


@pytest.mark.parametrize("kw", [
    dict(vocab=101, seq_len=8, global_batch=4, seed=9),
    dict(vocab=512, seq_len=16, global_batch=3, seed=7, n_patches=5,
         d_model=12),
    dict(vocab=51865, seq_len=4, global_batch=2, seed=3, enc_frames=6,
         d_model=8)])
def test_data_pipeline_equals_reference(kw):
    mine, theirs = TokenStream(DataCfg(**kw)), JTokenStream(JDataCfg(**kw))
    for step, lo, hi in ((0, 0, None), (17, 0, None), (5, 1, 3)):
        a, b = mine.batch(step, lo, hi), theirs.batch(step, lo, hi)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), k


def test_data_pipeline_memmap_equals_reference(tmp_path):
    path = tmp_path / "tokens.bin"
    np.arange(4096, dtype=np.uint32).tofile(path)
    kw = dict(vocab=5000, seq_len=32, global_batch=4, seed=1,
              source="memmap", memmap_path=str(path))
    a = TokenStream(DataCfg(**kw)).batch(3)
    b = JTokenStream(JDataCfg(**kw)).batch(3)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])


def test_checkpoint_atomic_keep_n(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_n=2, async_write=False)
    tree = {"a": torch.arange(4.0), "b": {"c": torch.ones((2, 2))}}
    for s in (10, 20, 30):
        mgr.save(s, {"a": tree["a"] * s, "b": {"c": tree["b"]["c"] * s}})
    assert mgr.all_steps() == [20, 30]
    assert not list(tmp_path.glob("*.tmp"))
    meta = json.loads((tmp_path / "step_00000030" / "meta.json").read_text())
    assert meta["step"] == 30 and meta["paths"] == ["a", "b/c"]
    got = mgr.restore(30, tree)
    np.testing.assert_allclose(got["a"].numpy(), np.arange(4.0) * 30)
    np.testing.assert_allclose(got["b"]["c"].numpy(), np.full((2, 2), 30.0))


def test_checkpoint_bf16_model_and_state_round_trip(tmp_path):
    """A bf16 model and its AdamW state: stored as uint16 bits with the
    true dtype in the meta, written by the async thread after ``save``
    copied them (the tensors are changed right after), restored bit for
    bit into the like-tree (the module's parameters in place)."""
    from repro_torch import configs as C
    from repro_torch.models.lm import LM
    cfg = C.get_reduced("minicpm_2b")
    model = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    opt = optim.adamw_init(dict(model.named_parameters()), compression=True)
    for t in opt.m.values():
        t.normal_()
    opt = opt._replace(step=torch.tensor(7, dtype=torch.int32))
    want = {n: p.detach().clone() for n, p in model.named_parameters()}
    want_m = {n: t.clone() for n, t in opt.m.items()}
    mgr = CheckpointManager(tmp_path, keep_n=1)
    mgr.save(7, (model, opt))
    with torch.no_grad():                 # the copy was taken before this
        for p in model.parameters():
            p.zero_()
        for t in opt.m.values():
            t.zero_()
    mgr.wait()
    meta = json.loads((tmp_path / "step_00000007" / "meta.json").read_text())
    assert meta["treedef"].startswith("PyTreeDef(")
    dtypes = dict(zip(meta["paths"], meta["dtypes"]))
    assert dtypes["0/embed"] == "bfloat16" and dtypes["1/m/embed"] == "float32"
    assert np.load(tmp_path / "step_00000007" / "leaves.npz")[
        f"leaf_{meta['paths'].index('0/embed')}"].dtype == np.uint16
    fresh = optim.adamw_init(dict(model.named_parameters()), compression=True)
    model2, opt2 = mgr.restore(7, (model, fresh))
    assert model2 is model and int(opt2.step) == 7
    for n, p in model.named_parameters():
        assert p.dtype == want[n].dtype and torch.equal(p, want[n]), n
    for n, t in opt2.m.items():
        assert torch.equal(t, want_m[n]), n
    assert all(float(t.abs().max()) == 0.0 for t in opt2.err.values())


def test_checkpoint_restore_refuses_other_leaves(tmp_path):
    mgr = CheckpointManager(tmp_path, async_write=False)
    mgr.save(1, {"a": torch.zeros(2)})
    with pytest.raises(ValueError):
        mgr.restore(1, {"b": torch.zeros(2)})


def test_train_restart_resumes_identically(tmp_path):
    # 6 steps straight vs (3 steps, stop, resume to 6); on the CPU the
    # same ops in the same order give the same bits
    kw = dict(global_batch=2, seq_len=16, log_every=0, device="cpu")
    full = T.train("minicpm_2b", steps=6, **kw)[2]
    d = tmp_path / "ck"
    T.train("minicpm_2b", steps=3, ckpt_dir=str(d), ckpt_every=3, **kw)
    resumed = T.train("minicpm_2b", steps=6, ckpt_dir=str(d),
                      ckpt_every=100, **kw)[2]
    assert len(resumed) == 3
    np.testing.assert_allclose(full[3:], resumed, rtol=2e-4, atol=2e-4)
    assert full[3:] == resumed


def test_train_loss_decreases():
    losses = T.train("minicpm_2b", steps=30, global_batch=4, seq_len=32,
                     log_every=0, device="cpu")[2]
    assert losses[-1] < losses[0]
    assert np.isfinite(losses).all()


def test_train_with_compression_runs():
    seen = []
    model, opt, losses = T.train(
        "qwen2_5_32b", steps=5, global_batch=2, seq_len=16,
        compression=True, log_every=0, device="cpu",
        on_step=lambda s, l: seen.append(s))
    assert np.isfinite(losses).all() and seen == [0, 1, 2, 3, 4]
    assert opt.err is not None and int(opt.step) == 5


def test_train_vlm_runs():
    losses = T.train("llava_next_34b", steps=2, global_batch=2, seq_len=8,
                     log_every=0, device="cpu")[2]
    assert np.isfinite(losses).all()


def test_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.train("minicpm_2b", steps=1, global_batch=2, seq_len=8)


def test_watchdog_fires_on_stall():
    fired = []
    wd = Watchdog(0.2, on_stall=lambda: fired.append(1)).start()
    time.sleep(0.5)
    wd.stop()
    assert wd.stalls >= 1 and len(fired) == wd.stalls


def test_watchdog_quiet_while_beating():
    wd = Watchdog(0.4).start()
    for _ in range(6):
        time.sleep(0.05)
        wd.beat()
    wd.stop()
    assert wd.stalls == 0
