"""The port's cost analysis (``repro_torch.launch.cost_analysis``) against
the reference's HLO counts (``repro.launch.hlo_analysis``), on the CPU.

The reference's figure is the sum of ``attribute_dots(text, top=<all
rows>)`` over a step compiled by ``jax.jit`` for one CPU device, as
``tests/test_hlo_analysis.py`` compiles it; the port's is the dry run's
product count of the same step on the ``meta`` device.  The reduced
dense, MoE, RWKV and enc-dec configs, train and prefill steps.

Attention is held apart, because the two sides do different work there
by design: the reference's jnp attention (``chunked_attention``) computes
every (query, key) pair of 512-row query blocks, masked or padded,
while the port's kernel computes only the unmasked pairs.  So the port's
attention must equal the reference's cost of one pair, read from its
HLO, times the port's unmasked pairs, and the products outside attention
must agree within the 20 % that ``test_hlo_analysis.py`` allows; both
totals are printed.  The totals themselves are 0.61-0.73 of the
reference's at these shapes, so they are not held within 20 %.
"""
import functools
import math

import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import configs as JC  # noqa: E402
from repro.launch import hlo_analysis as H  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.train import optim as JOPT  # noqa: E402
from repro.train import step as JSTEP  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.kernels import ref as KREF  # noqa: E402
from repro_torch.kernels import work  # noqa: E402
from repro_torch.launch import cost_analysis as CA  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

B, S, TE = 2, 64, 16
ATTENTION = ("bhgqd,bkhd->bhgqk", "bhgqk,bkhd->bhgqd")   # chunked_attention
ARCHS = ("minicpm_2b", "mixtral_8x7b", "rwkv6_7b", "whisper_small")


@functools.lru_cache(maxsize=None)
def _reference_rows(arch, kind):
    cfg = JC.get_reduced(arch)
    params = jax.eval_shape(lambda: JLM.init_params(jax.random.PRNGKey(0),
                                                    cfg))
    sd = jax.ShapeDtypeStruct
    batch = {"tokens": sd((B, S), jnp.int32)}
    if kind == "train":
        batch["labels"] = sd((B, S), jnp.int32)
    if cfg.family == "encdec":
        batch["enc_frames"] = sd((B, TE, cfg.d_model), cfg.dtype)
    if kind == "train":
        opt = jax.eval_shape(lambda: JOPT.adamw_init(params))
        lowered = jax.jit(JSTEP.make_train_step(cfg)).lower(params, opt,
                                                            batch)
    else:
        lowered = jax.jit(JSTEP.make_prefill_step(cfg, max_len=S)).lower(
            params, batch)
    return H.attribute_dots(lowered.compile().as_text(), top=10 ** 9)


def _port_cost(cfg, kind, s=S):
    model, opt, cache = DR.build(cfg, kind, B, s)
    batch = {"tokens": torch.empty(B, s, dtype=torch.int32, device="meta")}
    if kind == "train":
        batch["labels"] = batch["tokens"]
    if cfg.family == "encdec":
        batch["enc_frames"] = torch.empty(B, TE, cfg.d_model, dtype=cfg.dtype,
                                          device="meta")
    return DR.step_cost(cfg, model, kind, batch, opt=opt, cache=cache,
                        seq=s)


def _attention_pairs(cfg, sq, sk, causal):
    pairs, _, _ = work.attention_pairs(sq, sk, causal=causal,
                                       window=cfg.sliding_window, q_offset=0)
    return pairs


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dot_flops_against_reference_hlo(arch, kind):
    rows = _reference_rows(arch, kind)
    ref = math.fsum(r["flops"] for r in rows)
    ref_attn = math.fsum(r["flops"] for r in rows
                         if any(a in r["op"] for a in ATTENTION))
    cfg = TC.get_reduced(arch)
    cost = _port_cost(cfg, kind)
    port = cost["flops_dots"]
    port_attn = sum(v["flops"] for k, v in cost["credited"].items()
                    if k.startswith("flash_attention"))
    assert math.fsum(r["flops"] for r in CA.attribute_dots(cost, top=None)) == \
        pytest.approx(port, rel=1e-12)
    print(f"{arch} {kind}: dot FLOPs port {port:.6g} reference {ref:.6g} "
          f"(ratio {port / ref:.4f}); attention port {port_attn:.6g} "
          f"reference {ref_attn:.6g}; outside attention port "
          f"{port - port_attn:.6g} reference {ref - ref_attn:.6g}")
    assert abs((port - port_attn) - (ref - ref_attn)) / (ref - ref_attn) \
        < 0.2
    if cfg.family != "rwkv":
        # each attention call as (Sq, Sk, causal, the reference's passes
        # over it), a pass being one forward's two products: the
        # reference computes whole 512-row query blocks of every key, the
        # port the unmasked pairs.  A train step's reference decoder runs
        # its forward, remat's and a backward of two (4); its encoder is
        # not recomputed (3).  The port's backward kernel recomputes the
        # scores (2.5) and its remat covers the encoder too (4.5).
        train = kind == "train"
        dec, enc = (4, 3) if train else (1, 1)
        calls = [(S, S, True, dec)] * cfg.n_layers
        if cfg.family == "encdec":
            calls = [(TE, TE, False, enc)] * cfg.n_enc_layers + \
                [(S, S, True, dec), (S, TE, False, dec)] * cfg.n_layers
        padded = sum(n * -(-sq // 512) * 512 * sk for sq, sk, _, n in calls)
        per_pair = ref_attn / padded
        assert per_pair == 4 * B * cfg.n_heads * cfg.d_head
        # the port's attention from the reference's cost of a pair
        port_passes = 4.5 if train else 1
        assert port_attn == pytest.approx(
            per_pair * port_passes * sum(_attention_pairs(cfg, sq, sk, c)
                                         for sq, sk, c, _ in calls),
            rel=1e-12)


def test_flops_scale_with_layers():
    """The counterpart of ``test_scan_flops_scale_with_trip_count``: the
    port's layers are a loop, so each costs the same; FLOPs and products
    are linear in ``n_layers`` (a train step, remat included)."""
    import dataclasses
    base = TC.get_reduced("minicpm_2b")
    got = {}
    for L in (2, 4, 8):
        c = _port_cost(dataclasses.replace(base, n_layers=L), "train")
        got[L] = (c["flops_corrected"], c["flops_dots"])
    for i in range(2):
        per = got[4][i] - got[2][i]
        assert per > 0
        assert got[8][i] - got[4][i] == pytest.approx(2 * per, rel=1e-12)
    assert 3.0 < got[8][1] / got[2][1] < 5.0


def test_mamba_scan_credit_equals_the_loop():
    """On ``meta`` the Mamba scan (its kernel on the card) is credited in
    one go with ``work.mamba_scan_work``'s figures; the rest of the layer
    counts what it counts on the CPU, where the scan is the plain token
    loop, counted op by op."""
    cfg = TC.get_reduced("jamba_1_5_large")
    B, S, E, N = 2, 40, 2 * cfg.d_model, cfg.d_state
    costs = []
    for dev in ("cpu", "meta"):
        m = ssm.Mamba(cfg, device=dev,
                      generator=torch.Generator().manual_seed(0)
                      if dev == "cpu" else None)
        x = torch.zeros((B, S, cfg.d_model), dtype=cfg.dtype, device=dev)
        with torch.no_grad():
            costs.append(CA.analyze(m, x))
    cpu, meta = costs
    f, n_exp, nb = work.mamba_scan_work(B, S, E, N)
    assert meta["credited"]["mamba_scan"] == {"calls": 1, "flops": f + n_exp,
                                              "bytes": nb}
    z = torch.zeros
    loop = CA.analyze(KREF.mamba_scan_reference, z(B, S, E), z(B, S),
                      z(E, N), z(B, S, N), z(B, S, N), z(B, E, N))
    for key, part in (("flops_corrected", "flops"),
                      ("bytes_corrected", "bytes")):
        assert meta[key] - meta["credited"]["mamba_scan"][part] == \
            cpu[key] - loop[key], key
    assert meta["flops_dots"] == cpu["flops_dots"]


def test_peak_counts_each_storage_once_until_it_dies():
    n = 1000 * 4

    def fn():
        a = torch.ones(1000, device="meta")          # 4,000 B
        v = a[10:].view(-1, 10)                       # a view: no bytes
        b = a * 2                                     # 8,000 live
        del a, v
        c = b + 1                                     # a freed: 8,000
        b.add_(1)                                     # in place: no bytes
        x = torch.ones(1000, device="meta", requires_grad=True)
        y = (x * c).exp()          # exp saves y for the backward,
        s = y.sum()                # which s's graph holds
        del y                      # ... so y's storage stays live
        z = torch.ones(2000, device="meta")   # x * c freed by now
        return c, z, s
    cost = CA.analyze(fn)
    # b, c, x, y, s (4 B) and z (8,000 B)
    assert cost["peak_bytes"] == 6 * n + 4
    assert cost["host_bytes"] == 0


def test_attention_pairs_closed_form_equals_the_loop():
    """``work.attention_pairs`` against a loop over the query rows:
    causal or not, a sliding window, a query offset, Sq != Sk."""
    def loop(sq, sk, causal, window, off):
        pairs, lo_min, hi_max = 0, sk, -1
        for i in range(sq):
            pos = off + i
            hi = min(sk - 1, pos) if causal else sk - 1
            lo = max(0, pos - window + 1) if window else 0
            if hi >= lo:
                pairs += hi - lo + 1
                lo_min, hi_max = min(lo_min, lo), max(hi_max, hi)
        return (pairs, lo_min, hi_max) if pairs else (0, 0, -1)
    n = 0
    for sq in (1, 2, 5, 16, 33):
        for sk in (1, 3, 16, 40):
            for causal in (True, False):
                for window in (0, 1, 4, 17):
                    for off in (0, 1, 7, 39, 60):
                        assert work.attention_pairs(
                            sq, sk, causal=causal, window=window,
                            q_offset=off) == loop(sq, sk, causal, window,
                                                  off)
                        n += 1
    assert n == 5 * 4 * 2 * 4 * 5
    q = torch.empty(2, 1024, 8, 64, device="meta")
    k = torch.empty(2, 1024, 2, 64, device="meta")
    f, nb = work.attention_work(q, k, causal=True, window=0, q_offset=0)
    assert f == 4 * 2 * 8 * 64 * 1024 * 1025 // 2
    assert nb == 4 * (2 * 2 * 1024 * 8 * 64 + 2 * 2 * 1024 * 2 * 64)


def test_model_flops_rule_unchanged():
    """``work.family_flops`` (moved out of chip_smoke.py) on MiniCPM-2B's
    train step: 6 N D over the product weights plus attention at 3.5x its
    forward."""
    cfg = TC.get_config("minicpm_2b")
    model = LM(cfg, device="meta")
    flops, n = work.family_flops(model, cfg, 8, 2048, 0)
    emb = cfg.vocab_padded * cfg.d_model
    assert n == sum(p.numel() for p in model.parameters()
                    if p.ndim >= 2) - emb
    attn = 3.5 * 4 * 8 * cfg.n_heads * cfg.d_head * 2048 * 2049 // 2
    assert flops == pytest.approx(6 * n * 8 * 2048 + cfg.n_layers * attn,
                                  rel=1e-12)


def test_logsumexp_counts_its_hidden_temporary():
    """``logsumexp`` is counted as ATen's implementation runs it: its
    ``(x - max).exp_()`` temporary (x's size) is in the peak, and the
    op-for-op form gives the op's values."""
    x = torch.randn(4, 1000, generator=torch.Generator().manual_seed(0))
    x[1, 3] = float("inf")
    x[2] = -float("inf")
    got = CA._OPENED[torch.ops.aten.logsumexp.default](x, [-1])
    torch.testing.assert_close(got, torch.logsumexp(x, -1), rtol=0, atol=0)
    cost = CA.analyze(torch.logsumexp, torch.empty(4, 1000, device="meta"),
                      -1)
    assert cost["peak_bytes"] >= 4 * 4000 + 4 * 4   # the temporary + out
    assert cost["out"].shape == (4,)
