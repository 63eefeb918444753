"""The port's LM layers (``repro_torch.models``) against the reference's, on
the same numpy inputs and the same weights, at smoke widths in fp32.

Bar: max|port - reference| <= 1e-5 * max|reference| (``REL``): the two
packages sum the same products in different orders (XLA's and ATen's CPU
kernels), a few fp32 ulps apart. Masks, the int8 codes and scales of equal
inputs and the per-expert counts are compared exactly; the int8 codes of a
cache whose keys each package computed may differ by one where a key sits
on a rounding tie; softplus within 4 ulps elementwise.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models import xlstm as jxlstm
from repro_torch.configs import smoke_config
from repro_torch.interop import _leaves
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models import xlstm as txlstm

REL = 1e-5
ARCH = "mistral-large-123b"


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(seed, shape):
    return _rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    scale = float(np.max(np.abs(want)))
    assert err <= rel * scale, f"max err {err!r} > {rel} * {scale!r}"


def _module(cls, tree, cfg):
    """The port's module ``cls`` holding the reference's subtree ``tree``."""
    m = cls(cfg, None, "cpu")
    m.load_state_dict({path[1:]: torch.from_numpy(np.array(leaf))
                       for path, leaf in _leaves(tree, "")})
    return m


def _cfgs(arch=ARCH, **kw):
    return jsmoke(arch).scaled(**kw), smoke_config(arch).scaled(**kw)


# --------------------------------------------------------- norm, rope, mask

def test_rmsnorm_matches():
    jcfg, cfg = _cfgs()
    x, g = _normal(0, (2, 5, 64)), _normal(1, (64,))
    p = tlayers.RMSNorm(64, cfg, "cpu")
    p.load_state_dict({"g": torch.from_numpy(g)})
    _close(tlayers.rmsnorm(p, torch.from_numpy(x), cfg),
           jlayers.rmsnorm({"g": jnp.asarray(g)}, jnp.asarray(x), jcfg))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches(theta):
    x = _normal(2, (3, 16, 4, 32))
    pos = _rng(3).integers(0, 4096, (3, 16)).astype(np.int32)
    cos, sin = tlayers.rope_angles(torch.from_numpy(pos), 32, theta)
    jcos, jsin = jlayers.rope_angles(jnp.asarray(pos), 32, theta)
    _close(cos, jcos)
    _close(sin, jsin)
    _close(tlayers.apply_rope(torch.from_numpy(x), cos, sin),
           jlayers.apply_rope(jnp.asarray(x), jcos, jsin))


@pytest.mark.parametrize("q_len,kv_len,window,q_offset", [
    (6, 6, 3, 0), (16, 16, None, 0), (8, 40, 16, 32), (5, 12, 1, 7)])
def test_causal_window_mask_matches(q_len, kv_len, window, q_offset):
    got = tattn._causal_window_mask(q_len, kv_len, window, q_offset)
    want = jattn._causal_window_mask(q_len, kv_len, window, q_offset)
    assert np.array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------- attention --

@pytest.mark.parametrize("S,chunk,window", [(64, 16, None), (128, 32, 24),
                                            (96, 32, None)])
def test_sdpa_chunked_matches_full_and_reference(S, chunk, window):
    jcfg, cfg = _cfgs()
    q, k, v = (_normal(s, (2, S, 4, 16)) for s in (4, 5, 6))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    full = tattn._sdpa(tq, tk, tv, tattn._causal_window_mask(S, S, window),
                       cfg)
    chunked = tattn._sdpa_chunked(tq, tk, tv, cfg, causal=True,
                                  window=window, chunk=chunk)
    want = jattn._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jattn._causal_window_mask(S, S, window), jcfg)
    _close(full, want)
    _close(chunked, want)


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("arch,window", [(ARCH, None), ("gemma3-1b", 16),
                                         ("qwen1.5-32b", None)])
def test_attention_matches(arch, window, cross):
    jcfg, cfg = _cfgs(arch)
    tree = jax.tree.map(np.asarray,
                        jattn.init_attention(jax.random.PRNGKey(7), jcfg))
    p = _module(tattn.Attention, tree, cfg)
    x = _normal(8, (2, 24, cfg.d_model))
    src = _normal(9, (2, 10, cfg.d_model)) if cross else None
    got = tattn.attention(p, torch.from_numpy(x), cfg, window=window,
                          kv_src=None if src is None else torch.from_numpy(src),
                          causal=not cross)
    want = jattn.attention(tree, jnp.asarray(x), jcfg, window=window,
                           kv_src=None if src is None else jnp.asarray(src),
                           causal=not cross)
    _close(got, want)


@pytest.mark.parametrize("kv", ["compute", "int8"])
@pytest.mark.parametrize("window", [None, 8])
def test_attention_decode_ring_wraps(window, kv):
    """More steps than ring slots (W = 8), each batch slot at its own
    position: the outputs and the whole cache after every step."""
    jcfg, cfg = _cfgs("gemma3-1b", kv_cache_dtype=kv)
    tree = jax.tree.map(np.asarray,
                        jattn.init_attention(jax.random.PRNGKey(10), jcfg))
    p = _module(tattn.Attention, tree, cfg)
    B, W, steps = 2, 8, 21
    jc = jattn.init_layer_cache(jcfg, B, W)
    tc = tattn.init_layer_cache(cfg, B, W, device="cpu")
    start = np.array([0, 5], np.int32)
    xs = _normal(11, (steps, B, 1, cfg.d_model))
    for t in range(steps):
        pos = start + t
        y, tc = tattn.attention_decode(p, torch.from_numpy(xs[t]), tc,
                                       torch.from_numpy(pos), cfg, window)
        jy, jc = jattn.attention_decode(tree, jnp.asarray(xs[t]), jc,
                                        jnp.asarray(pos), jcfg, window)
        _close(y, jy)
        for got, want in zip(tc, jc):
            if got.dtype == torch.int8:
                # codes of near-equal keys: a rounding tie may differ by 1
                diff = np.abs(got.numpy().astype(int) - np.asarray(want))
                assert diff.max() <= 1 and diff.mean() < 1e-2
            else:
                _close(got, want)


def test_int8_codes_and_scales_match():
    x = _normal(12, (3, 1, 2, 16)) * 4.0
    x[0, 0, 1] = 0.0                      # an all-zero head: the scale floor
    q, s = tattn._quantize_kv(torch.from_numpy(x))
    jq, js = jattn._quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))
    assert np.array_equal(
        tattn._dequantize_kv(q, s, torch.float32).numpy(),
        np.asarray(jattn._dequantize_kv(jq, js, jnp.float32)))


# ------------------------------------------------------------------- MoE --

def _moe_pair(arch, **kw):
    jcfg, cfg = _cfgs(arch, **kw)
    tree = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(13),
                                                  jcfg))
    return jcfg, cfg, tree, _module(tmoe.MoE, tree, cfg)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "arctic-480b",
                                  "jamba-1.5-large-398b"])
@pytest.mark.parametrize("no_drop", [True, False])
def test_moe_ffn_matches(arch, no_drop):
    """qwen2-moe: top-2 of 8 plus shared experts; arctic: the dense
    residual. capacity_factor 1.0 without no_drop drops tokens."""
    jcfg, cfg, tree, p = _moe_pair(arch, capacity_factor=1.0)
    x = _normal(14, (2, 16, cfg.d_model))
    out, aux = tmoe.moe_ffn(p, torch.from_numpy(x), cfg, no_drop=no_drop)
    jout, jaux = jmoe.moe_ffn(tree, jnp.asarray(x), jcfg, no_drop=no_drop)
    _close(out, jout)
    _close(aux, jaux)
    if not no_drop:
        # the capacity really binds: some expert got more pairs than slots
        logits = torch.from_numpy(x).reshape(-1, cfg.d_model) @ p.router.w
        idx = torch.topk(torch.softmax(logits, -1), cfg.experts_per_token,
                         -1).indices
        cap = int(cfg.capacity_factor * 32 * cfg.experts_per_token
                  / cfg.n_experts)
        assert int(torch.bincount(idx.flatten()).max()) > cap


def test_moe_capacity_slots_match():
    """The sort-based slots, trash row and expert counts of one group."""
    jcfg, cfg, tree, p = _moe_pair("qwen2-moe-a2.7b")
    rng = _rng(15)
    Tg, K, E, cap = 24, 2, 8, 5
    gate_idx = np.stack([rng.choice(E, K, replace=False) for _ in range(Tg)])
    gate_vals = rng.random((Tg, K)).astype(np.float32)
    xg = _normal(16, (Tg, cfg.d_model))
    w = [p.w_gate, p.w_up, p.w_down]
    out, counts = tmoe._dispatch_group(
        torch.from_numpy(xg), torch.from_numpy(gate_idx),
        torch.from_numpy(gate_vals), *w, E, cap, torch.float32)
    jout, jcounts = jmoe._dispatch_group(
        jnp.asarray(xg), jnp.asarray(gate_idx), jnp.asarray(gate_vals),
        tree["w_gate"], tree["w_up"], tree["w_down"], E, cap, jnp.float32)
    assert np.array_equal(counts.numpy(), np.asarray(jcounts))
    assert int(counts.max()) > cap
    _close(out, jout)


# ------------------------------------------------------------ recurrences --

@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_recurrent_layers_match_over_a_sequence_and_step_by_step(kind):
    arch = "jamba-1.5-large-398b" if kind == "mamba" else "xlstm-125m"
    jcfg, cfg = _cfgs(arch)
    jmod, tmod = (jssm, tssm) if kind == "mamba" else (jxlstm, txlstm)
    cls = {"mamba": tssm.Mamba, "mlstm": txlstm.MLSTM,
           "slstm": txlstm.SLSTM}[kind]
    tree = jax.tree.map(np.asarray, getattr(jmod, f"init_{kind}")(
        jax.random.PRNGKey(17), jcfg))
    p = _module(cls, tree, cfg)
    B, S = 2, 12
    x = _normal(18, (B, S, cfg.d_model))
    seq = getattr(tmod, kind)(p, torch.from_numpy(x), cfg)
    _close(seq, getattr(jmod, kind)(tree, jnp.asarray(x), jcfg))

    init_t = getattr(tmod, f"init_{kind}_state")
    init_j = getattr(jmod, f"init_{kind}_state")
    st, jst = init_t(cfg, B, device="cpu"), init_j(jcfg, B)
    step_t, step_j = (getattr(tmod, f"{kind}_decode"),
                      getattr(jmod, f"{kind}_decode"))
    steps = []
    for t in range(S):
        y, st = step_t(p, torch.from_numpy(x[:, t:t + 1]), st, cfg)
        jy, jst = step_j(tree, jnp.asarray(x[:, t:t + 1]), jst, jcfg)
        _close(y, jy)
        steps.append(y)
    for got, want in zip(st, jst):
        _close(got, want)
    # the port's decode steps against its own sequence pass
    _close(torch.cat(steps, dim=1), seq.numpy())


def test_softplus_is_logaddexp():
    """The reference's softplus, ``logaddexp(x, 0)``, within an ulp or two
    (the two libraries' log1p/exp), with no cut-over to x above 20."""
    x = np.linspace(-40, 40, 801, dtype=np.float32)
    got = tlayers.softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=4 * np.finfo(np.float32).eps,
                               atol=0)
