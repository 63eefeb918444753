"""The port's ten architectures against the reference's, at ``smoke_config``
on the same weights (the reference's ``init_params`` carried across by
``interop.lm_params_from_numpy``): configs, layer plans, parameter counts,
the converted parameters, ``forward`` and eight ``decode_step``s, and the
port's decode against its own prefill.

Bars: logits within 1e-4 * max|logit| of the reference's (``REL``; fp32,
two libraries' summation orders through 2-17 layers); the port's decode
against its prefill within the reference test's 2e-3 (rtol and atol,
``tests/test_arch_smoke.py``).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro.models import config as jmconfig
from repro.models import model as jm
from repro.train import train_step as jtrain
from repro_torch import configs
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import config as mconfig
from repro_torch.models import model as tm
from repro_torch.train import train_step as ttrain

REL = 1e-4
B, S, STEPS = 2, 16, 8
ARCHS = jconfigs.ARCH_IDS


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


_CACHE = {}


def _pair(arch):
    """(jax cfg, port cfg, jax params, numpy tree, port LM, tokens, jax
    memory, port memory), built once per arch."""
    if arch not in _CACHE:
        jcfg = jconfigs.smoke_config(arch)
        cfg = configs.smoke_config(arch)
        params = jm.init_params(jax.random.PRNGKey(3), jcfg)
        tree = jax.tree.map(np.asarray, params)
        model = lm_params_from_numpy(tree, cfg, device="cpu")
        rng = np.random.default_rng(4)
        toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        jmem = tmem = None
        if cfg.encoder_decoder:
            emb = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
            jmem = jm.encode(params, jnp.asarray(emb), jcfg)
            tmem = tm.encode(model, torch.from_numpy(emb), cfg)
        _CACHE[arch] = (jcfg, cfg, params, tree, model, toks, jmem, tmem)
    return _CACHE[arch]


def _close(got, want, rel=REL):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    scale = float(np.max(np.abs(want)))
    assert err <= rel * scale, f"max err {err!r} > {rel} * {scale!r}"


def test_registry_matches():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert configs.FULL_ATTENTION_ARCHS == jconfigs.FULL_ATTENTION_ARCHS
    assert ([dataclasses.asdict(s) for s in mconfig.LM_SHAPES]
            == [dataclasses.asdict(s) for s in jmconfig.LM_SHAPES])
    for s in jmconfig.LM_SHAPES:
        assert (dataclasses.asdict(mconfig.shape_by_name(s.name))
                == dataclasses.asdict(s))
    with pytest.raises(KeyError):
        mconfig.shape_by_name("no-such-shape")


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_and_plan_match(arch):
    for get in ("get_config", "smoke_config"):
        cfg = getattr(configs, get)(arch)
        jcfg = getattr(jconfigs, get)(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg), get
        assert cfg.layer_kinds() == jcfg.layer_kinds()
        assert cfg.ffn_kinds() == jcfg.ffn_kinds()
        assert tm.layer_plan(cfg) == jm.layer_plan(jcfg)
        for active in (False, True):
            assert (cfg.param_count(active_only=active)
                    == jcfg.param_count(active_only=active))
    assert ([dataclasses.asdict(s) for s in configs.arch_shapes(arch)]
            == [dataclasses.asdict(s) for s in jconfigs.arch_shapes(arch)])


@pytest.mark.parametrize("arch", ARCHS)
def test_converted_params_account_for_every_leaf(arch):
    """Every reference leaf, unstacked by the layer plan, is one parameter
    of the port's LM with its shape and dtype; nothing else is."""
    jcfg, cfg, params, tree, model, *_ = _pair(arch)
    _, P, R, _ = jm.layer_plan(jcfg)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", None)))
                for k in path]
        if keys[0] == "blocks":
            for r in range(R):
                name = ".".join(["layers", str(r * P + int(keys[1]))]
                                + keys[2:])
                want[name] = (leaf.shape[1:], leaf.dtype)
        elif keys[0] == "tail":
            name = ".".join(["layers", str(P * R + int(keys[1]))] + keys[2:])
            want[name] = (leaf.shape, leaf.dtype)
        else:
            want[".".join(keys)] = (leaf.shape, leaf.dtype)
    got = {name: (tuple(p.shape), np.dtype(str(p.dtype).split(".")[1]))
           for name, p in model.named_parameters()}
    assert got == want
    assert (sum(p.numel() for p in model.parameters())
            == sum(x.size for x in jax.tree.leaves(tree)))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    jcfg, cfg, params, _, model, toks, jmem, tmem = _pair(arch)
    jlog, jaux = jax.jit(lambda p, t: jm.forward(p, t, jcfg, memory=jmem))(
        params, jnp.asarray(toks))
    logits, aux = tm.forward(model, torch.from_numpy(toks), cfg, memory=tmem)
    assert logits.dtype == torch.float32
    _close(logits, jlog)
    assert abs(float(aux) - float(jaux)) <= REL * max(abs(float(jaux)), 1.0)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    jcfg, cfg, params, _, model, toks, jmem, tmem = _pair(arch)
    jstate = jm.init_decode_state(jcfg, B, capacity=S, memory=jmem)
    state = tm.init_decode_state(cfg, B, capacity=S, memory=tmem,
                                 device="cpu")
    step = jax.jit(lambda p, t, s: jm.decode_step(p, t, s, jcfg))
    for t in range(STEPS):
        jlog, jstate = step(params, jnp.asarray(toks[:, t:t + 1]), jstate)
        logits, state = tm.decode_step(
            model, torch.from_numpy(toks[:, t:t + 1]), state, cfg)
        assert logits.shape == (B, 1, cfg.vocab_size)
        _close(logits, jlog)
    assert state.pos.tolist() == [STEPS] * B
    assert np.array_equal(state.pos.numpy(), np.asarray(jstate.pos))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch):
    """Greedy decode logits == full-forward logits at the same position."""
    _, cfg, _, _, model, toks, _, tmem = _pair(arch)
    T = 6
    full, _ = tm.forward(model, torch.from_numpy(toks[:, :T]), cfg,
                         memory=tmem)
    state = tm.init_decode_state(cfg, B, capacity=S, memory=tmem,
                                 device="cpu")
    outs = []
    for t in range(T):
        lg, state = tm.decode_step(model, torch.from_numpy(toks[:, t:t + 1]),
                                   state, cfg)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ["gemma3-1b", "seamless-m4t-medium"])
def test_make_prefill_and_serve_step_match_reference(arch):
    """The step factories: the bulk prefill (the encoder run on the
    frontend embeddings for enc-dec) and one serve step."""
    jcfg, cfg, params, _, model, toks, jmem, tmem = _pair(arch)
    emb = np.random.default_rng(5).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    _close(ttrain.make_prefill(cfg)(model, torch.from_numpy(toks),
                                    torch.from_numpy(emb)),
           jtrain.make_prefill(jcfg)(params, jnp.asarray(toks),
                                     jnp.asarray(emb)))
    state = tm.init_decode_state(cfg, B, capacity=S, memory=tmem,
                                 device="cpu")
    jstate = jm.init_decode_state(jcfg, B, capacity=S, memory=jmem)
    logits, state = ttrain.make_serve_step(cfg)(
        model, torch.from_numpy(toks[:, :1]), state)
    jlogits, _ = jtrain.make_serve_step(jcfg)(params, jnp.asarray(toks[:, :1]),
                                              jstate)
    _close(logits, jlogits)
    assert state.pos.tolist() == [1] * B


def test_init_params_is_seeded_and_covers_the_plan():
    cfg = configs.smoke_config("jamba-1.5-large-398b")
    a = tm.init_params(5, cfg, device="cpu")
    b = tm.init_params(5, cfg, device="cpu")
    assert len(a.layers) == cfg.n_layers
    assert [layer.kind for layer in a.layers] == list(cfg.layer_kinds())
    for (name, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), name
