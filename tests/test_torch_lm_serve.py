"""The port's token serving path (``repro_torch.serve.engine`` and
``repro_torch.launch.serve``) on the CPU: the reference's four engine
tests run on the port, the port's engine against the JAX engine on the
same weights, prompts and submit/tick schedule, the int8 KV cache, and the
CLI.

Bars: where the reference's top-1/top-2 logit margin is above
1e-3 * max|logit| (``MARGIN``) the greedy tokens are equal; the logits of
every tick agree within 1e-4 * max|logit| (``REL``, as
``test_torch_lm_arch.py``). The int8 cache against the compute cache: the
reference's bars (``tests/test_kv_int8.py``: error below 0.05 of
max|logit|, greedy agreement at least 0.9); the port's int8 against the
reference's int8 within 1e-3 * max|logit| (``INT8_REL``: a key on a
rounding tie may take the neighbouring code in one package).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.models import model as jm
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.configs import smoke_config
from repro_torch.interop import lm_params_from_numpy
from repro_torch.launch import serve as serve_cli
from repro_torch.models import model as tm
from repro_torch.serve.engine import ServeEngine

REL = 1e-4
MARGIN = 1e-3
INT8_REL = 1e-3


def _engine(slots=2):
    cfg = smoke_config("gemma3-1b")
    params = tm.init_params(0, cfg, device="cpu")
    return cfg, ServeEngine(cfg, params, batch_slots=slots, capacity=64,
                            device="cpu")


# ---------------------------------------- the reference's engine tests ---

def test_engine_drains_queue():
    cfg, eng = _engine(slots=2)
    rng = np.random.default_rng(0)
    uids = [eng.submit(rng.integers(0, cfg.vocab_size, size=5),
                       max_new_tokens=4) for _ in range(5)]
    done = eng.run_until_drained()
    assert sorted(r.uid for r in done) == sorted(uids)
    for r in done:
        assert len(r.output) == 4
        assert all(0 <= t < cfg.vocab_size for t in r.output)
        assert r.finished_at >= r.submitted_at


def test_engine_continuous_batching_overlaps():
    """A short request admitted later must finish while a long one runs."""
    cfg, eng = _engine(slots=2)
    rng = np.random.default_rng(1)
    long_uid = eng.submit(rng.integers(0, cfg.vocab_size, size=3),
                          max_new_tokens=20)
    short_uid = eng.submit(rng.integers(0, cfg.vocab_size, size=3),
                           max_new_tokens=2)
    third_uid = eng.submit(rng.integers(0, cfg.vocab_size, size=3),
                           max_new_tokens=2)
    order = [r.uid for r in eng.run_until_drained()]
    assert order.index(short_uid) < order.index(long_uid)
    assert order.index(third_uid) < order.index(long_uid)


def test_staggered_admits_match_solo_runs():
    """A request admitted into a freed slot mid-stream of another request
    reproduces its solo-run output token-for-token, and the long-running
    occupant is not disturbed."""
    cfg, eng = _engine(slots=2)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, size=4) for _ in range(3)]
    lens = [16, 3, 3]

    def solo(prompt, n_new):
        e = ServeEngine(cfg, eng.params, batch_slots=2, capacity=64,
                        device="cpu")
        uid = e.submit(prompt, max_new_tokens=n_new)
        (r,) = e.run_until_drained()
        assert r.uid == uid
        return r.output

    expect = [solo(p, n) for p, n in zip(prompts, lens)]
    uid0 = eng.submit(prompts[0], max_new_tokens=lens[0])  # long occupant
    uid1 = eng.submit(prompts[1], max_new_tokens=lens[1])
    for _ in range(100):
        eng.tick()
        if any(r.uid == uid1 for r in eng.done):
            break
    uid2 = eng.submit(prompts[2], max_new_tokens=lens[2])
    out = {r.uid: r.output for r in eng.run_until_drained()}
    assert out[uid1] == expect[1]
    assert out[uid2] == expect[2], "freed-slot re-admit diverged from solo"
    assert out[uid0] == expect[0], "long-running occupant was disturbed"


def test_engine_eos_stops_early():
    cfg, eng = _engine(slots=1)
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, cfg.vocab_size, size=4)
    eng.submit(prompt, max_new_tokens=1)
    first_tok = eng.run_until_drained()[0].output[0]
    eng2 = ServeEngine(eng.cfg, eng.params, batch_slots=1, capacity=64,
                       device="cpu")
    uid = eng2.submit(prompt, max_new_tokens=50, eos_id=first_tok)
    done = eng2.run_until_drained()
    assert done[-1].uid == uid and len(done[-1].output) == 1


# ----------------------------------------------- against the JAX engine ---

def _record(engine, to_numpy):
    """Wrap ``engine._step`` to keep each tick's last-position logits and
    the uid in each slot."""
    log, step = [], engine._step

    def recorded(params, tokens, state):
        logits, state = step(params, tokens, state)
        uids = [None if s.req is None else s.req.uid for s in engine.slots]
        log.append((uids, to_numpy(logits[:, -1])))
        return logits, state

    engine._step = recorded
    return log


def test_engine_matches_the_jax_engine():
    """Both engines on the same weights, prompts and schedule: 7 requests
    in 3 slots, two of them submitted mid-stream, prompts long enough
    that the local layers' 16-slot rings wrap."""
    jcfg, cfg = jsmoke("gemma3-1b"), smoke_config("gemma3-1b")
    params = jm.init_params(jax.random.PRNGKey(11), jcfg)
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                 device="cpu")
    jeng = JaxEngine(jcfg, params, batch_slots=3, capacity=64)
    teng = ServeEngine(cfg, model, batch_slots=3, capacity=64, device="cpu")
    jlog = _record(jeng, np.asarray)
    tlog = _record(teng, lambda x: x.numpy())
    rng = np.random.default_rng(12)
    reqs = [(rng.integers(0, cfg.vocab_size, size=n), g)
            for n, g in ((20, 6), (3, 4), (9, 12), (1, 3), (14, 5),
                         (0, 2), (6, 8))]
    for prompt, n_new in reqs[:5]:
        for e in (jeng, teng):
            e.submit(prompt, max_new_tokens=n_new)
    for tick in range(200):
        if tick == 7:
            for prompt, n_new in reqs[5:]:
                for e in (jeng, teng):
                    e.submit(prompt, max_new_tokens=n_new)
        if tick > 7 and not teng.queue and all(s.free for s in teng.slots):
            break
        assert jeng.tick() == teng.tick()
    assert not jeng.queue and all(s.free for s in jeng.slots)
    assert len(jlog) == len(tlog) > 20

    diverged = set()                   # uids past a near-tie disagreement
    for (juids, jl), (tuids, tl) in zip(jlog, tlog):
        assert juids == tuids
        for row, uid in enumerate(tuids):
            if uid in diverged:
                continue
            scale = float(np.max(np.abs(jl[row])))
            err = float(np.max(np.abs(tl[row] - jl[row])))
            assert err <= REL * scale, (uid, err, scale)
            top2 = np.sort(jl[row])[-2:]
            if int(np.argmax(tl[row])) != int(np.argmax(jl[row])):
                assert top2[1] - top2[0] <= MARGIN * scale, uid
                diverged.add(uid)
    jout = {r.uid: r.output for r in jeng.done}
    tout = {r.uid: r.output for r in teng.done}
    assert sorted(jout) == sorted(tout) == list(range(1, len(reqs) + 1))
    for uid in jout:
        if uid not in diverged:
            assert tout[uid] == jout[uid], uid
    assert len(diverged) <= 1


# ------------------------------------------------------------ int8 KV ---

def _decode(model, cfg, toks, state):
    outs = []
    for t in range(toks.shape[1]):
        lg, state = tm.decode_step(model, torch.from_numpy(toks[:, t:t + 1]),
                                   state, cfg)
        outs.append(lg)
    return torch.cat(outs, dim=1).numpy()


def test_int8_kv_decode_close_to_compute_cache_and_reference():
    jcfg = jsmoke("gemma3-27b")
    cfg = smoke_config("gemma3-27b")
    cfg8, jcfg8 = (c.scaled(kv_cache_dtype="int8") for c in (cfg, jcfg))
    params = jm.init_params(jax.random.PRNGKey(0), jcfg)
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                 device="cpu")
    B, T = 2, 8
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (B, T)).astype(np.int32)
    st8 = tm.init_decode_state(cfg8, B, capacity=16, device="cpu")
    assert st8.caches[0].k.dtype == torch.int8
    lf = _decode(model, cfg, toks, tm.init_decode_state(cfg, B, capacity=16,
                                                        device="cpu"))
    lq = _decode(model, cfg8, toks, st8)
    err = float(np.max(np.abs(lf - lq)) / max(np.max(np.abs(lf)), 1e-6))
    assert err < 0.05, err
    agree = float(np.mean(np.argmax(lf, -1) == np.argmax(lq, -1)))
    assert agree >= 0.9, agree

    step = jax.jit(lambda p, t, s: jm.decode_step(p, t, s, jcfg8))
    jst = jm.init_decode_state(jcfg8, B, capacity=16)
    jq = []
    for t in range(T):
        lg, jst = step(params, jnp.asarray(toks[:, t:t + 1]), jst)
        jq.append(np.asarray(lg))
    jq = np.concatenate(jq, axis=1)
    assert np.max(np.abs(lq - jq)) <= INT8_REL * np.max(np.abs(jq))


def test_int8_cache_memory_halves():
    cfg = smoke_config("gemma3-27b")
    cfg8 = cfg.scaled(kv_cache_dtype="int8")

    def cache_bytes(st):
        return sum(x.numel() * x.element_size() for c in st.caches
                   for x in c if x.ndim >= 3)

    st8 = tm.init_decode_state(cfg8, 2, capacity=64, device="cpu")
    st = tm.init_decode_state(cfg, 2, capacity=64, device="cpu")
    assert cache_bytes(st8) < 0.6 * cache_bytes(st)
    # at the full config's bf16 compute dtype, int8 is half of it exactly
    # in the k/v planes
    bf = cfg.scaled(dtype="bfloat16")
    kv = [c.k for c in tm.init_decode_state(bf, 2, 64, device="cpu").caches]
    kv8 = [c.k for c in st8.caches]
    assert (sum(x.numel() * x.element_size() for x in kv8) * 2
            == sum(x.numel() * x.element_size() for x in kv))


def test_reset_decode_slot_restores_one_row():
    cfg = smoke_config("jamba-1.5-large-398b").scaled(kv_cache_dtype="int8")
    model = tm.init_params(1, cfg, device="cpu")
    st = tm.init_decode_state(cfg, 3, capacity=8, device="cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                             (3, 4)).astype(np.int32)
    _decode(model, cfg, toks, st)
    before = [[x.clone() for x in c] for c in st.caches]
    tm.reset_decode_slot(cfg, st, 1, capacity=8)
    fresh = tm.init_decode_state(cfg, 3, capacity=8, device="cpu")
    assert st.pos.tolist() == [4, 0, 4]
    for c, b, f in zip(st.caches, before, fresh.caches):
        for x, xb, xf in zip(c, b, f):
            assert torch.equal(x[1], xf[1])
            assert torch.equal(x[[0, 2]], xb[[0, 2]])


# ------------------------------------------------------------- the CLI ---

@pytest.mark.parametrize("arch", ["gemma3-1b", "seamless-m4t-medium"])
def test_serve_cli_on_the_host(arch, capsys):
    serve_cli.main(["--arch", arch, "--smoke", "--batch", "2",
                    "--prompt-len", "8", "--gen", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"arch={arch} batch=2 prompt=8 gen=8" in out
    assert out.rstrip().endswith("serve OK")


def test_entry_points_raise_without_cuda(monkeypatch):
    """No silent fallback to the host: the card is the default device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke_config("gemma3-1b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tm.init_params(0, cfg)
    params = tm.init_params(0, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_cli.main(["--arch", "gemma3-1b", "--smoke"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tm.init_decode_state(cfg, 1, 8)
