"""The port's training substrate against the reference's: the token
pipeline (bitwise), ``ce_loss``, the schedule and ``adamw_update`` on the
same inputs; the port's own copies of the reference's seven behaviour
tests (``tests/test_train_and_data.py``); ``remat`` changing no bit; the
training CLI.

Bars: ``ce_loss`` and its metrics within 1e-6 relative, ``ppl_proxy`` =
exp(nll) within 1e-6 * nll (exp turns nll's absolute error into its
relative error); the schedule
within 1e-7 absolute at every step of 0..decay_steps; ``adamw_update``'s
parameters, moments and metrics within 1e-6 of max|x| per array (both
sides f32; the same operations in the same order, two libraries'
elementwise kernels and one global-norm sum order).
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.data import tokens as jtokens
from repro.train import loss as jloss
from repro.train import optimizer as jopt
from repro_torch import configs
from repro_torch.data.tokens import DataConfig, TokenPipeline
from repro_torch.dist import checkpoint as ckpt
from repro_torch.launch import train as train_cli
from repro_torch.models import model as tm
from repro_torch.train.loss import ce_loss
from repro_torch.train.optimizer import (AdamWState, OptimizerConfig,
                                         adamw_update, init_opt_state,
                                         lr_schedule)
from repro_torch.train.spectral import curvature_spectrum
from repro_torch.train.train_step import (init_train_state, load_state_tree,
                                          make_loss_fn, make_train_step,
                                          state_tree)

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small eager ops: one intra-op thread is faster than a pool, and the
    test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _max_rel(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    return float(np.max(np.abs(got - want))) / max(
        float(np.max(np.abs(want))), 1e-30)


def _batch(b: dict, device="cpu") -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


# ------------------------------------------------ against the reference ---

@pytest.mark.parametrize("seed", [0, 1234, 7])
def test_pipeline_bitwise_reference(seed):
    """Every batch of 2 hosts at steps 0..4, and after a seek, equal to the
    reference's bit for bit, dtypes included."""
    for vocab, seq in ((128, 16), (5000, 9)):
        kw = dict(vocab_size=vocab, seq_len=seq, global_batch=4, seed=seed)
        for host in (0, 1):
            mine = TokenPipeline(DataConfig(**kw), host_id=host, n_hosts=2)
            ref = jtokens.TokenPipeline(jtokens.DataConfig(**kw),
                                        host_id=host, n_hosts=2)
            for _ in range(5):
                a, b = mine.next_batch(), ref.next_batch()
                for k in ("tokens", "labels"):
                    assert a[k].dtype == b[k].dtype
                    np.testing.assert_array_equal(a[k], b[k])
            mine.seek(2)
            ref.seek(2)
            assert mine.step == ref.step == 2
            a, b = mine.next_batch(), ref.next_batch()
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(a[k], b[k])


def test_ce_loss_matches_reference():
    rng = np.random.default_rng(0)
    logits = (4 * rng.standard_normal((3, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    jl, jm = jloss.ce_loss(jnp.asarray(logits), jnp.asarray(labels))
    loss, metrics = ce_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    assert loss.dtype == torch.float32
    assert _max_rel(loss, jl) <= REL
    assert sorted(metrics) == sorted(jm)
    for k in jm:
        assert metrics[k].dtype == torch.float32
        bar = REL * float(jm["nll"]) if k == "ppl_proxy" else REL
        assert _max_rel(metrics[k], jm[k]) <= bar, k


def test_lr_schedule_matches_reference():
    oc = dict(lr=3e-4, warmup_steps=7, decay_steps=60, min_lr_ratio=0.1)
    for s in range(0, 61):
        want = float(jopt.lr_schedule(jnp.asarray(s, jnp.int32),
                                      jopt.OptimizerConfig(**oc)))
        got = lr_schedule(torch.tensor(s, dtype=torch.int32),
                          OptimizerConfig(**oc))
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-7, s


@pytest.mark.parametrize("count", [0, 3])
@pytest.mark.parametrize("gscale", [0.1, 30.0])
def test_adamw_update_matches_reference(count, gscale):
    """Same grads, state and params (gscale 30 triggers the clip)."""
    rng = np.random.default_rng(count + int(gscale))
    shapes = {"a.w": (5, 3), "b": (4,), "c.g": (2, 2, 3)}
    p = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    g = {k: (gscale * rng.standard_normal(s)).astype(np.float32)
         for k, s in shapes.items()}
    mu = {k: (0.1 * rng.standard_normal(s)).astype(np.float32)
          for k, s in shapes.items()}
    nu = {k: (0.01 * rng.random(s)).astype(np.float32)
          for k, s in shapes.items()}
    oc = dict(lr=1e-2, warmup_steps=2, decay_steps=10)
    jstate = jopt.AdamWState(mu={k: jnp.asarray(v) for k, v in mu.items()},
                             nu={k: jnp.asarray(v) for k, v in nu.items()},
                             count=jnp.asarray(count, jnp.int32))
    jp, jst, jm = jopt.adamw_update(
        {k: jnp.asarray(v) for k, v in g.items()}, jstate,
        {k: jnp.asarray(v) for k, v in p.items()},
        jopt.OptimizerConfig(**oc))

    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    tg = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
    st = AdamWState(mu={k: torch.from_numpy(v.copy()) for k, v in mu.items()},
                    nu={k: torch.from_numpy(v.copy()) for k, v in nu.items()},
                    count=torch.tensor(count, dtype=torch.int32))
    newp, st, m = adamw_update(tg, st, tp, OptimizerConfig(**oc))
    assert int(st.count) == count + 1 == int(jst.count)
    for k in shapes:
        np.testing.assert_array_equal(tg[k].numpy(), g[k])   # grads intact
        assert _max_rel(newp[k], jp[k]) <= REL, k
        assert _max_rel(st.mu[k], jst.mu[k]) <= REL, k
        assert _max_rel(st.nu[k], jst.nu[k]) <= REL, k
    for k in ("grad_norm", "lr"):
        assert _max_rel(m[k], jm[k]) <= REL, k


# ------------------------------- the reference's behaviour tests, ported ---

def test_pipeline_deterministic_and_seekable():
    cfg = DataConfig(vocab_size=128, seq_len=16, global_batch=4)
    p1 = TokenPipeline(cfg)
    batches = [p1.next_batch() for _ in range(5)]
    p2 = TokenPipeline(cfg)
    p2.seek(3)
    b3 = p2.next_batch()
    np.testing.assert_array_equal(b3["tokens"], batches[3]["tokens"])
    np.testing.assert_array_equal(b3["labels"], batches[3]["labels"])


def test_pipeline_host_sharding_disjoint():
    cfg = DataConfig(vocab_size=128, seq_len=16, global_batch=8)
    h0 = TokenPipeline(cfg, host_id=0, n_hosts=2).next_batch()
    h1 = TokenPipeline(cfg, host_id=1, n_hosts=2).next_batch()
    assert h0["tokens"].shape == (4, 16)
    assert not np.array_equal(h0["tokens"], h1["tokens"])
    with pytest.raises(ValueError):
        TokenPipeline(DataConfig(vocab_size=128, seq_len=16,
                                 global_batch=5), n_hosts=2)


def test_lr_schedule_shape():
    oc = OptimizerConfig(lr=1e-3, warmup_steps=10, decay_steps=100)
    lrs = [float(lr_schedule(torch.tensor(s), oc)) for s in range(0, 101, 10)]
    assert lrs[0] == 0.0
    assert abs(lrs[1] - 1e-3) < 1e-9          # end of warmup
    assert lrs[-1] <= lrs[1]
    assert lrs[-1] >= 1e-4 * 0.999            # min_lr floor


def test_adamw_moves_toward_gradient():
    params = {"w": torch.ones((4,))}
    grads = {"w": torch.tensor([1.0, -1.0, 0.0, 2.0])}
    st = init_opt_state(params)
    oc = OptimizerConfig(lr=0.1, warmup_steps=0, decay_steps=10,
                         weight_decay=0.0)
    before = params["w"].clone()
    new, st, m = adamw_update(grads, st, params, oc)
    delta = (new["w"] - before).numpy()
    assert delta[0] < 0 and delta[1] > 0 and delta[3] < 0
    assert m["grad_norm"] > 0


def test_loss_decreases_short_run():
    cfg = configs.smoke_config("xlstm-125m")
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                    global_batch=4))
    state = init_train_state(0, cfg, device="cpu")
    oc = OptimizerConfig(lr=3e-3, warmup_steps=3, decay_steps=40)
    step_fn = make_train_step(cfg, oc)
    losses = []
    for _ in range(30):
        state, metrics = step_fn(state, _batch(pipe.next_batch()))
        losses.append(float(metrics["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses


def test_checkpoint_resume_bitexact(tmp_path):
    """Stop at step 5, resume, and land on identical params at step 8."""
    cfg = configs.smoke_config("gemma3-1b")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2)
    oc = OptimizerConfig(lr=1e-3, warmup_steps=2, decay_steps=20)
    step_fn = make_train_step(cfg, oc)

    def run(state, pipe, n):
        for _ in range(n):
            state, _ = step_fn(state, _batch(pipe.next_batch()))
        return state

    pipe = TokenPipeline(dcfg)
    state = run(init_train_state(1, cfg, device="cpu"), pipe, 5)
    ckpt.save(str(tmp_path), 5, state_tree(state),
              extra={"cursor": pipe.step})
    ref = run(state, pipe, 3)  # continue to step 8 directly

    like = init_train_state(1, cfg, device="cpu")
    step, tree, extra = ckpt.load_latest(str(tmp_path), state_tree(like))
    assert step == 5 and int(tree["step"]) == 5
    resumed = load_state_tree(like, tree)
    pipe2 = TokenPipeline(dcfg)
    pipe2.seek(extra["cursor"])
    resumed = run(resumed, pipe2, 3)
    for (name, a), b in zip(ref.params.named_parameters(),
                            resumed.params.parameters()):
        assert torch.equal(a, b), name
    for k in ref.opt.mu:
        assert torch.equal(ref.opt.mu[k], resumed.opt.mu[k])
        assert torch.equal(ref.opt.nu[k], resumed.opt.nu[k])
    assert int(resumed.step) == int(ref.step) == 8


def test_spectral_probe_finite_and_symmetric_psd_at_minimum():
    cfg = configs.smoke_config("xlstm-125m").scaled(
        n_layers=4, d_model=32, vocab_size=64, head_dim=8)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=8,
                                    global_batch=2))
    state = init_train_state(2, cfg, device="cpu")
    batch = _batch(pipe.next_batch())

    def probe_loss(params, b):
        logits, _ = tm.forward(params, b["tokens"], cfg, remat=False)
        return ce_loss(logits, b["labels"])[0]

    spec = curvature_spectrum(probe_loss, state.params, batch, m=8)
    assert np.isfinite(spec["sharpness"]) and np.isfinite(spec["lambda_min"])
    assert spec["sharpness"] >= spec["lambda_min"]
    assert spec["dim"] > 1000


# ------------------------------------------------------------- the port ---

@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_remat_changes_no_bit(arch):
    """The loss, metrics and every gradient with ``remat=True`` equal the
    ones without, bit for bit."""
    cfg = configs.smoke_config(arch)
    model = tm.init_params(0, cfg, device="cpu")
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 12)),
             "labels": rng.integers(0, cfg.vocab_size, (2, 12))}
    if cfg.encoder_decoder:
        batch["embeds"] = rng.standard_normal((2, 12, cfg.d_model)).astype(
            np.float32)
    batch = _batch(batch)
    leaves = list(model.parameters())
    out = {}
    for remat in (False, True):
        loss, metrics = make_loss_fn(cfg, remat=remat)(model, batch)
        out[remat] = (loss, metrics, torch.autograd.grad(loss, leaves))
    (l0, m0, g0), (l1, m1, g1) = out[False], out[True]
    assert torch.equal(l0, l1)
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_train_state_tree_holds_no_bf16_leaf():
    """The checkpointed tree: parameters by name, mu, nu, count, step; the
    bf16-compute config keeps f32 masters, so ``save`` takes it."""
    cfg = configs.smoke_config("gemma3-1b").scaled(dtype="bfloat16")
    tree = state_tree(init_train_state(0, cfg, device="cpu"))
    assert sorted(tree) == ["count", "mu", "nu", "params", "step"]
    assert sorted(tree["mu"]) == sorted(tree["params"])
    assert all(t.dtype == torch.float32 for k in ("params", "mu", "nu")
               for t in tree[k].values())


def test_cli_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--arch", "xlstm-125m", "--smoke", "--steps", "1"])


def test_embeds_seed_is_a_function_of_seed_and_step():
    seeds = {train_cli.embeds_seed(s, t) for s in (0, 1) for t in (0, 1, 2)}
    assert len(seeds) == 6
    assert train_cli.embeds_seed(3, 4) == train_cli.embeds_seed(3, 4)
    assert all(0 <= s < 2 ** 63 for s in seeds)


def _cli(args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        capture_output=True, text=True, env=env, cwd=str(ROOT),
        timeout=timeout)


def test_cli_trains_probes_checkpoints_and_resumes(tmp_path):
    common = ["--arch", "xlstm-125m", "--smoke", "--batch", "2", "--seq",
              "16", "--device", "cpu", "--ckpt-dir", str(tmp_path),
              "--ckpt-every", "3", "--log-every", "2"]
    out = _cli(common + ["--steps", "6", "--spectral-every", "5"])
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert re.fullmatch(r"loss first10=\S+ last10=\S+ improved=(True|False)",
                        lines[-1]), lines[-1]
    probes = [re.search(r"sharpness=(\S+) lambda_min=(\S+)", ln)
              for ln in lines if "[spectral]" in ln]
    assert len(probes) == 2                    # steps 0 and 5
    for m in probes:
        top, low = float(m.group(1)), float(m.group(2))
        assert np.isfinite(top) and np.isfinite(low) and top >= low
    assert sum(ln.startswith("step=") for ln in lines) == 4   # 0, 2, 4, 5
    assert ckpt.latest_step(str(tmp_path)) == 6

    again = _cli(common + ["--steps", "8"])
    assert again.returncode == 0, again.stderr[-2000:]
    assert "resumed from step 6" in again.stdout
    assert ckpt.latest_step(str(tmp_path)) == 8
