"""The port's training path against the reference's on the ten
architectures' ``smoke_config``s, from the same weights and batch (the
reference's ``init_params`` tree and ``TrainState`` carried across by
``interop.lm_params_from_numpy`` / ``train_state_from_numpy``): the loss,
its metrics and every gradient; one whole ``make_train_step``; the
Hessian-vector product of the curvature probe; the probe's Lanczos.

Bars (fp32 on both sides, two libraries' summation orders):
- loss and metrics within ``LOSS_REL`` = 1e-6 relative (measured <= 2e-7),
  ``ppl_proxy`` = exp(nll) within ``LOSS_REL`` * nll (exp turns nll's
  absolute error into its relative error), a zero aux loss within 1e-12;
- every gradient: max|dg| / max|g| <= ``GRAD_REL`` = 1e-4 per parameter
  (measured <= 1.5e-5, jamba's ``A_log``; 2e-3 is the forward's bar in
  ``test_torch_lm_arch.py``);
- after one AdamW step, ``grad_norm`` within ``NORM_REL`` = 1e-5 relative
  (a norm over every gradient entry, whose entries agree to ``GRAD_REL``
  of max|g|; measured <= 5.8e-7 here, 1.2e-6 card against host) and ``lr``
  within 1e-12; the moments within 2 * ``GRAD_REL`` of max|moment| per
  parameter; the parameters within ``PARAM_ABS`` = 1e-6 * max|p| + 1e-3
  lr wherever |g| > ``G_FLIP`` = 1e-3 * max|g| of that parameter, and
  within 2 lr (1 + 1e-5) everywhere: Adam's first step is lr * g / (|g| +
  eps) + lr * wd * p, ~lr * sign(g), so an entry whose gradient is near 0
  can land anywhere in +-lr, and one that flips sign moves by 2 lr;
- the Hessian-vector product within ``HVP_REL`` = 1e-4 of max|Hv|
  (measured <= 3.8e-6);
- Lanczos on one symmetric matrix from the same start: alpha and beta
  within 1e-5 of max|lambda|, Ritz values the same.
"""
import numpy as np
import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jm
from repro.train import loss as jloss
from repro.train import optimizer as jopt
from repro.train import spectral as jspectral
from repro.train import train_step as jtrain
from repro_torch import configs
from repro_torch.interop import (_reference_leaves, lm_params_from_numpy,
                                 port_flat_to_reference,
                                 reference_flat_to_port,
                                 train_state_from_numpy)
from repro_torch.models import model as tm
from repro_torch.train import spectral
from repro_torch.train.loss import ce_loss
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_step import make_loss_fn, make_train_step

LOSS_REL = 1e-6
NORM_REL = 1e-5
GRAD_REL = 1e-4
G_FLIP = 1e-3
HVP_REL = 1e-4
LANCZOS_REL = 1e-5
AUX_COEF = 1e-2
B, S = 2, 16
OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=20)
ARCHS = [pytest.param(a, marks=pytest.mark.slow)
         if a.startswith("jamba") else a for a in jconfigs.ARCH_IDS]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small eager ops: one intra-op thread is faster than a pool, and the
    test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_CACHE = {}


def _case(arch):
    """(jax cfg, port cfg, jax params, numpy tree, numpy batch)."""
    if arch not in _CACHE:
        jcfg = jconfigs.smoke_config(arch)
        cfg = configs.smoke_config(arch)
        params = jm.init_params(jax.random.PRNGKey(3), jcfg)
        rng = np.random.default_rng(4)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
                 "labels": rng.integers(0, cfg.vocab_size, (B, S))}
        batch = {k: v.astype(np.int32) for k, v in batch.items()}
        if cfg.encoder_decoder:
            batch["embeds"] = rng.standard_normal(
                (B, S, cfg.d_model)).astype(np.float32)
        _CACHE[arch] = (jcfg, cfg, params, jax.tree.map(np.asarray, params),
                        batch)
    return _CACHE[arch]


def _jax_loss_fn(jcfg, remat=True):
    """The reference's ``make_train_step`` loss_fn, verbatim."""

    def loss_fn(params, batch):
        memory = None
        if jcfg.encoder_decoder:
            memory = jm.encode(params, batch["embeds"], jcfg)
        logits, aux = jm.forward(params, batch["tokens"], jcfg,
                                 memory=memory, remat=remat)
        loss, metrics = jloss.ce_loss(logits, batch["labels"])
        loss = loss + AUX_COEF * aux
        metrics["moe_aux"] = aux
        return loss, metrics

    return loss_fn


_GRADS = {}


def _reference_grads(arch):
    """(loss, metrics, grads by port name) of ``jax.value_and_grad``."""
    if arch not in _GRADS:
        jcfg, cfg, params, _, batch = _case(arch)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            _jax_loss_fn(jcfg), has_aux=True))(params, jb)
        _GRADS[arch] = (float(loss), {k: float(v) for k, v in metrics.items()},
                        dict(_reference_leaves(jax.tree.map(np.asarray, grads),
                                               cfg)))
    return _GRADS[arch]


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel(got, want) -> float:
    return abs(float(got) - want) / max(abs(want), 1e-30)


def _metric_ok(k: str, got, want: float, nll: float) -> bool:
    if k == "ppl_proxy":
        return _rel(got, want) <= LOSS_REL * max(nll, 1.0)
    if k == "grad_norm":
        return _rel(got, want) <= NORM_REL
    return _rel(got, want) <= LOSS_REL or abs(float(got) - want) <= 1e-12


def _max_rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.max(np.abs(got - want))) / max(
        float(np.max(np.abs(want))), 1e-30)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_reference(arch):
    _, cfg, _, tree, batch = _case(arch)
    jl, jmetrics, jgrads = _reference_grads(arch)
    model = lm_params_from_numpy(tree, cfg, device="cpu")
    loss, metrics = make_loss_fn(cfg, AUX_COEF)(model, _torch_batch(batch))
    names, leaves = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    assert _rel(loss.detach(), jl) <= LOSS_REL, (float(loss), jl)
    assert sorted(metrics) == sorted(jmetrics)
    for k, want in jmetrics.items():
        assert _metric_ok(k, metrics[k].detach(), want, jmetrics["nll"]), (
            k, float(metrics[k]), want)
    assert sorted(grads) == sorted(jgrads)
    worst = max((_max_rel(grads[k].numpy(), g), k) for k, g in jgrads.items())
    assert worst[0] <= GRAD_REL, worst


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    jcfg, cfg, params, _, batch = _case(arch)
    oc = dict(OPT)
    jstate = jtrain.TrainState(params=params,
                               opt=jopt.init_opt_state(params),
                               step=jnp.zeros((), jnp.int32))
    host = jax.tree.map(np.asarray, jstate)
    jstate, jm_ = jax.jit(jtrain.make_train_step(
        jcfg, jopt.OptimizerConfig(**oc)))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state = train_state_from_numpy(host, cfg, device="cpu")
    state, metrics = make_train_step(cfg, OptimizerConfig(**oc))(
        state, _torch_batch(batch))

    assert int(state.step) == 1 and int(state.opt.count) == 1
    assert sorted(metrics) == sorted(jm_)
    for k in ("loss", "nll", "z_loss", "ppl_proxy", "moe_aux", "grad_norm"):
        assert _metric_ok(k, metrics[k], float(jm_[k]), float(jm_["nll"])), (
            k, float(metrics[k]), float(jm_[k]))
    lr = float(jm_["lr"])
    assert abs(float(metrics["lr"]) - lr) <= 1e-12 and lr > 0

    _, _, jgrads = _reference_grads(arch)
    new = jax.tree.map(np.asarray, jstate)
    ref_p = dict(_reference_leaves(new.params, cfg))
    ref_mu = dict(_reference_leaves(new.opt.mu, cfg))
    ref_nu = dict(_reference_leaves(new.opt.nu, cfg))
    for name, p in state.params.named_parameters():
        for got, want in ((state.opt.mu[name], ref_mu[name]),
                          (state.opt.nu[name], ref_nu[name])):
            assert _max_rel(got.numpy(), want) <= 2 * GRAD_REL, name
        dp = np.abs(p.detach().numpy() - ref_p[name])
        assert float(dp.max()) <= 2 * lr * (1 + 1e-5), name
        g = np.abs(jgrads[name])
        sure = g > G_FLIP * g.max()
        bar = 1e-6 * float(np.abs(ref_p[name]).max()) + 1e-3 * lr
        assert float(dp[sure].max(initial=0.0)) <= bar, name


def _probe_loss(cfg):
    """The trainer's probe loss (``launch/train.py``): ce_loss of the
    forward without remat."""

    def loss(params, b):
        logits, _ = tm.forward(params, b["tokens"], cfg, remat=False)
        return ce_loss(logits, b["labels"])[0]

    return loss


@pytest.mark.parametrize("arch", ["gemma3-1b", "xlstm-125m"])
def test_hvp_matches_reference(arch):
    """The probe's Hessian-vector product, on one dense and one recurrent
    config, against the reference's ``make_hvp`` on the same tangent (the
    flat vectors mapped between the two orders)."""
    jcfg, cfg, params, tree, batch = _case(arch)

    def jprobe(p, b):
        logits, _ = jm.forward(p, b["tokens"], jcfg, remat=False)
        return jloss.ce_loss(logits, b["labels"])[0]

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jhvp, dim = jspectral.make_hvp(jprobe, params, jb)
    v = np.random.default_rng(5).standard_normal(dim).astype(np.float32)
    want = np.asarray(jhvp(jnp.asarray(v)))

    model = lm_params_from_numpy(tree, cfg, device="cpu")
    hvp, tdim = spectral.make_hvp(_probe_loss(cfg), model,
                                  _torch_batch(batch))
    assert tdim == dim
    got = hvp(torch.from_numpy(reference_flat_to_port(v, tree, cfg)))
    got = port_flat_to_reference(got.numpy(), tree, cfg)
    assert _max_rel(got, want) <= HVP_REL


def test_flat_order_maps_the_reference_vector_onto_the_port():
    """``reference_flat_to_port`` of the reference's raveled params is the
    port's ``flat_params``, and ``port_flat_to_reference`` undoes it."""
    _, cfg, params, tree, _ = _case("jamba-1.5-large-398b")
    flat = np.asarray(ravel_pytree(params)[0])
    model = lm_params_from_numpy(tree, cfg, device="cpu")
    port = spectral.flat_params(model).numpy()
    np.testing.assert_array_equal(reference_flat_to_port(flat, tree, cfg),
                                  port)
    np.testing.assert_array_equal(port_flat_to_reference(port, tree, cfg),
                                  flat)


def test_lanczos_tridiag_matches_reference():
    """``_lanczos_tridiag`` on one symmetric matrix from the same start:
    alpha, beta and the Ritz values of the reference's."""
    rng = np.random.default_rng(6)
    n, m = 200, 12
    X = rng.standard_normal((n, n))
    A = ((X + X.T) / 2).astype(np.float32)
    v0 = rng.standard_normal(n).astype(np.float32)
    Aj = jnp.asarray(A)

    def jmatvec(v):
        return Aj @ v

    ja, jb = jspectral._lanczos_tridiag(jmatvec, jnp.asarray(v0), m)
    At = torch.from_numpy(A)
    a, b = spectral._lanczos_tridiag(lambda v: At @ v, torch.from_numpy(v0),
                                     m)
    scale = float(np.max(np.abs(np.linalg.eigvalsh(A.astype(np.float64)))))
    for got, want in ((a, ja), (b, jb)):
        assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) <= (
            LANCZOS_REL * scale)

    def ritz(al, be):
        al, be = np.asarray(al, np.float64), np.asarray(be, np.float64)
        T = np.diag(al) + np.diag(be[:m - 1], 1) + np.diag(be[:m - 1], -1)
        return np.linalg.eigvalsh(T)

    assert float(np.max(np.abs(ritz(a.numpy(), b.numpy()) - ritz(ja, jb)))) \
        <= LANCZOS_REL * scale
