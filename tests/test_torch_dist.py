"""The mesh-free pieces of ``repro_torch.dist`` against ``repro.dist``, on
the CPU: checkpoints (and checkpoints each package reads from the other),
error-feedback compression, the straggler monitor, elastic remesh plans,
``lanczos_solve``'s ``callback=``, and the launcher at one rank.

The reference's own cases (``tests/test_dist.py:30-152``,
``tests/test_resilience.py:263, 278``) run on both packages with the same
inputs, drawn from numpy seeds; tolerances are stated per test.
"""
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.dist import checkpoint as j_ckpt
from repro.dist import compression as j_comp
from repro.dist.elastic import plan_remesh as j_plan_remesh
from repro.dist.straggler import StragglerMonitor as JMonitor
from repro_torch.dist import checkpoint as ckpt
from repro_torch.dist import compression as comp
from repro_torch.dist import launcher
from repro_torch.dist.elastic import plan_remesh
from repro_torch.dist.straggler import StragglerMonitor
from repro_torch.resilience.faults import slow_then_lost_trace


def _np_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((4, 8)),
            "nested": {"b": rng.standard_normal(3),
                       "step": np.asarray(7, np.int64)},
            "seq": [rng.standard_normal(2), (rng.standard_normal((2, 2)),)]}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_torch_tree(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jax.tree.map(lambda t: np.asarray(t), tree,
                     is_leaf=lambda t: isinstance(t, torch.Tensor)))]


def _dir_listing(path):
    return sorted(os.listdir(path))


# ------------------------------------------------------------ checkpoint --

def test_checkpoint_roundtrip(tmp_path):
    """test_dist.py:30 on the port: save, load_latest, same step, extra and
    values (exact); the files equal the reference's for the same tree."""
    t = _torch_tree(_np_tree(0))
    ckpt.save(str(tmp_path / "port"), 12, t, extra={"cursor": 34})
    step, restored, extra = ckpt.load_latest(str(tmp_path / "port"), t)
    assert step == 12 and extra["cursor"] == 34
    for a, b in zip(_leaves(t), _leaves(restored)):
        np.testing.assert_array_equal(a, b)
    j_ckpt.save(str(tmp_path / "ref"), 12, _jax_tree(_np_tree(0)),
                extra={"cursor": 34})
    mine = json.loads((tmp_path / "port" / "step_00000012" /
                       "manifest.json").read_text())
    theirs = json.loads((tmp_path / "ref" / "step_00000012" /
                         "manifest.json").read_text())
    assert mine == theirs
    for name in _dir_listing(tmp_path / "ref" / "step_00000012"):
        if name.endswith(".npy"):
            np.testing.assert_array_equal(
                np.load(tmp_path / "port" / "step_00000012" / name),
                np.load(tmp_path / "ref" / "step_00000012" / name))


def test_checkpoint_retention_and_latest(tmp_path):
    """test_dist.py:42: keep=3 over five saves, both packages alike."""
    t = _torch_tree(_np_tree(1))
    jt = _jax_tree(_np_tree(1))
    for s in [1, 2, 3, 4, 5]:
        ckpt.save(str(tmp_path / "port"), s, t, keep=3)
        j_ckpt.save(str(tmp_path / "ref"), s, jt, keep=3)
    assert ckpt.latest_step(str(tmp_path / "port")) == 5
    assert _dir_listing(tmp_path / "port") == _dir_listing(tmp_path / "ref")
    assert len([d for d in _dir_listing(tmp_path / "port")
                if d.startswith("step_")]) == 3


def test_checkpoint_skips_corrupt(tmp_path):
    """test_dist.py:51: a .tmp leftover and a directory without a manifest
    are skipped, by both packages."""
    ckpt.save(str(tmp_path), 1, _torch_tree(_np_tree(2)))
    os.makedirs(tmp_path / "step_00000002.tmp")
    os.makedirs(tmp_path / "step_00000003")
    assert ckpt.latest_step(str(tmp_path)) == 1
    assert j_ckpt.latest_step(str(tmp_path)) == 1
    assert ckpt.latest_step(str(tmp_path / "missing")) is None
    assert ckpt.load_latest(str(tmp_path / "missing"), {}) is None


def test_checkpoint_written_by_the_reference_loads_in_the_port(tmp_path):
    """Case (b): JAX save -> port load: same step, extra and values
    (exact), in the port template's dtype and structure."""
    tree = _np_tree(3)
    j_ckpt.save(str(tmp_path), 9, _jax_tree(tree),
                extra={"kind": "ke_dist", "j": 2, "n_matvec": 40})
    like = _torch_tree(tree)
    step, got, extra = ckpt.load_latest(str(tmp_path), like)
    assert step == 9 and extra == {"kind": "ke_dist", "j": 2, "n_matvec": 40}
    assert isinstance(got["seq"][1], tuple)
    assert got["nested"]["step"].dtype == torch.int64
    for a, b in zip(_leaves(like), _leaves(got)):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_written_by_the_port_loads_in_the_reference(tmp_path):
    """Case (b): port save -> JAX load: same step, extra and values."""
    tree = _np_tree(4)
    ckpt.save(str(tmp_path), 3, _torch_tree(tree),
              extra={"kind": "lanczos", "j": 20})
    step, got, extra = j_ckpt.load_latest(str(tmp_path), _jax_tree(tree))
    assert step == 3 and extra == {"kind": "lanczos", "j": 20}
    for a, b in zip(jax.tree_util.tree_leaves(_jax_tree(tree)),
                    jax.tree_util.tree_leaves(got)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_load_takes_the_template_dtype(tmp_path):
    """Each leaf comes back in the template leaf's dtype; a template with
    another leaf count raises; a bf16 leaf raises TypeError."""
    V = torch.randn(5, 3, dtype=torch.float64)
    ckpt.save(str(tmp_path), 0, {"V": V})
    _, got, _ = ckpt.load(str(tmp_path), 0,
                          {"V": torch.zeros(5, 3, dtype=torch.float32)})
    assert got["V"].dtype == torch.float32
    assert torch.equal(got["V"], V.float())
    with pytest.raises(ValueError, match="leaves"):
        ckpt.load(str(tmp_path), 0, {"V": V, "T": V})
    with pytest.raises(TypeError, match="bfloat16"):
        ckpt.save(str(tmp_path), 1, {"V": V.to(torch.bfloat16)})
    assert ckpt.latest_step(str(tmp_path)) == 0


def test_checkpoint_roundtrips_thick_restart_state(tmp_path):
    """test_resilience.py:263 on the port (exact)."""
    V = torch.from_numpy(np.random.default_rng(0).standard_normal((16, 6)))
    T = torch.from_numpy(np.random.default_rng(1).standard_normal((6, 6)))
    ckpt.save(str(tmp_path), 3, {"V": V, "T": T},
              extra={"kind": "ke_dist", "j": 2, "n_matvec": 40}, keep=2)
    ckpt.save(str(tmp_path), 4, {"V": V + 1.0, "T": T},
              extra={"kind": "ke_dist", "j": 3, "n_matvec": 50}, keep=2)
    like = {"V": torch.zeros_like(V), "T": torch.zeros_like(T)}
    step, tree, extra = ckpt.load_latest(str(tmp_path), like)
    assert step == 4 and extra["j"] == 3 and extra["n_matvec"] == 50
    assert torch.equal(tree["V"], V + 1.0) and torch.equal(tree["T"], T)


# ------------------------------------------------- lanczos callback= ------

def _lanczos_case():
    """test_dist.py:61's operator (JAX-built C) and the reference's default
    start block (PRNGKey(272727)), for both packages."""
    n = 64
    key = jax.random.PRNGKey(3)
    lam = jnp.sort(jax.random.normal(key, (n,), jnp.float64)) * 5
    Q, _ = jnp.linalg.qr(jax.random.normal(jax.random.fold_in(key, 1),
                                           (n, n), jnp.float64))
    C = 0.5 * ((Q * lam[None, :]) @ Q.T + ((Q * lam[None, :]) @ Q.T).T)
    v0 = jax.random.normal(jax.random.PRNGKey(272727), (n, 1), jnp.float64)
    return C, v0


def test_lanczos_checkpoint_resume(tmp_path):
    """test_dist.py:61 through the port's ``callback=``: the solve
    converges, the newest checkpoint has the reference's step, kind and
    j = m, and the wanted Ritz values of its T (the s smallest
    eigenvalues of T_m, converged) within 1e-10 of the reference's; the
    unconverged rest drift apart over the restarts by rounding."""
    from repro.core import ExplicitC as JExplicitC
    from repro.core import lanczos_solve as j_lanczos
    from repro_torch.core import ExplicitC, lanczos_solve
    C, v0 = _lanczos_case()
    n, s = C.shape[0], 4
    j_lanczos(JExplicitC(C), s, which="SA", v0=v0,
              callback=j_ckpt.lanczos_callback(str(tmp_path / "ref")))
    res = lanczos_solve(ExplicitC(torch.from_numpy(np.array(C))), s,
                        which="SA", v0=torch.from_numpy(np.array(v0)),
                        callback=ckpt.lanczos_callback(str(tmp_path / "port")))
    assert res.converged
    like = {"V": torch.zeros((n, 21), dtype=torch.float64),
            "T": torch.zeros((21, 21), dtype=torch.float64)}
    step, fact, extra = ckpt.load_latest(str(tmp_path / "port"), like)
    jstep, jfact, jextra = j_ckpt.load_latest(
        str(tmp_path / "ref"), {"V": jnp.zeros((n, 21)),
                                "T": jnp.zeros((21, 21))})
    assert extra == jextra == {"kind": "lanczos", "j": 20}
    assert step == jstep and fact["V"].shape[0] == n
    ev = np.linalg.eigvalsh(fact["T"].numpy()[:20, :20])
    jev = np.linalg.eigvalsh(np.asarray(jfact["T"], np.float64)[:20, :20])
    np.testing.assert_allclose(ev[:s], jev[:s], rtol=0, atol=1e-10)


def test_lanczos_callback_sees_the_segment_state():
    """The hook's call point is the reference's: after each restart's math,
    with the segment's (V, T) and m; at restart 0 both packages hand over
    the same basis and projected matrix (within 1e-12)."""
    from repro.core import ExplicitC as JExplicitC
    from repro.core import lanczos_solve as j_lanczos
    from repro_torch.core import ExplicitC, lanczos_solve
    C, v0 = _lanczos_case()
    seen, jseen = [], []
    res = lanczos_solve(
        ExplicitC(torch.from_numpy(np.array(C))), 4, which="SA",
        v0=torch.from_numpy(np.array(v0)),
        callback=lambda k, V, T, m: seen.append((k, V.clone(), T.clone(), m)))
    j_lanczos(JExplicitC(C), 4, which="SA", v0=v0,
              callback=lambda k, V, T, m: jseen.append(
                  (k, np.array(V), np.array(T), m)))
    assert [k for k, *_ in seen] == list(range(res.n_restart))
    k, V, T, m = seen[0]
    _, jV, jT, jm = jseen[0]
    assert m == jm == 20 and V.shape == (64, 21)
    # the segment's basis, not the restarted one: its residual block is set
    assert float(V[:, m:].abs().max()) > 0.1
    np.testing.assert_allclose(V.numpy(), jV, rtol=0, atol=1e-12)
    np.testing.assert_allclose(T.numpy(), jT, rtol=0, atol=1e-12)


# ----------------------------------------------------------- compression --

def _grads(seed):
    return {"w": np.random.default_rng(seed).standard_normal((64, 64))
            .astype(np.float32), "b": [np.linspace(-1, 1, 7,
                                                    dtype=np.float32)]}


def test_ef_compression_bounded_error():
    """test_dist.py:87 on the port; the int8 payload and the scales equal
    the reference's bit for bit, the error state within 1e-6."""
    g = _grads(4)
    tg = _torch_tree(g)
    q, s, ef = comp.compress_with_feedback(tg, comp.init_ef_state(tg))
    deq = comp.decompress(q, s)
    err = float((deq["w"] - tg["w"]).abs().max())
    assert err <= float(s["w"]) * 0.5 + 1e-6
    assert q["w"].dtype == torch.int8 and s["w"].dtype == torch.float32
    jg = _jax_tree(g)
    jq, js, jef = j_comp.compress_with_feedback(jg, j_comp.init_ef_state(jg))
    for k in ("w",):
        np.testing.assert_array_equal(q[k].numpy(), np.asarray(jq[k]))
        assert float(s[k]) == float(js[k])
        np.testing.assert_allclose(ef[k].numpy(), np.asarray(jef[k]),
                                   rtol=0, atol=1e-6)
    np.testing.assert_array_equal(q["b"][0].numpy(), np.asarray(jq["b"][0]))


def test_ef_accumulates_small_signals():
    """test_dist.py:100 on the port: after 100 rounds the 1e-4 signal got
    through to within one quantization step (and to within 1e-6 of the
    reference's total)."""
    g = np.full((8, 8), 1e-4, np.float32)
    g[0, 0] = 1.0
    tg = {"w": torch.from_numpy(g)}
    ef = comp.init_ef_state(tg)
    total = torch.zeros((8, 8))
    for _ in range(100):
        q, s, ef = comp.compress_with_feedback(tg, ef)
        total = total + comp.decompress(q, s)["w"]
    last_scale = float(s["w"])
    assert abs(float(total[1, 1]) - 100 * 1e-4) <= last_scale
    assert float(torch.round(tg["w"][1, 1] / last_scale)) == 0.0
    jg = {"w": jnp.asarray(g)}
    jef = j_comp.init_ef_state(jg)
    jtotal = jnp.zeros((8, 8), jnp.float32)
    for _ in range(100):
        jq, js, jef = j_comp.compress_with_feedback(jg, jef)
        jtotal = jtotal + j_comp.decompress(jq, js)["w"]
    np.testing.assert_allclose(total.numpy(), np.asarray(jtotal), rtol=0,
                               atol=1e-6)


# ------------------------------------------------- straggler and elastic --

def _feed(mon, times_by_step):
    for times in times_by_step:
        for h, t in enumerate(times):
            mon.record(h, t)


@pytest.mark.parametrize("n_hosts,slow,mb", [(8, 3, 4), (4, None, 2),
                                             (5, 0, 3)])
def test_straggler_detection_and_rebalance(n_hosts, slow, mb):
    """test_dist.py:117, 130: the same stragglers and plans as the
    reference (exact), totals preserved, the slow host shedding load."""
    steps = [[2.5 if h == slow else 1.0 for h in range(n_hosts)]] * 5
    mon, jmon = StragglerMonitor(n_hosts), JMonitor(n_hosts)
    _feed(mon, steps)
    _feed(jmon, steps)
    assert mon.stragglers() == jmon.stragglers() == (
        [] if slow is None else [slow])
    plan = mon.rebalance_plan(mb)
    assert plan == jmon.rebalance_plan(mb)
    assert sum(plan.values()) == n_hosts * mb
    if slow is not None:
        assert plan[slow] < mb


@pytest.mark.parametrize("n,mp,pods", [(512, 16, 2), (480, 16, 1),
                                       (500, 16, 1), (1, 1, 1), (7, 2, 1)])
def test_plan_remesh_keeps_tp(n, mp, pods):
    """test_dist.py:141: the plans equal the reference's field for field."""
    assert tuple(plan_remesh(n, mp, pods)) == tuple(j_plan_remesh(n, mp,
                                                                  pods))


def test_plan_remesh_rejects_impossible():
    with pytest.raises(ValueError):
        plan_remesh(8, model_parallel=16)
    with pytest.raises(ValueError):
        plan_remesh(8, model_parallel=0)


def test_straggler_and_elastic_compose_on_host_loss():
    """test_resilience.py:278 on the port: the slow-then-lost trace drives
    the monitor's rebalance while the host limps, then plan_remesh."""
    n_hosts, slow = 4, 2
    trace = slow_then_lost_trace(n_hosts=n_hosts, slow_host=slow)
    mon = StragglerMonitor(n_hosts)
    survivors = n_hosts
    for step in trace:
        if step["lost"]:
            survivors = n_hosts - len(step["lost"])
            break
        for h, t in enumerate(step["times"]):
            mon.record(h, t)
    assert mon.stragglers() == [slow]
    plan = mon.rebalance_plan(microbatches_per_host=6)
    assert sum(plan.values()) == n_hosts * 6
    assert plan[slow] < 6
    assert all(plan[h] >= 6 for h in range(n_hosts) if h != slow)
    rp = plan_remesh(survivors, 1)
    assert rp.new_shape == (survivors, 1)
    assert rp.n_used == survivors and rp.n_dropped == 0


# --------------------------------------------------------------- launcher --

def _one_rank(mesh, x):
    from repro_torch.dist.mesh import tiling
    tl = tiling(mesh)
    y = tl.all_reduce(x.clone(), tl.row_group)
    return (tuple(mesh.shape), tuple(mesh.mesh_dim_names), tl.R, tl.cm,
            tl.r, tl.c, y, dict(tl.counts))


def test_launcher_one_rank_runs_in_process():
    """One rank runs in this process on a 1 x 1 gloo mesh, its collectives
    count, and the process group is gone afterwards."""
    import torch.distributed as dist
    x = torch.arange(3, dtype=torch.float64)
    shape, names, R, cm, r, c, y, counts = launcher.run_local(
        _one_rank, (1, 1), "cpu", x)
    assert (shape, names, R, cm, r, c) == ((1, 1), ("data", "model"), 1, 1,
                                           0, 0)
    assert torch.equal(y, x) and counts == {"all_reduce": 1}
    assert not dist.is_initialized()


def test_launcher_refuses_more_ranks_than_cards():
    with pytest.raises(ValueError, match="cards"):
        launcher.run_local(_one_rank, (torch.cuda.device_count() + 1, 1),
                           "cuda", torch.zeros(1))


def test_make_mesh_needs_a_process_group():
    from repro_torch.dist import make_mesh
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh((1, 1), device_type="cpu")
