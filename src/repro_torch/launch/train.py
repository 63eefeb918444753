"""End-to-end trainer: data pipeline -> train step -> checkpoints,
auto-resume, straggler monitoring, and paper-technique spectral probes.

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
        --smoke --steps 30 --batch 4 --seq 32 --device cpu

Runs on the card (``--device cuda``, the default) unless ``--device cpu``
is given. The weights are drawn from ``--seed`` on the device; the batches
come from the token pipeline seeded by ``--seed``, and encoder-decoder
frontend embeddings from a generator seeded by (seed, pipeline step).
With ``--ckpt-dir`` the trainer resumes from the newest checkpoint there
(the pipeline's cursor is in its ``extra``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.data.tokens import DataConfig, TokenPipeline
from repro_torch.device import resolve_device, synchronize
from repro_torch.dist import checkpoint as ckpt
from repro_torch.dist.straggler import StragglerMonitor
from repro_torch.models.model import forward
from repro_torch.train.loss import ce_loss
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.spectral import curvature_spectrum
from repro_torch.train.train_step import (init_train_state, load_state_tree,
                                          make_train_step, state_tree)


def embeds_seed(seed: int, step: int) -> int:
    """The seed of the encoder-decoder embeddings drawn at pipeline step
    ``step``: one 63-bit word of numpy's SeedSequence of (seed, step)."""
    word = np.random.SeedSequence((seed, step)).generate_state(
        1, dtype=np.uint64)[0]
    return int(word >> np.uint64(1))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--spectral-every", type=int, default=0,
                    help="Lanczos curvature probe period (0 = off)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    opt_cfg = OptimizerConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                              decay_steps=args.steps)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=args.seq,
                                    global_batch=args.batch,
                                    seed=args.seed))
    state = init_train_state(args.seed, cfg, device=dev)
    start_step = 0

    if args.ckpt_dir:
        restored = ckpt.load_latest(args.ckpt_dir, state_tree(state))
        if restored is not None:
            start_step, tree, extra = restored
            load_state_tree(state, tree)
            pipe.seek(extra.get("cursor", start_step))
            print(f"resumed from step {start_step}", flush=True)

    step_fn = make_train_step(cfg, opt_cfg)
    monitor = StragglerMonitor(n_hosts=1)

    def batch_to_dev(b):
        out = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        if cfg.encoder_decoder:
            gen = torch.Generator(device=dev).manual_seed(
                embeds_seed(args.seed, pipe.step))
            out["embeds"] = torch.randn(
                (args.batch, args.seq, cfg.d_model), generator=gen,
                dtype=torch.float32, device=dev)
        return out

    def probe_loss(params, b):
        logits, _ = forward(params, b["tokens"], cfg, remat=False)
        return ce_loss(logits, b["labels"])[0]

    losses = []
    for step in range(start_step, args.steps):
        t0 = time.perf_counter()
        batch = batch_to_dev(pipe.next_batch())
        state, metrics = step_fn(state, batch)
        synchronize(dev)
        dt = time.perf_counter() - t0
        monitor.record(0, dt)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step={step} loss={float(metrics['loss']):.4f} "
                  f"nll={float(metrics['nll']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e} dt={dt*1e3:.0f}ms",
                  flush=True)
        if args.spectral_every and step % args.spectral_every == 0:
            spec = curvature_spectrum(probe_loss, state.params, batch, m=16)
            print(f"  [spectral] sharpness={spec['sharpness']:.3e} "
                  f"lambda_min={spec['lambda_min']:.3e}", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, step + 1, state_tree(state),
                      extra={"cursor": pipe.step})
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps, state_tree(state),
                  extra={"cursor": pipe.step})
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(f"loss first10={first:.4f} last10={last:.4f} "
          f"improved={bool(last < first)}")
    slow = monitor.stragglers()
    if slow:
        plan = monitor.rebalance_plan(microbatches_per_host=1)
        print(f"stragglers={slow} rebalance_plan={plan}", flush=True)


if __name__ == "__main__":
    main()
