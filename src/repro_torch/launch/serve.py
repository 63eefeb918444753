"""Serving driver: batched prefill-by-decode and greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
        --smoke --batch 4 --prompt-len 32 --gen 32 --device cpu

Runs on the card (``--device cuda``, the default) unless ``--device cpu``
is given. The weights, prompts and (enc-dec) frontend embeddings are drawn
from ``--seed`` on the device.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.device import resolve_device, synchronize
from repro_torch.models.model import encode, init_decode_state, init_params
from repro_torch.train.train_step import make_serve_step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(gen, cfg, device=dev)
    B = args.batch
    prompt = torch.randint(0, cfg.vocab_size, (B, args.prompt_len),
                           generator=gen, device=dev, dtype=torch.int32)
    memory = None
    if cfg.encoder_decoder:
        with torch.no_grad():
            memory = encode(params, torch.randn(
                (B, args.prompt_len, cfg.d_model), generator=gen, device=dev),
                cfg)

    serve = make_serve_step(cfg)
    state = init_decode_state(cfg, B, capacity=args.prompt_len + args.gen,
                              memory=memory, device=dev)

    # prefill by stepping the prompt through the decode path
    t0 = time.perf_counter()
    logits = None
    for t in range(args.prompt_len):
        logits, state = serve(params, prompt[:, t:t + 1], state)
    synchronize(dev)
    t_prefill = time.perf_counter() - t0

    # greedy decode
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    out_tokens = [tok]
    t0 = time.perf_counter()
    for _ in range(args.gen - 1):
        logits, state = serve(params, tok, state)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        out_tokens.append(tok)
    synchronize(dev)
    t_gen = time.perf_counter() - t0

    gen_ids = torch.cat(out_tokens, dim=1).cpu()
    tps = (args.gen - 1) * B / max(t_gen, 1e-9)
    print(f"arch={cfg.name} batch={B} prompt={args.prompt_len} "
          f"gen={args.gen}")
    print(f"prefill={t_prefill:.2f}s decode={t_gen:.2f}s "
          f"throughput={tps:.1f} tok/s")
    print("sample token ids:", [int(t) for t in gen_ids[0, :8]])
    if not (bool((gen_ids >= 0).all())
            and bool((gen_ids < cfg.vocab_size).all())):
        raise SystemExit("generated token ids out of range")
    print("serve OK")


if __name__ == "__main__":
    main()
