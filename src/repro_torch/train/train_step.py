"""The step factories of the LM stack: the train step the trainer runs, and
the one-token decode step and the bulk prefill the serving engine and the
serving CLI call."""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (LM, DecodeState, decode_step, encode,
                                      forward, init_params)
from .loss import ce_loss
from .optimizer import (AdamWState, OptimizerConfig, adamw_update,
                        init_opt_state)


class TrainState(NamedTuple):
    params: LM
    opt: AdamWState
    step: torch.Tensor           # () int32


def init_train_state(key: Union[int, torch.Generator], cfg: ModelConfig,
                     device=None) -> TrainState:
    """Fresh master weights drawn from ``key`` on ``device`` (the card
    unless ``device="cpu"``), zero moments, count and step 0."""
    params = init_params(key, cfg, device=device)
    opt = init_opt_state(params)
    return TrainState(params=params, opt=opt,
                      step=torch.zeros((), dtype=torch.int32,
                                       device=opt.count.device))


def make_loss_fn(cfg: ModelConfig, aux_coef: float = 1e-2,
                 remat: bool = True):
    """Returns loss_fn(params, batch) -> (loss, metrics): the reference's
    ``ce_loss`` of ``forward`` plus ``aux_coef`` times the MoE aux loss;
    encoder-decoder configs encode ``batch["embeds"]`` first."""

    def loss_fn(params: LM, batch: dict):
        memory = None
        if cfg.encoder_decoder:
            memory = encode(params, batch["embeds"], cfg)
        logits, aux = forward(params, batch["tokens"], cfg, memory=memory,
                              remat=remat)
        loss, metrics = ce_loss(logits, batch["labels"])
        loss = loss + aux_coef * aux
        metrics["moe_aux"] = aux
        return loss, metrics

    return loss_fn


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                    aux_coef: float = 1e-2, remat: bool = True):
    """Returns train_step(state, batch) -> (state, metrics).

    batch = {"tokens": (B, S) int, "labels": (B, S) int} on the state's
    device (+ "embeds" (B, S_enc, D) for encoder-decoder memory). The
    gradients come from ``torch.autograd``; the step writes the new
    parameters, moments, count and step into ``state`` in place and
    returns it, with the reference's metrics (``nll``, ``z_loss``,
    ``ppl_proxy``, ``moe_aux``, ``loss``, ``grad_norm``, ``lr``) as
    detached tensors.
    """
    loss_fn = make_loss_fn(cfg, aux_coef, remat)

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        names, leaves = zip(*state.params.named_parameters())
        loss, metrics = loss_fn(state.params, batch)
        grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
        _, _, opt_metrics = adamw_update(grads, state.opt, state.params,
                                         opt_cfg)
        del grads
        with torch.no_grad():
            state.step.add_(1)
        metrics = {k: v.detach() for k, v in
                   dict(metrics, loss=loss, **opt_metrics).items()}
        return state, metrics

    return train_step


def make_serve_step(cfg: ModelConfig):
    """Returns serve_step(params, tokens (B,1), state) -> (logits, state) —
    the one-new-token decode."""

    def serve_step(params, tokens, state: DecodeState):
        return decode_step(params, tokens, state, cfg)

    return serve_step


def make_prefill(cfg: ModelConfig):
    @torch.no_grad()
    def prefill(params, tokens, embeds: Optional[torch.Tensor] = None):
        memory = None
        if cfg.encoder_decoder:
            memory = encode(params, embeds, cfg)
        logits, _ = forward(params, tokens, cfg, memory=memory)
        return logits

    return prefill


def state_tree(state: TrainState) -> dict:
    """The state as the tree of tensors ``dist.checkpoint`` saves: the
    parameters by name, ``mu``, ``nu``, ``count`` and ``step`` (the f32
    masters hold no bfloat16 leaf, which ``checkpoint.save`` refuses)."""
    return {"params": dict(state.params.named_parameters()),
            "mu": state.opt.mu, "nu": state.opt.nu,
            "count": state.opt.count, "step": state.step}


@torch.no_grad()
def load_state_tree(state: TrainState, tree: dict) -> TrainState:
    """Copy ``tree`` (as ``state_tree`` lays it out, e.g. from
    ``checkpoint.load_latest``) into ``state`` in place; returns it."""
    mine = state_tree(state)
    for key in ("params", "mu", "nu"):
        for name, t in mine[key].items():
            t.copy_(tree[key][name])
    for key in ("count", "step"):
        mine[key].copy_(tree[key])
    return state
