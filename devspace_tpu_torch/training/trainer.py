"""The causal-LM train step, the train loop and gradient accumulation.

Counterpart of ``devspace_tpu/training/trainer.py`` (the single-device
path: no mesh, no parameter sharding, no vocab-parallel loss; those wait
for the port of ``parallel/``). PyTorch runs eagerly, so there is no jit
and no buffer donation: the step updates the parameters in place through
a torch optimizer.

The optimizer is a factory ``params -> torch.optim.Optimizer``.
``adamw(lr)`` is optax's ``adamw(lr)``: optax defaults to b1 0.9, b2
0.999, eps 1e-8 and weight decay 1e-4, while ``torch.optim.AdamW``
defaults to weight decay 1e-2, so the factory passes every value
explicitly. The two apply the same update (decoupled decay of the
pre-update parameter, bias-corrected moments). ``adam(lr)`` is optax's
``adam(lr)``: the same moments and no weight decay.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import torch

from ..ops.losses import fused_cross_entropy

# optax.adamw's defaults (optax/_src/alias.py)
ADAMW_DEFAULTS = {"betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 1e-4}


def adamw(lr: float, **overrides) -> Callable:
    """``optax.adamw(lr)`` as a factory of ``torch.optim.AdamW``."""
    return partial(torch.optim.AdamW, lr=lr, **{**ADAMW_DEFAULTS, **overrides})


def adam(lr: float, **overrides) -> Callable:
    """``optax.adam(lr)`` as a factory of ``torch.optim.Adam``."""
    defaults = {"betas": ADAMW_DEFAULTS["betas"], "eps": ADAMW_DEFAULTS["eps"]}
    return partial(torch.optim.Adam, lr=lr, **{**defaults, **overrides})


def param_leaves(params: dict) -> list[torch.Tensor]:
    """The tensors of a param tree, in one fixed order (embed, each
    layer's entries, final_norm, lm_head)."""
    return ([params["embed"]]
            + [t for layer in params["layers"] for t in layer.values()]
            + [params["final_norm"], params["lm_head"]])


def tree_like(params: dict, leaves: list) -> dict:
    """The tree of ``params``' shape holding ``leaves`` (param_leaves order)."""
    it = iter(leaves)
    tree = {"embed": next(it)}
    tree["layers"] = [{name: next(it) for name in layer} for layer in params["layers"]]
    tree["final_norm"] = next(it)
    tree["lm_head"] = next(it)
    return tree


def init_train_state(params: dict, optimizer: Callable) -> dict:
    """``{"params", "opt_state": the torch optimizer over them, "step"}``."""
    return {"params": params, "opt_state": optimizer(param_leaves(params)), "step": 0}


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return fused_cross_entropy(logits, labels).mean()


def lm_loss(forward: Callable, cfg, attention_fn=None) -> Callable:
    """``loss_fn(params, tokens)``: next-token cross-entropy of
    ``tokens[:, :-1]`` against ``tokens[:, 1:]`` through the fused loss."""

    def loss_fn(params, tokens):
        logits = forward(params, tokens[:, :-1], cfg, attention_fn=attention_fn)
        b, t, v = logits.shape
        return cross_entropy_loss(logits.reshape(b * t, v), tokens[:, 1:].reshape(-1))

    return loss_fn


def make_lm_train_step(forward: Callable, cfg, optimizer: Callable, attention_fn=None):
    """Causal-LM train step ``step_fn(state, tokens) -> (state, loss)``.
    ``state`` comes from ``init_train_state``, whose ``"opt_state"`` is
    the torch optimizer over the param leaves; ``optimizer`` is unused
    and kept so the signature matches the JAX package's. After a step
    every param leaf's ``.grad`` holds that step's gradient."""
    loss_fn = lm_loss(forward, cfg, attention_fn)

    def step_fn(state, tokens):
        opt = state["opt_state"]
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(state["params"], tokens)
        loss.backward()
        opt.step()
        return {**state, "step": state["step"] + 1}, loss.detach()

    return step_fn


def train_loop(
    step_fn: Callable,
    state,
    batches,
    checkpoint_manager=None,
    start_step: int = 0,
    log_every: int = 0,
    logger=None,
):
    """Drive ``step_fn(state, batch) -> (state, loss)`` over an iterable of
    batches with optional periodic checkpointing (anything with
    ``maybe_save(step, state)``, and ``wait_until_finished()`` if it saves
    asynchronously) and logging. Returns ``(state, last_loss)``."""
    loss = None
    step = start_step
    try:
        for batch in batches:
            state, loss = step_fn(state, batch)
            step += 1
            if log_every and logger and step % log_every == 0:
                scalar = loss["loss"] if isinstance(loss, dict) else loss
                logger.info("[train] step %d loss %.4f", step, float(scalar))
            if checkpoint_manager is not None:
                checkpoint_manager.maybe_save(step, state)
    finally:
        # asynchronous saves must commit even when the step or the
        # iterator raises
        if checkpoint_manager is not None and hasattr(checkpoint_manager, "wait_until_finished"):
            checkpoint_manager.wait_until_finished()
    return state, loss


def accumulate_gradients(loss_fn: Callable, n_accum: int) -> Callable:
    """Gradient accumulation over microbatches. ``loss_fn(params, batch)``
    -> scalar; returns ``grad_fn(params, batches) -> (loss, grads)`` where
    ``batches`` has a leading dim of ``n_accum`` microbatches and both
    results are means over them (grads in the params' tree shape)."""

    def grad_fn(params, batches):
        leaves = param_leaves(params)
        acc_loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        acc = [torch.zeros_like(p) for p in leaves]
        for i in range(n_accum):
            loss = loss_fn(params, batches[i])
            grads = torch.autograd.grad(loss, leaves)
            acc_loss = acc_loss + loss.detach() / n_accum
            acc = [a + g / n_accum for a, g in zip(acc, grads)]
        return acc_loss, tree_like(params, acc)

    return grad_fn
