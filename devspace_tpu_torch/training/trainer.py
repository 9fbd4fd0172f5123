"""The train steps (classifier, causal LM, MoE LM), the train loop and
gradient accumulation.

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
``adam(lr)``: the same moments and no weight decay. ``sgd(lr, momentum)``
is ``optax.sgd(lr, momentum=momentum)``: ``t = g + momentum * t; p -= lr
* t``, which is ``torch.optim.SGD`` with ``dampening=0`` (its first step
sets ``t = g``, as optax's zero-initialised trace gives).

A param tree is any nesting of dicts and lists with tensors at the
leaves (the LM's ``layers[i]``, the MoE's ``layers[i]["moe"]``), or a
``torch.nn.Module`` (the vision models), whose parameters are its leaves.
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


def sgd(lr: float, momentum: float = 0.9) -> Callable:
    """``optax.sgd(lr, momentum=momentum)`` as a factory of
    ``torch.optim.SGD`` (no dampening, no Nesterov)."""
    return partial(torch.optim.SGD, lr=lr, momentum=momentum, dampening=0.0, nesterov=False)


def param_leaves(params) -> list:
    """The leaves of a param tree, depth first: a dict's children by
    sorted key (as ``jax.tree.leaves`` lists them, so two trees with the
    same keys list their leaves alike whatever order the dicts were built
    in), a list's in order; a module's ``parameters()``."""
    if isinstance(params, torch.nn.Module):
        return list(params.parameters())
    if isinstance(params, dict):
        return [t for name in sorted(params) for t in param_leaves(params[name])]
    if isinstance(params, (list, tuple)):
        return [t for node in params for t in param_leaves(node)]
    return [params]


def tree_like(params, leaves: list):
    """The tree of ``params``' shape holding ``leaves`` (param_leaves
    order); dicts and lists are new, ``params`` is left as it is."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {name: build(node[name]) for name in sorted(node)}
            return {name: built[name] for name in node}  # node's own key order
        if isinstance(node, (list, tuple)):
            return type(node)(build(child) for child in node)
        return next(it)

    tree = build(params)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return tree


def init_train_state(params, optimizer: Callable) -> dict:
    """``{"params", "opt_state": the torch optimizer over them, "step"}``.
    ``params`` is a param tree or a module (the classifiers')."""
    return {"params": params, "opt_state": optimizer(param_leaves(params)), "step": 0}


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return fused_cross_entropy(logits, labels).mean()


def _apply_step(state: dict, loss_fn: Callable, *args):
    """Zero the grads, ``loss_fn(*args) -> (loss, aux)``, backward, the
    optimizer's step; returns ``(state with step + 1, loss, aux)``."""
    opt = state["opt_state"]
    opt.zero_grad(set_to_none=True)
    loss, aux = loss_fn(*args)
    loss.backward()
    opt.step()
    return {**state, "step": state["step"] + 1}, loss.detach(), aux


def make_classifier_train_step(model: torch.nn.Module, optimizer: Callable = None,
                               has_batch_stats: bool = False) -> Callable:
    """Train step for the port's classifier modules (MLP, ResNet, ViT):
    ``step_fn(state, {"image", "label"}) -> (state, loss)``, the mean
    fused cross-entropy of ``model(image, train=True)``. ``state`` is
    ``init_train_state(model, optimizer)``; ``optimizer`` is unused and
    kept so the signature matches the JAX package's.

    ``has_batch_stats``: the model keeps BatchNorm running statistics
    (its buffers), which each step updates in place, as the reference's
    ``mutable=["batch_stats"]`` returns them. It must say what the model
    holds: a model with buffers and ``False``, or none and ``True``,
    raises ``ValueError``, where the reference's apply would fail."""
    if has_batch_stats != any(True for _ in model.buffers()):
        raise ValueError(f"has_batch_stats={has_batch_stats} but the model "
                         f"{'has' if not has_batch_stats else 'has no'} running statistics")

    def loss_fn(images, labels):
        return cross_entropy_loss(model(images, train=True), labels), None

    def step_fn(state, batch):
        state, loss, _ = _apply_step(state, loss_fn, batch["image"], batch["label"])
        return state, loss

    return step_fn


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
        state, loss, _ = _apply_step(state, lambda: (loss_fn(state["params"], tokens), None))
        return state, loss

    return step_fn


def make_moe_lm_train_step(forward: Callable, cfg, optimizer: Callable = None,
                           attention_fn=None, moe_fn=None):
    """Causal-LM train step for the MoE transformer (``models.moe``):
    ``step_fn(state, tokens) -> (state, {"loss", "ce", "aux"})`` with
    ``loss = ce + cfg.aux_weight * aux``, the next-token cross-entropy
    through the fused loss and the mean load-balancing loss over layers.
    ``moe_fn`` replaces the dense routing (``expert_parallel.moe_ffn``
    waits for the port of ``parallel/``); ``optimizer`` is unused, as in
    ``make_lm_train_step``."""

    def loss_fn(params, tokens):
        logits, aux = forward(params, tokens[:, :-1], cfg, attention_fn=attention_fn,
                              moe_fn=moe_fn)
        b, t, v = logits.shape
        ce = cross_entropy_loss(logits.reshape(b * t, v), tokens[:, 1:].reshape(-1))
        return ce + cfg.aux_weight * aux, (ce.detach(), aux.detach())

    def step_fn(state, tokens):
        state, loss, (ce, aux) = _apply_step(state, loss_fn, state["params"], tokens)
        return state, {"loss": loss, "ce": ce, "aux": aux}

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
