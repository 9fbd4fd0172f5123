"""The train steps (classifier, causal LM, MoE LM), the train loop and
gradient accumulation.

Counterpart of ``devspace_tpu/training/trainer.py``. PyTorch runs
eagerly, so there is no jit and no buffer donation: the step updates
the parameters in place through a torch optimizer.

The mesh path (``mesh=``) is explicit SPMD over ``torch.distributed``
(``parallel/``): each process is one rank, ``state["params"]`` holds
its shards (``parallel.mesh.shard_tree`` by ``param_spec``) and the
step takes its rows of the batch (``parallel.data_parallel.shard_batch``
along ``data_axis``). Every rank backpropagates its share of the global
mean loss; then each gradient is summed over the axes along which the
ranks saw different tokens (``data_axis`` and, under a sequence-parallel
``attention_fn``, its ``seq_axis``) unless the leaf is sharded along
that axis; a leaf sharded over the model axis is complete on its rank
(the f/g hooks, ``parallel/tensor_parallel.py``). The optimizer then
steps each rank's shards. The loss returned is the global mean.

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

import math
from functools import partial
from typing import Callable, Optional

import torch

from ..models.layers import BatchNorm
from ..models.transformer import shard_config
from ..ops.losses import fused_cross_entropy, vocab_parallel_cross_entropy
from ..parallel.collectives import all_gather_split_bwd, all_reduce_
from ..parallel.data_parallel import reduce_gradients
from ..parallel.mesh import P, PartitionSpec, spec_axes, spec_leaves
from ..parallel.mesh import opt_state_partition_spec  # noqa: F401  (the reference's trainer has it)
from ..parallel.tensor_parallel import block_hooks

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
    order); dicts and lists are new, ``params`` is left as it is. For a
    module: ``{name: leaf}`` in ``named_parameters()`` order."""
    if isinstance(params, torch.nn.Module):
        names = [name for name, _ in params.named_parameters()]
        if len(names) != len(leaves):
            raise ValueError(f"{len(leaves)} leaves for a module of {len(names)} parameters")
        return dict(zip(names, leaves))
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


def _apply_step(state: dict, loss_fn: Callable, *args, reduce: Callable = None):
    """Zero the grads, ``loss_fn(*args) -> (loss, aux)``, backward,
    ``reduce(params)`` (the mesh path's gradient all-reduces), the
    optimizer's step; returns ``(state with step + 1, loss, aux)``."""
    opt = state["opt_state"]
    opt.zero_grad(set_to_none=True)
    loss, aux = loss_fn(*args)
    loss.backward()
    if reduce is not None:
        reduce(state["params"])
    opt.step()
    return {**state, "step": state["step"] + 1}, loss.detach(), aux


# -- the mesh path ----------------------------------------------------------
def _tree_specs(spec) -> list:
    """Every ``PartitionSpec`` of a spec tree."""
    if spec is None:
        return []
    if isinstance(spec, PartitionSpec):
        return [spec]
    children = spec.values() if isinstance(spec, dict) else spec
    return [s for child in children for s in _tree_specs(child)]


class _MeshPlan:
    """What a mesh step derives from its arguments: the axes the
    gradients are summed over, the model axis and its per-shard config
    and hooks, the sequence axis, and how a local loss sum becomes the
    global mean."""

    def __init__(self, mesh, data_axis: str, param_spec, attention_fn=None, cfg=None):
        self.mesh, self.data_axis, self.param_spec = mesh, data_axis, param_spec
        mesh.size(data_axis)  # raises for an axis the mesh lacks
        self.seq_axis = getattr(attention_fn, "seq_axis", None)
        model_axes = {a for s in _tree_specs(param_spec) for a in spec_axes(s)}
        model_axes -= {data_axis}
        if len(model_axes) > 1:
            raise ValueError(f"param_spec shards over {sorted(model_axes)}: one model axis "
                             f"besides {data_axis!r}")
        self.model_axis = next(iter(model_axes), None)
        if self.model_axis is not None and self.model_axis == self.seq_axis:
            raise ValueError(f"axis {self.seq_axis!r} shards both the sequence and the params")
        self.cfg, self.hooks = cfg, {}
        if self.model_axis is not None and cfg is not None:
            self.cfg = shard_config(cfg, mesh.size(self.model_axis))
            self.hooks = block_hooks(mesh, self.model_axis)
        self.reduce_axes = (data_axis,) + ((self.seq_axis,) if self.seq_axis else ())

    def sequence_shard(self, tokens: torch.Tensor):
        """The next-token pairs of this rank's rows, shifted first and then
        cut to this rank's sequence block -> (inputs, labels, global
        positions or None)."""
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        if self.seq_axis is None:
            return inputs, labels, None
        n, t_all = self.mesh.size(self.seq_axis), inputs.shape[1]
        if t_all % n:
            raise ValueError(f"{t_all} positions not divisible by the {self.seq_axis!r} axis ({n})")
        t = t_all // n
        lo = self.mesh.index(self.seq_axis) * t
        positions = torch.arange(lo, lo + t, device=tokens.device)
        return inputs[:, lo:lo + t], labels[:, lo:lo + t], positions

    def token_count(self, local: int) -> int:
        """The global number of positions, from this rank's."""
        return local * math.prod(self.mesh.size(a) for a in self.reduce_axes)

    def reduce(self, params) -> None:
        leaves = param_leaves(params)
        specs = ([P()] * len(leaves) if self.param_spec is None
                 else spec_leaves(self.param_spec, params))
        reduce_gradients(leaves, specs, self.mesh, self.reduce_axes)

    def global_sum(self, x: torch.Tensor) -> torch.Tensor:
        """A detached local term summed over the reduced axes."""
        x = x.detach().float().clone()
        for axis in self.reduce_axes:
            all_reduce_(x, self.mesh.group(axis))
        return x


def make_classifier_train_step(model: torch.nn.Module, optimizer: Callable = None,
                               has_batch_stats: bool = False, mesh=None,
                               data_axis: str = "data") -> Callable:
    """Train step for the port's classifier modules (MLP, ResNet, ViT):
    ``step_fn(state, {"image", "label"}) -> (state, loss)``, the mean
    fused cross-entropy of ``model(image, train=True)``. ``state`` is
    ``init_train_state(model, optimizer)``; ``optimizer`` is unused and
    kept so the signature matches the JAX package's.

    ``has_batch_stats``: the model keeps BatchNorm running statistics
    (its buffers), which each step updates in place, as the reference's
    ``mutable=["batch_stats"]`` returns them. It must say what the model
    holds: a model with buffers and ``False``, or none and ``True``,
    raises ``ValueError``, where the reference's apply would fail.

    ``mesh``: data parallelism over ``data_axis``. The batch holds this
    rank's rows, the params are replicated, the gradients summed over the
    axis; the model's BatchNorm layers take their statistics over the
    global batch (their ``group`` is set to the axis's), as the
    reference's ``jit`` over a sharded batch computes them."""
    if has_batch_stats != any(True for _ in model.buffers()):
        raise ValueError(f"has_batch_stats={has_batch_stats} but the model "
                         f"{'has' if not has_batch_stats else 'has no'} running statistics")
    plan = None
    if mesh is not None:
        plan = _MeshPlan(mesh, data_axis, None)
        if mesh.size(data_axis) > 1:
            for m in model.modules():
                if isinstance(m, BatchNorm):
                    m.group = mesh.group(data_axis)

    def loss_fn(images, labels):
        losses = fused_cross_entropy(model(images, train=True), labels)
        if plan is None:
            return losses.mean(), None
        return losses.sum() / plan.token_count(losses.shape[0]), None

    def step_fn(state, batch):
        state, loss, _ = _apply_step(state, loss_fn, batch["image"], batch["label"],
                                     reduce=plan.reduce if plan else None)
        return state, loss if plan is None else plan.global_sum(loss)

    return step_fn


def lm_loss(forward: Callable, cfg, attention_fn=None) -> Callable:
    """``loss_fn(params, tokens)``: next-token cross-entropy of
    ``tokens[:, :-1]`` against ``tokens[:, 1:]`` through the fused loss."""

    def loss_fn(params, tokens):
        logits = forward(params, tokens[:, :-1], cfg, attention_fn=attention_fn)
        b, t, v = logits.shape
        return cross_entropy_loss(logits.reshape(b * t, v), tokens[:, 1:].reshape(-1))

    return loss_fn


def _mesh_lm_loss(forward: Callable, plan: _MeshPlan, attention_fn,
                  vocab_parallel_axis: Optional[str]) -> Callable:
    """This rank's share of the global mean next-token loss."""
    mesh, head_axis = plan.mesh, None
    if plan.model_axis is not None and plan.model_axis in spec_axes(plan.param_spec["lm_head"]):
        head_axis = plan.model_axis
    vp_loss = None
    if vocab_parallel_axis is not None:
        if mesh.size(vocab_parallel_axis) > 1 and vocab_parallel_axis != head_axis:
            raise ValueError(f"vocab_parallel_axis {vocab_parallel_axis!r} must be the axis the "
                             f"LM head is sharded over ({head_axis!r})")
        vp_loss = vocab_parallel_cross_entropy(mesh, vocab_parallel_axis)

    def loss_fn(params, tokens):
        inputs, labels, positions = plan.sequence_shard(tokens)
        logits = forward(params, inputs, plan.cfg, attention_fn=attention_fn,
                         positions=positions, **plan.hooks)
        b, t, v = logits.shape
        labels = labels.reshape(-1)
        if vp_loss is not None:
            losses = vp_loss(logits.reshape(b * t, v), labels)
        else:
            if head_axis is not None and mesh.size(head_axis) > 1:
                logits = all_gather_split_bwd(logits, -1, mesh.group(head_axis))
            losses = fused_cross_entropy(logits.reshape(b * t, -1), labels)
        return losses.sum() / plan.token_count(b * t)

    return loss_fn


def make_lm_train_step(forward: Callable, cfg, optimizer: Callable, mesh=None,
                       data_axis: str = "data", param_spec=None, attention_fn=None,
                       vocab_parallel_axis: Optional[str] = None):
    """Causal-LM train step ``step_fn(state, tokens) -> (state, loss)``.
    ``state`` comes from ``init_train_state``, whose ``"opt_state"`` is
    the torch optimizer over the param leaves; ``optimizer`` is unused
    and kept so the signature matches the JAX package's.
    After a step every param leaf's ``.grad`` holds that step's gradient.

    With ``mesh`` (see the module's docstring): ``tokens`` are this
    rank's rows ``[B/data, T+1]``; ``param_spec`` (e.g.
    ``models.transformer.param_partition_spec``) shards the params over
    a model axis, and the step computes with the per-shard config and
    the f/g hooks; an ``attention_fn`` with a ``seq_axis``
    (``parallel.ring_attention``, ``parallel.sequence_parallel``) shards
    the sequence: the pairs are shifted first, then cut to this rank's
    block, with their global positions. ``vocab_parallel_axis`` (needs
    ``mesh``) takes the loss over the LM head's vocab shards
    (``ops.losses.vocab_parallel_cross_entropy``), the logits never
    gathered; without it, logits sharded over the model axis are
    gathered before the fused loss."""
    if vocab_parallel_axis is not None and mesh is None:
        raise ValueError("vocab_parallel_axis needs a mesh")
    if mesh is None:
        loss_fn = lm_loss(forward, cfg, attention_fn)

        def step_fn(state, tokens):
            state, loss, _ = _apply_step(state, lambda: (loss_fn(state["params"], tokens), None))
            return state, loss

        return step_fn

    plan = _MeshPlan(mesh, data_axis, param_spec, attention_fn, cfg)
    mesh_loss = _mesh_lm_loss(forward, plan, attention_fn, vocab_parallel_axis)

    def mesh_step(state, tokens):
        state, local, _ = _apply_step(state, lambda: (mesh_loss(state["params"], tokens), None),
                                      reduce=plan.reduce)
        return state, plan.global_sum(local)

    return mesh_step


def make_moe_lm_train_step(forward: Callable, cfg, optimizer: Callable = None, mesh=None,
                           data_axis: str = "data", param_spec=None, attention_fn=None,
                           moe_fn=None):
    """Causal-LM train step for the MoE transformer (``models.moe``):
    ``step_fn(state, tokens) -> (state, {"loss", "ce", "aux"})`` with
    ``loss = ce + cfg.aux_weight * aux``, the next-token cross-entropy
    through the fused loss and the mean load-balancing loss over layers.
    ``moe_fn`` replaces the dense routing (``expert_parallel.moe_ffn``);
    ``optimizer`` is unused, as in ``make_lm_train_step``.

    With ``mesh``: ``tokens`` are this rank's rows; ``param_spec``
    (``models.moe.param_partition_spec(cfg, model_axis=None,
    expert_axis=...)``) shards the experts over the data axis, whose
    gradients arrive complete through ``moe_fn``'s all-to-alls and take
    no all-reduce; the rest is summed over ``data_axis``. The attention
    is not tensor- or sequence-parallel here (``ValueError``), and dense
    routing over a data axis of more than one rank would route each
    rank's tokens alone where the reference routes the global batch
    (``ValueError``: pass ``moe_fn``)."""

    def loss_fn(params, tokens):
        logits, aux = forward(params, tokens[:, :-1], cfg, attention_fn=attention_fn,
                              moe_fn=moe_fn)
        b, t, v = logits.shape
        ce = cross_entropy_loss(logits.reshape(b * t, v), tokens[:, 1:].reshape(-1))
        return ce + cfg.aux_weight * aux, (ce.detach(), aux.detach())

    if mesh is None:
        def step_fn(state, tokens):
            state, loss, (ce, aux) = _apply_step(state, loss_fn, state["params"], tokens)
            return state, {"loss": loss, "ce": ce, "aux": aux}

        return step_fn

    plan = _MeshPlan(mesh, data_axis, param_spec, attention_fn)
    if plan.model_axis is not None or plan.seq_axis is not None:
        raise ValueError("the MoE step's mesh path shards experts over the data axis only")
    if moe_fn is None and mesh.size(data_axis) > 1:
        raise ValueError("dense routing over a data axis routes each rank's tokens alone: "
                         "pass moe_fn=parallel.expert_parallel.moe_ffn(mesh, ...)")

    def mesh_loss(params, tokens):
        # moe_fn's aux is already the mean over the axis (its gradient
        # reaches each rank's own term as 1/n)
        logits, aux = forward(params, tokens[:, :-1], cfg, attention_fn=attention_fn,
                              moe_fn=moe_fn)
        b, t, v = logits.shape
        losses = fused_cross_entropy(logits.reshape(b * t, v), tokens[:, 1:].reshape(-1))
        ce_part = losses.sum() / plan.token_count(b * t)
        return ce_part + cfg.aux_weight * aux, (ce_part.detach(), aux.detach())

    def mesh_step(state, tokens):
        state, _, (ce_part, aux) = _apply_step(state, mesh_loss, state["params"], tokens,
                                              reduce=plan.reduce)
        ce = plan.global_sum(ce_part)
        return state, {"loss": ce + cfg.aux_weight * aux, "ce": ce, "aux": aux}

    return mesh_step


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
    results are means over them (grads in the params' tree shape; for a
    module, ``{name: grad}`` by ``named_parameters()``)."""

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
