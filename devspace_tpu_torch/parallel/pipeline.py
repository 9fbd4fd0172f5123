"""Pipeline parallelism over a ``pipe`` mesh axis.

Counterpart of ``devspace_tpu/parallel/pipeline.py``, as explicit SPMD
(``parallel/mesh.py``): each process is one rank of the mesh, holds its
stage's params as plain tensors (``shard_tree`` by
``pipeline_param_specs``: the leading stage dim of every stage leaf cut
over ``pipe``) and runs the schedule's ticks itself. The reference runs
every tick of its ``lax.scan`` on every device, masking idle ticks, and
sends both hops unconditionally; here a rank computes only on the ticks
the schedule gives it, and every tick posts exactly the sends and
receives that tick needs, in one ``batch_isend_irecv``. Both sides of a
hop read it from one static plan (``one_f_one_b_hops``,
``interleaved_hops``), so the pairs match by construction; a hop whose
two ends are the same rank (a pipe axis of one, an interleaved chunk
hop at ``pipe = 1``) is a local hand-over and posts nothing.

- ``pipeline_apply``: the homogeneous-stage forward (GPipe order,
  ``M + S - 1`` ticks); the last stage broadcasts the outputs over
  ``pipe``.
- ``pipeline_lm_loss_and_grads``: the transformer trained under the
  non-interleaved 1F1B schedule (PipeDream-flush): stage ``s`` runs the
  forward of microbatch ``f`` at tick ``s + 2f`` and its backward at
  tick ``2S - 1 - s + 2b``. A rank stashes only its stage's input; at a
  B tick it recomputes the stage forward under autograd from the stash
  and takes ``torch.autograd.grad(y, (stage leaves, x), dy)`` (the
  reference's ``jax.vjp`` at B), so the flash forward runs twice per
  stage and microbatch. Stage 0 owns the embedding's gradient (a
  scatter-add of its input gradient), the last stage the head and the
  loss, computed inside its B tick from the recomputed output; embed and
  head gradients and the loss are summed over ``pipe`` and divided by
  ``M``, then averaged over ``data`` (``_reduce_pipeline_grads``).
- ``interleaved_pipeline_lm_loss_and_grads``: the interleaved
  (virtual-stage) 1F1B, driven by ``parallel/interleaved.py``'s static
  ``[T, S]`` tables; V chunks per rank, arrivals routed to chunk slots.
- Tensor parallelism inside every stage goes through the f/g pair
  (``parallel/tensor_parallel.block_hooks``) with the per-shard config
  (``models.transformer.shard_config``); ``data_axis`` splits each
  microbatch's rows over ``data``: ``tokens`` ``[M, mb, T+1]`` are this
  rank's rows, as the trainer's mesh step takes them.
- ``make_pipeline_lm_train_step``, ``make_interleaved_pipeline_lm_train_step``:
  ``step(state, tokens) -> (state, loss)`` with ``state`` from
  ``training.trainer.init_train_state`` over this rank's stage params;
  the optimizer's moments are made from the shards, so they live where
  their params do (``parallel.mesh.opt_state_partition_spec`` names
  them).

Gradients are accumulated in float32 over the microbatches, as the
reference's carry does, and handed to the optimizer in each param's
dtype.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

from ..models import transformer as tfm
from ..ops.losses import fused_cross_entropy
from .collectives import all_reduce_
from .interleaved import OP_B, OP_F, build_interleaved_schedule
from .mesh import Mesh, P, PartitionSpec, tree_leaves, tree_map
from .tensor_parallel import block_hooks

FWD, BWD = 0, 1  # hop kinds; also the tags that keep a pair's two hops apart


class Hop(NamedTuple):
    """One activation (``FWD``) or gradient (``BWD``) sent at the end of a
    tick from stage ``src`` to stage ``dst`` for microbatch ``mb``;
    ``key`` is where the receiver files it (the interleaved executor's
    chunk and buffer slot; the microbatch for 1F1B)."""

    src: int
    dst: int
    kind: int
    mb: int
    key: tuple


# -- layouts --------------------------------------------------------------------
def _stack(trees: list):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([t[i] for t in trees]) for i in range(len(first)))
    return torch.stack(trees)


def stack_stage_params(param_list: list):
    """Stack per-stage trees into the leading-stage-dim layout that
    ``pipeline_apply`` expects (shard the result over the pipe axis)."""
    return _stack(list(param_list))


def transformer_stage_params(params: dict, n_stages: int) -> dict:
    """Split a transformer param tree (``models.transformer.init_params``)
    into the pipeline layout ``{"embed", "stages" [S, K, ...],
    "final_norm", "lm_head"}`` with ``K = n_layers / n_stages``."""
    n_layers = len(params["layers"])
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers not divisible by {n_stages} stages")
    k = n_layers // n_stages
    groups = [stack_stage_params(params["layers"][s * k:(s + 1) * k]) for s in range(n_stages)]
    return {"embed": params["embed"], "stages": stack_stage_params(groups),
            "final_norm": params["final_norm"], "lm_head": params["lm_head"]}


def transformer_unstage_params(stage_params: dict) -> dict:
    """Inverse of ``transformer_stage_params``."""
    stages = stage_params["stages"]
    s_n, k_n = tree_leaves(stages)[0].shape[:2]
    layers = [{name: w[si, ki] for name, w in stages.items()}
              for si in range(s_n) for ki in range(k_n)]
    return {"embed": stage_params["embed"], "layers": layers,
            "final_norm": stage_params["final_norm"], "lm_head": stage_params["lm_head"]}


def pipeline_param_specs(axis: str = "pipe", tp_axis: Optional[str] = None) -> dict:
    """Spec tree of the staged layout: stage groups sharded over ``axis``;
    with ``tp_axis`` each layer's weights also Megatron-sharded over the
    model axis (columns for qkv/gate/up, rows for o/down; leaves are
    ``[S, K, d_in, d_out]``). Embedding and head are replicated."""
    if tp_axis is None:
        return {"embed": P(), "stages": P(axis), "final_norm": P(), "lm_head": P()}
    col, row = P(axis, None, None, tp_axis), P(axis, None, tp_axis, None)
    return {
        "embed": P(),
        "stages": {"wq": col, "wk": col, "wv": col, "wo": row, "w_gate": col, "w_up": col,
                   "w_down": row, "attn_norm": P(axis, None, None),
                   "ffn_norm": P(axis, None, None)},
        "final_norm": P(),
        "lm_head": P(),
    }


def transformer_interleaved_stage_params(params: dict, n_stages: int, n_chunks: int) -> dict:
    """The INTERLEAVED layout: virtual stage ``p = v * S + s`` holds layers
    ``[p*K, (p+1)*K)``; leaves are ``[V, S, K, ...]``, so cutting dim 1
    over ``pipe`` hands rank s its V chunks ``{v*S + s}`` (Megatron's
    virtual-pipeline assignment)."""
    n_layers = len(params["layers"])
    total = n_stages * n_chunks
    if n_layers % total:
        raise ValueError(f"{n_layers} layers not divisible by {n_stages} stages x "
                         f"{n_chunks} chunks")
    k = n_layers // total
    chunks = [stack_stage_params([
        stack_stage_params(params["layers"][(v * n_stages + s) * k:(v * n_stages + s + 1) * k])
        for s in range(n_stages)]) for v in range(n_chunks)]
    return {"embed": params["embed"], "stages": stack_stage_params(chunks),
            "final_norm": params["final_norm"], "lm_head": params["lm_head"]}


def transformer_uninterleave_params(stage_params: dict) -> dict:
    """Inverse of ``transformer_interleaved_stage_params``."""
    stages = stage_params["stages"]
    v_n, s_n, k_n = tree_leaves(stages)[0].shape[:3]
    layers = [{name: w[p // s_n, p % s_n, ki] for name, w in stages.items()}
              for p in range(v_n * s_n) for ki in range(k_n)]
    return {"embed": stage_params["embed"], "layers": layers,
            "final_norm": stage_params["final_norm"], "lm_head": stage_params["lm_head"]}


def interleaved_param_specs(axis: str = "pipe", tp_axis: Optional[str] = None) -> dict:
    """Specs of the interleaved layout: ``pipeline_param_specs`` with the
    chunk dim in front (leaves ``[V, S, K, ...]``, the stage dim is 1)."""
    base = pipeline_param_specs(axis, tp_axis)
    stages = base["stages"]
    prefix = (lambda s: P(None, *s))
    return {**base, "stages": prefix(stages) if isinstance(stages, PartitionSpec)
            else {k: prefix(s) for k, s in stages.items()}}


# -- hops -----------------------------------------------------------------------
def _exchange(mesh: Mesh, axis: str, sends: list, recvs: list) -> list:
    """Post this tick's hops: ``sends`` ``[(dst stage, tensor, kind)]``,
    ``recvs`` ``[(src stage, like tensor, kind)]`` -> the received tensors
    in ``recvs``' order. A hop to this rank itself is handed over without
    communication. Ops go out ordered by kind, so two hops between the
    same pair of ranks pair up by order (NCCL) and by tag (gloo)."""
    me, group = mesh.index(axis), mesh.group(axis)
    local = {kind: t for dst, t, kind in sends if dst == me}
    out: list = [None] * len(recvs)
    ops = []
    for dst, t, kind in sorted((h for h in sends if h[0] != me), key=lambda h: h[2]):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), dist.get_global_rank(group, dst),
                              group, kind))
    for i, (src, like, kind) in sorted(enumerate(recvs), key=lambda e: e[1][2]):
        if src == me:
            out[i] = local.pop(kind)
            continue
        out[i] = torch.empty_like(like)
        ops.append(dist.P2POp(dist.irecv, out[i], dist.get_global_rank(group, src), group, kind))
    if local:
        raise RuntimeError(f"hops to this rank with no matching receive: {sorted(local)}")
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def _f_mb(s: int, tau: int, n_stages: int, m: int) -> Optional[int]:
    """The microbatch stage ``s`` forwards at tick ``tau`` under 1F1B."""
    d = tau - s
    return d // 2 if d >= 0 and d % 2 == 0 and d // 2 < m else None


def _b_mb(s: int, tau: int, n_stages: int, m: int) -> Optional[int]:
    """The microbatch stage ``s`` backpropagates at tick ``tau`` under 1F1B."""
    d = tau - (2 * n_stages - 1 - s)
    return d // 2 if d >= 0 and d % 2 == 0 and d // 2 < m else None


def one_f_one_b_hops(n_stages: int, n_micro: int) -> list:
    """Per tick of the 1F1B schedule, the hops sent at its end: a forward
    output to the next stage (consumed by its F one tick later), an
    input gradient to the previous one (consumed by its B one tick
    later)."""
    plan = []
    for tau in range(2 * (n_micro + n_stages - 1)):
        hops = []
        for s in range(n_stages):
            f = _f_mb(s, tau, n_stages, n_micro)
            if f is not None and s < n_stages - 1:
                hops.append(Hop(s, s + 1, FWD, f, (f,)))
            b = _b_mb(s, tau, n_stages, n_micro)
            if b is not None and s > 0:
                hops.append(Hop(s, s - 1, BWD, b, (b,)))
        plan.append(hops)
    return plan


def interleaved_hops(sched) -> list:
    """Per tick of an interleaved schedule, the hops sent at its end, read
    off the op tables (sender's side) and checked against the receive
    routing tables (receiver's side); ``RuntimeError`` where the two
    disagree. ``key`` is the receiver's (chunk, buffer slot)."""
    S, V = sched.n_stages, sched.n_chunks
    n_virtual = S * V
    plan = []
    for tau in range(sched.total_ticks):
        hops = []
        for s in range(S):
            op, c, m = int(sched.op[tau, s]), int(sched.chunk[tau, s]), int(sched.mb[tau, s])
            p = c * S + s
            if op == OP_F and p + 1 < n_virtual:
                hops.append(Hop(s, (s + 1) % S, FWD, m, ((p + 1) // S, m % sched.f_depth)))
            elif op == OP_B and p > 0:
                hops.append(Hop(s, (s - 1) % S, BWD, m, ((p - 1) // S, m % sched.b_depth)))
        plan.append(hops)
    # the receiver's view: every routing entry of tick tau + 1 is a hop of
    # tick tau, and every hop has one
    for tau in range(sched.total_ticks):
        want = {(h.dst, h.kind): h.key for h in plan[tau]}
        got = {}
        if tau + 1 < sched.total_ticks:
            for s in range(S):
                if sched.recv_f_chunk[tau + 1, s] >= 0:
                    got[(s, FWD)] = (int(sched.recv_f_chunk[tau + 1, s]),
                                     int(sched.recv_f_slot[tau + 1, s]))
                if sched.recv_b_chunk[tau + 1, s] >= 0:
                    got[(s, BWD)] = (int(sched.recv_b_chunk[tau + 1, s]),
                                     int(sched.recv_b_slot[tau + 1, s]))
        if want != got:
            raise RuntimeError(f"tick {tau}: hops sent {want} != hops routed {got}")
    return plan


def _post_hops(mesh: Mesh, axis: str, hops: list, me: int, out: dict, like: torch.Tensor) -> list:
    """This rank's part of one tick's hops: send ``out[kind]`` for each hop
    from ``me``, receive each hop to ``me`` -> ``[(hop, tensor)]``."""
    sends = [(h.dst, out[h.kind], h.kind) for h in hops if h.src == me]
    mine = [h for h in hops if h.dst == me]
    got = _exchange(mesh, axis, sends, [(h.src, like, h.kind) for h in mine])
    return list(zip(mine, got))


# -- the homogeneous-stage forward ----------------------------------------------
def pipeline_apply(mesh: Mesh, stage_fn: Callable, axis: str = "pipe", params_spec=(),
                   xs_spec: tuple = ()):
    """Build ``f(stage_params, xs) -> ys``, the GPipe-order forward.

    ``stage_params``: this rank's stage (every leaf with a leading stage
    dim of 1: a ``[S, ...]`` stack cut by ``f.params_spec``); ``xs``:
    ``[M, mb, ...]``, the same on every rank of ``axis`` (this rank's
    block of the dims ``xs_spec`` shards); returns the last stage's
    ``[M, mb, ...]`` outputs on every rank of ``axis``.
    ``stage_fn(params_one_stage, x) -> y`` keeps the activation's shape.
    ``params_spec`` shards the dims after each leaf's stage dim (a tuple
    for every leaf, or a tree of tuples per leaf; ``stage_fn`` then owns
    the tensor-parallel sums), ``xs_spec`` the dims after the microbatch
    dim: ``f.params_spec`` and ``f.xs_spec`` are the full specs to cut
    the stack and the microbatches with. No autograd."""
    n_stages = mesh.size(axis)

    @torch.no_grad()
    def f(stage_params, xs):
        params = tree_map(lambda p: p[0], stage_params)
        s = mesh.index(axis)
        _open_group(mesh, axis, xs.device)
        m = xs.shape[0]
        outputs = torch.zeros_like(xs)
        buf = None
        for t in range(m + n_stages - 1):
            y = None
            if s <= t < s + m:
                y = stage_fn(params, xs[t] if s == 0 else buf)
                if s == n_stages - 1:
                    outputs[t - s] = y
            sends = [(s + 1, y, FWD)] if y is not None and s < n_stages - 1 else []
            recvs = [(s - 1, xs[0], FWD)] if s > 0 and s - 1 <= t < s - 1 + m else []
            got = _exchange(mesh, axis, sends, recvs)
            if got:
                buf = got[0]
        group = mesh.group(axis)
        dist.broadcast(outputs, dist.get_global_rank(group, n_stages - 1), group=group)
        return outputs

    f.params_spec = _stage_spec(params_spec, axis)
    f.xs_spec = P(None, *xs_spec)
    return f


def _stage_spec(dims, axis: str):
    """A tuple of dims (or a tree of them) with the stage axis in front."""
    if isinstance(dims, dict):
        return {k: _stage_spec(v, axis) for k, v in dims.items()}
    if isinstance(dims, list):
        return [_stage_spec(v, axis) for v in dims]
    return P(axis, *dims)


# -- 1F1B and interleaved training of the transformer ----------------------------
def _tp_layer_setup(cfg, mesh: Mesh, tp_axis: Optional[str]):
    """The per-shard config (``ValueError`` where a width does not divide
    by the axis) and ``layer_apply`` hooks of Megatron-TP stages: the one
    place the tensor-parallel wiring of both schedules lives."""
    if tp_axis is None:
        return cfg, {}
    local = tfm.shard_config(cfg, mesh.size(tp_axis))
    return local, block_hooks(mesh, tp_axis)


def _reduce_pipeline_grads(mesh: Mesh, loss_sum, g_embed, g_head: dict, g_stages: dict,
                           axis: str, data_axis: Optional[str], m_total: int):
    """The loss lives on the last stage, the embed gradient on stage 0,
    the head's on the last stage: summed over ``pipe``; stage gradients
    stay on their stage; everything is divided by ``m_total`` and
    averaged over ``data``."""
    pipe = mesh.group(axis)
    for t in [loss_sum, g_embed, *g_head.values()]:
        all_reduce_(t, pipe)
    everything = [loss_sum, g_embed, *g_head.values(), *g_stages.values()]
    for t in everything:
        t.div_(m_total)
    if data_axis is not None:
        n = mesh.size(data_axis)
        for t in everything:
            all_reduce_(t, mesh.group(data_axis)).div_(n)
    return loss_sum, g_embed, g_head, g_stages


def _per_layer(stacked: dict) -> list:
    """``{name: [K, ...]}`` -> K dicts ``{name: [...]}`` (views)."""
    return [{n: w[i] for n, w in stacked.items()} for i in range(tree_leaves(stacked)[0].shape[0])]


def _open_group(mesh: Mesh, axis: str, device) -> None:
    """One collective over ``axis`` before any hop: NCCL wants every rank
    of a group in its first call, which a tick's hops are not."""
    all_reduce_(torch.zeros(1, device=device), mesh.group(axis))


class _LM:
    """What both schedules compute with: this rank's embed, head and
    stage leaves, the per-shard layer math, the head's loss and the
    float32 gradient buffers."""

    def __init__(self, cfg, local_cfg, hooks: dict, stage_params: dict, tokens, n_micro: int):
        if tokens.shape[0] != n_micro:
            raise ValueError(f"tokens hold {tokens.shape[0]} microbatches, the schedule "
                             f"{n_micro}")
        self.cfg, self.local_cfg, self.hooks = cfg, local_cfg, hooks
        self.embed = stage_params["embed"].detach()
        self.head = {k: stage_params[k].detach() for k in ("final_norm", "lm_head")}
        self.inputs, self.targets = tokens[:, :, :-1].long(), tokens[:, :, 1:]
        t = self.inputs.shape[2]
        self.cos, self.sin = tfm.rope_frequencies(cfg, torch.arange(t, device=tokens.device))
        self.act_like = torch.empty((self.inputs.shape[1], t, cfg.dim), dtype=cfg.dtype,
                                    device=tokens.device)
        self.g_embed = torch.zeros_like(self.embed, dtype=torch.float32)
        self.g_head = {k: torch.zeros_like(v, dtype=torch.float32) for k, v in self.head.items()}
        self.loss_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)

    def embed_rows(self, mb: int) -> torch.Tensor:
        return self.embed[self.inputs[mb]].to(self.cfg.dtype)

    def forward(self, layers: list, x: torch.Tensor) -> torch.Tensor:
        """``layers`` (one dict of weights a layer) on ``x``."""
        h = x
        for layer in layers:
            h, _ = tfm.layer_apply(h, layer, self.local_cfg, self.cos, self.sin, **self.hooks)
        return h

    def backward(self, layers: list, acc: list, x: torch.Tensor, mb: int, dy, last: bool,
                 first: bool):
        """A B tick: the layers recomputed from the stashed input under
        autograd, seeded by the head's loss on the last stage or by the
        gradient ``dy`` from the next stage; each layer's weight gradients
        are added to its float32 buffers in ``acc`` -> the input gradient,
        or None on stage 0, which takes the embedding's gradient instead.
        Each layer's weights are leaves of their own, so a layer's
        gradient is never a slice of a zero-filled stack."""
        views = [{n: w.detach().requires_grad_(True) for n, w in layer.items()}
                 for layer in layers]
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            y = self.forward(views, x)
            if last:
                y_leaf = y.detach().requires_grad_(True)
                head = {k: v.detach().requires_grad_(True) for k, v in self.head.items()}
                h = tfm.rms_norm(y_leaf, head["final_norm"], self.cfg.norm_eps)
                logits = (h @ head["lm_head"]).float()
                loss = fused_cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                           self.targets[mb].reshape(-1)).mean()
                g_norm, g_lm, dy = torch.autograd.grad(
                    loss, (head["final_norm"], head["lm_head"], y_leaf))
                self.g_head["final_norm"] += g_norm
                self.g_head["lm_head"] += g_lm
                self.loss_sum += loss.detach().float()
                dy = dy.to(self.cfg.dtype)
            leaves = [w for view in views for w in view.values()]
            grads = torch.autograd.grad(y, [*leaves, x], dy)
        for target, g in zip((a for layer in acc for a in layer.values()), grads[:-1],
                             strict=True):
            target += g
        dx = grads[-1]
        if first:
            d = dx.shape[-1]
            self.g_embed.index_add_(0, self.inputs[mb].reshape(-1), dx.reshape(-1, d).float())
            dx = None
        return dx

    def result(self, mesh, axis, data_axis, m_total, g_stages: dict, stage_dim) -> tuple:
        loss, g_embed, g_head, g_stages = _reduce_pipeline_grads(
            mesh, self.loss_sum, self.g_embed, self.g_head, g_stages, axis, data_axis, m_total)
        return loss, {"embed": g_embed, "stages": {k: stage_dim(g) for k, g in g_stages.items()},
                      "final_norm": g_head["final_norm"], "lm_head": g_head["lm_head"]}


def pipeline_lm_loss_and_grads(mesh: Mesh, cfg, n_microbatches: int, axis: str = "pipe",
                               data_axis: Optional[str] = None, tp_axis: Optional[str] = None):
    """Build ``f(stage_params, tokens) -> (loss, grads)``: the transformer's
    forward and backward under the 1F1B schedule.

    ``stage_params``: this rank's shards of ``transformer_stage_params``
    (``shard_tree`` by ``pipeline_param_specs(axis, tp_axis)``: stage
    leaves ``[1, K, ...]``); ``tokens``: ``[M, mb, T+1]`` int, this
    rank's rows of each microbatch when ``data_axis`` is set (inputs
    ``[..., :-1]``, targets ``[..., 1:]``), ``M == n_microbatches``.
    With ``tp_axis`` each stage's weights are Megatron shards and the
    stage math runs head- and FFN-parallel through the f/g pair. Returns
    the mean loss over every microbatch and float32 gradients shaped like
    ``stage_params``, the same on every rank that holds the same
    shards."""
    n_stages, m_total = mesh.size(axis), n_microbatches
    local_cfg, hooks = _tp_layer_setup(cfg, mesh, tp_axis)
    plan = one_f_one_b_hops(n_stages, m_total)

    def fn(stage_params, tokens):
        s = mesh.index(axis)
        _open_group(mesh, axis, tokens.device)
        lm = _LM(cfg, local_cfg, hooks, stage_params, tokens, m_total)
        stages = {k: v.detach()[0] for k, v in stage_params["stages"].items()}  # [K, ...]
        g_stages = {k: torch.zeros_like(v, dtype=torch.float32) for k, v in stages.items()}
        layers, acc = _per_layer(stages), _per_layer(g_stages)
        ring: dict = {}  # microbatch -> stashed stage input
        fwd_in: dict = {}  # microbatch -> activation from the previous stage
        bwd_in: dict = {}  # microbatch -> gradient from the next stage
        for tau, hops in enumerate(plan):
            out = {}
            f = _f_mb(s, tau, n_stages, m_total)
            if f is not None:
                x = lm.embed_rows(f) if s == 0 else fwd_in.pop(f)
                with torch.no_grad():
                    out[FWD] = lm.forward(layers, x)
                ring[f] = x
            b = _b_mb(s, tau, n_stages, m_total)
            if b is not None:
                dy = None if s == n_stages - 1 else bwd_in.pop(b)
                out[BWD] = lm.backward(layers, acc, ring.pop(b), b, dy, last=s == n_stages - 1,
                                       first=s == 0)
            for hop, got in _post_hops(mesh, axis, hops, s, out, lm.act_like):
                (fwd_in if hop.kind == FWD else bwd_in)[hop.mb] = got
        return lm.result(mesh, axis, data_axis, m_total, g_stages, lambda g: g[None])

    return fn


def interleaved_pipeline_lm_loss_and_grads(mesh: Mesh, cfg, n_microbatches: int, n_chunks: int,
                                           axis: str = "pipe", data_axis: Optional[str] = None,
                                           tp_axis: Optional[str] = None):
    """Interleaved (virtual-stage) 1F1B: ``f(stage_params, tokens) ->
    (loss, grads)`` with ``stage_params`` this rank's shards of
    ``transformer_interleaved_stage_params`` (``interleaved_param_specs``:
    leaves ``[V, 1, K, ...]``). The same math as the non-interleaved
    schedule with a ~V-fold smaller bubble (``parallel/interleaved.py``);
    composes with ``data_axis`` and ``tp_axis`` as it does."""
    n_stages, m_total = mesh.size(axis), n_microbatches
    sched = build_interleaved_schedule(n_stages, n_chunks, n_microbatches)
    plan = interleaved_hops(sched)
    local_cfg, hooks = _tp_layer_setup(cfg, mesh, tp_axis)
    last_chunk = n_chunks - 1

    def fn(stage_params, tokens):
        s = mesh.index(axis)
        _open_group(mesh, axis, tokens.device)
        lm = _LM(cfg, local_cfg, hooks, stage_params, tokens, m_total)
        chunks = {k: v.detach()[:, 0] for k, v in stage_params["stages"].items()}  # [V, K, ...]
        g_stages = {k: torch.zeros_like(v, dtype=torch.float32) for k, v in chunks.items()}
        layers = [_per_layer({k: v[c] for k, v in chunks.items()}) for c in range(n_chunks)]
        acc = [_per_layer({k: g[c] for k, g in g_stages.items()}) for c in range(n_chunks)]
        ring: dict = {}  # (chunk, ring slot) -> stashed chunk input
        arrived = {FWD: {}, BWD: {}}  # kind -> (chunk, buffer slot) -> tensor
        for tau, hops in enumerate(plan):
            op, c = int(sched.op[tau, s]), int(sched.chunk[tau, s])
            m, slot = int(sched.mb[tau, s]), int(sched.slot[tau, s])
            first, last = c == 0 and s == 0, c == last_chunk and s == n_stages - 1
            out = {}
            if op == OP_F:
                x = lm.embed_rows(m) if first else arrived[FWD].pop((c, m % sched.f_depth))
                with torch.no_grad():
                    out[FWD] = lm.forward(layers[c], x)
                ring[(c, slot)] = x
            elif op == OP_B:
                dy = None if last else arrived[BWD].pop((c, m % sched.b_depth))
                out[BWD] = lm.backward(layers[c], acc[c], ring.pop((c, slot)), m, dy, last, first)
            for hop, got in _post_hops(mesh, axis, hops, s, out, lm.act_like):
                if hop.key in arrived[hop.kind]:
                    raise RuntimeError(f"tick {tau}: buffer {hop.key} still holds a hop")
                arrived[hop.kind][hop.key] = got
        return lm.result(mesh, axis, data_axis, m_total, g_stages, lambda g: g[:, None])

    return fn


def _pp_train_step(loss_and_grads: Callable) -> Callable:
    """The train-step tail of both layouts: each leaf's gradient set in its
    dtype, the optimizer's step over this rank's leaves."""

    def step(state, tokens):
        params = state["params"]
        loss, grads = loss_and_grads(params, tokens)
        opt = state["opt_state"]
        opt.zero_grad(set_to_none=True)
        for p, g in zip(tree_leaves(params), tree_leaves(grads), strict=True):
            p.grad = g.to(p.dtype)
        opt.step()
        return {**state, "step": state["step"] + 1}, loss

    return step


def make_pipeline_lm_train_step(mesh: Mesh, cfg, optimizer: Callable, n_microbatches: int,
                                axis: str = "pipe", data_axis: Optional[str] = None,
                                tp_axis: Optional[str] = None) -> Callable:
    """1F1B pipeline-parallel LM train step ``step(state, tokens) ->
    (state, loss)``. ``state`` is ``training.trainer.init_train_state``
    over this rank's shards of ``transformer_stage_params``
    (``pipeline_param_specs(axis, tp_axis)``); ``tokens`` ``[M, mb, T+1]``
    hold this rank's ``data`` rows. Loss and gradients are those of the
    non-pipelined ``make_lm_train_step`` on the unstaged params;
    ``data_axis``/``tp_axis`` compose pp with dp and tp on one mesh.
    ``optimizer`` is unused (the state holds the optimizer), as in the
    trainer's steps."""
    del optimizer
    return _pp_train_step(pipeline_lm_loss_and_grads(
        mesh, cfg, n_microbatches, axis=axis, data_axis=data_axis, tp_axis=tp_axis))


def make_interleaved_pipeline_lm_train_step(mesh: Mesh, cfg, optimizer: Callable,
                                            n_microbatches: int, n_chunks: int,
                                            axis: str = "pipe", data_axis: Optional[str] = None,
                                            tp_axis: Optional[str] = None) -> Callable:
    """Interleaved 1F1B train step ``step(state, tokens) -> (state, loss)``
    over this rank's shards of ``transformer_interleaved_stage_params``
    (``interleaved_param_specs``): ``make_pipeline_lm_train_step`` with a
    ~V-fold smaller bubble (Megatron's ``2*(S-1)`` chunk ticks when S
    divides the microbatch count)."""
    del optimizer
    return _pp_train_step(interleaved_pipeline_lm_loss_and_grads(
        mesh, cfg, n_microbatches, n_chunks, axis=axis, data_axis=data_axis, tp_axis=tp_axis))
