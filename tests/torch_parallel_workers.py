"""The port's side of the parallel parity tests, run on every rank of a
gloo world (``torch_parallel_world.World``). Imports no JAX: arrays
arrive and leave as numpy; each function builds its mesh on the CPU and
returns what the pytest process compares with the JAX package."""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.distributed as dist

from devspace_tpu_torch.models import moe as tmoe
from devspace_tpu_torch.models import transformer as ttfm
from devspace_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from devspace_tpu_torch.ops.losses import vocab_parallel_cross_entropy
from devspace_tpu_torch.parallel import (
    collectives,
    data_parallel,
    expert_parallel,
    fsdp,
    pipeline,
)
from devspace_tpu_torch.parallel.mesh import (
    P,
    create_mesh,
    gather_tensor,
    gather_tree,
    shard_tensor,
    shard_tree,
    sharding,
    spec_leaves,
    tree_leaves,
)
from devspace_tpu_torch.parallel.ring_attention import ring_attention
from devspace_tpu_torch.parallel.sequence_parallel import ulysses_attention
from devspace_tpu_torch.parallel.tensor_parallel import (
    shard_columnwise,
    shard_rowwise,
    tp_attention_projections,
    tp_mlp,
)
from devspace_tpu_torch.training import data as tdata
from devspace_tpu_torch.training import trainer as ttrainer


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def cpu_mesh(axes: dict):
    return create_mesh(axes, device="cpu")


def tree_np(tree):
    return params_to_numpy(tree)


# -- mesh ---------------------------------------------------------------------
def mesh_layout(axes: dict) -> dict:
    """This rank's coordinates and each axis group's ranks and size."""
    mesh = cpu_mesh(axes)
    return {
        "rank": dist.get_rank(),
        "shape": mesh.shape,
        "index": {a: mesh.index(a) for a in mesh.shape},
        "group_ranks": {a: dist.get_process_group_ranks(mesh.group(a)) for a in mesh.shape},
    }


def mesh_backend_mismatch() -> str:
    """A mesh on the card over this gloo world raises (the card itself is
    stood in for: ``resolve_device`` answers ``cuda:0``)."""
    from devspace_tpu_torch.parallel import mesh as mesh_mod

    real = mesh_mod.resolve_device
    mesh_mod.resolve_device = lambda device: torch.device("cuda", 0)
    try:
        create_mesh({"data": -1}, device="cuda")
    except ValueError as e:
        return str(e)
    finally:
        mesh_mod.resolve_device = real
    return "no error"


def shard_and_gather(axes: dict, spec: tuple, x) -> dict:
    mesh = cpu_mesh(axes)
    block = shard_tensor(t(x), P(*spec), mesh)
    return {"block": block.numpy().copy(), "index": {a: mesh.index(a) for a in mesh.shape},
            "full": gather_tensor(block.contiguous(), P(*spec), mesh).numpy()}


# -- data parallelism -----------------------------------------------------------
def _mse_loss(p, b):
    return torch.mean((b["x"] @ p["w"] - b["y"]) ** 2)


def dp_step(w, xs, ys, lr: float) -> dict:
    mesh = cpu_mesh({"data": -1})
    params = {"w": t(w).requires_grad_()}
    opt = ttrainer.sgd(lr, momentum=0.0)(ttrainer.param_leaves(params))
    step = data_parallel.make_train_step(_mse_loss, None, mesh)
    batch = data_parallel.shard_batch({"x": t(xs), "y": t(ys)}, mesh)
    params, opt, loss = step(params, opt, batch)
    return {"w": params["w"].detach().numpy(), "loss": float(loss), "rows": batch["x"].shape[0]}


def dp_psum_mean_grad(w, xs, ys) -> np.ndarray:
    """The gradient of the averaged loss, summed over the axis."""
    mesh = cpu_mesh({"data": -1})
    wt = t(w).requires_grad_()
    batch = data_parallel.shard_batch({"x": t(xs), "y": t(ys)}, mesh)
    loss = data_parallel.psum_mean_loss(_mse_loss, mesh)({"w": wt}, batch)
    loss.backward()
    collectives.all_reduce_(wt.grad, mesh.group("data"))
    return np.stack([wt.grad.numpy(), np.full_like(w, float(loss))])


def dp_eval(w, xs) -> np.ndarray:
    mesh = cpu_mesh({"data": -1})
    ev = data_parallel.make_eval_step(lambda p, x: x @ p["w"], mesh)
    out = ev({"w": t(w)}, data_parallel.shard_batch(t(xs), mesh))
    return gather_tensor(out, P("data"), mesh).numpy()


def prefetch_sharded(n_batches: int) -> list:
    mesh = cpu_mesh({"data": -1})
    batches = ({"x": np.full((8, 4), i, np.float32) + np.arange(8, dtype=np.float32)[:, None]}
               for i in range(n_batches))
    out = tdata.prefetch_to_device(batches, size=2, sharding=sharding(mesh, "data"))
    return [b["x"].numpy() for b in out]


def classifier_mesh_step(model_name: str, state_dict: dict, images, labels, lr: float) -> dict:
    """One SGD step of an MLP or a small ResNet over a data mesh: the
    params after it (equal on every rank), the loss, the running
    statistics."""
    from devspace_tpu_torch.models.mlp import MLP
    from devspace_tpu_torch.models.resnet import ResNet

    mesh = cpu_mesh({"data": -1})
    if model_name == "mlp":
        model = MLP(features=(32, 10), device="cpu")
    else:
        model = ResNet(stage_sizes=(1, 1), num_classes=10, num_filters=8,
                       dtype=torch.float32, device="cpu")
    model.load_state_dict({k: t(v) for k, v in state_dict.items()})
    opt = ttrainer.sgd(lr, momentum=0.9)
    state = ttrainer.init_train_state(model, opt)
    step = ttrainer.make_classifier_train_step(model, opt, has_batch_stats=model_name != "mlp",
                                               mesh=mesh)
    batch = data_parallel.shard_batch({"image": t(images), "label": t(labels)}, mesh)
    state, loss = step(state, batch)
    return {"loss": float(loss),
            "state": {k: v.detach().numpy() for k, v in model.state_dict().items()}}


# -- tensor parallelism -------------------------------------------------------
def tp_mlp_case(x, w_up, w_down, dy) -> dict:
    mesh = cpu_mesh({"model": -1})
    xt = t(x).requires_grad_()
    up = shard_columnwise(t(w_up), mesh).requires_grad_()
    down = shard_rowwise(t(w_down), mesh).requires_grad_()
    y = tp_mlp(mesh)(xt, up, down)
    y.backward(t(dy))
    g = mesh.group("model")
    return {"y": y.detach().numpy(), "dx": xt.grad.numpy(),
            "dw_up": collectives.gather(up.grad, 1, g).numpy(),
            "dw_down": collectives.gather(down.grad, 0, g).numpy()}


def tp_attention_case(x, wq, wk, wv, wo, n_heads: int) -> np.ndarray:
    """Head-parallel projections around full attention on the local heads."""
    from devspace_tpu_torch.parallel.ring_attention import full_attention

    mesh = cpu_mesh({"model": -1})
    hd = wq.shape[1] // n_heads

    def attn(q, k, v):
        b, tt, _ = q.shape
        split = lambda z: z.reshape(b, tt, -1, hd)
        return full_attention(split(q), split(k), split(v), causal=True).reshape(b, tt, -1)

    cols = [shard_columnwise(t(w), mesh) for w in (wq, wk, wv)]
    y = tp_attention_projections(mesh)(t(x), *cols, shard_rowwise(t(wo), mesh), attn)
    return y.numpy()


def tp_layer_case(cfg_kwargs: dict, layer_np: dict, h, dh) -> dict:
    """``layer_apply`` on the per-shard config and weight shards with the
    f/g hooks: its output and every weight's gradient (gathered)."""
    from devspace_tpu_torch.parallel.tensor_parallel import block_hooks

    mesh = cpu_mesh({"model": -1})
    cfg = ttfm.TransformerConfig(**cfg_kwargs, dtype=torch.float32)
    spec = ttfm.param_partition_spec(cfg)["layers"][0]
    layer = shard_tree({k: t(v).requires_grad_() for k, v in layer_np.items()}, spec, mesh)
    ht = t(h).requires_grad_()
    cos, sin = ttfm.rope_frequencies(cfg, torch.arange(h.shape[1]))
    local = ttfm.shard_config(cfg, mesh.size("model"))
    out, _ = ttfm.layer_apply(ht, layer, local, cos, sin, **block_hooks(mesh))
    out.backward(t(dh))
    grads = {k: v.grad for k, v in layer.items()}
    return {"out": out.detach().numpy(), "dh": ht.grad.numpy(),
            "grads": tree_np(gather_tree(grads, spec, mesh))}


def vocab_parallel_case(axes: dict, logits, labels, g) -> dict:
    mesh = cpu_mesh(axes)
    spec = P("data", "model")
    block = shard_tensor(t(logits), spec, mesh).clone().requires_grad_()
    rows = shard_tensor(t(labels), P("data"), mesh)
    losses = vocab_parallel_cross_entropy(mesh, "model")(block, rows)
    losses.backward(shard_tensor(t(g), P("data"), mesh))
    return {"loss": gather_tensor(losses.detach(), P("data"), mesh).numpy(),
            "grad": gather_tensor(block.grad, spec, mesh).numpy()}


def lm_mesh_step(axes: dict, params_np: dict, cfg_kwargs: dict, tokens, steps: int, lr: float,
                 vocab_parallel: bool, attention: str = "default", momentum: float = 0.0,
                 block_size=512, device: str = "cpu") -> dict:
    """``steps`` SGD steps of ``make_lm_train_step`` over a mesh on
    ``device`` (``cuda``: this rank's card, float32 with TF32 off):
    losses, the full params after and the last step's gradients
    (gathered)."""
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    mesh = create_mesh(axes, device=device)
    cfg = ttfm.TransformerConfig(**cfg_kwargs, dtype=torch.float32)
    model_axis = "model" if "model" in axes else None
    spec = ttfm.param_partition_spec(cfg, model_axis=model_axis)
    params = shard_tree(params_from_numpy(params_np, mesh.device, trainable=True), spec, mesh)
    opt = ttrainer.sgd(lr, momentum=momentum)
    state = ttrainer.init_train_state(params, opt)
    attn = None
    batch_axis = "data" if "data" in axes else None
    if attention == "ring":
        attn = ring_attention(mesh, "seq", causal=True, batch_axis=batch_axis,
                              block_size=block_size)
    elif attention == "ulysses":
        attn = ulysses_attention(mesh, "seq", causal=True, batch_axis=batch_axis)
    step = ttrainer.make_lm_train_step(
        ttfm.forward, cfg, opt, mesh=mesh, data_axis="data", param_spec=spec,
        attention_fn=attn, vocab_parallel_axis="model" if vocab_parallel else None)
    rows = data_parallel.shard_batch(t(tokens), mesh)
    losses = []
    for _ in range(steps):
        state, loss = step(state, rows)
        losses.append(float(loss))
    leaves = ttrainer.param_leaves(state["params"])
    grads = ttrainer.tree_like(state["params"], [p.grad for p in leaves])  # the last step's
    return {"losses": losses, "params": tree_np(gather_tree(state["params"], spec, mesh)),
            "grads": tree_np(gather_tree(grads, spec, mesh)),
            "opt_spec": ttrainer.opt_state_partition_spec(state["opt_state"], spec,
                                                          state["params"])}


# -- sequence parallelism -----------------------------------------------------
def attention_case(kind: str, axes: dict, spec: tuple, q, k, v, dout, causal: bool,
                   block_size=512) -> dict:
    """Ring or Ulysses attention over ``axes``, each rank holding its block
    of q/k/v under ``spec``: the full output and input gradients
    (gathered) and any warnings."""
    mesh = cpu_mesh(axes)
    spec = P(*spec)
    ql, kl, vl = (shard_tensor(t(a), spec, mesh).clone().requires_grad_() for a in (q, k, v))
    batch_axis = spec[0]
    head_axis = spec[2] if len(spec) > 2 else None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if kind == "ring":
            fn = ring_attention(mesh, "seq", causal=causal, batch_axis=batch_axis,
                                head_axis=head_axis, block_size=block_size)
        else:
            fn = ulysses_attention(mesh, "seq", causal=causal, batch_axis=batch_axis)
        out = fn(ql, kl, vl)
    out.backward(shard_tensor(t(dout), spec, mesh))
    full = lambda x: gather_tensor(x, spec, mesh).numpy()
    return {"out": full(out.detach()), "dq": full(ql.grad), "dk": full(kl.grad),
            "dv": full(vl.grad), "warnings": [str(w.message) for w in caught]}


def ulysses_indivisible(q) -> str:
    mesh = cpu_mesh({"seq": -1})
    x = shard_tensor(t(q), P(None, "seq"), mesh)
    try:
        ulysses_attention(mesh)(x, x, x)
    except ValueError as e:
        return str(e)
    return "no error"


# -- expert parallelism -------------------------------------------------------
def moe_ffn_case(params_np: dict, x, k: int, capacity_factor: float, activation: str,
                 device: str = "cpu") -> dict:
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    mesh = create_mesh({"data": -1}, device=device)
    params = shard_moe(params_np, mesh)
    act = expert_parallel.swiglu if activation == "swiglu" else expert_parallel.gelu
    layer = expert_parallel.moe_ffn(mesh, "data", k=k, capacity_factor=capacity_factor,
                                    activation=act)
    # the routing moe_ffn takes, read where it is made
    routes, route = [], expert_parallel._route
    expert_parallel._route = lambda *a: routes.append(route(*a)) or routes[-1]
    try:
        y, aux = layer(shard_tensor(t(x), P("data"), mesh).to(mesh.device), params)
    finally:
        expert_parallel._route = route
    dispatch = routes[0][0].to(torch.uint8)
    return {"y": gather_tensor(y, P("data"), mesh).cpu().numpy(), "aux": float(aux),
            "dispatch": gather_tensor(dispatch, P("data"), mesh).cpu().numpy().astype(bool)}


def shard_moe(params_np: dict, mesh):
    return expert_parallel.shard_moe_params({k: t(v) for k, v in params_np.items()}, mesh)


def moe_mesh_step(params_np: dict, cfg_kwargs: dict, tokens, lr: float) -> dict:
    """One SGD step of the expert-parallel MoE LM over a data mesh."""
    mesh = cpu_mesh({"data": -1})
    cfg = tmoe.MoEConfig(**cfg_kwargs, dtype=torch.float32)
    spec = tmoe.param_partition_spec(cfg, model_axis=None, expert_axis="data")
    params = shard_tree(params_from_numpy(params_np, "cpu", trainable=True), spec, mesh)
    opt = ttrainer.sgd(lr, momentum=0.0)
    state = ttrainer.init_train_state(params, opt)
    moe_fn = expert_parallel.moe_ffn(mesh, "data", k=cfg.experts_per_token,
                                     capacity_factor=cfg.capacity_factor,
                                     activation=expert_parallel.swiglu)
    step = ttrainer.make_moe_lm_train_step(tmoe.forward, cfg, opt, mesh=mesh, param_spec=spec,
                                           moe_fn=moe_fn)
    state, metrics = step(state, data_parallel.shard_batch(t(tokens), mesh))
    grads = ttrainer.tree_like(state["params"],
                               [p.grad for p in ttrainer.param_leaves(state["params"])])
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": tree_np(gather_tree(state["params"], spec, mesh)),
            "grads": tree_np(gather_tree(grads, spec, mesh))}


def moe_dense_refused(cfg_kwargs: dict) -> str:
    mesh = cpu_mesh({"data": -1})
    cfg = tmoe.MoEConfig(**cfg_kwargs, dtype=torch.float32)
    try:
        ttrainer.make_moe_lm_train_step(tmoe.forward, cfg, None, mesh=mesh)
    except ValueError as e:
        return str(e)
    return "no error"


# -- FSDP -----------------------------------------------------------------------
def _fsdp_loss(p, b):
    pred = torch.tanh(b["x"] @ p["w1"]) @ p["w2"] + p["b"]
    return torch.mean((pred - b["y"]) ** 2)


def fsdp_case(params_np: dict, xs, ys, lr: float, min_size: int, steps: int,
              device: str = "cpu") -> dict:
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    mesh = create_mesh({"data": -1}, device=device)
    params = {k: t(v).to(mesh.device).requires_grad_() for k, v in params_np.items()}
    spec = fsdp.fsdp_spec(params, mesh, min_size=min_size)
    step, shards, opt = fsdp.make_fsdp_train_step(_fsdp_loss, ttrainer.adam(lr), mesh, params,
                                                  min_size=min_size)
    batch = data_parallel.shard_batch({"x": t(xs), "y": t(ys)}, mesh)
    losses = []
    for _ in range(steps):
        shards, opt, loss = step(shards, opt, batch)
        losses.append(float(loss))
    return {"losses": losses, "spec": spec,
            "shapes": {k: tuple(v.shape) for k, v in shards.items()},
            "opt_spec": fsdp.opt_state_spec(opt, spec, shards),
            "params": {k: v.cpu().numpy() for k, v in gather_tree(shards, spec, mesh).items()}}


def fsdp_lm_step(params_np: dict, cfg_kwargs: dict, tokens, lr: float) -> dict:
    """The TINY LM's loss through ``make_fsdp_train_step`` (SGD)."""
    mesh = cpu_mesh({"data": -1})
    cfg = ttfm.TransformerConfig(**cfg_kwargs, dtype=torch.float32)
    params = params_from_numpy(params_np, "cpu", trainable=True)
    loss_fn = ttrainer.lm_loss(ttfm.forward, cfg)
    step, shards, opt = fsdp.make_fsdp_train_step(loss_fn, ttrainer.sgd(lr, momentum=0.0),
                                                  mesh, params)
    spec = fsdp.fsdp_spec(params, mesh)
    shards, opt, loss = step(shards, opt, data_parallel.shard_batch(t(tokens), mesh))
    grads = ttrainer.tree_like(shards, [p.grad for p in ttrainer.param_leaves(shards)])
    return {"loss": float(loss), "params": tree_np(gather_tree(shards, spec, mesh)),
            "grads": tree_np(gather_tree(grads, spec, mesh))}


def fsdp_layerwise_steps(params_np: dict, cfg_kwargs: dict, tokens, lr: float, steps: int,
                         remat: bool = False) -> dict:
    """``steps`` SGD steps of the TINY LM through ``make_fsdp_train_step``
    (every leaf of 1024 elements or more sharded over ``data``) -> the
    losses, the params after, the largest number of gathered bytes alive
    at once in each step, and the bytes of the gathered leaves: the
    embedding, the head, each layer's, and all of them together."""
    from functools import partial

    mesh = cpu_mesh({"data": -1})
    cfg = ttfm.TransformerConfig(**cfg_kwargs, dtype=torch.float32)
    params = params_from_numpy(params_np, "cpu", trainable=True)
    forward = partial(ttfm.forward, remat=True) if remat else ttfm.forward
    step, shards, opt = fsdp.make_fsdp_train_step(ttrainer.lm_loss(forward, cfg),
                                                  ttrainer.sgd(lr, momentum=0.0), mesh, params)
    spec = fsdp.fsdp_spec(params, mesh)
    batch = data_parallel.shard_batch(t(tokens), mesh)
    losses, peaks = [], []
    for _ in range(steps):
        shards, opt, loss = step(shards, opt, batch)
        losses.append(float(loss))
        peaks.append(step.stats["gathered_peak_bytes"])

    def gathered_bytes(tree, specs):
        return sum(x.numel() * x.element_size()
                   for x, s in zip(tree_leaves(tree), spec_leaves(specs, tree)) if any(s))

    return {"losses": losses, "peaks": peaks, "layerwise": step.stats["layerwise"],
            "params": tree_np(gather_tree(shards, spec, mesh)),
            "bytes": {"embed": gathered_bytes(params["embed"], spec["embed"]),
                      "lm_head": gathered_bytes(params["lm_head"], spec["lm_head"]),
                      "layers": [gathered_bytes(lyr, s)
                                 for lyr, s in zip(params["layers"], spec["layers"])],
                      "whole": gathered_bytes(params, spec)}}


def fsdp_mlp_peak(params_np: dict, xs, ys) -> dict:
    """One Adam(1e-2) step of the MLP tree (no ``layers``) at min_size 64:
    its loss, the params after, the gathered peak and the bytes of its
    gathered leaves."""
    mesh = cpu_mesh({"data": -1})
    params = {k: t(v).requires_grad_() for k, v in params_np.items()}
    step, shards, opt = fsdp.make_fsdp_train_step(_fsdp_loss, ttrainer.adam(1e-2), mesh, params,
                                                  min_size=64)
    spec = fsdp.fsdp_spec(params, mesh, min_size=64)
    shards, opt, loss = step(shards, opt,
                             data_parallel.shard_batch({"x": t(xs), "y": t(ys)}, mesh))
    whole = sum(params[k].numel() * 4 for k in params if any(spec[k]))
    return {"peak": step.stats["gathered_peak_bytes"], "layerwise": step.stats["layerwise"],
            "whole": whole, "loss": float(loss),
            "params": {k: v.numpy() for k, v in gather_tree(shards, spec, mesh).items()}}


def noop() -> int:
    return dist.get_rank()



# -- pipeline parallelism -----------------------------------------------------
def _pipeline_setup(axes: dict, params_np: dict, cfg_kwargs: dict, n_chunks: int,
                    device: str = "cpu"):
    """The mesh, config, this rank's staged params and their spec tree:
    the 1F1B layout for ``n_chunks == 0``, else the interleaved one."""
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    mesh = create_mesh(axes, device=device)
    cfg = ttfm.TransformerConfig(**cfg_kwargs, dtype=torch.float32)
    params = params_from_numpy(params_np, mesh.device)
    tp_axis = "model" if "model" in axes else None
    if n_chunks:
        staged = pipeline.transformer_interleaved_stage_params(params, axes["pipe"], n_chunks)
        spec = pipeline.interleaved_param_specs("pipe", tp_axis)
    else:
        staged = pipeline.transformer_stage_params(params, axes["pipe"])
        spec = pipeline.pipeline_param_specs("pipe", tp_axis)
    return mesh, cfg, shard_tree(staged, spec, mesh), spec, tp_axis


def _pipeline_rows(tokens, mesh, axes: dict):
    toks = t(tokens).to(mesh.device)
    return shard_tensor(toks, P(None, "data"), mesh).contiguous() if "data" in axes else toks


def pipeline_loss_grads(axes: dict, params_np: dict, cfg_kwargs: dict, tokens,
                        n_chunks: int = 0, device: str = "cpu") -> dict:
    """The loss and the gathered staged gradients of
    ``pipeline_lm_loss_and_grads`` (or, with ``n_chunks``, the
    interleaved executor) over ``axes``."""
    from devspace_tpu_torch.ops import flash_attention as tflash

    mesh, cfg, local, spec, tp_axis = _pipeline_setup(axes, params_np, cfg_kwargs, n_chunks,
                                                      device)
    data_axis = "data" if "data" in axes else None
    m = len(tokens)
    if n_chunks:
        fn = pipeline.interleaved_pipeline_lm_loss_and_grads(
            mesh, cfg, m, n_chunks, data_axis=data_axis, tp_axis=tp_axis)
    else:
        fn = pipeline.pipeline_lm_loss_and_grads(mesh, cfg, m, data_axis=data_axis,
                                                 tp_axis=tp_axis)
    before = tflash.LAUNCHES["fwd"]
    loss, grads = fn(local, _pipeline_rows(tokens, mesh, axes))
    return {"loss": float(loss), "grads": tree_np(gather_tree(grads, spec, mesh)),
            "flash_fwd_launches": tflash.LAUNCHES["fwd"] - before}


def pipeline_train_steps(axes: dict, params_np: dict, cfg_kwargs: dict, tokens, steps: int,
                         lr: float, n_chunks: int = 0, device: str = "cpu",
                         momentum: float = 0.9) -> dict:
    """``steps`` SGD steps of ``make_pipeline_lm_train_step`` (or the
    interleaved one) -> losses, the gathered staged params after, the
    optimizer state's specs and the flash and loss kernels' launches
    (on the card)."""
    from devspace_tpu_torch.ops import flash_attention as tflash
    from devspace_tpu_torch.ops import losses as tlosses

    mesh, cfg, local, spec, tp_axis = _pipeline_setup(axes, params_np, cfg_kwargs, n_chunks,
                                                      device)
    data_axis = "data" if "data" in axes else None
    opt = ttrainer.sgd(lr, momentum=momentum)
    state = ttrainer.init_train_state(local, opt)
    m = len(tokens)
    if n_chunks:
        step = pipeline.make_interleaved_pipeline_lm_train_step(
            mesh, cfg, opt, m, n_chunks, data_axis=data_axis, tp_axis=tp_axis)
    else:
        step = pipeline.make_pipeline_lm_train_step(mesh, cfg, opt, m, data_axis=data_axis,
                                                    tp_axis=tp_axis)
    rows = _pipeline_rows(tokens, mesh, axes)
    before = (dict(tflash.LAUNCHES), tlosses.LAUNCHES)
    losses = []
    for _ in range(steps):
        state, loss = step(state, rows)
        losses.append(float(loss))
    launches = {k: tflash.LAUNCHES[k] - before[0][k] for k in before[0]}
    launches["xent"] = tlosses.LAUNCHES - before[1]
    return {"losses": losses, "params": tree_np(gather_tree(state["params"], spec, mesh)),
            "opt_spec": ttrainer.opt_state_partition_spec(state["opt_state"], spec,
                                                          state["params"]),
            "step": state["step"], "launches": launches}


def pipeline_apply_case(axes: dict, ws, xs) -> np.ndarray:
    """``pipeline_apply`` of ``y = tanh(x @ w_s)`` stages (``ws`` ``[S, d,
    d]``) over ``axes``, microbatches ``xs`` ``[M, mb, d]``; with a
    ``model`` axis each stage's weight is column-sharded and its outputs
    gathered inside the stage."""
    mesh = cpu_mesh(axes)
    tp = "model" in axes

    def stage_fn(p, x):
        y = x @ p["w"]
        if tp:
            y = collectives.gather(y, -1, mesh.group("model"))
        return torch.tanh(y)

    f = pipeline.pipeline_apply(mesh, stage_fn, params_spec={"w": (None, "model") if tp
                                                              else (None,)})
    local = shard_tree({"w": t(ws)}, f.params_spec, mesh)
    return f(local, t(xs)).numpy()


# -- tensor-parallel serving --------------------------------------------------
def engine_tp_streams(axes: dict, params_np: dict, cfg_kwargs: dict, prompts: list, n_new: int,
                      kv_dtype=None, quantize: bool = False, draft_np=None,
                      draft_kwargs=None, late: bool = False, checkpoint: str = None,
                      spec_k: int = 4, device: str = "cpu", dtype: str = "float32",
                      seed=None, max_len: int = 32) -> dict:
    """``InferenceEngine(mesh=)`` over ``axes`` on ``device`` (float32 by
    default; or ``from_checkpoint(mesh=)`` of ``checkpoint``), prewarmed:
    rank 0 submits ``prompts`` (with ``late``, the second once the first
    has streamed a token) and returns their greedy streams; every other
    rank the streams of the requests it mirrored; with the paged
    wrapper's last dispatch and launches and the engine's counters. With
    ``seed`` the params are made on the device from it instead of
    ``params_np``."""
    from devspace_tpu_torch.inference import InferenceEngine
    from devspace_tpu_torch.inference.quantization import quantize_params
    from devspace_tpu_torch.ops import paged_attention as tpa

    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    mesh = create_mesh(axes, device=device)
    cfg = ttfm.TransformerConfig(**cfg_kwargs, dtype=getattr(torch, dtype))
    kw = dict(max_slots=2, max_len=max_len, mesh=mesh, kv_dtype=kv_dtype, spec_k=spec_k)
    if draft_np is not None:
        kw.update(draft_params=params_from_numpy(draft_np, "cpu"),
                  draft_cfg=ttfm.TransformerConfig(**draft_kwargs, dtype=torch.float32))
    if checkpoint is not None:
        engine = InferenceEngine.from_checkpoint(checkpoint, cfg,
                                                 quantize="int8" if quantize else None, **kw)
    else:
        if seed is None:
            params = params_from_numpy(params_np, "cpu")
        else:
            params = ttfm.init_params(cfg, torch.Generator(device=mesh.device).manual_seed(seed))
        engine = InferenceEngine(quantize_params(params) if quantize else params, cfg, **kw)
        del params
    engine.prewarm()
    captures = engine.stats()["graph_captures"]
    engine.start()
    try:
        if mesh.index("model") == 0:
            reqs = [engine.submit(prompts[0], n_new)]
            if late:
                next(reqs[0].stream(timeout=60))
            reqs += [engine.submit(p, n_new) for p in prompts[1:]]
            streams = [r.result(timeout=120) for r in reqs]
        else:
            try:
                engine.submit(prompts[0], n_new)
                refused = "no error"
            except RuntimeError as e:
                refused = str(e)
    finally:
        engine.stop()
    if mesh.index("model") != 0:
        streams = [list(r.tokens) for r in engine.mirrored]
    stats = engine.stats()
    return {"streams": streams, "dispatch": dict(tpa.LAST_DISPATCH),
            "captures": (captures, stats["graph_captures"]),
            "paged_decode_launches": stats["paged_decode_launches"],
            "decode_steps": stats["decode_steps"],
            "spec_rounds": stats["spec_rounds"],
            "refused": None if mesh.index("model") == 0 else refused,
            "pool_heads": engine.pool["k"].shape[2]}


def engine_tp_indivisible(cfg_kwargs: dict, draft_kwargs=None) -> str:
    from devspace_tpu_torch.inference import InferenceEngine

    mesh = cpu_mesh({"model": -1})
    cfg = ttfm.TransformerConfig(**cfg_kwargs, dtype=torch.float32)
    params = ttfm.init_params(cfg, torch.Generator().manual_seed(0))
    kw = {}
    if draft_kwargs is not None:
        dcfg = ttfm.TransformerConfig(**draft_kwargs, dtype=torch.float32)
        kw = dict(draft_params=ttfm.init_params(dcfg, torch.Generator().manual_seed(1)),
                  draft_cfg=dcfg)
    try:
        InferenceEngine(params, cfg, max_slots=2, max_len=32, mesh=mesh, **kw)
    except ValueError as e:
        return str(e)
    return "no error"


# -- checkpoints on a mesh ----------------------------------------------------
def sharded_restore_case(path: str, axes: dict, cfg_kwargs: dict, quantize: bool = False) -> dict:
    """This rank's blocks of a params checkpoint: through
    ``restore_checkpoint`` into ``sharded_template`` by the TP spec, and
    through ``load_serving_params(mesh=)`` (int8 with ``quantize``)."""
    from devspace_tpu_torch.inference.checkpoint import load_serving_params
    from devspace_tpu_torch.training import checkpoint as tckpt

    mesh = cpu_mesh(axes)
    cfg = ttfm.TransformerConfig(**cfg_kwargs, dtype=torch.float32)
    spec = ttfm.param_partition_spec(cfg, "model")
    template = tckpt.sharded_template(ttfm.init_params(cfg, torch.Generator(), device="meta"),
                                      mesh, spec)
    blocks = tckpt.restore_checkpoint(path, template)
    serving, _ = load_serving_params(path, cfg, mesh=mesh,
                                     quantize="int8" if quantize else None)
    return {"index": mesh.index("model"), "blocks": tree_np(blocks),
            "serving": tree_np(serving)}


def _gathered_moments(opt, params, spec, mesh) -> dict:
    """name -> {state name: the logical moment} of ``opt`` over ``params``."""
    from devspace_tpu_torch.training import checkpoint as tckpt

    names = tckpt.param_names(params, opt)
    specs = tckpt._named_specs(params, spec)
    out = {}
    for i, entry in opt.state_dict()["state"].items():
        out[names[i]] = {k: gather_tensor(v, specs[names[i]], mesh).numpy()
                         if v.dim() else v.numpy() for k, v in entry.items()}
    return out


def mesh_save_case(root: str, kind: str, params_np: dict, cfg_kwargs: dict, tokens,
                   lr: float) -> dict:
    """One AdamW step of a train state sharded over ``pipe`` (the 1F1B
    step) or FSDP's ``data`` (``make_fsdp_train_step``) over every rank,
    then a save from the mesh through ``CheckpointManager(mesh=,
    spec_tree=)`` -> the logical params and moments (gathered here) and
    whether the step directory is complete on this rank after the save."""
    from devspace_tpu_torch.training import checkpoint as tckpt

    mesh = cpu_mesh({"pipe": -1} if kind == "pipe" else {"data": -1})
    cfg = ttfm.TransformerConfig(**cfg_kwargs, dtype=torch.float32)
    params = params_from_numpy(params_np, "cpu", trainable=True)
    opt = ttrainer.adamw(lr)
    if kind == "pipe":
        n = mesh.size("pipe")
        spec = pipeline.pipeline_param_specs("pipe")
        local = shard_tree(pipeline.transformer_stage_params(params, n), spec, mesh)
        state = ttrainer.init_train_state(local, opt)
        step = pipeline.make_pipeline_lm_train_step(mesh, cfg, opt, len(tokens))
        state, _ = step(state, t(tokens))
    else:
        fstep, shards, fopt = fsdp.make_fsdp_train_step(ttrainer.lm_loss(ttfm.forward, cfg),
                                                        opt, mesh, params, min_size=0)
        spec = fsdp.fsdp_spec(params, mesh, min_size=0)
        shards, fopt, _ = fstep(shards, fopt, data_parallel.shard_batch(t(tokens), mesh))
        state = {"params": shards, "opt_state": fopt, "step": 1}
    manager = tckpt.CheckpointManager(root, mesh=mesh, spec_tree=spec)
    path = manager.save(1, state)
    import os

    return {"complete": sorted(os.listdir(path)),
            "params": tree_np(gather_tree(state["params"], spec, mesh)),
            "moments": _gathered_moments(state["opt_state"], state["params"], spec, mesh)}


# -- elastic restore of a train state -------------------------------------------
def elastic_save(root: str, kind: str, params_np: dict, cfg_kwargs: dict, tokens,
                 lr: float) -> dict:
    """One AdamW step of the TINY LM with the train state sharded over
    FSDP's ``data`` (``kind="fsdp"``) or staged over ``pipe`` (the 1F1B
    step, two micro-batches), a save from the mesh to
    ``root/step_00000001``, then the uninterrupted run's next step ->
    that step's loss and the saved logical moments by name."""
    from devspace_tpu_torch.training import checkpoint as tckpt

    mesh = cpu_mesh({"data": -1} if kind == "fsdp" else {"pipe": -1})
    cfg = ttfm.TransformerConfig(**cfg_kwargs, dtype=torch.float32)
    params = params_from_numpy(params_np, "cpu", trainable=True)
    opt = ttrainer.adamw(lr)
    if kind == "fsdp":
        fstep, shards, fopt = fsdp.make_fsdp_train_step(ttrainer.lm_loss(ttfm.forward, cfg), opt,
                                                        mesh, params)
        spec = fsdp.fsdp_spec(params, mesh)
        rows = data_parallel.shard_batch(t(tokens), mesh)

        def step(state, rows):
            shards, fopt, loss = fstep(state["params"], state["opt_state"], rows)
            return {"params": shards, "opt_state": fopt, "step": state["step"] + 1}, loss

        state = {"params": shards, "opt_state": fopt, "step": 0}
    else:
        spec = pipeline.pipeline_param_specs("pipe")
        local = shard_tree(pipeline.transformer_stage_params(params, mesh.size("pipe")), spec,
                           mesh)
        state = ttrainer.init_train_state(local, opt)
        rows = t(tokens.reshape(2, -1, tokens.shape[-1]))
        step = pipeline.make_pipeline_lm_train_step(mesh, cfg, opt, 2)
    state, _ = step(state, rows)
    tckpt.save_checkpoint(f"{root}/step_00000001", state, mesh=mesh, spec_tree=spec)
    moments = {name: {k: v.copy() for k, v in entry.items()}  # before the next step moves them
               for name, entry in _gathered_moments(state["opt_state"], state["params"], spec,
                                                    mesh).items()}
    _, loss = step(state, rows)
    return {"loss": float(loss), "moments": moments}


def elastic_restore(path: str, axis: str, cfg_kwargs: dict, tokens, lr: float) -> dict:
    """The saved train state restored with every rank on ``axis`` through
    a train-state ``sharded_template`` (``model``: ``{"data": 1, "model":
    -1}``, the TP spec and the mesh step; ``data``: FSDP's spec and
    step), then one step -> its loss, the step restored, each
    parameter's spec and this rank's moment blocks."""
    from devspace_tpu_torch.training import checkpoint as tckpt

    mesh = cpu_mesh({"data": 1, "model": -1} if axis == "model" else {"data": -1})
    cfg = ttfm.TransformerConfig(**cfg_kwargs, dtype=torch.float32)
    logical = ttfm.init_params(cfg, torch.Generator(), device="meta")
    opt = ttrainer.adamw(lr)
    if axis == "model":
        spec = ttfm.param_partition_spec(cfg, "model")
    else:
        spec = fsdp.fsdp_spec(logical, mesh)
    template = tckpt.sharded_template({"params": logical, "opt_state": opt, "step": 0}, mesh,
                                      spec)
    state = tckpt.restore_checkpoint(path, template)
    names = tckpt.param_names(state["params"], state["opt_state"])
    specs = tckpt._named_specs(state["params"], spec)
    moments = {names[i]: {k: v.numpy().copy() for k, v in entry.items()}
               for i, entry in state["opt_state"].state_dict()["state"].items()}
    restored_step = state["step"]
    rows = data_parallel.shard_batch(t(tokens), mesh)
    if axis == "model":
        step = ttrainer.make_lm_train_step(ttfm.forward, cfg, opt, mesh=mesh, param_spec=spec)
        state, loss = step(state, rows)
    else:
        fstep, _, _ = fsdp.make_fsdp_train_step(
            ttrainer.lm_loss(ttfm.forward, cfg), opt, mesh,
            ttfm.init_params(cfg, torch.Generator().manual_seed(0)))
        _, _, loss = fstep(state["params"], state["opt_state"], rows)
    return {"index": mesh.index(axis), "loss": float(loss), "step": restored_step,
            "moments": moments, "specs": {n: tuple(s) for n, s in specs.items()}}


# -- the host KV tier under tensor-parallel serving ------------------------------
TIER_KEYS = ("kv_spill_blocks", "kv_spill_bytes", "kv_restore_hits", "kv_restore_fallbacks",
             "recompute_tokens_saved", "prefix_hit_tokens", "kv_tier_spilled_nodes",
             "kv_tier_remote_nodes", "kv_migrate_chains", "kv_migrate_blocks",
             "kv_migrate_bytes", "kv_migrate_failures", "kv_export_chains", "requests_failed")


def engine_tp_tier(params_np: dict, cfg_kwargs: dict, reqs: list, waves: list, engine_kw: dict,
                   tier: str, tier_dir=None, exports=(), pulls=()) -> dict:
    """``InferenceEngine(mesh={"model": all ranks})`` with the host KV tier
    ``tier`` (the disk level under ``tier_dir``), float32, prewarmed:
    rank 0 serves ``reqs`` in ``waves`` (each wave finishing before the
    next), then each request of ``pulls`` (with its ``kv_source``)
    alone, then exports the KVM1 chain of each prompt of ``exports``
    through the running schedulers -> the streams (rank 0's, or those the rank
    mirrored), the tier and migration counters, the envelopes (rank 0),
    the graph captures before and after the traffic, and the pool's KV
    heads on this rank."""
    from devspace_tpu_torch.inference import InferenceEngine
    from devspace_tpu_torch.inference.prefix_cache import fingerprint_chain

    mesh = cpu_mesh({"model": -1})
    cfg = ttfm.TransformerConfig(**cfg_kwargs, dtype=torch.float32)
    kw = dict(engine_kw, mesh=mesh, kv_tier=tier)
    if tier_dir is not None:
        kw["kv_tier_dir"] = f"{tier_dir}/rank{dist.get_rank()}"
    engine = InferenceEngine(params_from_numpy(params_np, "cpu"), cfg, **kw)
    engine.prewarm()
    captures = engine.stats()["graph_captures"]
    engine.start()
    leader = mesh.index("model") == 0
    streams, envelopes = [], []
    try:
        if leader:
            for lo, hi in waves:
                handles = [engine.submit(**r) for r in reqs[lo:hi]]
                streams.extend(h.result(timeout=120) for h in handles)
            for r in pulls:
                streams.append(engine.submit(**r).result(timeout=120))
            envelopes = [engine.export_kv_chain(fingerprint_chain(p, kw["block_size"])[-1],
                                                timeout=60) for p in exports]
    finally:
        engine.stop()
    if not leader:
        streams = [list(r.tokens) for r in engine.mirrored]
    st = engine.stats()
    return {"streams": streams, "stats": {k: st[k] for k in TIER_KEYS},
            "envelopes": envelopes, "captures": (captures, st["graph_captures"]),
            "pool_heads": engine.pool["k"].shape[2], "tier_entries": st["kv_tier_entries"]}
