"""parallel/ on the card, at one rank of NCCL (marked ``cuda``; they skip
on a machine without one, and import no JAX).

    python -m pytest -m cuda tests/test_torch_parallel_cuda.py

One H100 holds one NCCL rank (two processes on one card do not form an
NCCL group: "Duplicate GPU detected", PERF.md), so these run the
mesh paths' real code at world 1 with their collectives on NCCL; the
multi-rank semantics are held on the CPU by the gloo tests
(``tests/test_torch_parallel_*.py``). At one rank the mesh steps do the
plain steps' operations on the same values: losses and updates within
``1e-3`` relative (the loss's reduction order); ring attention and
Ulysses against the flash kernel within ``1e-2`` of each head's largest
value (bf16: one rounding of P and dS apart, as the kernels' own card
tests hold them); ``moe_ffn`` against ``moe_ffn_reference`` within one
bf16 rounding of the largest output; the vocab-parallel loss against the
loss kernel ``rtol=atol=1e-5`` (float32).

On a machine with four cards the multi-card
tests run the mesh paths across them, one NCCL rank a card (a world of
spawned processes, ``torch_parallel_world.World(4, ..., "nccl")``), in
float32 with TF32 off, against the plain step on one card: the composed
``{"data": 1, "model": 2, "seq": 2}`` step with ring attention and the
vocab-parallel loss, ``{"data": 2, "seq": 2}`` with Ulysses, ``{"data":
2, "model": 2}`` with the fused loss over gathered logits; ``moe_ffn``
over four cards; FSDP. Tolerances as the CPU tests': the loss within
1e-5 relative, each gradient leaf within 1e-4 of its largest reference
value, outputs ``rtol=1e-5, atol=1e-6``. With fewer cards they skip.

Part 2 (pipelines and tensor-parallel serving). At one rank: the 1F1B
and interleaved (V = 2) steps against the plain step (losses within
``1e-3``; first-step gradients within ``2e-2`` of each leaf's largest
value: bf16, the microbatches' gradients summed in float32 and rounded
once, the batch's rounded once), their flash and loss launches as the
schedule predicts; the engine over ``mesh={"model": 1}`` against the
plain engine, greedy streams equal token for token (an all-reduce and a
gather over one rank change no bit), ``LAST_DISPATCH`` ``{"impl":
"cuda", "tp": True}``, captures flat after ``prewarm``, the same
paged-decode launches a step. On four cards: 1F1B at ``pipe = 4`` (the
bench LM's widths, 2 layers a stage), ``{"pipe": 2, "model": 2}``, the
interleaved step at ``pipe = 4``, V = 2, each in float32 against the
plain step on card 0 (loss within 1e-5, gradients within 1e-4 of each
leaf's largest); the engine at ``model = 4`` at Llama-2-7B's widths in
float32 with 4 layers against the one-card engine, greedy streams equal
on tie-free prompts; the full bf16 Llama-2-7B at ``model = 4``, its
token agreement with the one-card engine printed (``-s``).
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from devspace_tpu_torch.models import transformer as tfm
from devspace_tpu_torch.ops import flash_attention as fa
from devspace_tpu_torch.ops import losses as xl
from devspace_tpu_torch.parallel import expert_parallel as tep
from devspace_tpu_torch.parallel import fsdp
from devspace_tpu_torch.ops import paged_attention as pa
from devspace_tpu_torch.parallel import mesh as pmesh
from devspace_tpu_torch.parallel import pipeline as tpipe
from devspace_tpu_torch.parallel.data_parallel import shard_batch
from devspace_tpu_torch.parallel.ring_attention import ring_attention
from devspace_tpu_torch.parallel.sequence_parallel import ulysses_attention
from devspace_tpu_torch.inference import InferenceEngine
from devspace_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from devspace_tpu_torch.training import trainer as ttrainer
import torch_parallel_workers as w
from torch_parallel_world import World

pytestmark = pytest.mark.cuda

CFG = dataclasses.replace(tfm.TINY, dim=256, n_heads=4, n_kv_heads=4, ffn_dim=512,
                          vocab_size=1024, max_seq_len=2048)
REL = 1e-3
HEAD_REL = 1e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture
def world(dev):
    with pmesh.distributed(dev):
        assert dist.get_backend() == "nccl"
        yield dev


def trainable(params, dev):
    return ttrainer.tree_like(params, [p.detach().to(dev, copy=True).requires_grad_()
                                       for p in ttrainer.param_leaves(params)])


def run_steps(step, state, batches):
    losses = []
    for b in batches:
        state, loss = step(state, b)
        losses.append(loss.item())
    return state, losses


def update_err(before, a, b):
    worst = 0.0
    for p0, x, y in zip(*(ttrainer.param_leaves(t) for t in (before, a, b))):
        dx, dy = x.detach().float() - p0.float(), y.detach().float() - p0.float()
        worst = max(worst, ((dy - dx).abs().max() / dx.abs().max().clamp_min(1e-30)).item())
    return worst


def test_mesh_and_fsdp_lm_steps_equal_the_plain_step(world):
    dev = world
    base = tfm.init_params(CFG, torch.Generator(device=dev).manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(1)
    batches = [torch.randint(0, CFG.vocab_size, (2, 1281), generator=g, device=dev)
               for _ in range(2)]
    opt = ttrainer.adamw(3e-4)
    plain = ttrainer.make_lm_train_step(tfm.forward, CFG, opt)
    p_state, p_losses = run_steps(plain, ttrainer.init_train_state(trainable(base, dev), opt),
                                  batches)
    mesh = pmesh.create_mesh({"data": 1, "model": 1}, dev)
    spec = tfm.param_partition_spec(CFG)
    step = ttrainer.make_lm_train_step(tfm.forward, CFG, opt, mesh=mesh, param_spec=spec)
    before = dict(fa.LAUNCHES), xl.LAUNCHES
    m_state, m_losses = run_steps(step, ttrainer.init_train_state(
        pmesh.shard_tree(trainable(base, dev), spec, mesh), opt),
        [shard_batch(b, mesh) for b in batches])
    assert fa.LAUNCHES["fwd"] - before[0]["fwd"] == CFG.n_layers * 2
    assert xl.LAUNCHES - before[1] == 2
    assert max(abs(a - b) / abs(a) for a, b in zip(p_losses, m_losses)) <= REL
    assert update_err(base, p_state["params"], m_state["params"]) <= REL

    fstep, shards, fopt = fsdp.make_fsdp_train_step(ttrainer.lm_loss(tfm.forward, CFG), opt,
                                                    mesh, trainable(base, dev))
    f_losses = []
    for b in batches:
        shards, fopt, loss = fstep(shards, fopt, shard_batch(b, mesh))
        f_losses.append(loss.item())
    full = pmesh.gather_tree(shards, fsdp.fsdp_spec(base, mesh), mesh)
    assert max(abs(a - b) / abs(a) for a, b in zip(p_losses, f_losses)) <= REL
    assert update_err(base, p_state["params"], full) <= REL


def grads_within(ref: list, got: list, rel: float) -> float:
    worst = 0.0
    for r, g in zip(ref, got, strict=True):
        worst = max(worst, ((g.float() - r.float()).abs().max() / r.float().abs().max()).item())
    assert worst <= rel, worst
    return worst


@pytest.mark.parametrize("n_chunks", [0, 2], ids=["1f1b", "interleaved"])
def test_pipeline_steps_at_one_rank_equal_the_plain_step(world, n_chunks):
    dev = world
    m, steps = 2, 2
    base = tfm.init_params(CFG, torch.Generator(device=dev).manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(1)
    batches = [torch.randint(0, CFG.vocab_size, (2, 1281), generator=g, device=dev)
               for _ in range(steps)]
    opt = ttrainer.adamw(3e-4)
    plain_params = trainable(base, dev)
    plain = ttrainer.make_lm_train_step(tfm.forward, CFG, opt)
    p_state, p_losses = run_steps(plain, ttrainer.init_train_state(plain_params, opt), batches[:1])
    plain_grads = [p.grad.clone() for p in ttrainer.param_leaves(plain_params)]
    _, more = run_steps(plain, p_state, batches[1:])
    p_losses += more

    mesh = pmesh.create_mesh({"pipe": 1}, dev)
    params = trainable(base, dev)
    if n_chunks:
        staged = tpipe.transformer_interleaved_stage_params(params, 1, n_chunks)
        spec = tpipe.interleaved_param_specs()
        step = tpipe.make_interleaved_pipeline_lm_train_step(mesh, CFG, opt, m, n_chunks)
        unstage = tpipe.transformer_uninterleave_params
    else:
        staged = tpipe.transformer_stage_params(params, 1)
        spec = tpipe.pipeline_param_specs()
        step = tpipe.make_pipeline_lm_train_step(mesh, CFG, opt, m)
        unstage = tpipe.transformer_unstage_params
    state = ttrainer.init_train_state(pmesh.shard_tree(staged, spec, mesh), opt)
    before = dict(fa.LAUNCHES), xl.LAUNCHES
    state, first = step(state, batches[0].view(m, -1, batches[0].shape[-1]))
    local = ttrainer.param_leaves(state["params"])
    grads = ttrainer.param_leaves(unstage(ttrainer.tree_like(state["params"],
                                                             [p.grad.clone() for p in local])))
    _, more = run_steps(step, state, [b.view(m, -1, b.shape[-1]) for b in batches[1:]])
    losses = [first.item()] + more
    # each microbatch and layer: a forward at F, again at B, one backward
    assert fa.LAUNCHES["fwd"] - before[0]["fwd"] == 2 * m * CFG.n_layers * steps
    assert fa.LAUNCHES["bwd_dq"] - before[0]["bwd_dq"] == m * CFG.n_layers * steps
    assert fa.LAUNCHES["bwd_dkv"] - before[0]["bwd_dkv"] == m * CFG.n_layers * steps
    assert xl.LAUNCHES - before[1] == m * steps
    assert max(abs(a - b) / abs(a) for a, b in zip(p_losses, losses)) <= REL
    grads_within(plain_grads, grads, 2e-2)


SERVE_CFG = dataclasses.replace(tfm.TINY, dim=512, n_heads=8, n_kv_heads=4, ffn_dim=1024,
                                vocab_size=1024, n_layers=2, max_seq_len=512)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_tp_engine_at_one_rank_equals_the_plain_engine(world, kv_dtype):
    dev = world
    params = tfm.init_params(SERVE_CFG, torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, SERVE_CFG.vocab_size, n).tolist() for n in (5, 40, 90, 130)]

    def serve(engine):
        engine.prewarm()
        captures = engine.stats()["graph_captures"]
        engine.start()
        try:
            out = [h.result(timeout=120) for h in [engine.submit(p, 24) for p in prompts]]
        finally:
            engine.stop()
        st = engine.stats()
        assert st["graph_captures"] == captures > 0 and st["requests_failed"] == 0
        return out, st["paged_decode_launches"] / st["decode_steps"]

    plain, plain_per_step = serve(InferenceEngine(params, SERVE_CFG, device=dev, max_slots=4,
                                                  max_len=256, kv_dtype=kv_dtype))
    mesh = pmesh.create_mesh({"model": 1}, dev)
    got, per_step = serve(InferenceEngine(params, SERVE_CFG, mesh=mesh, max_slots=4,
                                          max_len=256, kv_dtype=kv_dtype))
    assert pa.LAST_DISPATCH == {"impl": "cuda", "tp": True}
    assert got == plain
    assert per_step == plain_per_step == SERVE_CFG.n_layers


def head_rel(got, ref):
    b, t, h, d = ref.shape
    rows = lambda x: x.float().transpose(1, 2).reshape(b * h, -1)
    return ((rows(got) - rows(ref)).abs().amax(-1) / rows(ref).abs().amax(-1)).max().item()


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_ring_and_ulysses_match_the_flash_kernel(world, kind):
    dev = world
    mesh = pmesh.create_mesh({"seq": 1}, dev)
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v, do = (torch.randn((1, 2048, 8, 128), generator=g, device=dev, dtype=torch.bfloat16)
                   for _ in range(4))
    fn = (ring_attention(mesh, "seq", causal=True, block_size=512) if kind == "ring"
          else ulysses_attention(mesh, "seq", causal=True))

    def run(f):
        qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
        out = f(qq, kk, vv)
        out.backward(do)
        return out.detach(), qq.grad, kk.grad, vv.grad

    before = fa.LAUNCHES["fwd"]
    flash = run(tfm.default_attention)
    assert fa.LAUNCHES["fwd"] == before + 1
    got = run(fn)
    for part, x, ref in zip(("o", "dq", "dk", "dv"), got, flash):
        assert head_rel(x, ref) <= HEAD_REL, part


def test_moe_ffn_equals_the_dense_reference(world):
    dev = world
    mesh = pmesh.create_mesh({"data": 1}, dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    params = tep.init_moe_params(gen, 512, 2 * 1024, 8)  # fused gate | up for SwiGLU
    params["w_down"] = (0.02 * torch.randn((8, 1024, 512), generator=gen, device=dev)).to(
        torch.bfloat16)
    x = torch.randn((1024, 512), generator=torch.Generator(device=dev).manual_seed(4),
                    device=dev).to(torch.bfloat16)
    layer = tep.moe_ffn(mesh, "data", k=2, capacity_factor=2.0, activation=tep.swiglu)
    y, aux = layer(x, tep.shard_moe_params(params, mesh))
    y_ref, aux_ref = tep.moe_ffn_reference(x, params, k=2, capacity_factor=2.0,
                                           activation=tep.swiglu)
    bound = 2.0 ** -8 * y_ref.float().abs().max().item()
    assert (y.float() - y_ref.float()).abs().max().item() <= bound
    assert abs(aux.item() - aux_ref.item()) <= 1e-6


def test_vocab_parallel_loss_equals_the_loss_kernel(world):
    dev = world
    mesh = pmesh.create_mesh({"model": 1}, dev)
    g = torch.Generator(device=dev).manual_seed(5)
    logits = 3 * torch.randn((512, 32000), generator=g, device=dev)
    labels = torch.randint(0, 32000, (512,), generator=g, device=dev)
    got = xl.vocab_parallel_cross_entropy(mesh, "model")(logits, labels)
    torch.testing.assert_close(got, xl.fused_cross_entropy(logits, labels), rtol=1e-5,
                               atol=1e-5)


def test_a_mesh_on_the_card_over_gloo_raises(dev, tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        with pytest.raises(ValueError, match="needs the nccl backend"):
            pmesh.create_mesh(device=dev)
    finally:
        dist.destroy_process_group()


# -- across four cards ---------------------------------------------------------
CARDS_CFG = dict(vocab_size=1024, dim=256, n_layers=2, n_heads=8, n_kv_heads=4, ffn_dim=512,
                 max_seq_len=1024)


@pytest.fixture(scope="module")
def cards(tmp_path_factory):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs")
    world = World(4, tmp_path_factory.mktemp("nccl"), backend="nccl")
    yield world
    world.close()


def plain_lm_step(params_np, tokens, lr):
    """The step without a mesh on card 0, float32 with TF32 off -> (loss,
    params after, gradients) as numpy trees."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = tfm.TransformerConfig(**CARDS_CFG, dtype=torch.float32)
    params = params_from_numpy(params_np, dev, trainable=True)
    opt = ttrainer.sgd(lr, momentum=0.0)
    step = ttrainer.make_lm_train_step(tfm.forward, cfg, opt)
    state, loss = step(ttrainer.init_train_state(params, opt), torch.from_numpy(tokens).to(dev))
    grads = ttrainer.tree_like(params, [p.grad for p in ttrainer.param_leaves(params)])
    return loss.item(), params_to_numpy(state["params"]), params_to_numpy(grads)


def leaves_close(ref, got, rel):
    for r, g in zip(ttrainer.param_leaves(ref), ttrainer.param_leaves(got), strict=True):
        r, g = np.asarray(r, np.float64), np.asarray(g, np.float64)
        assert np.abs(g - r).max() <= rel * np.abs(r).max()


@pytest.mark.parametrize("axes, attention, vocab_parallel", [
    ({"data": 1, "model": 2, "seq": 2}, "ring", True),
    ({"data": 2, "seq": 2}, "ulysses", False),
    ({"data": 2, "model": 2}, "default", False),
])
def test_mesh_lm_step_across_four_cards_equals_one_card(cards, axes, attention, vocab_parallel):
    cfg = tfm.TransformerConfig(**CARDS_CFG, dtype=torch.float32)
    params_np = params_to_numpy(tfm.init_params(cfg, torch.Generator().manual_seed(0)))
    tokens = np.random.default_rng(1).integers(0, CARDS_CFG["vocab_size"], size=(4, 513))
    loss, _, grads = plain_lm_step(params_np, tokens, 1e-2)
    for r in cards.run(w.lm_mesh_step, axes, params_np, CARDS_CFG, tokens, 1, 1e-2,
                       vocab_parallel, attention, 0.0, 512, "cuda"):
        assert abs(r["losses"][0] - loss) <= 1e-5 * abs(loss)
        leaves_close(grads, r["grads"], 1e-4)


def test_moe_ffn_across_four_cards_equals_the_dense_reference(cards, monkeypatch):
    """Against ``moe_ffn_reference`` of each card's tokens on card 0 (the
    same device type, so the same router logits): the routing (``_route``'s
    dispatch, read in both) identical, dropped rows equal, outputs within
    float32's ``rtol=atol=1e-5`` (the experts' products batched otherwise:
    ``[E/4, 4C, D]`` against ``[E, C, D]``). A failure names the rows off,
    which of them were routed otherwise, and their top-2 router gap; the
    printed line says how many rows the CPU routes otherwise than the
    card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    t, d, f, e = 256, 64, 128, 8
    gen = torch.Generator().manual_seed(3)
    params = {"w_gate": torch.randn(d, e, generator=gen),
              "w_up": torch.randn(e, d, 2 * f, generator=gen) * d ** -0.5,
              "w_down": torch.randn(e, f, d, generator=gen) * f ** -0.5}
    x = torch.randn(t, d, generator=gen)
    on_card = {k: v.cuda() for k, v in params.items()}
    top2 = torch.softmax(x.cuda() @ on_card["w_gate"], -1).topk(2).values.cpu().numpy()
    gap = top2[:, 0] - top2[:, 1]
    routes, route = [], tep._route
    monkeypatch.setattr(tep, "_route", lambda *a: routes.append(route(*a)) or routes[-1])

    def reference(xs, p, cf):
        """(y, dispatch) of the dense reference, each of the four shards alone."""
        del routes[:]
        ys = [tep.moe_ffn_reference(s, p, k=2, capacity_factor=cf, activation=tep.swiglu)[0]
              for s in xs.chunk(4)]
        return (torch.cat(ys).cpu().numpy(),
                torch.cat([r[0] for r in routes]).cpu().numpy())

    for cf in (8.0, 0.5):  # no drops, then drops: capacity per card, as the reference's
        got = cards.run(w.moe_ffn_case, {k: v.numpy() for k, v in params.items()}, x.numpy(), 2,
                        cf, "swiglu", "cuda")
        ref, ref_route = reference(x.cuda(), on_card, cf)
        _, cpu_route = reference(x, params, cf)
        cpu_rows = np.flatnonzero(np.any(cpu_route != ref_route, axis=(1, 2)))
        dropped = int(np.all(ref == 0, axis=1).sum())
        print(f"moe_ffn over four cards, capacity factor {cf}: {dropped} of {t} rows dropped; "
              f"the CPU routes {cpu_rows.size} rows otherwise than the card "
              f"(top-2 gaps {gap[cpu_rows].tolist()})")
        for r in got:
            routed = np.flatnonzero(np.any(r["dispatch"] != ref_route, axis=(1, 2)))
            off = np.flatnonzero(~np.isclose(r["y"], ref, rtol=1e-5, atol=1e-5).all(axis=1))
            msg = (f"capacity factor {cf}: rows off {off.tolist()}; routed otherwise "
                   f"{routed.tolist()}; top-2 gaps of the rows off {gap[off].tolist()}")
            assert routed.size == 0, msg
            np.testing.assert_array_equal(np.all(r["y"] == 0, axis=1), np.all(ref == 0, axis=1),
                                          err_msg=msg)
            np.testing.assert_allclose(r["y"], ref, rtol=1e-5, atol=1e-5, err_msg=msg)


def test_fsdp_across_four_cards_equals_one_card(cards):
    rng = np.random.default_rng(0)
    params = {"w1": (rng.standard_normal((16, 64)) * 0.1).astype(np.float32),
              "w2": (rng.standard_normal((64, 4)) * 0.1).astype(np.float32),
              "b": np.zeros(4, np.float32)}
    xs = rng.standard_normal((32, 16)).astype(np.float32)
    ys = rng.standard_normal((32, 4)).astype(np.float32)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    p = {k: torch.tensor(v, device=dev, requires_grad=True) for k, v in params.items()}
    opt = ttrainer.adam(1e-2)(list(p.values()))
    batch = {"x": torch.from_numpy(xs).to(dev), "y": torch.from_numpy(ys).to(dev)}
    losses = []
    for _ in range(2):
        opt.zero_grad()
        loss = w._fsdp_loss(p, batch)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    for r in cards.run(w.fsdp_case, params, xs, ys, 1e-2, 64, 2, "cuda"):
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
        for k in params:
            np.testing.assert_allclose(r["params"][k], p[k].detach().cpu().numpy(), rtol=1e-5,
                                       atol=1e-6)


# -- part 2 across four cards --------------------------------------------------
BENCH_WIDTHS = dict(vocab_size=32000, dim=1024, n_layers=8, n_heads=16, n_kv_heads=16,
                    ffn_dim=4096, max_seq_len=2048)


def plain_grads(cfg_kwargs, params_np, tokens):
    """The loss and gradients without a pipeline on card 0 (float32, TF32
    off), the microbatches flattened into one batch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = tfm.TransformerConfig(**cfg_kwargs, dtype=torch.float32)
    params = params_from_numpy(params_np, dev, trainable=True)
    flat = torch.from_numpy(tokens.reshape(-1, tokens.shape[-1])).to(dev)
    loss = ttrainer.lm_loss(tfm.forward, cfg)(params, flat)
    loss.backward()
    grads = ttrainer.tree_like(params, [p.grad for p in ttrainer.param_leaves(params)])
    return loss.item(), params_to_numpy(grads)


@pytest.mark.parametrize("axes, n_chunks", [({"pipe": 4}, 0), ({"pipe": 2, "model": 2}, 0),
                                            ({"pipe": 4}, 2)],
                         ids=["1f1b-pipe4", "1f1b-pipe2-model2", "interleaved-pipe4"])
def test_pipeline_across_four_cards_equals_one_card(cards, axes, n_chunks):
    cfg = tfm.TransformerConfig(**BENCH_WIDTHS, dtype=torch.float32)
    params_np = params_to_numpy(tfm.init_params(cfg, torch.Generator().manual_seed(0)))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(4, 1, 1281))
    loss, grads = plain_grads(BENCH_WIDTHS, params_np, tokens)
    unstage = (tpipe.transformer_uninterleave_params if n_chunks
               else tpipe.transformer_unstage_params)
    for r in cards.run(w.pipeline_loss_grads, axes, params_np, BENCH_WIDTHS, tokens, n_chunks,
                       "cuda", timeout=600):
        assert abs(r["loss"] - loss) <= 1e-5 * abs(loss)
        leaves_close(grads, unstage(r["grads"]), 1e-4)
        # each rank's layers: a flash forward per microbatch at F and at B
        layers = BENCH_WIDTHS["n_layers"] // axes["pipe"]
        assert r["flash_fwd_launches"] == 2 * len(tokens) * layers


LLAMA_WIDTHS_4L = dict(vocab_size=32000, dim=4096, n_layers=4, n_heads=32, n_kv_heads=32,
                       ffn_dim=11008, max_seq_len=512)


def one_card_streams(cfg_kwargs, dtype, prompts, n_new, seed=0):
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = tfm.TransformerConfig(**cfg_kwargs, dtype=dtype)
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
    engine = InferenceEngine(params, cfg, device=dev, max_slots=2, max_len=256).start()
    try:
        return [engine.submit(p, n_new).result(timeout=300) for p in prompts]
    finally:
        engine.stop()
        del engine, params
        torch.cuda.empty_cache()


def test_tp_engine_across_four_cards_equals_one_card(cards):
    """Llama-2-7B's widths, 4 layers, float32: greedy streams equal the
    one-card engine's on tie-free prompts."""
    prompts = [[5, 1, 4], [2, 2, 2, 2, 2], list(range(10, 40))]
    ref = one_card_streams(LLAMA_WIDTHS_4L, torch.float32, prompts, 16)
    got = cards.run(w.engine_tp_streams, {"model": 4}, None, LLAMA_WIDTHS_4L, prompts, 16,
                    None, False, None, None, False, None, 4, "cuda", "float32", 0, 256,
                    timeout=900)
    for r in got:
        assert r["streams"] == ref
        assert r["dispatch"] == {"impl": "cuda", "tp": True}
        assert r["captures"][0] == r["captures"][1]
        assert r["pool_heads"] == 8
        assert r["paged_decode_launches"] == LLAMA_WIDTHS_4L["n_layers"] * r["decode_steps"] > 0


def test_bf16_llama2_7b_across_four_cards_reports_token_agreement(cards):
    cfg_kwargs = dict(vocab_size=32000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=32,
                      ffn_dim=11008, max_seq_len=4096)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 32000, n).tolist() for n in (7, 64, 200)]
    ref = one_card_streams(cfg_kwargs, torch.bfloat16, prompts, 32)
    got = cards.run(w.engine_tp_streams, {"model": 4}, None, cfg_kwargs, prompts, 32, None,
                    False, None, None, False, None, 4, "cuda", "bfloat16", 0, 256, timeout=1200)
    streams = got[0]["streams"]
    same = sum(a == b for r, s in zip(ref, streams) for a, b in zip(r, s))
    first_diff = [next((i for i, (a, b) in enumerate(zip(r, s)) if a != b), None)
                  for r, s in zip(ref, streams)]
    print(f"bf16 Llama-2-7B at model = 4 against one card: {same}/{sum(map(len, ref))} "
          f"tokens agree; first divergence per stream {first_diff}")
    assert all(r["streams"] == streams for r in got)  # every rank samples the same
    assert all(r["dispatch"] == {"impl": "cuda", "tp": True} and r["paged_decode_launches"] > 0
               for r in got)
    assert all(s[0] == r[0] for r, s in zip(ref, streams))
