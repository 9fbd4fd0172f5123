"""The port's checkpoints (devspace_tpu_torch/training/checkpoint.py) and
the train -> serve seam (inference/checkpoint.py,
``InferenceEngine.from_checkpoint``), on the CPU at TINY.

Checkpoints round-trip byte for byte (bf16 and float32); a save's
temporary sibling is never listed; retention keeps the newest
``max_to_keep``; an asynchronous save commits, also when a step raises;
a run resumed from a checkpoint equals an uninterrupted one bit for bit,
Adam state included; a restore of the params alone never opens the
optimizer's file; and the serving loader picks steps, takes one
directory, refuses a missing step or a wrong config, and quantizes."""

import dataclasses
import os

import pytest
import torch

from devspace_tpu_torch.inference import InferenceEngine, load_serving_params
from devspace_tpu_torch.inference.quantization import QuantizedLinear, quantize_weight
from devspace_tpu_torch.models import transformer as tfm
from devspace_tpu_torch.training import checkpoint as ckpt
from devspace_tpu_torch.training import trainer

CFG = tfm.TINY
F32 = dataclasses.replace(tfm.TINY, dtype=torch.float32)
PROMPTS = [[5, 1, 4], [2, 2, 2, 2, 2]]


def init_state(cfg=CFG, seed=0):
    params = tfm.init_params(cfg, torch.Generator().manual_seed(seed))
    for p in trainer.param_leaves(params):
        p.requires_grad_()
    return trainer.init_train_state(params, trainer.adamw(1e-2))


def batches(start, stop, cfg=CFG):
    return [torch.randint(1, cfg.vocab_size, (2, 17), generator=torch.Generator().manual_seed(s))
            for s in range(start, stop)]


def assert_bytes_equal(a, b):
    for x, y in zip(trainer.param_leaves(a), trainer.param_leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.detach().contiguous().view(torch.uint8),
                           y.detach().contiguous().view(torch.uint8))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """TINY trained 6 steps, checkpointed every 3 (keeping 2) -> (root,
    the in-memory trained params)."""
    root = tmp_path_factory.mktemp("train_ckpt")
    state = init_state()
    step_fn = trainer.make_lm_train_step(tfm.forward, CFG, None)
    mgr = ckpt.CheckpointManager(str(root), save_interval=3, max_to_keep=2)
    state, loss = trainer.train_loop(step_fn, state, batches(0, 6), checkpoint_manager=mgr)
    assert torch.isfinite(loss)
    return str(root), state["params"]


@pytest.mark.parametrize("cfg", [CFG, F32], ids=["bf16", "f32"])
def test_save_restore_is_byte_equal(tmp_path, cfg):
    params = tfm.init_params(cfg, torch.Generator().manual_seed(3))
    ckpt.save_checkpoint(str(tmp_path / "c"), params)
    meta = ckpt.read_meta(str(tmp_path / "c"))
    assert meta["kind"] == "params" and meta["leaves"]["layers.1.wq"]["dtype"] == str(
        cfg.dtype).removeprefix("torch.")
    assert sorted(os.listdir(tmp_path / "c")) == ["meta.json", "params.pt"]
    assert_bytes_equal(ckpt.restore_checkpoint(str(tmp_path / "c")), params)
    with pytest.raises(FileExistsError):
        ckpt.save_checkpoint(str(tmp_path / "c"), params, force=False)
    ckpt.save_checkpoint(str(tmp_path / "c"), params)  # force replaces in place
    assert_bytes_equal(ckpt.restore_checkpoint(str(tmp_path / "c")), params)


def test_train_state_round_trips(tmp_path):
    state = init_state()
    step_fn = trainer.make_lm_train_step(tfm.forward, CFG, None)
    state, _ = trainer.train_loop(step_fn, state, batches(0, 2))
    ckpt.save_checkpoint(str(tmp_path / "s"), state)
    back = ckpt.restore_checkpoint(str(tmp_path / "s"))
    assert back["step"] == 2 and set(back) == {"params", "opt_state", "step"}
    assert_bytes_equal(back["params"], state["params"])
    want = state["opt_state"].state_dict()["state"]
    for i, entry in want.items():
        for key, value in entry.items():
            assert torch.equal(back["opt_state"]["state"][i][key], value)


def test_temporary_sibling_is_ignored(tmp_path):
    params = tfm.init_params(CFG, torch.Generator().manual_seed(0))
    mgr = ckpt.CheckpointManager(str(tmp_path), save_interval=1)
    mgr.save(4, params)
    (tmp_path / "step_00000009.tmp-123-456").mkdir()  # a save cut off mid-write
    (tmp_path / "notes").mkdir()
    assert mgr.all_steps() == [4] and mgr.latest_step() == 4
    assert ckpt.latest_step_dir(str(tmp_path)).endswith("step_00000004")
    assert ckpt.list_step_dirs(str(tmp_path / "missing")) == []
    assert load_serving_params(str(tmp_path), CFG, device="cpu")[1] == 4


def test_retention_and_maybe_save(tmp_path):
    params = tfm.init_params(CFG, torch.Generator().manual_seed(0))
    mgr = ckpt.CheckpointManager(str(tmp_path), save_interval=2, max_to_keep=2)
    written = [mgr.maybe_save(s, params) for s in range(1, 8)]
    assert [w is not None for w in written] == [False, True, False, True, False, True, False]
    assert mgr.all_steps() == [4, 6]
    with pytest.raises(FileNotFoundError):
        ckpt.CheckpointManager(str(tmp_path / "empty")).restore()


@pytest.mark.parametrize("fail", [False, True], ids=["clean", "step_raises"])
def test_async_save_commits(tmp_path, fail):
    """An asynchronous save is written on a thread and committed by
    train_loop's exit, also when a later step raises."""
    state = init_state()
    inner = trainer.make_lm_train_step(tfm.forward, CFG, None)

    def step_fn(state, tokens):
        if fail and state["step"] == 3:
            raise RuntimeError("step failed")
        return inner(state, tokens)

    with ckpt.CheckpointManager(str(tmp_path), save_interval=3, use_async=True) as mgr:
        if fail:
            with pytest.raises(RuntimeError, match="step failed"):
                trainer.train_loop(step_fn, state, batches(0, 6), checkpoint_manager=mgr)
        else:
            state, _ = trainer.train_loop(step_fn, state, batches(0, 6), checkpoint_manager=mgr)
        assert mgr._writer is None  # train_loop waited for it
        assert mgr.all_steps() == ([3] if fail else [3, 6])
        restored = mgr.restore()
    assert restored["step"] == (3 if fail else 6)
    if not fail:
        assert_bytes_equal(restored["params"], state["params"])


def test_async_save_error_raises_at_wait(tmp_path, monkeypatch):
    params = tfm.init_params(CFG, torch.Generator().manual_seed(0))
    mgr = ckpt.CheckpointManager(str(tmp_path), use_async=True)

    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "write_snapshot", broken)
    mgr.save(1, params)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait_until_finished()
    mgr.close()  # the error was raised once


def test_restore_or_init_cold_and_resumed(tmp_path):
    """Six steps uninterrupted equal three, a checkpoint, and three more
    resumed from it through restore_or_init — params and AdamW state bit
    for bit."""
    step_fn = trainer.make_lm_train_step(tfm.forward, CFG, None)
    full, _ = trainer.train_loop(step_fn, init_state(), batches(0, 6))

    mgr = ckpt.CheckpointManager(str(tmp_path), save_interval=3)
    state, start = mgr.restore_or_init(init_state)
    assert start == 0 and state["step"] == 0  # cold start
    trainer.train_loop(step_fn, state, batches(0, 3), checkpoint_manager=mgr)
    assert mgr.all_steps() == [3]

    resumed, start = ckpt.CheckpointManager(str(tmp_path)).restore_or_init(init_state)
    assert start == 3 and resumed["step"] == 3
    # the optimizer still holds the restored tensors
    assert resumed["opt_state"].param_groups[0]["params"][0] is resumed["params"]["embed"]
    resumed, _ = trainer.train_loop(step_fn, resumed, batches(3, 6), start_step=3)
    assert resumed["step"] == 6
    assert_bytes_equal(resumed["params"], full["params"])
    want, got = full["opt_state"].state_dict(), resumed["opt_state"].state_dict()
    for i, entry in want["state"].items():
        for key, value in entry.items():
            assert torch.equal(got["state"][i][key], value), (i, key)


def test_partial_restore_never_opens_the_optimizer_file(tmp_path):
    state = init_state()
    ckpt.save_checkpoint(str(tmp_path / "s"), state)
    opt_file = tmp_path / "s" / ckpt.OPT_FILE
    opt_file.write_bytes(b"not a checkpoint")
    opt_file.chmod(0)
    with pytest.raises(Exception):  # the file is unreadable to a full restore
        ckpt.restore_checkpoint(str(tmp_path / "s"))
    template = {"params": tfm.init_params(CFG, torch.Generator(), device="meta")}
    got = ckpt.restore_checkpoint(str(tmp_path / "s"), template, partial=True)
    assert set(got) == {"params"}
    assert_bytes_equal(got["params"], state["params"])
    params, step = load_serving_params(str(tmp_path / "s"), CFG, device="cpu")
    assert step is None
    assert_bytes_equal(params, state["params"])
    with pytest.raises(ValueError, match="template"):
        ckpt.restore_checkpoint(str(tmp_path / "s"), partial=True)


def test_serving_loader_selects_steps_and_directories(trained):
    root, live = trained
    params, step = load_serving_params(root, CFG, device="cpu")
    assert step == 6, "the latest step dir wins"
    assert_bytes_equal(params, live)
    p3, s3 = load_serving_params(root, CFG, step=3, device="cpu")
    assert s3 == 3 and not torch.equal(p3["lm_head"], params["lm_head"])
    direct, s = load_serving_params(os.path.join(root, "step_00000003"), CFG, device="cpu")
    assert s == 3 and torch.equal(direct["lm_head"], p3["lm_head"])
    with pytest.raises(FileNotFoundError, match="available steps"):
        load_serving_params(root, CFG, step=5, device="cpu")
    with pytest.raises(FileNotFoundError, match="no step_NNNNNNNN"):
        load_serving_params(os.path.join(root, "step_00000003"), CFG, step=3, device="cpu")
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        load_serving_params(os.path.join(root, "nope"), CFG, device="cpu")
    wrong = dataclasses.replace(CFG, dim=128)
    with pytest.raises(ValueError, match="does not match the serving config"):
        load_serving_params(root, wrong, device="cpu")


def test_serving_loader_casts_to_the_config_dtype(trained):
    root, live = trained
    params, _ = load_serving_params(root, F32, device="cpu")
    assert params["lm_head"].dtype == torch.float32 and params["final_norm"].dtype == torch.float32
    assert torch.equal(params["lm_head"], live["lm_head"].detach().float())


def test_serving_loader_quantizes(trained):
    root, live = trained
    params, _ = load_serving_params(root, CFG, device="cpu", quantize="int8")
    assert isinstance(params["lm_head"], QuantizedLinear)
    assert isinstance(params["layers"][0]["w_down"], QuantizedLinear)
    assert isinstance(params["embed"], torch.Tensor)
    want = quantize_weight(live["layers"][1]["w_up"].detach())
    assert torch.equal(params["layers"][1]["w_up"].q, want.q)
    assert torch.equal(params["layers"][1]["w_up"].scale, want.scale)
    with pytest.raises(ValueError, match="int4"):
        load_serving_params(root, CFG, device="cpu", quantize="int4")


def drive(engine, prompts=PROMPTS, n=6):
    engine.start()
    try:
        return [h.result(timeout=120) for h in [engine.submit(p, n) for p in prompts]]
    finally:
        engine.stop()


def test_from_checkpoint_serves_the_trained_params(trained):
    root, live = trained
    kw = dict(device="cpu", max_slots=2, max_len=48)
    want = drive(InferenceEngine(trainer.tree_like(live, [p.detach() for p in
                                                          trainer.param_leaves(live)]), CFG, **kw))
    assert drive(InferenceEngine.from_checkpoint(root, CFG, **kw)) == want
    spec = InferenceEngine.from_checkpoint(root, CFG, draft_checkpoint=root, draft_cfg=CFG,
                                           draft_step=3, spec_k=3, **kw)
    assert spec.draft_params is not None and spec.draft_cfg is CFG
    assert not isinstance(spec.draft_params["lm_head"], QuantizedLinear)
    assert drive(spec) == want  # greedy streams never depend on the draft
    assert spec.stats()["spec_rounds"] > 0
    q = InferenceEngine.from_checkpoint(root, CFG, quantize="int8", draft_checkpoint=root,
                                        draft_cfg=CFG, **kw)
    assert isinstance(q.params["lm_head"], QuantizedLinear)
    assert not isinstance(q.draft_params["lm_head"], QuantizedLinear)  # the draft stays dense
    with pytest.raises(ValueError, match="draft_cfg without draft_checkpoint"):
        InferenceEngine.from_checkpoint(root, CFG, draft_cfg=CFG, **kw)
    with pytest.raises(ValueError, match="draft_checkpoint requires draft_cfg"):
        InferenceEngine.from_checkpoint(root, CFG, draft_checkpoint=root, **kw)
