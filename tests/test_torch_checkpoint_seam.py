"""The checkpoint seam between the JAX package and the port, on the CPU.

- JAX trains TINY for 6 steps with its Orbax ``CheckpointManager`` (the
  ``trained`` fixture of tests/test_serving_checkpoint.py);
  ``scripts/convert_checkpoint.py --to torch`` converts the root; the
  port's ``InferenceEngine.from_checkpoint`` and the JAX package's give
  equal greedy streams on a float32 copy of TINY, dense and int8.
- The reverse: the port trains TINY with its own ``CheckpointManager``,
  ``--to orbax`` converts, and ``devspace_tpu.inference.
  load_serving_params`` restores params whose logits agree with the
  port's within ``atol=1e-4`` (float32, the bound of
  tests/test_torch_forward.py), and whose bytes are the port's.
- ``scripts/train_draft_pair_torch.py`` at TINY widths writes the JAX
  script's layout (``target/`` and ``draft/`` step roots, ``pair.json``
  with its keys) and its pair serves through ``from_checkpoint``.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir, "scripts"))

import convert_checkpoint  # noqa: E402
from devspace_tpu.inference import InferenceEngine as JaxEngine  # noqa: E402
from devspace_tpu.inference import load_serving_params as jax_load  # noqa: E402
from devspace_tpu.models import transformer as jtfm  # noqa: E402
from devspace_tpu.training.checkpoint import CheckpointManager as JaxManager  # noqa: E402
from devspace_tpu.training.trainer import make_lm_train_step, train_loop  # noqa: E402
from devspace_tpu_torch.inference import InferenceEngine, load_serving_params  # noqa: E402
from devspace_tpu_torch.models import transformer as ttfm  # noqa: E402
from devspace_tpu_torch.models.convert import params_to_numpy  # noqa: E402
from devspace_tpu_torch.training import checkpoint as tckpt  # noqa: E402
from devspace_tpu_torch.training import trainer as ttrainer  # noqa: E402

JCFG32 = dataclasses.replace(jtfm.TINY, dtype=jnp.float32)
TCFG32 = dataclasses.replace(ttfm.TINY, dtype=torch.float32)
PROMPTS = [[5, 1, 4], [2, 2, 2, 2, 2], list(range(1, 17))]
ATOL = 1e-4


@pytest.fixture(scope="module")
def jax_trained(tmp_path_factory):
    """TINY trained by JAX for 6 steps, an Orbax checkpoint every 3 ->
    the Orbax root and the same root converted to the port's format."""
    root = tmp_path_factory.mktemp("jax_ckpt")
    opt = optax.adam(1e-2)
    params = jtfm.init_params(jtfm.TINY, jax.random.PRNGKey(0))
    state = {"params": params, "opt_state": opt.init(params), "step": jnp.zeros((), jnp.int32)}
    step_fn = make_lm_train_step(jtfm.forward, jtfm.TINY, opt, donate=False)
    rng = np.random.default_rng(0)
    batches = [jnp.asarray(rng.integers(1, jtfm.TINY.vocab_size, (2, 17))) for _ in range(6)]
    mgr = JaxManager(str(root), save_interval=3, max_to_keep=2)
    state, loss = train_loop(step_fn, state, batches, checkpoint_manager=mgr)
    assert np.isfinite(float(loss))
    out = str(tmp_path_factory.mktemp("converted"))
    written = convert_checkpoint.orbax_to_torch(str(root), out)
    assert written == os.path.join(out, "step_00000006")
    return str(root), out, state["params"]


def jax_streams(engine, n=12):
    engine.start()
    try:
        return [h.result(timeout=300) for h in [engine.submit(p, n) for p in PROMPTS]]
    finally:
        engine.stop()


def port_streams(engine, n=12):
    engine.start()
    try:
        return [h.result(timeout=120) for h in [engine.submit(p, n) for p in PROMPTS]]
    finally:
        engine.stop()


def test_converted_params_are_the_jax_params(jax_trained):
    _, out, live = jax_trained
    params, step = load_serving_params(out, ttfm.TINY, device="cpu")
    assert step == 6
    want = jax.tree.leaves(jax.tree.map(np.asarray, live))
    got = jax.tree.leaves(params_to_numpy(params))
    for w, g in zip(want, got):
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))
    assert tckpt.read_meta(os.path.join(out, "step_00000006"))["kind"] == "params"


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["dense", "int8"])
def test_jax_checkpoint_serves_equal_streams_in_both_engines(jax_trained, quantize):
    root, out, _ = jax_trained
    ref = jax_streams(JaxEngine.from_checkpoint(root, JCFG32, quantize=quantize, max_slots=2,
                                                max_len=48))
    got = port_streams(InferenceEngine.from_checkpoint(out, TCFG32, quantize=quantize,
                                                       device="cpu", max_slots=2, max_len=48))
    assert got == ref


def test_port_checkpoint_converts_back_to_orbax(tmp_path):
    """Port-trained TINY (float32, 4 AdamW steps, a train-state
    checkpoint) -> Orbax -> the JAX package's loader."""
    params = ttfm.init_params(TCFG32, torch.Generator().manual_seed(0))
    for p in ttrainer.param_leaves(params):
        p.requires_grad_()
    state = ttrainer.init_train_state(params, ttrainer.adamw(1e-2))
    step_fn = ttrainer.make_lm_train_step(ttfm.forward, TCFG32, None)
    g = torch.Generator().manual_seed(1)
    batches = [torch.randint(1, 256, (2, 17), generator=g) for _ in range(4)]
    mgr = tckpt.CheckpointManager(str(tmp_path / "port"), save_interval=4)
    state, _ = ttrainer.train_loop(step_fn, state, batches, checkpoint_manager=mgr)
    assert tckpt.read_meta(mgr._dir(4))["kind"] == "train_state"
    written = convert_checkpoint.torch_to_orbax(str(tmp_path / "port"), str(tmp_path / "orbax"))
    assert written == str(tmp_path / "orbax" / "step_00000004")
    jparams, step = jax_load(str(tmp_path / "orbax"), JCFG32)
    assert step == 4
    for w, g in zip(jax.tree.leaves(params_to_numpy(state["params"])),
                    jax.tree.leaves(jax.tree.map(np.asarray, jparams))):
        np.testing.assert_array_equal(g, w)
    toks = np.random.default_rng(2).integers(0, 256, size=(2, 20))
    ref = np.asarray(jtfm.forward(jparams, jnp.asarray(toks, jnp.int32), JCFG32))
    with torch.no_grad():
        got = ttfm.forward(state["params"], torch.from_numpy(toks), TCFG32).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_converter_command_line(jax_trained, tmp_path, capsys):
    root, _, _ = jax_trained
    convert_checkpoint.main(["--to", "torch", root, str(tmp_path / "t"), "--step", "3"])
    assert capsys.readouterr().out.strip() == str(tmp_path / "t" / "step_00000003")
    assert load_serving_params(str(tmp_path / "t"), ttfm.TINY, device="cpu")[1] == 3


PAIR_TARGET = ttfm.TransformerConfig(vocab_size=64, dim=64, n_layers=2, n_heads=2, n_kv_heads=2,
                                     ffn_dim=128, max_seq_len=128)
PAIR_DRAFT = ttfm.TransformerConfig(vocab_size=64, dim=32, n_layers=1, n_heads=2, n_kv_heads=2,
                                    ffn_dim=64, max_seq_len=128)
CORPUS = {"active": 64, "noise": 0.02, "seed": 0}


def test_pair_script_writes_the_jax_scripts_layout(tmp_path):
    from train_draft_pair import train_pair as jax_train_pair
    from train_draft_pair_torch import train_pair

    def jax_cfg(cfg):
        return jtfm.TransformerConfig(**{f.name: getattr(cfg, f.name)
                                         for f in dataclasses.fields(cfg) if f.name != "dtype"})

    jmeta = jax_train_pair(str(tmp_path / "jax"), jax_cfg(PAIR_TARGET), jax_cfg(PAIR_DRAFT),
                           CORPUS, steps=2, batch=4, seq=17, lr=1e-2, log=lambda *a: None)
    meta, trained = train_pair(str(tmp_path / "port"), PAIR_TARGET, PAIR_DRAFT, CORPUS, steps=4,
                               batch=4, seq=17, lr=1e-2, device="cpu", log=lambda *a: None)
    assert set(meta) == set(jmeta)
    with open(tmp_path / "port" / "pair.json") as f:
        assert json.load(f) == json.loads(json.dumps(meta))
    for key in ("target", "draft"):
        assert {k: v for k, v in jmeta[key].items() if k in meta[key]} == meta[key]
        assert sorted(os.listdir(tmp_path / "port" / key)) == ["step_00000004"]
        assert sorted(os.listdir(tmp_path / "jax" / key)) == ["step_00000002"]
        params, report = trained[key]
        assert report["steps"] == 4 and report["losses_finite"]
        restored, step = load_serving_params(str(tmp_path / "port" / key),
                                             PAIR_TARGET if key == "target" else PAIR_DRAFT,
                                             device="cpu")
        assert step == 4
        for a, b in zip(ttrainer.param_leaves(restored), ttrainer.param_leaves(params)):
            assert torch.equal(a, b)
    for k in ("target_draft_agreement", "target_accuracy", "draft_accuracy"):
        assert 0.0 <= meta[k] <= 1.0
    assert meta["params_ratio"] > 2.0
    engine = InferenceEngine.from_checkpoint(
        str(tmp_path / "port" / "target"), PAIR_TARGET, draft_checkpoint=str(
            tmp_path / "port" / "draft"), draft_cfg=PAIR_DRAFT, device="cpu", max_slots=2,
        max_len=64, spec_k=3)
    assert len(port_streams(engine, n=8)[0]) == 8 and engine.stats()["spec_rounds"] > 0
