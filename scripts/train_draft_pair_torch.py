"""Train a target + much-smaller draft LM on the same learnable corpus, with
the PyTorch port (``devspace_tpu_torch``).

The port of ``scripts/train_draft_pair.py``, with the same flags, the
same configs (the bench envs), corpus and recipe, and the same output:
both models train on the order-2 Markov corpus
(``training/data.py:markov_sampler``) with Adam, their bare params are
saved through the port's ``CheckpointManager`` under ``--out``
(``target/`` and ``draft/`` step roots), and ``pair.json`` holds the
configs, the corpus parameters and the measured greedy agreement. A
server restores the pair through the train -> serve seam
(``InferenceEngine.from_checkpoint``). Runs on the card unless
``--device cpu`` is given; imports nothing of JAX.

Usage::

    python scripts/train_draft_pair_torch.py --out runs/spec_pair [--steps 600]

Target size follows BENCH_DIM/BENCH_LAYERS/BENCH_FFN; draft size follows
DRAFT_DIM/DRAFT_LAYERS/DRAFT_FFN/DRAFT_HEADS.
"""

import argparse
import dataclasses
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from devspace_tpu_torch.device import resolve_device
from devspace_tpu_torch.models import transformer as tfm
from devspace_tpu_torch.training import trainer
from devspace_tpu_torch.training.checkpoint import CheckpointManager
from devspace_tpu_torch.training.data import markov_sampler


def bench_target_cfg() -> tfm.TransformerConfig:
    """The env knobs of scripts/bench_inference.py, as the JAX script."""
    return tfm.TransformerConfig(
        vocab_size=32_000,
        dim=int(os.environ.get("BENCH_DIM", 1024)),
        n_layers=int(os.environ.get("BENCH_LAYERS", 8)),
        n_heads=8,
        n_kv_heads=8,
        ffn_dim=int(os.environ.get("BENCH_FFN", 2816)),
        max_seq_len=1024,
    )


def bench_draft_cfg(target: tfm.TransformerConfig) -> tfm.TransformerConfig:
    """~8x fewer non-embedding FLOPs than the default target (dim/4,
    layers/4)."""
    return tfm.TransformerConfig(
        vocab_size=target.vocab_size,
        dim=int(os.environ.get("DRAFT_DIM", 256)),
        n_layers=int(os.environ.get("DRAFT_LAYERS", 2)),
        n_heads=int(os.environ.get("DRAFT_HEADS", 4)),
        n_kv_heads=int(os.environ.get("DRAFT_HEADS", 4)),
        ffn_dim=int(os.environ.get("DRAFT_FFN", 704)),
        max_seq_len=target.max_seq_len,
    )


def _param_count(params) -> int:
    return sum(t.numel() for t in trainer.param_leaves(params))


def _cfg_dict(cfg: tfm.TransformerConfig) -> dict:
    d = dataclasses.asdict(cfg)
    d.pop("dtype", None)  # not JSON; pair configs use the default
    return d


def train_one(
    name: str,
    cfg: tfm.TransformerConfig,
    root: str,
    sample,
    steps: int,
    batch: int,
    seq: int,
    lr: float,
    seed: int,
    device: torch.device,
    log=print,
) -> tuple[dict, dict]:
    """Train ``cfg`` on the corpus for ``steps`` Adam steps from params
    drawn with ``seed``, save the final params under ``root`` (step
    ``steps``) -> (the trained params, detached; a report: seconds on the
    host clock, batch sampling included, the first and last loss, and
    whether every loss was finite)."""
    params = tfm.init_params(cfg, torch.Generator(device=device).manual_seed(seed))
    for p in trainer.param_leaves(params):
        p.requires_grad_()
    opt = trainer.adam(lr)
    state = trainer.init_train_state(params, opt)
    inner = trainer.make_lm_train_step(tfm.forward, cfg, opt)
    losses = []

    def step_fn(state, tokens):
        state, loss = inner(state, tokens)
        losses.append(loss)  # read once training ends: no sync per step
        return state, loss

    batches = (sample(batch, seq, seed=seed * 100_000 + s) for s in range(steps))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    state, _ = trainer.train_loop(step_fn, state, batches)
    losses = [x.item() for x in losses]
    seconds = time.perf_counter() - t0
    trained = trainer.tree_like(params, [p.detach() for p in trainer.param_leaves(state["params"])])
    # the serving artifact is the bare params tree: the Adam moments would
    # triple the bytes for nothing a server reads
    CheckpointManager(str(root), save_interval=steps, max_to_keep=1).save(steps, trained)
    report = {"params_m": _param_count(trained) / 1e6, "steps": steps, "seconds": seconds,
              "first_loss": losses[0], "last_loss": losses[-1],
              "losses_finite": all(math.isfinite(x) for x in losses)}
    log(f"[pair] {name}: {steps} steps in {seconds:.1f}s, final loss {losses[-1]:.4f}, "
        f"{report['params_m']:.1f}M params")
    return trained, report


def greedy_agreement(t_params, t_cfg, d_params, d_cfg, sample, n=64, length=65, seed=9) -> dict:
    """Held-out greedy next-token agreement between target and draft (the
    static proxy for speculative acceptance) and each model's accuracy
    against the corpus, at positions with full order-2 context."""
    tokens = sample(n, length, seed=seed)
    with torch.no_grad():
        tp = tfm.forward(t_params, tokens[:, :-1], t_cfg).argmax(-1)
        dp = tfm.forward(d_params, tokens[:, :-1], d_cfg).argmax(-1)
    actual = tokens[:, 1:]
    sl = slice(1, None)  # pred i needs tokens i-1, i of context
    return {
        "target_draft_agreement": round((tp[:, sl] == dp[:, sl]).float().mean().item(), 4),
        "target_accuracy": round((tp[:, sl] == actual[:, sl]).float().mean().item(), 4),
        "draft_accuracy": round((dp[:, sl] == actual[:, sl]).float().mean().item(), 4),
    }


def train_pair(
    out: str,
    target_cfg: tfm.TransformerConfig,
    draft_cfg: tfm.TransformerConfig,
    corpus: dict,
    steps: int,
    batch: int = 32,
    seq: int = 129,
    lr: float = 3e-4,
    device=None,
    log=print,
) -> tuple[dict, dict]:
    """The whole pipeline: train both models, measure agreement, write
    ``pair.json`` -> (the pair metadata, ``{"target": (params, report),
    "draft": (params, report)}``)."""
    if corpus["active"] > target_cfg.vocab_size:  # tokens are 1..active-1
        raise ValueError("corpus active symbols must fit the vocab")
    dev = resolve_device(device)
    sample = markov_sampler(**corpus, device=dev)
    trained = {
        name: train_one(name, cfg, os.path.join(out, name), sample, steps, batch, seq, lr,
                        seed=seed, device=dev, log=log)
        for name, cfg, seed in (("target", target_cfg, 0), ("draft", draft_cfg, 1))
    }
    (t_params, _), (d_params, _) = trained["target"], trained["draft"]
    metrics = greedy_agreement(t_params, target_cfg, d_params, draft_cfg, sample)
    meta = {
        "target": _cfg_dict(target_cfg),
        "draft": _cfg_dict(draft_cfg),
        "corpus": corpus,
        "steps": steps,
        "batch": batch,
        "seq": seq,
        "lr": lr,
        "params_ratio": round(_param_count(t_params) / _param_count(d_params), 2),
        **metrics,
    }
    with open(os.path.join(out, "pair.json"), "w") as f:
        json.dump(meta, f, indent=1)
    log(f"[pair] {json.dumps(metrics)} (params ratio {meta['params_ratio']}x)")
    return meta, trained


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=129)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--active", type=int, default=512)
    ap.add_argument("--noise", type=float, default=0.02)
    ap.add_argument("--corpus-seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    target = bench_target_cfg()
    draft = bench_draft_cfg(target)
    meta, _ = train_pair(
        args.out,
        target,
        draft,
        {"active": args.active, "noise": args.noise, "seed": args.corpus_seed},
        steps=args.steps,
        batch=args.batch,
        seq=args.seq,
        lr=args.lr,
        device=args.device,
    )
    print(json.dumps(meta))


if __name__ == "__main__":
    main()
