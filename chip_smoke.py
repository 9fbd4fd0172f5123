#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (devspace_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA Hopper GPU
and the CUDA toolkit. It builds the port's CUDA kernels from the sources
in the checkout (one nvcc per source, all started together), holds each
against its plain PyTorch version and times it, then drives the port's
three paths:

- training: the LM that bench.py trains on a chip (vocab 32000, dim
  1024, 8 layers, 16 heads, ffn 4096, bf16; random weights from seed 0)
  takes AdamW steps at batch 8 x 2048 through the flash-attention and
  cross-entropy kernels;
- serving: at the full width and depth of Llama-2-7B, the engine at its
  defaults (the depth-2 dispatch window, the prefix cache, every decode
  chunk a CUDA graph captured by ``prewarm`` and replayed) answers
  concurrent requests with a bf16 KV pool and an int8 one through the
  paged-decode kernel, each greedy stream held to the argmax of an eager
  forward; then a steady decode burst (8 x 256 tokens) and a burst
  sharing a 512-token prefix, with the cache on and off; the same burst
  at depth 1 gives the same streams; one request goes through the HTTP
  server; then the host KV tier (``kv_tier`` phase): four waves on
  fresh 2-slot engines with a 33-block pool, bf16 and int8, the tier on
  and off (waves 2-3 evict and spill a 512-token chain, wave 4 restores
  its 8 blocks and decodes them through the kernel; int8 streams equal
  the tier-off ones, bf16 tokens are the eager argmax or a near tie),
  and a KVM1 migration of that chain between two servers (``POST
  /prefill`` on one, ``/generate`` with ``kv_source`` on the other;
  the migrated blocks equal the source's byte for byte); then int8
  weights from a checkpoint (``int8_weights`` phase): the 7B params are
  saved by ``save_checkpoint`` into a temporary directory and restored
  byte for byte by ``load_serving_params``, and
  ``serve.build_engine(checkpoint=..., quantize="int8")`` serves the
  smoke requests and the steady burst after ``prewarm`` through the
  paged-decode kernel, each greedy stream held to an eager forward's
  argmax over the same int8 params, beside a bf16 engine kept alive;
  the steady burst also runs on an engine with metrics on and one with
  them off, alternated (``engine_variants.no_metrics``); last, the fleet
  (``fleet`` phase): two replicas of that checkpoint, each ``python -m
  devspace_tpu_torch.serve`` under the port's ``ReplicaFleet``, share
  the card behind its ``RoutingGateway`` and ``TelemetryCollector``; a
  greedy burst over three 512-token contexts is held to the same prompts
  served directly, to prefix affinity, to the collector's federated
  token count, to each replica's kernel launches and flat graph
  captures; one replica is SIGKILLed (a request routed to it is rerouted
  before its first byte) and restarted; a third replica's ``/readyz``
  flips to 503 under an injected TTFT breach and comes back; then the
  serving chaos harness (``chaos`` phase): two more replicas of that
  checkpoint, with the host KV tier, take three scenarios of
  scripts/chaos_serving_check_torch.py through the port's open-loop
  ``LoadGenerator``: Poisson traffic with one replica SIGKILLed
  mid-stream, chat waves through the gateway with the prefix-hot replica
  SIGKILLed mid-wave and TTFT after recovery held to the healthy wave's,
  and RAG traffic under two-phase placement (a live KVM1 migration
  first) with the prefill-pool replica SIGKILLed at its first placement;
  every request ends terminal, none hung, each stream held to the one a
  replica serves alone for its prompt, a corrupted one only at a near
  tie;
- speculative serving: the target and draft LMs of
  scripts/train_draft_pair.py (target: vocab 32000, dim 1024, 8 layers,
  8 heads, ffn 2816; draft: dim 256, 2 layers, 4 heads, ffn 704; bf16)
  train on the Markov corpus at batch 32 x 129 through the
  short-sequence attention and cross-entropy kernels, by the port of
  that script (scripts/train_draft_pair_torch.py), which saves them as
  checkpoints; ``InferenceEngine.from_checkpoint`` restores them (the
  params byte for byte) into an engine with the draft, which answers
  greedy and sampled requests (draft prefill through the short-sequence
  kernel, verification blocks through the paged-decode kernel, each
  spec round a replayed graph), beside one without it, whose streams
  equal those of an engine over the in-memory params, and one request
  goes through HTTP ``/generate_speculative``.

The engine's paged-decode launches are counted per graph replay
(``stats()["paged_decode_launches"]``): the wrapper's own count moves
only while ``prewarm`` captures the graphs, and the script checks that
it stays at 0 while the engine serves.

The model zoo (after the LM's training): the loss kernel at the
classifiers' and the MoE LM's shapes and flash at head width 128, each
held against its plain version and timed; ResNet-50 at full width in
float32 on the card against the CPU (eval logits, one SGD step's loss
and running statistics); bench.py's ResNet-50 harness (space-to-depth
stem, bf16, batch 256 x 224^2, SGD 0.1 with momentum 0.9, 3 + 20 steps,
one profiled step by kind of kernel, then a few steps with the conv7
stem); the MNIST MLP for 200 Adam steps (loss below 1e-3 by step 100);
ViT-B/16 at batch 128 x 224^2; and Mixtral-8x7B's widths at 2 layers
(batch 2 x 2048 tokens, AdamW) through flash attention at D = 128 and
the loss kernel, each with its launch counts.

Then the deploy path (``deploy`` phase): a torch project scaffolded by
the port's generator (the torch Dockerfile and ``chart-gpu``), whose
``.devspace/config.yaml`` is examples/jax-mnist's with a ``gpu`` block of
one worker and one card, is loaded by the port's config loader,
preflighted by its project lint (no error) and rendered by its chart
renderer; the rendered StatefulSet's container command (torchrun, its
pod index 0, pod 0's address 127.0.0.1) runs here and trains the MNIST
example over an NCCL world of one through the loss kernel, one launch a
step, the loss at step 100 below the mnist_train phase's bound.

Then the same project applied to a cluster (``cluster`` phase): the
port's CLI, each call a process in the project's dir against the port's
fake cluster (``DEVSPACE_FAKE_BACKEND``) — ``deploy`` (the lint
preflight, the fake builder, the chart applied, its pods synthesized, the
rollout waited for and the release recorded), ``status deployments`` and
``print --manifests`` (the documents it applied) — then the applied
StatefulSet's command runs in worker 0 through the fake's
``exec_stream``, with ``NODE_RANK`` from the pod's env as the fake
synthesized it, and trains the MNIST example on the card as the deploy
phase does; ``purge`` leaves the fake empty.

The RMSNorm kernel lies on no model's path (as in the JAX package); it is
built, held against its plain version and timed.

Last, parallel/ over torch.distributed, inside a world of one NCCL rank
(``parallel`` phase; NCCL refuses two ranks on one card): (a) the bench LM at 8 x 2048 through the mesh
step (``{"data": 1, "model": 1}``, the tensor-parallel spec) and (b)
through FSDP, 3 AdamW steps each, against the step without a mesh
(losses and updates within 1e-3, the flash and loss kernels launched as
the step count predicts; FSDP gathers one layer at a time, so its peak
memory exceeds the mesh step's by at most the LM head plus one layer's
gathered weights); (c) the long-context example's widths (dim
2048, 16 layers, 16 heads, 8 KV heads, ffn 5504, vocab 32000, bf16)
through its script's ``build`` (ring attention, the vocab-parallel loss,
remat) on one sequence of 4096 tokens, the 32768 of the example over
its 8-ring; (d) ring attention (eight 512-key sub-blocks) and Ulysses
against the flash kernel on bf16 ``[1, 4096, 16, 128]``; (e) the MoE at
Mixtral-8x7B's widths, 2 layers, with ``moe_ffn`` as its expert layer,
3 AdamW steps at 2 x 2049 tokens, ``moe_ffn`` held to
``moe_ffn_reference``; then the 1F1B and interleaved pipelines, and the
tensor-parallel 7B engine over ``{"model": 1}``; (f) the FSDP run's
train state saved from the mesh and restored, AdamW moments byte for
byte, onto the tensor-parallel layout, whose next step's loss is FSDP's;
(g) the kv_tier phase's waves on the tensor-parallel engine with the host
tier, streams, tier counters and KVM1 export equal to the plain engine's.

Then the analysis tooling (``analysis`` phase, devspace_tpu_torch/lint):
one more wave of the smoke requests on the plain 7B engine and on the
tensor-parallel engine's two pools, each under ``CompileWatch`` after
``prewarm`` (no graph captured; the paged-decode launches of the wave
counted), SHD300-303 over the live 7B's serving spec tree on meshes of
``model`` = 1, 2, 3, 4, 8 (SHD302 at 3 only) and over the bench LM's
1F1B and interleaved layouts at ``pipe`` = 4 and its FSDP specs at
``data`` = 8, SHD304 on meta tensors over the trainer's AdamW update and
a decode program (clean) and a seeded cast (one finding), and the static
legs of scripts/analysis_gate_torch.py.

Each phase prints one JSON line; any failure raises and exits non-zero.
The line before the last lists the kernels; the last is
``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import hashlib
import itertools
import json
import math
import os
import re
import shlex
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional
import urllib.error
import urllib.request

import numpy as np
import torch
import yaml
import torch.nn.functional as F

from devspace_tpu_torch import serve
from devspace_tpu_torch.inference import InferenceEngine, load_serving_params
from devspace_tpu_torch.inference import engine as einf
from devspace_tpu_torch.inference import quantization as wq
from devspace_tpu_torch.inference import kv_tier as kvt
from devspace_tpu_torch.inference import speculative as spec
from devspace_tpu_torch import lint
from devspace_tpu_torch.deploy.chart import RELEASE_CONFIGMAP_PREFIX, ChartDeployer
from devspace_tpu_torch.generator import generator as scaffold
from devspace_tpu_torch.lint import rules_gpu
from devspace_tpu_torch.lint.runtime import CompileWatch
from devspace_tpu_torch.models import mlp, moe, resnet, vit
from devspace_tpu_torch.models import transformer as tfm
from devspace_tpu_torch.ops import _build
from devspace_tpu_torch.ops import attention as sa
from devspace_tpu_torch.ops import flash_attention as fa
from devspace_tpu_torch.ops import losses as xl
from devspace_tpu_torch.ops import normalization as rn
from devspace_tpu_torch.parallel import expert_parallel as eparallel
from devspace_tpu_torch.parallel import fsdp as pfsdp
from devspace_tpu_torch.parallel import mesh as pmesh
from devspace_tpu_torch.parallel import pipeline as ppipe
from devspace_tpu_torch.parallel.data_parallel import shard_batch
from devspace_tpu_torch.parallel.ring_attention import ring_attention
from devspace_tpu_torch.parallel.sequence_parallel import ulysses_attention
from devspace_tpu_torch.ops import paged_attention as pa
from devspace_tpu_torch.training import data as tdata
from devspace_tpu_torch.training import checkpoint as tckpt
from devspace_tpu_torch.training import trainer as ttrainer
from devspace_tpu_torch.inference.prefix_cache import fingerprint_chain
from devspace_tpu_torch.training.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
    sharded_template,
)

sys.path.insert(0, str(Path(__file__).resolve().parent / "scripts"))
import analysis_gate_torch as gate_script  # noqa: E402
import train_draft_pair_torch as pair_script  # noqa: E402
import train_long_context_torch as long_script  # noqa: E402

REPO_ROOT = str(Path(__file__).resolve().parent)

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth, dense bf16
# on the tensor cores, float32 outside them
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12
# kernel vs plain version: float32 as tests/test_models_ops.py holds the
# Pallas kernel. bf16: both accumulate in f32 and round the output to
# bf16, so they differ by about one bf16 ulp (2^-8 of an element): a max
# abs error of 2e-2 on unit-normal inputs, and, per live (row, head), a
# max error of at most 1e-2 of that head's largest output — the check
# that still binds on long rows, whose outputs are ~0.03
F32_RTOL, F32_ATOL = 2e-4, 2e-5
BF16_MAX_ABS = 2e-2
BF16_HEAD_REL = 1e-2
# cross-entropy kernel vs plain version: both compute in float32 from
# the same values, in other orders
XENT_RTOL, XENT_ATOL = 1e-5, 1e-5
# the one kernel of the serving path, and the TPU kernel it replaces
KERNEL_SOURCE = "devspace_tpu_torch/csrc/paged_decode.cu"
KERNEL_REPLACES = "devspace_tpu/ops/paged_attention.py:95"  # _kernel
SOURCES = ("paged_decode", "flash_attention", "flash_backward", "cross_entropy", "attention",
           "rms_norm")
# the kernels of the training path: name -> (launch counter, source, the
# TPU kernel body it replaces)
TRAIN_KERNELS = {
    "flash_fwd": ("fwd", "devspace_tpu_torch/csrc/flash_attention.cu",
                  "devspace_tpu/ops/flash_attention.py:29"),  # _fwd_kernel
    "flash_bwd_dq": ("bwd_dq", "devspace_tpu_torch/csrc/flash_backward.cu",
                     "devspace_tpu/ops/flash_attention.py:126"),  # _bwd_dq_kernel
    "flash_bwd_dkv": ("bwd_dkv", "devspace_tpu_torch/csrc/flash_backward.cu",
                      "devspace_tpu/ops/flash_attention.py:178"),  # _bwd_dkv_kernel
    "cross_entropy": (None, "devspace_tpu_torch/csrc/cross_entropy.cu",
                      "devspace_tpu/ops/losses.py:30"),  # _xent_kernel
}
# the LM bench.py trains on a chip (bench.py:293-297), bf16, AdamW 3e-4
BENCH_LM = tfm.TransformerConfig(
    vocab_size=32000, dim=1024, n_layers=8, n_heads=16, n_kv_heads=16, ffn_dim=4096,
    max_seq_len=2048,
)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 8, 2048, 3e-4
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
# flash attention at the bench LM's shape ([B*H, T, D]) and at D = 128
FLASH_SHAPES = {"bench": (8 * 16, 2048, 64), "d128": (4 * 8, 2048, 128)}
XENT_SHAPE = (TRAIN_BATCH * TRAIN_SEQ, 32000)
# the pair scripts/train_draft_pair.py trains and bench.py serves
# (train_draft_pair.py:47-73), bf16, at that script's batch, sequence,
# optimizer and corpus
PAIR_TARGET = tfm.TransformerConfig(
    vocab_size=32000, dim=1024, n_layers=8, n_heads=8, n_kv_heads=8, ffn_dim=2816,
    max_seq_len=1024,
)
PAIR_DRAFT = tfm.TransformerConfig(
    vocab_size=32000, dim=256, n_layers=2, n_heads=4, n_kv_heads=4, ffn_dim=704,
    max_seq_len=1024,
)
PAIR_BATCH, PAIR_SEQ, PAIR_LR, PAIR_STEPS = 32, 129, 3e-4, 600
PAIR_CORPUS = {"active": 512, "noise": 0.02, "seed": 0}
SPEC_K, SPEC_NEW_TOKENS = 4, 64
SPEC_PROMPT_LENS = (7, 33, 64, 120, 250, 500)
# the current token's position in each of the 8 slots of a verification
# block (None: a parked slot); the last one ends at max_len
VERIFY_POSITIONS = (8, 64, 250, 563, None, 1, 1019, None)
# two greedy streams may part only at a near-tie of the target. The bound
# is measured on the trained target (``logit_path_gaps``): g, the largest
# logit difference between the [40, D] verification block and [8, D]
# decode steps at the same positions, and f, between the full-sequence
# forward (which recomputes the logits where two streams part) and those
# decode steps. Two paths can order two tokens differently only if their
# margin is at most 2g, and the recomputed margin is off by at most 2f,
# so both candidates must lie within NEAR_TIE_GAPS * (g + f) of the
# recomputed top logit, in absolute logits
NEAR_TIE_GAPS = 2
# the paths themselves may differ by bf16 rounding only: logits leave the
# lm_head product in bf16, one ulp of which is 2^-8 of the value. For the
# trained 8-layer pair the paths stay within LOGIT_PATH_REL of the largest
# logit. Through the 32 layers of Llama-2-7B with random weights the
# rounding adds up further: the decode path and the full-sequence forward
# (whose attention rounds P to bf16 before P.V) part by up to 6% of the
# largest logit (0.357 of 6.06 on an H100), still well under the whole
# logits a row that read another row's blocks or length would be off by
LOGIT_PATH_REL = 2.0 ** -6
LOGIT_PATH_REL_7B = 2.0 ** -3
# the short-sequence attention kernel at the pair's training shapes
# ([B*H, T, D]: target, draft), at the draft's prefill of a 500-token
# prompt (the 512 bucket, batch 1: the two-pass kernel), and the RMSNorm
# shapes
ATTN_TRAIN_SHAPES = {"target": (32 * 8, 128, 128), "draft": (32 * 4, 128, 64)}
ATTN_PREFILL_SHAPE = (4, 512, 64)
ATTN_KERNEL = ("devspace_tpu_torch/csrc/attention.cu", "devspace_tpu/ops/attention.py:36")
RMS_KERNEL = ("devspace_tpu_torch/csrc/rms_norm.cu", "devspace_tpu/ops/normalization.py:24")
RMS_SHAPES = ((4096, 1024), (4096, 256), (8, 4096), (33, 1001))
# RMSNorm also timed at the Llama-2-7B width
RMS_WIDE = (4096, 4096)
# RMSNorm kernel vs plain version: float32 the same arithmetic summed in
# another order; bf16 outputs within one bf16 ulp
RMS_F32_TOL = dict(rtol=1e-5, atol=1e-6)
RMS_BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-6)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def child_pids() -> list:
    """This process's live children (zombies left out), from /proc."""
    me, out = str(os.getpid()), []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmd = f.read()
        except OSError:
            continue
        # multiprocessing's resource tracker ends when this process does
        if ppid == me and state != "Z" and b"resource_tracker" not in cmd:
            out.append(int(entry))
    return out


def stop_children(grace_s: float = 10.0) -> list:
    """SIGTERM every child still running (a phase that failed may leave
    one: a replica mid-restart, a rank), SIGKILL what outlives
    ``grace_s``, and reap them; returns their pids."""
    import signal

    pids = child_pids()
    for pid in pids:
        with contextlib.suppress(ProcessLookupError):
            os.kill(pid, signal.SIGTERM)
    deadline = time.monotonic() + grace_s
    while child_pids() and time.monotonic() < deadline:
        time.sleep(0.1)
    for pid in child_pids():
        with contextlib.suppress(ProcessLookupError):
            os.kill(pid, signal.SIGKILL)
    for pid in pids:
        with contextlib.suppress(ChildProcessError):
            os.waitpid(pid, 0)
    return pids


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, reps: int, warmup: int = 3, spin_ms: float = 50.0) -> tuple[float, float]:
    """(median device time of ``fn``, host time to enqueue one call), in
    ms, over ``reps`` calls with one CUDA event pair per call. A spin
    kernel queued first (``spin_ms`` at ~2 GHz) keeps the device busy
    while the host queues every call, so host launch overhead is not in
    the device time as long as the spin outlasts the enqueueing."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda._sleep(int(spin_ms * 2e6))
    t0 = time.perf_counter()
    for start, end in events:
        start.record()
        fn()
        end.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events), host_ms


# -- kernel inputs ------------------------------------------------------------
def paged_inputs(seed, lengths, H, Hkv, D, bs, dtype, int8, dev, mb=None):
    """Random q and pools, each row's table a run of distinct blocks, ``mb``
    columns wide (default: as many as the longest row needs)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B = len(lengths)
    mb = mb or max(1, max(-(-n // bs) for n in lengths))
    n_blocks = 1 + B * mb
    q = torch.randn((B, H, D), generator=g, device=dev).to(dtype)
    pk = torch.randn((n_blocks, Hkv, bs, D), generator=g, device=dev)
    pv = torch.randn((n_blocks, Hkv, bs, D), generator=g, device=dev)
    perm = torch.randperm(n_blocks - 1, generator=g, device=dev) + 1
    tables = perm[: B * mb].view(B, mb).to(torch.int32).contiguous()
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    if int8:
        pk, ks = pa.quantize_kv(pk)
        pv, vs = pa.quantize_kv(pv)
        return q, pk, pv, tables, lens, ks, vs
    return q, pk.to(dtype), pv.to(dtype), tables, lens, None, None


def verify_inputs(seed, dtype, dev):
    """The paged-decode kernel's inputs as ``decode_block_paged`` makes
    them for the pair's speculative engine: 8 slots x (spec_k + 1) flat
    rows, H = Hkv = 8, D = 128, block 64, a table of max_len / 64 = 16
    blocks per slot repeated for its 5 rows, row (b, j) of length
    pos_b + j + 1. A parked slot has a zeroed table (scratch block 0)
    and lengths 1..5."""
    k1 = SPEC_K + 1
    lengths = [pos + j + 1 if pos is not None else j + 1
               for pos in VERIFY_POSITIONS for j in range(k1)]
    q, pk, pv, tables, lens, _, _ = paged_inputs(
        seed, lengths, PAIR_TARGET.n_heads, PAIR_TARGET.n_kv_heads, PAIR_TARGET.head_dim, 64,
        dtype, False, dev)
    tables = tables[::k1].clone()
    tables[torch.tensor([pos is None for pos in VERIFY_POSITIONS], device=dev)] = 0
    return q, pk, pv, tables.repeat_interleave(k1, dim=0).contiguous(), lens, None, None


def library_attention(q, pk, pv, tables, lengths, ks, vs):
    """Gather + scaled_dot_product_attention: the library yardstick for
    the kernel (timed here only; the port never calls it)."""
    B, H, D = q.shape
    _, Hkv, bs, _ = pk.shape
    idx = tables.long()
    T = idx.shape[1] * bs
    keys = pk[idx].permute(0, 2, 1, 3, 4).reshape(B, Hkv, T, D)
    vals = pv[idx].permute(0, 2, 1, 3, 4).reshape(B, Hkv, T, D)
    if ks is not None:
        keys = pa.dequantize_kv(keys, ks[idx].permute(0, 2, 1, 3).reshape(B, Hkv, T), q.dtype)
        vals = pa.dequantize_kv(vals, vs[idx].permute(0, 2, 1, 3).reshape(B, Hkv, T), q.dtype)
    mask = (torch.arange(T, device=q.device)[None, :] < lengths[:, None])[:, None, None, :]
    out = F.scaled_dot_product_attention(q[:, :, None, :], keys, vals, attn_mask=mask,
                                         enable_gqa=H != Hkv)
    return out[:, :, 0, :]


def bound(q, pk, tables, lengths, int8, kv_lengths=None) -> tuple[float, str]:
    """Least time the card could take: each input read once, the output
    written once, K/V only for the positions this run's lengths cover
    (``kv_lengths``: once per slot where rows share a slot's blocks)."""
    B, H, D = q.shape
    _, Hkv, _, _ = pk.shape
    tokens = int((lengths if kv_lengths is None else kv_lengths).sum().item())
    nbytes = 2 * tokens * Hkv * D * pk.element_size()
    if int8:
        nbytes += 2 * tokens * Hkv * 4  # f32 scales
    nbytes += 2 * q.numel() * q.element_size() + tables.numel() * 4 + lengths.numel() * 4
    flops = 4 * tokens * H * D
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def paged_plan(q, pk, tables, int8) -> dict:
    """The split plan the wrapper launches these inputs with."""
    B, _, D = q.shape
    _, Hkv, bs, _ = pk.shape
    plan = pa.plan_splits(B, Hkv, tables.shape[1], bs, D, pk.element_size(), int8,
                          torch.cuda.get_device_properties(0).multi_processor_count)
    return plan._asdict()


# the split kernel's parity cases beside the main-path ones: (lengths,
# H, Hkv, table width); D = 128, block 64
SPLIT_PARITY = {
    # lengths on and beside tile and split edges, a full table, a dead row;
    # GQA with 8 query heads a KV head
    "split_edges": ([1, 63, 64, 65, 1023, 1024, 1025, 4095, 4096, 0], 32, 4, None),
    # one row at context 4096: its 64 blocks cut over many blocks
    "b1_ctx4096": ([4096], 32, 32, None),
}


# -- phases -------------------------------------------------------------------
def phase_parity(dev) -> dict:
    """Kernel vs plain version at main-path shapes: D=128, bs=64; ragged
    lengths (full table >= 2048, partial last block, length 1, dead
    slot); MHA (H=Hkv=32, Llama-2-7B) and GQA (H=32, Hkv=8); float and
    int8 pools, bf16 and f32; the split cases (``SPLIT_PARITY``). Then the
    [B*K = 40] verification rows of the speculative path
    (``verify_inputs``), bf16 and f32."""
    cases = {"mha": ([2560, 700, 1, 0, 2100], 32, 32, None),
             "gqa": ([2560, 700, 1, 0, 2100], 32, 8, None), **SPLIT_PARITY}
    errs, head_rel = {}, {}
    for case, (lengths, H, Hkv, mb) in cases.items():
        for dtype in (torch.bfloat16, torch.float32):
            for int8 in (False, True):
                args = paged_inputs(1, lengths, H, Hkv, 128, 64, dtype, int8, dev, mb)
                got = pa.paged_decode_attention(*args)
                torch.cuda.synchronize()  # lint: allow(JIT502) — parity: one readback per case, after its kernel ran
                assert pa.LAST_DISPATCH["impl"] == "cuda"
                ref = pa.paged_decode_reference(*args)
                live = args[4] > 0
                assert (got[~live] == 0).all(), "dead rows must be exactly zero"
                diff = (got[live].float() - ref[live].float()).abs()
                err = diff.max().item()  # lint: allow(JIT502) — parity: one readback per case, after its kernel ran
                rel = (diff.amax(-1) / ref[live].float().abs().amax(-1)).max().item()  # lint: allow(JIT502) — parity: one readback per case, after its kernel ran
                name = f"{case}/{str(dtype)[6:]}/{'int8' if int8 else 'float'}"
                if dtype == torch.float32:
                    torch.testing.assert_close(got[live], ref[live], rtol=F32_RTOL, atol=F32_ATOL)
                else:
                    assert err <= BF16_MAX_ABS, f"{name}: bf16 max abs error {err}"
                    assert rel <= BF16_HEAD_REL, f"{name}: bf16 per-head relative error {rel}"
                # the splits merge in a fixed order: a second launch repeats bit for bit
                assert torch.equal(pa.paged_decode_attention(*args), got), f"{name}: not repeatable"
                errs[name], head_rel[name] = err, rel
    # the speculative path's verification rows
    for dtype in (torch.bfloat16, torch.float32):
        args = verify_inputs(3, dtype, dev)
        assert args[0].shape == (40, 8, 128) and args[3].shape == (40, 16)
        got = pa.paged_decode_attention(*args)
        torch.cuda.synchronize()  # lint: allow(JIT502) — parity: one readback per case, after its kernel ran
        assert pa.LAST_DISPATCH["impl"] == "cuda"
        ref = pa.paged_decode_reference(*args)
        diff = (got.float() - ref.float()).abs()
        err = diff.max().item()  # lint: allow(JIT502) — parity: one readback per case, after its kernel ran
        rel = (diff.amax(-1) / ref.float().abs().amax(-1)).max().item()  # lint: allow(JIT502) — parity: one readback per case, after its kernel ran
        name = f"verify/{str(dtype)[6:]}/float"
        if dtype == torch.float32:
            torch.testing.assert_close(got, ref, rtol=F32_RTOL, atol=F32_ATOL)
        else:
            assert err <= BF16_MAX_ABS, f"{name}: bf16 max abs error {err}"
            assert rel <= BF16_HEAD_REL, f"{name}: bf16 per-head relative error {rel}"
        errs[name], head_rel[name] = err, rel
    return errs, head_rel


# the kernel's timing cases: (lengths, table width); H = Hkv = 32, D =
# 128, block 64 (Llama-2-7B)
PAGED_TIMING = {
    # a decode step's attention, per layer, at context 1024: the pool kinds
    "bf16": ([1024] * 8, None), "int8": ([1024] * 8, None),
    # the same rows in the engine's table width (max_len 2048 / 64)
    "b8_mb32_ctx1024": ([1024] * 8, 32),
    # one row at context 4096
    "b1_ctx4096": ([4096], None),
}


def phase_timing(dev) -> dict:
    """Each ``PAGED_TIMING`` case (q bf16; pool int8 for "int8", else
    bf16) and the speculative path's verification rows (``verify_b40``,
    bf16): the kernel (split and combine) beside its plain version, gather
    + SDPA and its bound. The K/V read of the B = 8 cases (134 MB bf16, 67
    MB int8) exceeds the 50 MB L2, so it comes from HBM; the B = 1 row
    (67 MB) too. The kernel reads a slot's blocks once for each of its
    verification rows; their bound reads them once a slot."""
    out = {}
    cases = {name: paged_inputs(2, lengths, 32, 32, 128, 64, torch.bfloat16, name == "int8", dev,
                                mb)
             for name, (lengths, mb) in PAGED_TIMING.items()}
    cases["verify_b40"] = verify_inputs(3, torch.bfloat16, dev)
    for name, args in cases.items():
        int8 = name == "int8"
        q, pk, pv, tables, lens, ks, vs = args
        ms, _ = device_ms(lambda: pa.paged_decode_attention(*args), 200)
        got = pa.paged_decode_attention(*args)
        assert torch.equal(got, pa.paged_decode_attention(*args))
        plain, _ = device_ms(lambda: pa.paged_decode_reference(*args), 20)
        lib, _ = device_ms(lambda: library_attention(*args), 50)
        lib_err = (library_attention(*args).float() - got.float()).abs().max().item()  # lint: allow(JIT502) — the library call's error, read once per timed shape
        # the verification rows of a slot share its blocks: read once
        kv_lens = lens.view(-1, SPEC_K + 1).amax(1) if name == "verify_b40" else None
        bound_ms, bound_by = bound(q, pk, tables, lens, int8, kv_lens)
        out[name] = {
            "kernel_ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_share": bound_ms / ms, "library_max_abs_err": lib_err,
            "plan": paged_plan(q, pk, tables, int8), "table_width": tables.shape[1],
        }
    return out


def phase_small_reference(dev) -> dict:
    """The model on the card against the same model on the CPU (the plain
    path) on a small float32 input: TINY, a chunked prefill then decode
    steps fed the CPU's greedy tokens, float and int8 pools. Logits must
    agree to atol 1e-3 (float32 with TF32 off; different sum orders)."""
    cfg = dataclasses.replace(tfm.TINY, dtype=torch.float32)
    cpu = torch.device("cpu")
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    gparams = {
        "embed": params["embed"].to(dev), "final_norm": params["final_norm"].to(dev),
        "lm_head": params["lm_head"].to(dev),
        "layers": [{k: v.to(dev) for k, v in layer.items()} for layer in params["layers"]],
    }
    worst = {}
    for kv in (None, "int8"):
        pools = {d: tfm.init_paged_pool(cfg, 9, 8, kv, d) for d in (cpu, dev)}
        prompt = torch.randint(1, cfg.vocab_size, (13,), generator=torch.Generator().manual_seed(1))
        err = 0.0
        logits = {}
        for d, p in ((cpu, params), (dev, gparams)):
            table = torch.tensor([3, 5, 1, 7], device=d)
            logits[d], _ = tfm.prefill_chunk_paged(p, pools[d], table, prompt.to(d), 0, cfg)
        err = max(err, (logits[dev].cpu() - logits[cpu]).abs().max().item())  # lint: allow(JIT502) — the card's result read back to hold it to the CPU's
        tables = torch.tensor([[3, 5, 1, 7], [2, 4, 0, 0]], dtype=torch.int32)
        tok = torch.stack([logits[cpu][-1].argmax(), torch.tensor(9)])
        pos = torch.tensor([13, 0])
        for _ in range(6):
            step = {}
            for d, p in ((cpu, params), (dev, gparams)):
                step[d], _ = tfm.decode_tokens_paged(p, pools[d], tables.to(d), tok.to(d),
                                                     pos.to(d), cfg)
            err = max(err, (step[dev].cpu() - step[cpu]).abs().max().item())  # lint: allow(JIT502) — the card's result read back to hold it to the CPU's
            tok, pos = step[cpu].argmax(-1), pos + 1
        assert err <= 1e-3, f"card vs CPU logits differ by {err} ({kv or 'float'} pool)"
        worst[kv or "float"] = err
    return worst


def decode_step_times(engine) -> dict:
    """One Llama-2-7B decode step for 8 slots at context 1024 (blocks
    1..128 of the still-unused pool), three ways: ``eager_ms``, CUDA
    events around the eager call as the engine runs it (the device waits
    for the host between launches); ``host_ms``, the host's time to
    enqueue that call; ``graph_ms``, the same step captured in a CUDA
    graph and replayed — device time with no host in the way."""
    B, bs = 8, engine.block_size
    mb = 1024 // bs
    tables = torch.arange(1, 1 + B * mb, dtype=torch.int32, device=engine.device).view(B, mb)
    tok = torch.arange(B, device=engine.device)
    pos = torch.full((B,), 1023, device=engine.device)

    def step():
        return tfm.decode_tokens_paged(engine.params, engine.pool, tables, tok, pos, engine.cfg)

    eager, host = [], []
    with torch.no_grad():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                step()
        torch.cuda.current_stream().wait_stream(side)
        for _ in range(5):
            torch.cuda.synchronize()  # lint: allow(JIT502) — timing: each timed run starts on an idle card
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            step()
            end.record()
            host.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()  # lint: allow(JIT502) — timing: each timed run starts on an idle card
            eager.append(start.elapsed_time(end))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        graph_ms, _ = device_ms(graph.replay, 10)
    return {"eager_ms": statistics.median(eager), "host_ms": statistics.median(host),
            "graph_ms": graph_ms}


def prewarm_engine(engine) -> dict:
    """``engine.prewarm()``: every decode chunk and spec round captured as
    a CUDA graph before traffic. The paged-decode wrapper counts its
    launches only here: once in each program's warm-up run and once in
    its capture, so twice the launches its replays will account."""
    pa.LAUNCHES = 0
    t0 = time.monotonic()
    timings = engine.prewarm()
    seconds = time.monotonic() - t0
    st = engine.stats()
    keys = engine._programs.keys()
    per_replay = sum(engine.cfg.n_layers * (key[1] if key[0] == "decode" else engine.spec_depth)
                     for key in keys)
    assert st["graph_captures"] == len(keys), (st["graph_captures"], len(keys))
    assert pa.LAUNCHES == 2 * per_replay, (pa.LAUNCHES, per_replay)
    return {"seconds": seconds, "captures": st["graph_captures"],
            "graphs_s": sum(v for k, v in timings.items() if k.startswith(("decode_", "spec_"))),
            "launches_at_capture": pa.LAUNCHES}


def drive_engine(engine, requests) -> dict:
    """Submit every request at once, wait for all; decode steps and the
    paged-decode launches of the engine's graph replays counted over
    exactly this run. ``prewarm`` captured every program, so no graph is
    captured in the run and the wrapper's own count stays at 0: every
    launch is a replay's."""
    reset_counts()
    before = engine.stats()
    t0 = time.monotonic()
    handles = [engine.submit(p, n, **kw) for p, n, kw in requests]
    results = [h.result(timeout=600) for h in handles]
    wall = time.monotonic() - t0
    st = engine.stats()
    steps = st["decode_steps"] - before["decode_steps"]
    launches = st["paged_decode_launches"] - before["paged_decode_launches"]
    assert st["graph_captures"] == before["graph_captures"], "a graph was captured in the run"
    assert pa.LAUNCHES == 0, f"{pa.LAUNCHES} launches outside the graphs"
    assert steps > 0 and launches == engine.cfg.n_layers * steps, (launches, steps)
    vocab = engine.cfg.vocab_size
    for toks in results:
        assert all(0 <= t < vocab for t in toks)
    ttft = [h.first_token_at - h.submitted_at for h in handles]
    return {
        "results": results, "launches": launches, "decode_steps": steps, "wall_s": wall,
        "tokens": sum(len(h.tokens) for h in handles),
        "tok_per_s": sum(len(h.tokens) for h in handles) / wall,
        "ttft_s": ttft,
        "decode_dispatches": st["decode_dispatches"] - before["decode_dispatches"],
        "dispatch_depth_occupancy": st["dispatch_depth_occupancy"],
    }


def serving_requests(cfg) -> list:
    rng = np.random.default_rng(0)
    S, E = 1234, 4321  # forced token, EOS id
    return [
        (rng.integers(1, cfg.vocab_size, 7).tolist(), 32, {}),
        (rng.integers(1, cfg.vocab_size, 120).tolist(), 32, {}),
        (rng.integers(1, cfg.vocab_size, 333).tolist(), 32,
         {"temperature": 0.8, "top_p": 0.9, "seed": 7}),
        (rng.integers(1, cfg.vocab_size, 520).tolist(), 32, {}),  # two prefill chunks
        (rng.integers(1, cfg.vocab_size, 700).tolist(), 32, {}),  # 512 + 188
        # every token forced to S; EOS never comes; the stop [S, S] only
        # counts once it lies past min_new_tokens=4: gen 6, result 4 tokens
        (rng.integers(1, cfg.vocab_size, 64).tolist(), 32,
         {"eos_id": E, "stop": [[S, S]], "min_new_tokens": 4, "logit_bias": {S: 1e4}}),
    ]


GREEDY = (0, 1, 3, 4)  # the plain greedy requests of serving_requests


def argmax_ties(params, cfg, prompt, out, bound) -> list:
    """The tokens of the greedy stream ``out`` that are not the argmax of
    ONE eager full-sequence forward over prompt + out, each of which must
    lie within ``bound`` (absolute logits, from ``logit_path_gaps``) of
    the top logit: the near-ties."""
    toks = torch.tensor([prompt + out[:-1]], device=params["embed"].device)
    with torch.no_grad():
        logits = tfm.forward(params, toks, cfg)[0, len(prompt) - 1:]
    top = logits.max(dim=-1)
    picked = logits.gather(1, torch.tensor(out, device=logits.device)[:, None])[:, 0]
    gaps = (top.values - picked).tolist()
    ties = [{"position": j, "tokens": [t, int(top.indices[j])], "gap": g}
            for j, (t, g) in enumerate(zip(out, gaps)) if g > 0]
    assert all(t["gap"] <= bound for t in ties), (ties, bound)
    return ties


STEADY = {"requests": 8, "prompt": 64, "new_tokens": 256}
PREFIX = {"requests": 8, "shared": 512, "tail": 64, "new_tokens": 16}


def steady_burst(engine) -> dict:
    """8 requests with 64-token prompts and 256 new tokens, at once: the
    decode rate from the moment every request has its first token (all 8
    slots decoding) to the last token, on the host clock: ms per decode
    step the engine dispatched and tokens/s."""
    rng = np.random.default_rng(2)
    vocab = engine.cfg.vocab_size
    t_submit = time.monotonic()
    handles = [engine.submit(rng.integers(1, vocab, STEADY["prompt"]).tolist(),
                             STEADY["new_tokens"]) for _ in range(STEADY["requests"])]
    while not all(h.first_token_at for h in handles):
        time.sleep(0.0005)
    t0, s0 = time.monotonic(), engine.stats()
    results = [h.result(timeout=600) for h in handles]
    t1, s1 = time.monotonic(), engine.stats()
    assert [len(r) for r in results] == [STEADY["new_tokens"]] * STEADY["requests"]
    steps = s1["decode_steps"] - s0["decode_steps"]
    tokens = s1["tokens_generated"] - s0["tokens_generated"]
    return {**STEADY, "decode_steps": steps, "seconds": t1 - t0,
            "ms_per_step": (t1 - t0) * 1e3 / steps, "tok_per_s": tokens / (t1 - t0),
            "burst_tok_per_s": sum(map(len, results)) / (t1 - t_submit),
            "readback_wait_s": s1["readback_wait_s"] - s0["readback_wait_s"],
            "host_sched_s": s1["host_sched_s"] - s0["host_sched_s"],
            "dispatch_depth_occupancy": s1["dispatch_depth_occupancy"]}


def prefix_burst(engine) -> dict:
    """One request publishes a 512-token prefix (with the cache on), then
    8 requests sharing it, each with its own 64-token tail, arrive at
    once: their time to first token, and the prefix tokens they found
    cached."""
    rng = np.random.default_rng(3)
    vocab = engine.cfg.vocab_size
    shared = rng.integers(1, vocab, PREFIX["shared"]).tolist()
    engine.submit(shared + [1], 1).result(timeout=600)
    before = engine.stats()
    prompts = [shared + rng.integers(1, vocab, PREFIX["tail"]).tolist()
               for _ in range(PREFIX["requests"])]
    handles = [engine.submit(p, PREFIX["new_tokens"]) for p in prompts]
    results = [h.result(timeout=600) for h in handles]
    ttft = [h.first_token_at - h.submitted_at for h in handles]
    hits = engine.stats()["prefix_hit_tokens"] - before["prefix_hit_tokens"]
    return {"results": results, "prefix_hit_tokens": hits,
            "ttft_s_median": statistics.median(ttft), "ttft_s_max": max(ttft)}


def phase_engine(params, dev, card) -> tuple[dict, InferenceEngine, list, list]:
    """Llama-2-7B at the engine's defaults (depth-2 window, prefix cache,
    every decode chunk a replayed graph) after ``prewarm``: the burst,
    each greedy stream held to the eager forward's argmax, the steady
    decode rate and the shared-prefix burst."""
    cfg = tfm.LLAMA2_7B
    engine = InferenceEngine(params, cfg, device=dev, max_slots=8, max_len=2048)
    # finite logits of the right shape from one full-width prefill chunk
    # (all-zero table: writes land in scratch block 0)
    logits, _ = tfm.prefill_chunk_paged(
        params, engine.pool, torch.zeros(engine.max_blocks, dtype=torch.int32, device=dev),
        torch.arange(1, 17, device=dev), 0, cfg,
    )
    assert tuple(logits.shape) == (16, cfg.vocab_size) and torch.isfinite(logits).all()
    step = decode_step_times(engine)
    warm = prewarm_engine(engine)
    engine.start()
    engine.submit(list(range(1, 9)), 4).result(timeout=600)  # warm-up, not counted
    requests = serving_requests(cfg)
    run = drive_engine(engine, requests)
    results = run.pop("results")
    assert [len(r) for r in results[:5]] == [32] * 5, [len(r) for r in results]
    assert results[5] == [1234] * 4, results[5]
    # every position a generated token was chosen at, the prompt's last
    gaps = logit_path_gaps(params, cfg, [requests[i][0] + results[i] for i in GREEDY], dev,
                           LOGIT_PATH_REL_7B, positions=len(results[0]) + 1)
    tie_bound = NEAR_TIE_GAPS * (gaps["verify_vs_decode"] + gaps["forward_vs_decode"])
    ties = [t for i in GREEDY for t in argmax_ties(params, cfg, requests[i][0], results[i],
                                                    tie_bound)]
    steady = steady_burst(engine)
    prefix = prefix_burst(engine)
    st = engine.stats()
    assert st["requests_failed"] == 0
    assert st["free_blocks"] + st["prefix_cached_blocks"] == st["total_blocks"]
    assert st["graph_captures"] == warm["captures"]
    return {
        "phase": "engine", "model": "llama2-7b", "kv_pool": "bf16", "card": card,
        "dispatch_depth": st["dispatch_depth"], "prefix_cache": engine.prefix_cache_enabled,
        "prompt_lens": [len(p) for p, _, _ in requests], "max_new_tokens": 32,
        "decode_step_b8_ctx1024": step, "prewarm": warm,
        "ttft_s_median": statistics.median(run["ttft_s"]), "ttft_s_max": max(run["ttft_s"]),
        **{k: v for k, v in run.items() if k != "ttft_s"},
        "argmax_near_ties": ties, "near_tie_bound": tie_bound, "logit_path_gaps": gaps,
        "logit_path_rel": LOGIT_PATH_REL_7B,
        "steady": steady, "steady_ms_per_step_over_graph_ms": steady["ms_per_step"] / step["graph_ms"],
        "prefix_burst": {k: v for k, v in prefix.items() if k != "results"},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }, engine, results, prefix["results"]


def phase_engine_variants(params, dev, card, results, prefix_results) -> dict:
    """The same burst at dispatch depth 1 (the serial loop, replaying the
    same graphs) gives the same streams as depth 2, and the shared-prefix
    burst with the prefix cache off gives the same streams as with it on,
    at its own time to first token. Then ``no_metrics``: the steady burst
    on an engine with metrics on and one with them off, both alive,
    alternated on, off, off, on: each one's ms per decode step."""
    cfg = tfm.LLAMA2_7B
    out = {"phase": "engine_variants", "model": "llama2-7b", "card": card}
    for name, kw in (("depth1", {"dispatch_depth": 1}), ("no_prefix_cache", {"prefix_cache": False})):
        engine = InferenceEngine(params, cfg, device=dev, max_slots=8, max_len=2048, **kw)
        warm = prewarm_engine(engine)
        engine.start()
        try:
            engine.submit(list(range(1, 9)), 4).result(timeout=600)  # warm-up, not counted
            if name == "depth1":
                run = drive_engine(engine, serving_requests(cfg))
                assert run.pop("results") == results, "depth 1 and depth 2 streams differ"
                out[name] = {k: v for k, v in run.items() if k != "ttft_s"}
            else:
                prefix = prefix_burst(engine)
                assert prefix.pop("results") == prefix_results, "the prefix cache changed a stream"
                assert prefix["prefix_hit_tokens"] == 0
                out[name] = {"prefix_burst": prefix}
            out[name]["prewarm"] = warm
            assert engine.stats()["requests_failed"] == 0
        finally:
            engine.stop()
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    engines = {m: InferenceEngine(params, cfg, device=dev, max_slots=8, max_len=2048, metrics=m)
               for m in (True, False)}
    try:
        assert engines[True].telemetry is not None and engines[False].telemetry is None
        for engine in engines.values():
            prewarm_engine(engine)
            engine.start()
            engine.submit(list(range(1, 9)), 4).result(timeout=600)  # warm-up, not counted
        steady = {True: [], False: []}
        for m in (True, False, False, True):
            steady[m].append(steady_burst(engines[m]))
        for engine in engines.values():
            assert engine.stats()["requests_failed"] == 0
        assert engines[False].metrics_text() == ""
        out["no_metrics"] = {
            f"metrics_{'on' if m else 'off'}": {
                "ms_per_step": [r["ms_per_step"] for r in runs],
                "tok_per_s": [r["tok_per_s"] for r in runs]}
            for m, runs in steady.items()}
        on = statistics.mean(r["ms_per_step"] for r in steady[True])
        off = statistics.mean(r["ms_per_step"] for r in steady[False])
        out["no_metrics"]["on_over_off_ms_per_step"] = on / off
    finally:
        for engine in engines.values():
            engine.stop()
    del engines
    gc.collect()
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def http_server(engine, model: str):
    """The port's HTTP server over ``engine`` on a free local port: yields
    its base URL, shuts the server down on exit."""
    server = serve.Server(engine, model)
    httpd = serve.make_http_server(server, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
        thread.join(timeout=30)


def http_json(url: str, path: str, body: dict) -> tuple[int, dict]:
    """(status, reply) of one JSON POST."""
    req = urllib.request.Request(url + path, data=json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def phase_http(engine, card) -> dict:
    with http_server(engine, "llama2-7b") as url:
        body = json.dumps({"prompt_ids": list(range(100, 140)), "max_new_tokens": 8}).encode()
        t0 = time.monotonic()
        with urllib.request.urlopen(urllib.request.Request(url + "/generate", data=body),
                                    timeout=300) as resp:
            assert resp.status == 200
            tokens = json.loads(resp.read())["tokens"]
        elapsed = time.monotonic() - t0
        with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
    assert len(tokens) == 8 and all(0 <= t < engine.cfg.vocab_size for t in tokens)
    assert health["ok"] and health["requests_failed"] == 0
    return {"phase": "http", "card": card, "tokens": len(tokens), "round_trip_s": elapsed}


def phase_engine_int8(params, dev, card) -> dict:
    cfg = tfm.LLAMA2_7B
    engine = InferenceEngine(params, cfg, device=dev, max_slots=8, max_len=2048, kv_dtype="int8")
    warm = prewarm_engine(engine)
    engine.start()
    try:
        rng = np.random.default_rng(1)
        requests = [(rng.integers(1, cfg.vocab_size, n).tolist(), 16, {}) for n in (7, 100, 300, 600)]
        run = drive_engine(engine, requests)
        results = run.pop("results")
        assert [len(r) for r in results] == [16] * 4
        assert engine.stats()["requests_failed"] == 0
    finally:
        engine.stop()
    return {
        "phase": "engine", "model": "llama2-7b", "kv_pool": "int8", "card": card, "prewarm": warm,
        "ttft_s_median": statistics.median(run["ttft_s"]),
        **{k: v for k, v in run.items() if k != "ttft_s"},
        # the tensor-parallel engine's int8 pool serves these again (parallel)
        "reference": {"requests": requests, "results": results},
    }


# -- int8 weights from a checkpoint ------------------------------------------------
def tree_bytes(params: dict) -> int:
    """Bytes of a param tree's leaves, an int8 weight's ``q`` and ``scale``
    both counted."""
    total = 0
    for leaf in ttrainer.param_leaves(params):
        parts = (leaf.q, leaf.scale) if isinstance(leaf, wq.QuantizedLinear) else (leaf,)
        total += sum(t.numel() * t.element_size() for t in parts)
    return total


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# the weight shapes of one Llama-2-7B decode step ([D_in, D_out]) and how
# many of each a step multiplies: wq, wk, wv, wo; w_gate, w_up; w_down (32
# layers each); lm_head
INT8_PRODUCT_SHAPES = {"attn": ((4096, 4096), 4 * 32), "gate_up": ((4096, 11008), 2 * 32),
                       "down": ((11008, 4096), 32), "lm_head": ((4096, 32000), 1)}


def int8_product_times(dev, rows: int = 8) -> dict:
    """Where the int8 weight product's time goes, at a decode step's
    shapes (``rows`` x D_in bf16 activations), each kind cycling through
    enough distinct weights to miss the 50 MB L2 as the 32 layers do:
    the dense bf16 product, the card's int8 product whole, its upcast of
    ``q`` alone and its float32-output product alone (and the same
    product with bf16 output, for comparison), with the bytes bound of
    the int8 product (``q`` read once); then each summed over one step's
    products."""
    g = torch.Generator(device=dev).manual_seed(11)
    out = {}
    for name, ((d_in, d_out), _) in INT8_PRODUCT_SHAPES.items():
        n = max(2, math.ceil(200e6 / (2 * d_in * d_out)))
        dense = [(torch.randn((d_in, d_out), generator=g, device=dev) * 0.02).to(torch.bfloat16)
                 for _ in range(n)]
        quant = [wq.quantize_weight(w) for w in dense]
        upcast = [ql.q.to(torch.bfloat16) for ql in quant]
        x = torch.randn((rows, d_in), generator=g, device=dev).to(torch.bfloat16)
        it = iter(range(1 << 30))
        cases = {
            "dense_bf16": lambda: x @ dense[next(it) % n],
            "int8": lambda: x @ quant[next(it) % n],
            "upcast": lambda: quant[next(it) % n].q.to(torch.bfloat16),
            "mm_f32_out": lambda: torch.mm(x, upcast[next(it) % n], out_dtype=torch.float32),
            "mm_bf16_out": lambda: torch.mm(x, upcast[next(it) % n]),
        }
        out[name] = {case: device_ms(fn, 40)[0] for case, fn in cases.items()}
        out[name]["int8_bound_ms"] = (d_in * d_out + 4 * d_out + 2 * rows * (d_in + d_out)) \
            / HBM_BYTES_PER_S * 1e3
        del dense, quant, upcast
    out["step"] = {case: sum(out[name][case] * count
                             for name, (_, count) in INT8_PRODUCT_SHAPES.items())
                   for case in out["attn"]}
    return out


def phase_int8_weights(params, dev, card, bf16_graph_ms, tmp: str, cfg=tfm.LLAMA2_7B,
                       model="llama2-7b") -> dict:
    """The train -> serve seam at full width with int8 weights: the params
    in memory saved by ``save_checkpoint`` as a bare tree into ``tmp``, a
    temporary directory the caller removes (its free space checked first),
    and restored by
    ``load_serving_params`` (every leaf equal to the saved one byte for
    byte); ``q`` and ``scale`` made on the card equal those made on the
    CPU from the same leaf (lm_head, the first and last layers'
    w_down); then ``serve.build_engine(checkpoint=..., quantize="int8")``
    serves after ``prewarm`` — the smoke requests, each greedy stream
    held to an eager forward's argmax over the same int8 params up to
    near ties, and the steady burst — with no graph captured after
    prewarm, while a bf16 engine over the same weights stays alive
    (peak memory with both)."""
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    dense_bytes = tree_bytes(params)
    free = shutil.disk_usage(tmp).free
    line = {"phase": "int8_weights", "model": model, "card": card,
            "disk": {"free_gb": free / 1e9, "checkpoint_gb": dense_bytes / 1e9}}
    if free < 1.05 * dense_bytes:
        raise RuntimeError(f"{tmp}: {free / 1e9:.2f} GB free, the checkpoint needs "
                           f"{dense_bytes / 1e9:.2f} GB")
    engines = []
    try:
        sync(dev)
        t0 = time.monotonic()
        save_checkpoint(os.path.join(tmp, "step_00000001"), params)
        save_s = time.monotonic() - t0
        t0 = time.monotonic()
        restored, step = load_serving_params(tmp, cfg, device=dev)
        sync(dev)
        load_s = time.monotonic() - t0
        assert step == 1 and assert_same_bytes(restored, params) == dense_bytes
        del restored
        layers = params["layers"]
        checked = {"lm_head": params["lm_head"], "layers.0.w_down": layers[0]["w_down"],
                   f"layers.{len(layers) - 1}.w_down": layers[-1]["w_down"]}
        for name, leaf in checked.items():
            here, there = wq.quantize_weight(leaf), wq.quantize_weight(leaf.cpu())  # lint: allow(JIT502) — each leaf's int8 bytes held to the CPU's, read back once
            assert torch.equal(here.q.cpu(), there.q), name  # lint: allow(JIT502) — each leaf's int8 bytes held to the CPU's, read back once
            assert torch.equal(bits(here.scale.cpu()), bits(there.scale)), name  # lint: allow(JIT502) — each leaf's int8 bytes held to the CPU's, read back once
        sync(dev)
        t0 = time.monotonic()
        qtree = wq.quantize_params(params)
        sync(dev)
        quantize_s = time.monotonic() - t0
        del qtree
        products = int8_product_times(dev)
        bf16 = InferenceEngine(params, cfg, device=dev, max_slots=8,
                               max_len=min(2048, cfg.max_seq_len))
        engines.append(bf16)
        bf16_warm = prewarm_engine(bf16)
        t0 = time.monotonic()
        engine = serve.build_engine(model, device=dev, checkpoint=tmp, quantize="int8")
        sync(dev)
        build_s = time.monotonic() - t0
        engines.append(engine)
        for name in wq._MATMUL_LEAVES - {"lm_head"}:
            assert isinstance(engine.params["layers"][0][name], wq.QuantizedLinear), name
        assert isinstance(engine.params["lm_head"], wq.QuantizedLinear)
        step_times = decode_step_times(engine)
        warm = prewarm_engine(engine)
        engine.start()
        engine.submit(list(range(1, 9)), 4).result(timeout=600)  # warm-up, not counted
        requests = serving_requests(cfg)
        run = drive_engine(engine, requests)
        results = run.pop("results")
        n_new = requests[0][1]
        assert [len(r) for r in results[:5]] == [n_new] * 5, [len(r) for r in results]
        assert results[5] == [1234] * 4, results[5]
        gaps = logit_path_gaps(engine.params, cfg, [requests[i][0] + results[i] for i in GREEDY],
                               dev, LOGIT_PATH_REL_7B, positions=n_new + 1)
        tie_bound = NEAR_TIE_GAPS * (gaps["verify_vs_decode"] + gaps["forward_vs_decode"])
        ties = [t for i in GREEDY for t in argmax_ties(engine.params, cfg, requests[i][0],
                                                        results[i], tie_bound)]
        steady = steady_burst(engine)
        st = engine.stats()
        assert st["requests_failed"] == 0
        assert st["graph_captures"] == warm["captures"], "a graph was captured after prewarm"
        line.update({
            "save_s": save_s, "save_gbps": dense_bytes / save_s / 1e9,
            "load_s": load_s, "load_gbps": dense_bytes / load_s / 1e9,
            "dense_params_byte_equal": True, "q_scale_card_equals_cpu": sorted(checked),
            "quantize_s": quantize_s, "build_engine_s": build_s,
            "dense_weight_gb": dense_bytes / 1e9, "int8_weight_gb": tree_bytes(engine.params) / 1e9,
            "decode_step_b8_ctx1024": step_times, "bf16_graph_ms": bf16_graph_ms,
            "graph_ms_over_bf16": step_times["graph_ms"] / bf16_graph_ms,
            "product_ms": products,
            "prewarm": warm, "bf16_engine_prewarm": bf16_warm,
            "prompt_lens": [len(p) for p, _, _ in requests], "max_new_tokens": n_new,
            "ttft_s_median": statistics.median(run["ttft_s"]),
            **{k: v for k, v in run.items() if k != "ttft_s"},
            "argmax_near_ties": ties, "near_tie_bound": tie_bound, "logit_path_gaps": gaps,
            "steady": steady,
            "steady_ms_per_step_over_graph_ms": steady["ms_per_step"] / step_times["graph_ms"],
            "graph_captures_after_prewarm": st["graph_captures"] - warm["captures"],
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else None,
        })
    finally:
        for engine in engines:
            engine.stop()
    return line


# -- the host KV tier and KV migration ------------------------------------------
# the kv_tier phase's engine and traffic at Llama-2-7B: the pool is the
# engine's floor (one max_len sequence plus scratch), the tier's budget
# holds ~60 of the ~17.3 MB int8 payloads, more than the waves spill
KV_TIER = {"max_slots": 2, "max_len": 2048, "block_size": 64, "n_blocks": 33,
           "tier_bytes": 1 << 30, "shared": 512, "distinct": 1024, "tail": 64, "new_tokens": 16}


def kv_tier_waves(cfg, sizes) -> list:
    """The four waves: a shared prompt, two distinct long prompts (which
    evict and, with the tier, spill its chain) and the shared prompt with
    a tail of its own (which restores it)."""
    rng = np.random.default_rng(4)
    V = cfg.vocab_size
    shared = rng.integers(1, V, sizes["shared"]).tolist()
    waves = [shared] + [rng.integers(1, V, sizes["distinct"]).tolist() for _ in range(2)]
    return waves + [shared + rng.integers(1, V, sizes["tail"]).tolist()]


def kv_tier_engine(params, cfg, dev, sizes, kv_dtype, tier) -> InferenceEngine:
    return InferenceEngine(params, cfg, device=dev, max_slots=sizes["max_slots"],
                           max_len=sizes["max_len"], block_size=sizes["block_size"],
                           n_blocks=sizes["n_blocks"], kv_dtype=kv_dtype, kv_tier=tier,
                           kv_tier_bytes=sizes["tier_bytes"])


def run_waves(engine, waves, n_new) -> list:
    """Each wave alone, finishing before the next: its stream, time to
    first token, and the decode steps and paged-decode launches of its
    graph replays."""
    out = []
    for prompt in waves:
        before = engine.stats()
        h = engine.submit(prompt, n_new)
        tokens = h.result(timeout=600)
        st = engine.stats()
        steps = st["decode_steps"] - before["decode_steps"]
        launches = st["paged_decode_launches"] - before["paged_decode_launches"]
        assert launches == engine.cfg.n_layers * steps > 0, (launches, steps)
        out.append({"tokens": tokens, "ttft_s": h.first_token_at - h.submitted_at,
                    "decode_steps": steps, "launches": launches,
                    "restore_hits": st["kv_restore_hits"] - before["kv_restore_hits"]})
    return out


def synced_device_ms(fn, reps: int = 5, spin_ms: float = 200.0) -> float:
    """Median device time of ``fn``, in ms, for a function that waits on
    the card inside: each call runs alone behind its own spin kernel, which
    hides the host's enqueueing (and a restore's staging) as long as it
    outlasts them; the end event, queued once ``fn`` returns, adds the
    host's wake-up after the wait (microseconds)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()  # lint: allow(JIT502) — timing: each timed run starts on an idle card
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_ms * 2e6))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()  # lint: allow(JIT502) — timing: each timed run starts on an idle card
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def tier_group_device_ms(engine) -> dict:
    """Device time of one full ``_RESTORE_BATCH`` group on the engine's
    pool (blocks 1..16; run after the engine has stopped, since the
    restore rewrites them): a spill's ``_gather_blocks`` (the gather, a
    float pool's quantization, the block-major copy into the pinned
    staging) and a restore's ``_restore_group`` (the upload from the
    staging, the layout, a float pool's dequantization, the scatter)."""
    R = einf._RESTORE_BATCH
    blks = list(range(1, R + 1))
    parts = [np.array(a) for a in engine._gather_blocks(blks)]
    group = list(zip(*parts))
    spill_ms = synced_device_ms(lambda: engine._gather_blocks(blks))
    restore_ms = synced_device_ms(lambda: engine._restore_group(blks, group))
    return {"group_blocks": R, "group_bytes": sum(a.nbytes for a in parts),
            "spill_ms_per_block": spill_ms / R, "restore_ms_per_block": restore_ms / R}


def tier_host_profile(engine, n: int) -> dict:
    """Host ms per block of each part of one ``n``-block spill and restore
    on the stopped engine's pool (blocks 1..n), in the engine's order.
    Spill: ``gather`` (the device gather and copy into the pinned staging,
    waited on), ``pack`` (the KVT1 payload: ``tobytes`` copies and the
    join), ``put`` (into a host tier: its blake2b checksum and the LRU
    insert). Restore: ``get`` (the checksum verified), ``unpack`` (views),
    ``stage_scatter`` (``_restore_group``: the copies into the staging,
    the upload and scatter, waited on). Apart: ``checksum`` (blake2b over
    each payload alone, as put and get each run it once) and on the card
    ``pinned_alloc`` (one fresh allocation of an ``n``-block staging set,
    which the engine no longer makes per call; ``cudaHostAlloc`` calls in
    ``pinned_allocs`` where torch counts them)."""
    cuda = engine.device.type == "cuda"
    blks = list(range(1, n + 1))
    tier = kvt.HostKVTier(max_bytes=1 << 40)
    digests = [f"{b:032x}" for b in blks]
    ms: dict = {}

    def clock(name, fn):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3 / n
        return out

    kq, ks, vq, vs = clock("gather", lambda: engine._gather_blocks(blks))
    payloads = clock("pack", lambda: [kvt.pack_kv_payload(kq[b], ks[b], vq[b], vs[b])
                                      for b in range(n)])
    clock("put", lambda: [tier.put(d, p) for d, p in zip(digests, payloads)])
    got = clock("get", lambda: [tier.get(d) for d in digests])
    group = clock("unpack", lambda: [kvt.unpack_kv_payload(p) for p in got])
    clock("stage_scatter", lambda: engine._restore_group(blks, group))
    clock("checksum", lambda: [kvt._checksum(p) for p in payloads])
    out = {"blocks": n, "payload_bytes": len(payloads[0]),
           "spill_ms_per_block": {k: ms[k] for k in ("gather", "pack", "put")},
           "restore_ms_per_block": {k: ms[k] for k in ("get", "unpack", "stage_scatter")},
           "checksum_ms_per_block": ms["checksum"]}
    if cuda:
        count = getattr(torch.cuda, "host_memory_stats", dict)
        before = count().get("num_host_alloc", 0)
        clock("pinned_alloc", lambda: [torch.empty((n,) + tuple(h.shape[1:]), dtype=h.dtype,
                                                   pin_memory=True) for h in engine._stage])
        out["pinned_alloc_ms_per_block"] = ms["pinned_alloc"]
        out["pinned_allocs"] = count().get("num_host_alloc", 0) - before
    return out


def pinned_copy_gbps(nbytes: int, dev) -> dict:
    """The yardstick for the tier's copies: one plain copy of ``nbytes``
    between pinned host memory and the card, each way."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    card = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    h2d, _ = device_ms(lambda: card.copy_(host, non_blocking=True), 5)
    d2h, _ = device_ms(lambda: host.copy_(card, non_blocking=True), 5)
    return {"bytes": nbytes, "h2d_gb_s": nbytes / h2d / 1e6, "d2h_gb_s": nbytes / d2h / 1e6}


def chain_blocks(engine, prompt, n) -> list:
    """The pool blocks the engine's radix tree holds for the first ``n``
    full blocks of ``prompt`` (the engine is stopped)."""
    bs = engine.block_size
    cur = engine._prefix_cache.cursor()
    blks = [cur.step(tuple(prompt[i * bs: (i + 1) * bs])) for i in range(n)]
    assert None not in blks, blks
    return blks


TIER_COUNTERS = ("kv_spill_blocks", "kv_restore_hits", "kv_restore_fallbacks",
                 "recompute_tokens_saved")


def chain_export(engine, prompt) -> dict:
    """The stopped engine's KVM1 envelope of ``prompt``'s full blocks
    (``export_kv_chain``, served inline): its blocks, bytes and blake2b."""
    envelope = engine.export_kv_chain(fingerprint_chain(prompt, engine.block_size)[-1])
    assert envelope is not None
    return {"blocks": len(kvt.unpack_chain_envelope(envelope)), "bytes": len(envelope),
            "blake2b": hashlib.blake2b(envelope, digest_size=32).hexdigest()}


def kv_pool_run(params, cfg, dev, sizes, waves, kv_dtype, tie_bound) -> tuple[dict, list]:
    """The waves on fresh engines with the tier off, then on; the checks
    of the tier-on run, whose streams, tier counters and KVM1 export of
    the shared chain are the line's ``reference`` (the tensor-parallel
    engine's replay is held to them). Returns the pool's line and the
    tier-off wave 4 stream."""
    pool = "int8" if kv_dtype else "bf16"
    n_blocks = sizes["shared"] // sizes["block_size"]
    runs, launches = {}, 0
    for tier in ("off", "host"):
        engine = kv_tier_engine(params, cfg, dev, sizes, kv_dtype, tier)
        warm = prewarm_engine(engine)
        engine.start()
        try:
            reset_counts()
            runs[tier] = run_waves(engine, waves, sizes["new_tokens"])
            assert pa.LAUNCHES == 0, f"{pa.LAUNCHES} launches outside the graphs"
            st = engine.stats()
        finally:
            engine.stop()
        assert st["graph_captures"] == warm["captures"], "a graph was captured in the run"
        assert st["requests_failed"] == 0
        launches += sum(w["launches"] for w in runs[tier])
        if tier == "host":
            # before the device and host profiles, which rewrite pool blocks
            export = chain_export(engine, waves[0])
            tier_st, device = st, tier_group_device_ms(engine) if dev.type == "cuda" else {}
            host_parts = tier_host_profile(engine, n_blocks)
        del engine
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    on, off = runs["host"][3], runs["off"][3]
    assert tier_st["kv_spill_blocks"] > 0, tier_st
    assert on["restore_hits"] == n_blocks, (on["restore_hits"], n_blocks)
    assert tier_st["kv_restore_fallbacks"] == 0, tier_st
    assert tier_st["recompute_tokens_saved"] == sizes["shared"], tier_st
    equal = sum(a == b for a, b in zip(on["tokens"], off["tokens"]))
    ties = None
    if kv_dtype == "int8":
        # q and the scales are restored verbatim: the streams are equal
        assert on["tokens"] == off["tokens"], (on["tokens"], off["tokens"])
    else:
        # int8 noise on the restored blocks: every token is the argmax of
        # an eager forward over the stream, or a near tie
        ties = argmax_ties(params, cfg, waves[3], on["tokens"], tie_bound)
    return {
        "kv_pool": pool, "launches": launches,
        "wave4_ttft_s": {"tier_on_restore": on["ttft_s"], "tier_off_recompute": off["ttft_s"]},
        # with the tier on, wave 3 spills 8 blocks at admission, 16 as it decodes
        "ttft_s_by_wave": {t: [w["ttft_s"] for w in runs[t]] for t in ("host", "off")},
        "wave4_equal_tokens": equal, "wave4_tokens": len(on["tokens"]),
        "wave4_paged_decode_launches": on["launches"], "argmax_near_ties": ties,
        "restore_hits": on["restore_hits"],
        "host_ms_per_block": {
            "restore": tier_st["kv_restore_s"] * 1e3 / tier_st["kv_restore_hits"],
            "spill": tier_st["kv_spill_s"] * 1e3 / tier_st["kv_spill_blocks"]},
        "device": device, "host_parts": host_parts,
        **{k: tier_st[k] for k in ("kv_spill_blocks", "kv_spill_bytes", "kv_restore_fallbacks",
                                   "recompute_tokens_saved", "kv_restores",
                                   "kv_restores_overlapped", "kv_tier_entries",
                                   "kv_tier_resident_bytes")},
        "export": export,
        "reference": {"streams": [w["tokens"] for w in runs["host"]],
                      "counters": {k: tier_st[k] for k in TIER_COUNTERS}, "export": export},
    }, off["tokens"]


def kv_migration_run(params, cfg, dev, sizes, waves, cold, model) -> dict:
    """Two int8-pool engines behind two in-process servers: A prefills the
    shared prompt (``POST /prefill``), B serves wave 4's prompt with
    ``kv_source`` set to A's URL, so the chain's KVM1 envelope crosses
    HTTP. B's stream equals the cold run's; the migrated blocks in B's
    pool equal A's byte for byte."""
    n_blocks = sizes["shared"] // sizes["block_size"]
    a = kv_tier_engine(params, cfg, dev, sizes, "int8", "host")
    b = kv_tier_engine(params, cfg, dev, sizes, "int8", "host")
    warm = [prewarm_engine(e)["captures"] for e in (a, b)]
    try:
        with http_server(a.start(), model) as url_a, http_server(b.start(), model) as url_b:
            reset_counts()
            code, reply = http_json(url_a, "/prefill", {"prompt_ids": waves[0]})
            assert code == 200 and reply == {"prefilled_tokens": len(waves[0])}, (code, reply)
            t0 = time.monotonic()
            code, reply = http_json(url_b, "/generate", {
                "prompt_ids": waves[3], "kv_source": url_a, "max_new_tokens": sizes["new_tokens"]})
            seconds = time.monotonic() - t0
            assert code == 200, (code, reply)
            assert pa.LAUNCHES == 0, f"{pa.LAUNCHES} launches outside the graphs"
    finally:
        a.stop()
        b.stop()
    st_a, st_b = a.stats(), b.stats()
    assert reply["tokens"] == cold, (reply["tokens"], cold)
    assert (st_b["kv_migrate_chains"], st_b["kv_migrate_blocks"], st_b["kv_migrate_failures"]) \
        == (1, n_blocks, 0), st_b
    assert st_a["kv_export_chains"] == 1, st_a
    assert [st_a["graph_captures"], st_b["graph_captures"]] == warm
    assert st_a["requests_failed"] == st_b["requests_failed"] == 0
    for ba, bb in zip(chain_blocks(a, waves[0], n_blocks), chain_blocks(b, waves[3], n_blocks)):
        for key in ("k", "v", "k_scale", "v_scale"):
            assert torch.equal(a.pool[key][:, ba], b.pool[key][:, bb]), (key, ba, bb)
    return {"envelope_bytes": st_b["kv_migrate_bytes"], "migrate_s": st_b["kv_migrate_s"],
            "generate_round_trip_s": seconds, "blocks": st_b["kv_migrate_blocks"],
            "restore_hits": st_b["kv_restore_hits"],
            "launches": st_a["paged_decode_launches"] + st_b["paged_decode_launches"]}


def phase_kv_tier(params, dev, card, tie_bound, cfg=tfm.LLAMA2_7B, sizes=KV_TIER,
                  model: str = "llama2-7b") -> dict:
    """The host KV tier at full width: the four waves on a bf16 pool and
    an int8 pool, each with the tier on and off on fresh engines
    (prewarmed; the restored chain decodes through the paged-decode
    kernel's graph replays), then the migration leg between two servers."""
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    waves = kv_tier_waves(cfg, sizes)
    out = {"phase": "kv_tier", "model": model, "card": card,
           "engine": {k: v for k, v in sizes.items() if k not in ("shared", "distinct", "tail")},
           "waves": [len(w) for w in waves], "new_tokens": sizes["new_tokens"],
           "near_tie_bound": tie_bound}
    for kv_dtype in (None, "int8"):
        line, cold = kv_pool_run(params, cfg, dev, sizes, waves, kv_dtype, tie_bound)
        out[line["kv_pool"]] = line
    # the int8 pool's tier-off wave 4 is the cold run the migration matches
    out["migration"] = kv_migration_run(params, cfg, dev, sizes, waves, cold, model)
    if dev.type == "cuda":
        group = out["bf16"]["device"]["group_bytes"]
        out["pinned_copy"] = pinned_copy_gbps(group, dev)
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["seconds"] = time.monotonic() - t0
    return out


# -- training path ------------------------------------------------------------
def bound_of(nbytes: float, flops: float, flops_per_s: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# flops per live (query, key) pair in units of D: the work each flash
# kernel computes (as flash_bound counts it), and the tensor-core work the
# kernel issues for it: the dk/dv kernel runs dV = P^T dO and dK = dS^T Q
# twice, on bf16 hi and lo terms of P and dS, so 12 D where the work is 8 D
FLASH_WORK_D = {"fwd": 4, "bwd_dq": 6, "bwd_dkv": 8}
FLASH_TENSOR_D = {"fwd": 4, "bwd_dq": 6, "bwd_dkv": 12}


def flash_bound(kernel: str, bh: int, t: int, d: int, causal: bool, elem: int):
    """Least time for one flash kernel: its inputs read once and outputs
    written once, against 4 D (forward), 6 D (dq) or 8 D (dk/dv) flops
    per live (query, key) pair, at the dense bf16 peak."""
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = bh * pairs * d * FLASH_WORK_D[kernel]
    rows, vec = bh * t * d * elem, bh * t * 4
    nbytes = {"fwd": 4 * rows + vec,                 # q, k, v in; o, lse out
              "bwd_dq": 5 * rows + 2 * vec,          # q, k, v, dO, lse, delta in; dq out
              "bwd_dkv": 6 * rows + 2 * vec}[kernel]  # ...; dk, dv out
    return bound_of(nbytes, flops, BF16_FLOPS_PER_S)


def flash_rates(kernel: str, bh: int, t: int, d: int, causal: bool, ms: float,
                bound_ms: float) -> dict:
    """Achieved rates of one flash kernel call that took ``ms``: the work
    (GFLOP) and TFLOP/s, the tensor-core work it issues and that rate, and
    the share of its bound (bound_ms / ms)."""
    pairs = t * (t + 1) // 2 if causal else t * t
    work = bh * pairs * d * FLASH_WORK_D[kernel] / 1e9
    tensor = bh * pairs * d * FLASH_TENSOR_D[kernel] / 1e9
    return {"gflop": work, "tflops": work / ms, "tensor_gflop": tensor,
            "tensor_tflops": tensor / ms, "bound_share": bound_ms / ms}


def xent_bound(b: int, v: int, elem: int):
    """Logits read once, int64 labels read, loss and lse written; about
    four float32 operations per logit (max, subtract, exp, add)."""
    return bound_of(b * v * elem + b * 8 + 2 * b * 4, 4 * b * v, F32_FLOPS_PER_S)


def flash_inputs(seed, shape, dtype, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev).to(dtype) for _ in range(4)]


def flash_run(q, k, v, do, causal):
    """The three kernels, the backward ones from the forward's residuals."""
    o, lse = fa.flash_fwd(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    return o, lse, delta, dq, dk, dv


def kernel_err(got, ref, name) -> tuple[float, float]:
    """(max abs error, max per-head error over the head's largest
    reference value); raises beyond the stated tolerance."""
    diff = (got.float() - ref.float()).abs()
    head = (diff.flatten(1).amax(-1) / ref.float().abs().flatten(1).amax(-1)).max().item()
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=F32_RTOL, atol=F32_ATOL, msg=name)
    else:
        assert head <= BF16_HEAD_REL, f"{name}: bf16 per-head relative error {head}"
    return diff.max().item(), head


def phase_train_kernel_parity(dev) -> dict:
    """Flash forward (O, lse) and backward (dq, dk, dv) against the plain
    versions at the bench LM's [B*H, T, D] and at D = 128, float32 (TF32
    off) and bf16, causal and not; bf16 grads twice for determinism; the
    cross-entropy at the bench step's [B*T, V], f32 and bf16 logits."""
    out = {}
    for shape_name, shape in FLASH_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                q, k, v, do = flash_inputs(3, shape, dtype, dev)
                o, lse, delta, dq, dk, dv = flash_run(q, k, v, do, causal)
                torch.cuda.synchronize()  # lint: allow(JIT502) — parity: one readback per case, after its kernel ran
                assert fa.LAST_DISPATCH["impl"] == "cuda"
                ro, rlse = fa.flash_fwd_reference(q, k, v, causal)
                rdk, rdv = fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal)
                rdq = fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, causal)
                name = f"{shape_name}/{str(dtype)[6:]}/{'causal' if causal else 'full'}"
                torch.testing.assert_close(lse, rlse, rtol=F32_RTOL, atol=1e-4, msg=name + " lse")
                line = {t: kernel_err(g, r, f"{name} {t}")
                        for t, g, r in (("o", o, ro), ("dq", dq, rdq), ("dk", dk, rdk),
                                        ("dv", dv, rdv))}
                line["lse"] = (lse - rlse).abs().max().item()  # lint: allow(JIT502) — parity: one readback per case, after its kernel ran
                if dtype == torch.bfloat16 and causal:
                    again = flash_run(q, k, v, do, causal)
                    line["bitwise_repeat"] = all(
                        torch.equal(a, b) for a, b in zip((dq, dk, dv), again[3:]))
                    assert line["bitwise_repeat"], f"{name}: grads differ between two runs"
                out[name] = line
                del q, k, v, do, o, lse, delta, dq, dk, dv, ro, rlse, rdq, rdk, rdv
                torch.cuda.empty_cache()
    b, vocab = XENT_SHAPE
    g = torch.Generator(device=dev).manual_seed(4)
    labels = torch.randint(0, vocab, (b,), generator=g, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        logits = (3 * torch.randn((b, vocab), generator=g, device=dev)).to(dtype)
        loss, lse = xl.xent_fwd(logits, labels)
        torch.cuda.synchronize()  # lint: allow(JIT502) — parity: one readback per case, after its kernel ran
        assert xl.LAST_DISPATCH["impl"] == "cuda"
        rloss, rlse = xl._xent_fwd_reference(logits, labels)
        torch.testing.assert_close(loss, rloss, rtol=XENT_RTOL, atol=XENT_ATOL)
        torch.testing.assert_close(lse, rlse, rtol=XENT_RTOL, atol=XENT_ATOL)
        out[f"xent/{str(dtype)[6:]}"] = {"loss": (loss - rloss).abs().max().item(),  # lint: allow(JIT502) — parity: one readback per case, after its kernel ran
                                         "lse": (lse - rlse).abs().max().item()}  # lint: allow(JIT502) — parity: one readback per case, after its kernel ran
        del logits
    return out


def flash_timing(shape, heads: int, seed: int, dev) -> dict:
    """Each flash kernel at bf16 causal ``shape`` [B*H, T, D] beside its
    plain version, one library call computing the same function (SDPA
    forward on [B, H, T, D] with ``heads`` heads; SDPA backward for dq
    and dk/dv together) and its bound."""
    bh, t, d = shape
    q, k, v, do = flash_inputs(seed, (bh, t, d), torch.bfloat16, dev)
    o, lse = fa.flash_fwd(q, k, v, True)
    delta = (do.float() * o.float()).sum(-1)
    out = {}
    kernels = {
        "fwd": (lambda: fa.flash_fwd(q, k, v, True),
                lambda: fa.flash_fwd_reference(q, k, v, True)),
        "bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, True),
                   lambda: fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, True)),
        "bwd_dkv": (lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, True),
                    lambda: fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta, True)),
    }
    for name, (kernel, plain) in kernels.items():
        ms, _ = device_ms(kernel, 20)
        plain_ms, _ = device_ms(plain, 3, warmup=1)
        bound_ms, bound_by = flash_bound(name, bh, t, d, True, 2)
        out[name] = {"kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None,
                     **flash_rates(name, bh, t, d, True, ms, bound_ms)}
    q4, k4, v4 = [x.view(bh // heads, heads, t, d).detach().requires_grad_() for x in (q, k, v)]
    out["fwd"]["library_ms"], _ = device_ms(
        lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True), 20)
    sdpa = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    lib_bwd, _ = device_ms(
        lambda: torch.autograd.grad(sdpa, (q4, k4, v4), do.view(bh // heads, heads, t, d),
                                    retain_graph=True), 20)
    pair_ms = out["bwd_dq"]["kernel_ms"] + out["bwd_dkv"]["kernel_ms"]
    pair_gflop = out["bwd_dq"]["gflop"] + out["bwd_dkv"]["gflop"]
    pair_bound = out["bwd_dq"]["bound_ms"] + out["bwd_dkv"]["bound_ms"]
    out["bwd_pair"] = {"kernel_ms": pair_ms, "library_ms": lib_bwd, "gflop": pair_gflop,
                       "tflops": pair_gflop / pair_ms, "bound_share": pair_bound / pair_ms}
    out["fwd"]["library_max_abs_err"] = (sdpa.detach().view(bh, t, d).float() - o.float()).abs().max().item()
    del q, k, v, do, o, lse, delta, q4, k4, v4, sdpa
    torch.cuda.empty_cache()
    return out


def xent_timing(b: int, vocab: int, seed: int, dev) -> dict:
    """The loss kernel on f32 logits [b, vocab] beside its plain version,
    ``F.cross_entropy`` and its bound."""
    g = torch.Generator(device=dev).manual_seed(seed)
    logits = 3 * torch.randn((b, vocab), generator=g, device=dev)
    labels = torch.randint(0, vocab, (b,), generator=g, device=dev)
    ms, _ = device_ms(lambda: xl.xent_fwd(logits, labels), 20)
    plain_ms, _ = device_ms(lambda: xl._xent_fwd_reference(logits, labels), 5)
    lib_ms, _ = device_ms(lambda: F.cross_entropy(logits, labels, reduction="none"), 20)
    bound_ms, bound_by = xent_bound(b, vocab, 4)
    del logits
    torch.cuda.empty_cache()
    return {"kernel_ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_train_kernel_timing(dev) -> dict:
    """Each kernel at the bench step's shape (bf16, causal [128, 2048,
    64]; logits f32 [16384, 32000]) beside its plain version, one library
    call computing the same function (SDPA forward; SDPA backward for dq
    and dk/dv together; F.cross_entropy) and its bound."""
    return {**flash_timing(FLASH_SHAPES["bench"], BENCH_LM.n_heads, 5, dev),
            "xent": xent_timing(*XENT_SHAPE, 6, dev)}


def trainable(params: dict, dev) -> dict:
    """A copy of ``params`` on ``dev`` that takes grads (a copy even on
    the same device: a step updates its params in place)."""
    return ttrainer.tree_like(params, [p.detach().to(dev, copy=True).requires_grad_()
                                       for p in ttrainer.param_leaves(params)])


def phase_train_small_reference(dev) -> dict:
    """One AdamW step of float32 TINY at [2, 1281] tokens (T = 1280 takes
    the flash path) on the card, through the kernels, against the same
    step on the CPU, through the plain versions: the loss within 1e-4
    and every grad leaf within 1e-3 of its largest value (float32 with
    TF32 off, sums in other orders)."""
    cfg = dataclasses.replace(tfm.TINY, dtype=torch.float32)
    cpu = torch.device("cpu")
    base = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = tdata.markov_sampler(device=cpu)(2, 1281, seed=1)
    result = {}
    for d in (cpu, dev):
        reset_train_counts()
        step = ttrainer.make_lm_train_step(tfm.forward, cfg, ttrainer.adamw(TRAIN_LR))
        state, loss = step(ttrainer.init_train_state(trainable(base, d), ttrainer.adamw(TRAIN_LR)),
                           tokens.to(d))
        result[d] = (loss.item(), [p.grad.cpu() for p in ttrainer.param_leaves(state["params"])])  # lint: allow(JIT502) — the card's result read back to hold it to the CPU's
    counts = train_counts()  # of the run on the card, the last one
    n = cfg.n_layers
    assert counts == {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n, "cross_entropy": 1}, counts
    loss_err = abs(result[dev][0] - result[cpu][0])
    grad_err = max(((g - r).abs().max() / r.abs().max()).item()
                   for g, r in zip(result[dev][1], result[cpu][1]))
    assert loss_err <= 1e-4, f"card vs CPU loss differs by {loss_err}"
    assert grad_err <= 1e-3, f"card vs CPU grads differ by {grad_err} of a leaf's largest value"
    return {"loss": result[dev][0], "loss_err": loss_err, "grad_rel_err": grad_err,
            "launches": counts}


def reset_train_counts() -> None:
    fa.LAUNCHES = dict.fromkeys(fa.LAUNCHES, 0)
    xl.LAUNCHES = 0


def train_counts() -> dict:
    return {name: xl.LAUNCHES if key is None else fa.LAUNCHES[key]
            for name, (key, _, _) in TRAIN_KERNELS.items()}


def kernel_kind(name: str) -> str:
    """The kind a device kernel counts under in ``device_breakdown``, from
    its profiler name: the port's kernels by their symbols (any variant:
    ``flash_bwd_dkv_sm90_kernel<64>``, ``flash_bwd_dq_f32_kernel<16>``,
    ``flash_fwd_sm90_kernel<64>``, ``attention_fwd_onepass_kernel<128,
    128>``, ``xent_kernel``), matrix products by cuBLAS's and CUTLASS's
    names, everything else "other"."""
    for symbol, kind in (("flash_bwd_dkv", "flash_bwd_dkv"), ("flash_bwd_dq", "flash_bwd_dq"),
                         ("flash_fwd", "flash_fwd"), ("attention_fwd", "short_attention"),
                         ("xent_kernel", "cross_entropy")):
        if symbol in name:
            return kind
    if any(s in name.lower() for s in ("gemm", "xmma", "cutlass", "sm90_", "wgmma", "nvjet")):
        return "matmul"
    return "other"


LM_KINDS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "short_attention", "cross_entropy",
            "matmul", "other")


def device_breakdown(step_fn, classify=kernel_kind, kinds=LM_KINDS) -> dict:
    """One step under torch.profiler: device time by kind of kernel
    (``classify(name)``, one of ``kinds``: for the LM the port's kernels,
    matrix products, the rest) against the step's wall time, whose
    remainder is the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kinds = dict.fromkeys(kinds, 0.0)
    top = []  # (ms, calls, kernel name)
    for evt in prof.key_averages():
        if str(getattr(evt, "device_type", "")).split(".")[-1] != "CUDA":
            continue
        if re.match(r"[\w.]+#", evt.key):
            continue  # a range annotation (Optimizer.step#AdamW.step) spanning kernels
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        name = evt.key
        kinds[classify(name)] += us / 1e3
        top.append((us / 1e3, evt.count, name[:90]))
    busy = sum(kinds.values())
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall_ms if busy else None, "device_ms": kinds,
            "top_kernels": sorted(top, reverse=True)[:15]}


def phase_train(dev, card) -> dict:
    """The bench LM at batch 8 x 2048 from the Markov corpus: 2 warm-up
    and 10 timed AdamW steps through the kernels; then one profiled
    step. Every loss finite, the last below the first; each flash kernel
    launched 8 times and the loss kernel once per step."""
    cfg = BENCH_LM
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    for p in ttrainer.param_leaves(params):
        p.requires_grad_()
    n_params = sum(p.numel() for p in ttrainer.param_leaves(params))
    opt = ttrainer.adamw(TRAIN_LR)
    state = ttrainer.init_train_state(params, opt)
    step = ttrainer.make_lm_train_step(tfm.forward, cfg, opt)
    sample = tdata.markov_sampler(device=dev)
    batches = [sample(TRAIN_BATCH, TRAIN_SEQ + 1, seed=s)
               for s in range(1, TRAIN_WARMUP + TRAIN_STEPS + 2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_train_counts()
    state, losses, step_ms, elapsed = timed_steps(
        step, state, batches[:TRAIN_WARMUP + TRAIN_STEPS], TRAIN_WARMUP)
    counts = train_counts()
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    expect = {name: (1 if key is None else cfg.n_layers) * n_steps
              for name, (key, _, _) in TRAIN_KERNELS.items()}
    assert counts == expect, (counts, expect)
    assert fa.LAST_DISPATCH["impl"] == "cuda" and xl.LAST_DISPATCH["impl"] == "cuda"
    losses = scalar_losses(losses)
    assert losses[-1] < losses[0], losses
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tok_s = TRAIN_BATCH * TRAIN_SEQ * TRAIN_STEPS / elapsed
    breakdown = device_breakdown(lambda: step(state, batches[-1]))
    return {
        "phase": "train", "model": "bench-lm", "card": card, "params_m": n_params / 1e6,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "warmup": TRAIN_WARMUP,
        "step_ms_median": statistics.median(step_ms), "step_ms": step_ms,
        "tok_per_s": tok_s, "model_tflops": 6 * n_params * tok_s / 1e12,
        "peak_mem_gb": peak_gb, "losses": losses, "launches": counts,
        "profiled_step": breakdown,
    }


# -- the model zoo (ResNet-50, the MNIST MLP, ViT-B/16, the Mixtral-width MoE)
def zoo_kernel_kind(name: str) -> str:
    """The kind a device kernel of a vision or MoE step counts under: the
    loss kernel and the flash kernels by their symbols, the optimizer's
    fused multi-tensor kernels, BatchNorm and the elementwise and
    reduction kernels around it (ReLU, casts, residual adds, the spatial
    mean), convolutions and matrix products by cuDNN's, cuBLAS's and
    CUTLASS's names (the classifier's one head product counts there
    too), everything else "other"."""
    if "xent_kernel" in name:
        return "loss_kernel"
    kind = kernel_kind(name)
    if kind.startswith("flash"):
        return "flash"
    n = name.lower()
    if "multi_tensor_apply" in n:
        return "optimizer"
    if "pool" in n:  # max pooling, whose NHWC kernels' names read like cuDNN's
        return "other"
    if any(s in n for s in ("batch_norm", "elementwise", "reduce_kernel", "softmax")):
        return "elementwise"
    if kind == "matmul" or any(s in n for s in ("conv", "fprop", "dgrad", "wgrad", "cudnn",
                                                 "implicit", "nhwc", "nchw")):
        return "conv_matmul"
    return "other"


ZOO_KINDS = ("conv_matmul", "elementwise", "loss_kernel", "flash", "optimizer", "other")
# bench.py's headline harness (bench.py:182-256): ResNet-50 v1.5, the
# space-to-depth stem, bf16, batch 256 x 224^2 from default_rng(0), 1000
# classes, SGD 0.1 with momentum 0.9, 3 warm-up and 20 timed steps; 4.09
# GFLOP a forward per image (bench.py:254), x3 for a train step. cuDNN
# picks its algorithms by timing them (``cudnn.benchmark``) in every zoo
# phase, the parity one included
RESNET = {"batch": 256, "image": 224, "classes": 1000, "lr": 0.1, "warmup": 3, "steps": 20,
          "conv7_warmup": 2, "conv7_steps": 5}
RESNET50_FWD_GFLOP_PER_IMG = 4.09
ZOO_SMALL = {"batch": 8, "image": 64}
# ResNet-50 on the card against the CPU, float32 (TF32 off): sums in
# other orders through 53 conv + BatchNorm layers, ~4e-6 a product
ZOO_SMALL_REL = 1e-3
# examples/jax-mnist: MLP (512, 256, 10), Adam 1e-3, batch 256
MNIST = {"batch": 256, "lr": 1e-3, "steps": 200, "check_step": 100, "below": 1e-3}
# ViT-B/16 at 224^2, batch 128, bf16, Adam 1e-3, one fixed batch
VIT = {"batch": 128, "image": 224, "classes": 1000, "lr": 1e-3, "warmup": 3, "steps": 10}
# MIXTRAL_8X7B's widths at 2 of its 32 layers (46.7B parameters do not
# fit one card; 2 layers are 3.16B), batch 2 x 2049 Markov tokens, AdamW
MOE_CFG = dataclasses.replace(moe.MIXTRAL_8X7B, n_layers=2)
MOE = {"batch": 2, "seq": 2048, "lr": 3e-4, "warmup": 2, "steps": 8}
# the loss kernel at each zoo path's shape (f32 logits [rows, classes]),
# flash at the MoE's (bf16 causal [B*H, T, D]: batch 2, 32 heads)
ZOO_XENT_SHAPES = {"resnet50": (RESNET["batch"], RESNET["classes"]), "mnist": (MNIST["batch"], 10),
                   "vit": (VIT["batch"], VIT["classes"]),
                   "moe": (MOE["batch"] * MOE["seq"], MOE_CFG.vocab_size)}
ZOO_FLASH_SHAPE = (MOE["batch"] * MOE_CFG.n_heads, MOE["seq"], MOE_CFG.head_dim)
ZOO_FLASH_HEADS = MOE_CFG.n_heads


@contextlib.contextmanager
def cudnn_benchmark():
    """cuDNN picks each convolution's algorithm by timing the candidates
    on first use of a shape (the zoo phases' setting)."""
    before = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = before


def phase_zoo_kernel_parity(dev) -> dict:
    """The loss kernel against its plain version at the zoo's f32 shapes,
    and the flash forward and backward pair at the MoE's bf16 causal
    [64, 2048, 128]."""
    out = {}
    for b, vocab in ZOO_XENT_SHAPES.values():
        g = torch.Generator(device=dev).manual_seed(7)
        logits = 3 * torch.randn((b, vocab), generator=g, device=dev)
        labels = torch.randint(0, vocab, (b,), generator=g, device=dev)
        loss, lse = xl.xent_fwd(logits, labels)
        torch.cuda.synchronize()  # lint: allow(JIT502) — parity: one readback per case, after its kernel ran
        assert xl.LAST_DISPATCH["impl"] == "cuda"
        rloss, rlse = xl._xent_fwd_reference(logits, labels)
        torch.testing.assert_close(loss, rloss, rtol=XENT_RTOL, atol=XENT_ATOL)
        torch.testing.assert_close(lse, rlse, rtol=XENT_RTOL, atol=XENT_ATOL)
        out[f"xent/{b}x{vocab}"] = {"loss": (loss - rloss).abs().max().item(),  # lint: allow(JIT502) — parity: one readback per case, after its kernel ran
                                    "lse": (lse - rlse).abs().max().item()}  # lint: allow(JIT502) — parity: one readback per case, after its kernel ran
    q, k, v, do = flash_inputs(8, ZOO_FLASH_SHAPE, torch.bfloat16, dev)
    o, lse, delta, dq, dk, dv = flash_run(q, k, v, do, True)
    torch.cuda.synchronize()
    assert fa.LAST_DISPATCH["impl"] == "cuda"
    ro, rlse = fa.flash_fwd_reference(q, k, v, True)
    rdq = fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, True)
    rdk, rdv = fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta, True)
    torch.testing.assert_close(lse, rlse, rtol=F32_RTOL, atol=1e-4, msg="d128 lse")
    line = {t: kernel_err(g, r, f"moe d128 {t}")
            for t, g, r in (("o", o, ro), ("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv))}
    line["lse"] = (lse - rlse).abs().max().item()
    out["flash/bfloat16/causal/" + "x".join(map(str, ZOO_FLASH_SHAPE))] = line
    del q, k, v, do, o, lse, delta, dq, dk, dv, ro, rlse, rdq, rdk, rdv
    torch.cuda.empty_cache()
    return out


def phase_zoo_kernel_timing(dev) -> dict:
    """The loss kernel at each zoo shape and the flash kernels at the
    MoE's, each beside its plain version, its library call and bound."""
    out = {f"xent/{b}x{v}": xent_timing(b, v, 9, dev) for b, v in ZOO_XENT_SHAPES.values()}
    out["flash_d128"] = flash_timing(ZOO_FLASH_SHAPE, ZOO_FLASH_HEADS, 10, dev)
    return out


def classifier_batch(batch: int, image: int, classes: int, seed: int, dev) -> dict:
    """One batch as bench.py makes it: unit normals NHWC and uniform
    labels from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(batch, image, image, 3)).astype(np.float32)
    labels = rng.integers(0, classes, size=batch)
    return {"image": torch.from_numpy(images).to(dev), "label": torch.from_numpy(labels).to(dev)}


def phase_zoo_small_reference(dev) -> dict:
    """ResNet-50 (space-to-depth stem, full width) in float32 at batch 8
    x 64^2 on the card, through cuDNN and the loss kernel, against the
    same model on the CPU through the plain versions: eval-mode logits,
    the loss of one SGD step and the running statistics after it, each
    within ``ZOO_SMALL_REL`` of its largest value."""
    cpu = torch.device("cpu")
    base = resnet.ResNet50(num_classes=1000, dtype=torch.float32, stem="space_to_depth",
                           device=cpu, seed=0)
    batch = classifier_batch(ZOO_SMALL["batch"], ZOO_SMALL["image"], 1000, 1, cpu)
    result = {}
    for d in (cpu, dev):
        model = copy.deepcopy(base).to(d)
        with torch.no_grad():
            logits = model(batch["image"].to(d), train=False)
        opt = ttrainer.sgd(RESNET["lr"])
        step = ttrainer.make_classifier_train_step(model, opt, has_batch_stats=True)
        reset_train_counts()
        _, loss = step(ttrainer.init_train_state(model, opt),
                       {k: t.to(d) for k, t in batch.items()})
        result[d] = (logits.cpu(), loss.item(), [b.cpu() for b in model.buffers()])  # lint: allow(JIT502) — the card's result read back to hold it to the CPU's
    assert xl.LAUNCHES == 1, xl.LAUNCHES  # the card's step, the last one
    logit_err = ((result[dev][0] - result[cpu][0]).abs().max()
                 / result[cpu][0].abs().max()).item()
    loss_err = abs(result[dev][1] - result[cpu][1]) / abs(result[cpu][1])
    stats_err = max(((a - b).abs().max() / b.abs().max()).item()
                    for a, b in zip(result[dev][2], result[cpu][2]))
    for name, err in (("logits", logit_err), ("loss", loss_err), ("batch_stats", stats_err)):
        assert err <= ZOO_SMALL_REL, f"card vs CPU {name} differ by {err} of the largest value"
    return {"model": "resnet50/space_to_depth/f32", **ZOO_SMALL, "loss": result[dev][1],
            "logit_rel_err": logit_err, "loss_rel_err": loss_err, "stats_rel_err": stats_err,
            "rel_tol": ZOO_SMALL_REL, "cudnn_benchmark": torch.backends.cudnn.benchmark}


def timed_steps(step, state, batches, warmup: int) -> tuple:
    """Run every batch through ``step``; the ones after ``warmup`` between
    CUDA events. Returns (state, losses as tensors, per-step device ms,
    host seconds of the timed steps)."""
    losses = []
    for batch in batches[:warmup]:
        state, loss = step(state, batch)
        losses.append(loss)
    torch.cuda.synchronize()
    timed = batches[warmup:]
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in timed]
    t0 = time.perf_counter()
    for (start, end), batch in zip(events, timed):
        start.record()
        state, loss = step(state, batch)
        end.record()
        losses.append(loss)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    return state, losses, [s.elapsed_time(e) for s, e in events], elapsed


def scalar_losses(losses) -> list:
    out = [(x["loss"] if isinstance(x, dict) else x).item() for x in losses]
    assert all(math.isfinite(x) for x in out), out
    return out


def classifier_run(model, opt, batch, warmup: int, steps: int) -> dict:
    step = ttrainer.make_classifier_train_step(model, opt, has_batch_stats=any(
        True for _ in model.buffers()))
    state = ttrainer.init_train_state(model, opt)
    state, losses, step_ms, elapsed = timed_steps(step, state, [batch] * (warmup + steps), warmup)
    n = batch["label"].shape[0]
    return {"state": state, "step": step, "losses": scalar_losses(losses),
            "step_ms_median": statistics.median(step_ms), "step_ms": step_ms,
            "imgs_per_s": n * steps / elapsed}


def phase_resnet50_train(dev, card) -> dict:
    """bench.py's ResNet-50 harness on the port: 3 warm-up and 20 timed
    SGD steps on one 256 x 224^2 batch, then one profiled step, then the
    example's conv7 stem for a few steps. The loss finite and falling,
    the loss kernel launched once a step."""
    batch = classifier_batch(RESNET["batch"], RESNET["image"], RESNET["classes"], 0, dev)
    model = resnet.ResNet50(num_classes=RESNET["classes"], dtype=torch.bfloat16,
                            stem="space_to_depth", device=dev, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_train_counts()
    run = classifier_run(model, ttrainer.sgd(RESNET["lr"]), batch, RESNET["warmup"],
                         RESNET["steps"])
    n_steps = RESNET["warmup"] + RESNET["steps"]
    assert train_counts()["cross_entropy"] == n_steps, (train_counts(), n_steps)
    assert xl.LAST_DISPATCH["impl"] == "cuda"
    losses = run["losses"]
    assert losses[-1] < losses[0], losses
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    profiled = device_breakdown(lambda: run["step"](run["state"], batch), zoo_kernel_kind,
                                ZOO_KINDS)
    launches = train_counts()["cross_entropy"]  # the timed steps' and the profiled one's
    assert launches == n_steps + 1, (launches, n_steps)
    del run["state"], run["step"], model
    gc.collect()
    torch.cuda.empty_cache()
    conv7 = resnet.ResNet50(num_classes=RESNET["classes"], dtype=torch.bfloat16, stem="conv7",
                            device=dev, seed=0)
    reset_train_counts()
    c7 = classifier_run(conv7, ttrainer.sgd(RESNET["lr"]), batch, RESNET["conv7_warmup"],
                        RESNET["conv7_steps"])
    c7_launches = train_counts()["cross_entropy"]
    assert c7_launches == RESNET["conv7_warmup"] + RESNET["conv7_steps"], c7_launches
    del c7["state"], c7["step"], conv7, batch
    gc.collect()
    torch.cuda.empty_cache()
    flop_per_img = 3 * RESNET50_FWD_GFLOP_PER_IMG * 1e9
    return {
        "phase": "resnet50_train", "card": card, "model": "resnet50/space_to_depth/bf16",
        "params_m": n_params / 1e6, **{k: RESNET[k] for k in ("batch", "image", "warmup", "steps")},
        "cudnn_benchmark": torch.backends.cudnn.benchmark,
        "imgs_per_s": run["imgs_per_s"], "step_ms_median": run["step_ms_median"],
        "step_ms": run["step_ms"], "model_tflops": flop_per_img * run["imgs_per_s"] / 1e12,
        "peak_mem_gb": peak_gb, "losses": losses, "xent_launches": launches + c7_launches,
        "profiled_step": profiled,
        "conv7": {"imgs_per_s": c7["imgs_per_s"], "step_ms_median": c7["step_ms_median"],
                  "model_tflops": flop_per_img * c7["imgs_per_s"] / 1e12,
                  "losses": c7["losses"], "xent_launches": c7_launches},
    }


def phase_mnist_train(dev, card) -> dict:
    """examples/jax-mnist on the port: the MLP (512, 256, 10), Adam 1e-3,
    200 steps on ``synthetic_mnist(256, seed=0)``; the loss at step 100
    below 1e-3 (the JAX example is below 1e-6 by step 50 on the CPU)."""
    model = mlp.MLP(features=(512, 256, 10), device=dev, seed=0)
    opt = ttrainer.adam(MNIST["lr"])
    state = ttrainer.init_train_state(model, opt)
    step = ttrainer.make_classifier_train_step(model, opt)
    batches = list(itertools.islice(tdata.synthetic_mnist(MNIST["batch"], seed=0, device=dev),
                                    MNIST["steps"]))
    reset_train_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for batch in batches:
        state, loss = step(state, batch)
        losses.append(loss)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    losses = scalar_losses(losses)
    launches = train_counts()["cross_entropy"]
    assert launches == MNIST["steps"], launches
    at = losses[MNIST["check_step"]]
    assert at < MNIST["below"], f"loss {at} at step {MNIST['check_step']}"
    return {"phase": "mnist_train", "card": card, "model": "mlp(512,256,10)/f32", **MNIST,
            "loss_at_check_step": at, "losses_every_10": losses[::10],
            "step_ms_mean": elapsed * 1e3 / MNIST["steps"],
            "imgs_per_s": MNIST["batch"] * MNIST["steps"] / elapsed, "xent_launches": launches}


# -- the deploy path: a scaffolded torch project, preflighted, rendered, run --------
EXAMPLE_CONFIG = Path(REPO_ROOT) / "examples" / "jax-mnist" / ".devspace" / "config.yaml"
DEPLOY = {"gpu": {"workers": 1, "perWorker": 1}, "steps": MNIST["steps"],
          "check_step": MNIST["check_step"], "below": MNIST["below"], "master_port": 29500,
          "timeout_s": 300}
DEPLOY_TRAIN_PY = """\
\"\"\"The MNIST example's entry point in a scaffolded torch project: the
port's scripts/train_mnist_torch.py, then the losses it logged and the
loss kernel's launch count, each on a line of its own.\"\"\"
import json
import sys

import torch

sys.path[:0] = [{repo!r}, {scripts!r}]

import train_mnist_torch  # noqa: E402
from devspace_tpu_torch.ops import losses  # noqa: E402

print(f"torch {{torch.__version__}}", flush=True)
logged = train_mnist_torch.main()
print("losses " + json.dumps(logged), flush=True)
print(f"xent_launches {{losses.LAUNCHES}}", flush=True)
"""


def deploy_project(root: str, args: list, gpu: dict) -> None:
    """The project the deploy phase runs, in ``root``: ``train.py``, the
    port's scaffold for it (the torch Dockerfile and ``chart-gpu``) and
    ``.devspace/config.yaml``, which is examples/jax-mnist's config with
    its ``tpu`` block replaced by ``gpu`` and the chart's ``command``
    value by ``args`` (``[train.py, --steps, N]``)."""
    with open(os.path.join(root, "train.py"), "w") as fh:
        fh.write(DEPLOY_TRAIN_PY.format(repo=REPO_ROOT, scripts=str(Path(REPO_ROOT) / "scripts")))
    language = scaffold.detect_language(root)
    assert language == "torch", language
    scaffold.create_dockerfile(root, language)
    scaffold.create_chart(root, language)
    with open(EXAMPLE_CONFIG) as fh:
        example = yaml.safe_load(fh)
    config = {"version": example["version"], "gpu": gpu,
              **{k: v for k, v in example.items() if k not in ("version", "tpu")}}
    (deployment,) = config["deployments"]
    values = deployment["chart"]["values"]
    values.pop("command")
    values["args"] = args
    os.makedirs(os.path.join(root, ".devspace"))
    with open(os.path.join(root, ".devspace", "config.yaml"), "w") as fh:
        yaml.safe_dump(config, fh, sort_keys=False)


def free_port(preferred: int) -> int:
    """``preferred`` where it can be bound on this host, else a free port."""
    import socket

    for port in (preferred, 0):
        with socket.socket() as sock:
            try:
                sock.bind(("127.0.0.1", port))
            except OSError:
                continue
            return sock.getsockname()[1]
    raise RuntimeError("no free port")


def pod_command(sts: dict, node_rank: int, master_port: int, workdir: str,
                pod_env: dict = None) -> tuple:
    """The rendered StatefulSet's container as a command on this host:
    ``(argv, env, substitutions)``. The substitutions, and only they: the
    pod index (``node_rank``) for a ``NODE_RANK`` from the pod-index
    label, ``127.0.0.1`` for ``--master-addr``, ``master_port`` for
    ``--master-port`` where it differs, ``workdir`` for ``workingDir``,
    and ``python -m torch.distributed.run`` for ``torchrun`` where the
    console script is not on ``PATH``. With ``pod_env`` (a pod's env as
    a cluster gave it) an env entry from the pod index takes the pod's
    value instead, and is no substitution. ``$(VAR)`` references in the
    command are expanded from the container's env, as the kubelet does."""
    (c,) = sts["spec"]["template"]["spec"]["containers"]
    subs = [f"workingDir {c['workingDir']} -> {workdir}"]
    env = {}
    for e in c.get("env") or []:
        field = ((e.get("valueFrom") or {}).get("fieldRef") or {}).get("fieldPath")
        if field == rules_gpu.POD_INDEX_FIELD and pod_env is not None:
            env[e["name"]] = pod_env[e["name"]]
        elif field == rules_gpu.POD_INDEX_FIELD:
            env[e["name"]] = str(node_rank)
            subs.append(f"{e['name']} {field} -> {node_rank}")
        elif "value" in e:
            env[e["name"]] = str(e["value"])
        else:
            raise AssertionError(f"env {e} has no value this host can give")
    argv = []
    for arg in [str(a) for a in c["command"] + c["args"]]:
        arg = re.sub(r"\$\((\w+)\)", lambda m: env[m.group(1)], arg)
        flag, eq, value = arg.partition("=")
        if eq and flag == "--master-addr" and value != "127.0.0.1":
            subs.append(f"{arg} -> --master-addr=127.0.0.1")
            arg = "--master-addr=127.0.0.1"
        elif eq and flag == "--master-port" and value != str(master_port):
            subs.append(f"{arg} -> --master-port={master_port}")
            arg = f"--master-port={master_port}"
        argv.append(arg)
    if argv[0] == "torchrun" and shutil.which("torchrun") is None:
        argv[:1] = [sys.executable, "-m", "torch.distributed.run"]
        subs.append(f"torchrun -> {sys.executable} -m torch.distributed.run")
    return argv, env, subs


def run_pod(argv: list, env: dict, workdir: str) -> subprocess.Popen:
    """Start a pod's command on this host, its output piped."""
    return subprocess.Popen(argv, cwd=workdir, env={**os.environ, **env}, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def pod_result(proc: subprocess.Popen, timeout_s: float) -> dict:
    """A pod's exit code and what its train.py printed: the world line,
    the logged losses, ``done`` and the loss kernel's launches."""
    try:
        out, _ = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        raise AssertionError(f"the pod ran past {timeout_s} s:\n{out[-4000:]}") from None
    return parse_pod_output(proc.returncode, out)


def parse_pod_output(rc: int, out: str) -> dict:
    """What a pod's train.py printed, as ``pod_result`` returns it."""
    lines = out.splitlines()
    world = next((ln for ln in lines if ln.startswith("device: ")), None)
    losses = next((json.loads(ln[7:]) for ln in lines if ln.startswith("losses ")), None)
    launches = next((int(ln.split()[1]) for ln in lines if ln.startswith("xent_launches ")),
                    None)
    return {"rc": rc, "world": world, "losses": losses, "launches": launches,
            "done": "done" in lines, "tail": out[-4000:]}


def phase_deploy(dev, card) -> dict:
    """The deploy path on the card: a torch project scaffolded by the
    port's generator (``deploy_project``) is loaded by the port's config
    loader and preflighted by ``collect_project_findings`` (no error),
    rendered by ``ChartDeployer.render_manifests``, and its StatefulSet's
    container runs here (``pod_command``): torchrun starts the MNIST
    trainer, which forms an NCCL world of one through
    ``parallel.mesh.distributed()`` and trains ``DEPLOY["steps"]`` steps
    through the loss kernel, one launch a step, with the loss at step 100
    below the mnist_train phase's bound. Rehearsed on the CPU with
    ``--device cpu`` added (gloo, and no kernel launches)."""
    t0 = time.monotonic()
    root = tempfile.mkdtemp(prefix="deploy-")
    try:
        deploy_project(root, ["train.py", "--steps", str(DEPLOY["steps"])], DEPLOY["gpu"])
        project = lint.load_project(root)
        findings, n_objects = lint.collect_project_findings(project)
        errors = [f"{f.rule_id} {f.legacy()}" for f in findings if f.severity == lint.ERROR]
        assert not errors, errors
        (deployment,) = project.config.deployments
        deployer = ChartDeployer(None, deployment, project.namespace, base_dir=project.root)
        docs = deployer.render_manifests(gpu=project.config.gpu)
        (sts,) = [d for d in docs if d["kind"] == "StatefulSet"]
        argv, env, subs = pod_command(sts, 0, free_port(DEPLOY["master_port"]), root)
        if dev.type == "cpu":
            argv.append("--device=cpu")
            subs.append("--device=cpu appended (the CPU rehearsal)")
        for sub in subs:
            print(f"deploy: substituted {sub}", flush=True)
        print(f"deploy: {' '.join(argv)}", flush=True)
        t = time.monotonic()
        pod = pod_result(run_pod(argv, env, root), DEPLOY["timeout_s"])
        run_s = time.monotonic() - t
    finally:
        shutil.rmtree(root, ignore_errors=True)
    assert pod["rc"] == 0 and pod["done"], pod["tail"]
    backend = pmesh.backend_for(dev)
    assert pod["world"] and pod["world"].endswith(f"backend {backend}, world 1"), pod["tail"]
    losses = pod["losses"]
    at = losses[DEPLOY["check_step"] // 100]
    assert at < DEPLOY["below"], f"loss {at} at step {DEPLOY['check_step']}"
    # the plain path on the CPU launches no kernel
    want = DEPLOY["steps"] if dev.type == "cuda" else 0
    assert pod["launches"] == want, (pod["launches"], want)
    return {"phase": "deploy", "card": card, "gpu": DEPLOY["gpu"], "objects": n_objects,
            "findings": [f"{f.rule_id} {f.legacy()}" for f in findings],
            "kinds": sorted(d["kind"] for d in docs), "argv": argv, "env": env,
            "substitutions": subs, "world": pod["world"], "steps": DEPLOY["steps"],
            "losses_every_100": losses, "loss_at_check_step": at,
            "xent_launches": pod["launches"], "run_s": run_s,
            "seconds": time.monotonic() - t0}


# -- the project applied to the port's fake cluster by the port's CLI ------------
CLUSTER = {"cli_timeout_s": 180}


def run_cli(args: list, project: str, cluster: str) -> dict:
    """One call of the port's CLI as a user makes it: ``python -m
    devspace_tpu_torch <args>`` in the project's dir, against the fake
    cluster at ``cluster``; its exit code, seconds and output."""
    env = {**os.environ, "DEVSPACE_FAKE_BACKEND": cluster, "DEVSPACE_NONINTERACTIVE": "1",
           "PYTHONPATH": os.pathsep.join(filter(None, [REPO_ROOT,
                                                       os.environ.get("PYTHONPATH")]))}
    t = time.monotonic()
    proc = subprocess.run([sys.executable, "-m", "devspace_tpu_torch", *args], cwd=project,
                          env=env, text=True, capture_output=True,
                          timeout=CLUSTER["cli_timeout_s"])
    return {"args": args, "rc": proc.returncode, "s": time.monotonic() - t,
            "out": proc.stdout + proc.stderr}


def exec_result(proc, timeout_s: float) -> dict:
    """An exec stream's exit code and what its train.py printed (as
    ``pod_result``): each output stream read to its end, all within
    ``timeout_s``."""
    from devspace_tpu_torch.kube.streams import StreamClosed

    deadline = time.monotonic() + timeout_s
    out = b""
    for stream in (proc.stdout, proc.stderr):
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                proc.terminate()
                text = (out + proc.stdout.drain() + proc.stderr.drain()).decode("utf-8",
                                                                                  "replace")
                raise AssertionError(f"the exec ran past {timeout_s} s:\n{text[-4000:]}")
            try:
                out += stream.read_available(timeout=min(left, 1.0))
            except StreamClosed:
                break
    rc = proc.wait(max(deadline - time.monotonic(), 1.0))
    assert rc is not None, "the exec closed its output and did not exit"
    return parse_pod_output(rc, out.decode("utf-8", "replace"))


def without_status(obj: dict) -> dict:
    """A stored object without what the cluster stamps on it: its status
    and its generation."""
    obj = copy.deepcopy(obj)
    obj.pop("status", None)
    obj["metadata"].pop("generation", None)
    return obj


def phase_cluster(dev, card) -> dict:
    """The deploy phase's project applied to a cluster by the port's CLI,
    as a user applies it: ``deploy`` (the lint preflight, ``FakeBuilder``,
    ``deploy_all``: ``ChartDeployer.deploy`` applies into the fake, whose
    pods are synthesized, ``_wait_ready`` passes, the release is
    recorded), ``status deployments`` (a row for the StatefulSet) and
    ``print --manifests`` (the applied objects, without the status
    stamps), each a process in the project's dir with
    ``DEVSPACE_FAKE_BACKEND``. From the objects the fake stored, the
    StatefulSet and worker 0 (``slice_workers``; ``NODE_RANK=0`` in its
    env, as the fake resolves chart-gpu's pod-index fieldRef): the
    StatefulSet's command runs in worker 0 through the fake's
    ``exec_stream`` with ``pod_command``'s substitutions but the pod's
    ``NODE_RANK``, in the pod's copy of the project (the image the fake
    builder does not build), and trains the MNIST example as the deploy
    phase checks it. ``purge`` then leaves no object and no pod."""
    from devspace_tpu_torch.kube.fake import FakeCluster

    t0 = time.monotonic()
    root = tempfile.mkdtemp(prefix="cluster-")
    project, cluster = os.path.join(root, "proj"), os.path.join(root, "cluster")
    calls = []

    def cli(*args):
        call = run_cli(list(args), project, cluster)
        calls.append({k: call[k] for k in ("args", "rc", "s")})
        assert call["rc"] == 0, call
        return call

    try:
        os.makedirs(project)
        deploy_project(project, ["train.py", "--steps", str(DEPLOY["steps"])], DEPLOY["gpu"])
        cli("deploy")
        status = cli("status", "deployments")
        with open(os.path.join(project, ".devspace", "config.yaml")) as fh:
            (name,) = [d["name"] for d in yaml.safe_load(fh)["deployments"]]
        assert any(ln.split()[:1] == [name] and "StatefulSet" in ln.split()
                   for ln in status["out"].splitlines()), status["out"]
        printed = [d for d in yaml.safe_load_all(cli("print", "--manifests")["out"]) if d]
        fc = FakeCluster(cluster, persist=True)
        # the release record is the deployer's, not the chart's
        applied = {(kind, n): m for (kind, _, n), m in fc.objects.items()
                   if not n.startswith(RELEASE_CONFIGMAP_PREFIX)}
        assert {(d["kind"], d["metadata"]["name"]): d for d in printed} == \
            {k: without_status(m) for k, m in applied.items()}, (printed, applied)
        sts = fc.get_object("apps/v1", "StatefulSet", name)
        (worker,) = fc.slice_workers({"app": name}, expected=DEPLOY["gpu"]["workers"],
                                     timeout=10)
        pod_env = worker.container_env()
        assert pod_env.get("NODE_RANK") == "0", (worker.name, pod_env)
        (c,) = sts["spec"]["template"]["spec"]["containers"]
        workdir = fc.translate_path(worker, c["workingDir"])
        shutil.copytree(project, workdir, ignore=shutil.ignore_patterns(".devspace"))
        argv, env, subs = pod_command(sts, 0, free_port(DEPLOY["master_port"]), workdir,
                                      pod_env=pod_env)
        subs.append(f"image: the project copied to {workdir} (the fake builder builds none)")
        if dev.type == "cpu":
            argv.append("--device=cpu")
            subs.append("--device=cpu appended (the CPU rehearsal)")
        for sub in subs:
            print(f"cluster: substituted {sub}", flush=True)
        script = " ".join(["cd", shlex.quote(workdir), "&&", "exec", "env",
                           *[shlex.quote(f"{k}={v}") for k, v in env.items()],
                           *map(shlex.quote, argv)])
        print(f"cluster: exec in {worker.name}: {script}", flush=True)
        t = time.monotonic()
        pod = exec_result(fc.exec_stream(worker, ["sh", "-c", script], stdin=False),
                          DEPLOY["timeout_s"])
        run_s = time.monotonic() - t
        cli("purge")
        after = FakeCluster(cluster, persist=True)
        left = {"objects": sorted(map(list, after.objects)), "pods": sorted(map(list, after.pods))}
        assert left == {"objects": [], "pods": []}, left
    finally:
        shutil.rmtree(root, ignore_errors=True)
    assert pod["rc"] == 0 and pod["done"], pod["tail"]
    backend = pmesh.backend_for(dev)
    assert pod["world"] and pod["world"].endswith(f"backend {backend}, world 1"), pod["tail"]
    losses = pod["losses"]
    at = losses[DEPLOY["check_step"] // 100]
    assert at < DEPLOY["below"], f"loss {at} at step {DEPLOY['check_step']}"
    want = DEPLOY["steps"] if dev.type == "cuda" else 0
    assert pod["launches"] == want, (pod["launches"], want)
    return {"phase": "cluster", "card": card, "gpu": DEPLOY["gpu"], "cli": calls,
            "applied_kinds": sorted(kind for kind, _ in applied), "worker": worker.name,
            "pod_env": pod_env, "argv": argv, "substitutions": subs, "world": pod["world"],
            "steps": DEPLOY["steps"], "losses_every_100": losses, "loss_at_check_step": at,
            "xent_launches": pod["launches"], "run_s": run_s, "left_after_purge": left,
            "seconds": time.monotonic() - t0}


def vit_train_flop_per_image(hidden: int, depth: int, mlp_dim: int, patch: int, image: int,
                             classes: int) -> float:
    """3 x the forward's matrix-product flops (2 a multiply-add) of one
    image: the patch embedding, per block q/k/v/out (4 D^2 a token), the
    MLP (2 D M a token) and attention (2 T D a token: scores and P.V),
    the head on the cls token."""
    t = (image // patch) ** 2 + 1
    embed = (t - 1) * patch * patch * 3 * hidden
    block = t * (4 * hidden * hidden + 2 * hidden * mlp_dim + 2 * t * hidden)
    return 3 * 2 * (embed + depth * block + hidden * classes)


def phase_vit_train(dev, card) -> dict:
    """ViT-B/16 at batch 128 x 224^2, bf16, Adam 1e-3: 3 warm-up and 10
    timed steps on one batch; the loss finite and falling, the loss
    kernel launched once a step."""
    model = vit.ViT_B16(num_classes=VIT["classes"], dtype=torch.bfloat16,
                        image_size=VIT["image"], device=dev, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    batch = classifier_batch(VIT["batch"], VIT["image"], VIT["classes"], 0, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_train_counts()
    run = classifier_run(model, ttrainer.adam(VIT["lr"]), batch, VIT["warmup"], VIT["steps"])
    launches = train_counts()["cross_entropy"]
    assert launches == VIT["warmup"] + VIT["steps"], launches
    assert run["losses"][-1] < run["losses"][0], run["losses"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    flop = vit_train_flop_per_image(768, 12, 3072, 16, VIT["image"], VIT["classes"])
    del run["state"], run["step"], model, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"phase": "vit_train", "card": card, "model": "vit-b16/bf16", "params_m": n_params / 1e6,
            **VIT, "imgs_per_s": run["imgs_per_s"], "step_ms_median": run["step_ms_median"],
            "step_ms": run["step_ms"], "train_gflop_per_img": flop / 1e9,
            "model_tflops": flop * run["imgs_per_s"] / 1e12, "peak_mem_gb": peak_gb,
            "losses": run["losses"], "xent_launches": launches}


def moe_active_params(cfg) -> int:
    """Parameters a token's forward multiplies by: attention, the router,
    ``experts_per_token`` experts of each layer, lm_head (the embedding
    is a lookup)."""
    hd = cfg.head_dim
    attn = cfg.dim * (2 * cfg.n_heads * hd + 2 * cfg.n_kv_heads * hd)
    expert = 3 * cfg.dim * cfg.ffn_dim
    layer = attn + cfg.dim * cfg.num_experts + cfg.experts_per_token * expert
    return cfg.n_layers * layer + cfg.dim * cfg.vocab_size


def moe_dispatch_flop(cfg, tokens: int) -> float:
    """The dense routing's one-hot products of one train step, apart from
    6 N_active: dispatch (T E C D multiply-adds) and combine (the same),
    forward and twice that backward, every layer."""
    c = eparallel.expert_capacity(tokens, cfg.num_experts, cfg.capacity_factor,
                                  cfg.experts_per_token)
    return cfg.n_layers * 3 * 2 * 2 * tokens * cfg.num_experts * c * cfg.dim


def phase_moe_train(dev, card) -> dict:
    """MIXTRAL_8X7B's widths at 2 layers, bf16, batch 2 x 2049 from
    ``markov_tokens``, AdamW 3e-4: 2 warm-up and 8 timed steps through
    flash attention (T = 2048, D = 128, 32 heads from 8 KV heads) and the
    loss kernel; ce and aux finite, every kernel launched as the step
    count predicts."""
    cfg = MOE_CFG
    params = moe.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    leaves = ttrainer.param_leaves(params)
    for p in leaves:
        p.requires_grad_()
    n_params = sum(p.numel() for p in leaves)
    opt = ttrainer.adamw(MOE["lr"])
    state = ttrainer.init_train_state(params, opt)
    step = ttrainer.make_moe_lm_train_step(moe.forward, cfg, opt)
    n_steps = MOE["warmup"] + MOE["steps"]
    batches = list(itertools.islice(
        tdata.markov_tokens(MOE["batch"], MOE["seq"] + 1, seed=0, device=dev), n_steps))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_train_counts()
    state, metrics, step_ms, elapsed = timed_steps(step, state, batches, MOE["warmup"])
    counts = train_counts()
    expect = {name: (1 if key is None else cfg.n_layers) * n_steps
              for name, (key, _, _) in TRAIN_KERNELS.items()}
    assert counts == expect, (counts, expect)
    losses = scalar_losses(metrics)
    ce = [m["ce"].item() for m in metrics]
    aux = [m["aux"].item() for m in metrics]
    assert all(math.isfinite(x) for x in ce + aux), (ce, aux)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tokens = MOE["batch"] * MOE["seq"]
    tok_s = tokens * MOE["steps"] / elapsed
    n_active = moe_active_params(cfg)
    dispatch = moe_dispatch_flop(cfg, tokens)
    del state, params, leaves, opt, batches, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return {"phase": "moe_train", "card": card, "model": "mixtral-8x7b widths, 2 layers, bf16",
            "params_b": n_params / 1e9, "active_params_b": n_active / 1e9, **MOE,
            "capacity": eparallel.expert_capacity(tokens, cfg.num_experts, cfg.capacity_factor,
                                                  cfg.experts_per_token),
            "tok_per_s": tok_s, "step_ms_median": statistics.median(step_ms), "step_ms": step_ms,
            "model_tflops": 6 * n_active * tok_s / 1e12,
            "dispatch_tflop_per_step": dispatch / 1e12,
            "dispatch_tflops": dispatch * tok_s / tokens / 1e12,
            "peak_mem_gb": peak_gb, "losses": losses, "ce": ce, "aux": aux, "launches": counts}


# -- speculative path ---------------------------------------------------------
def phase_short_attention_parity(dev) -> dict:
    """The short-sequence kernel against ``attention_reference``: float32
    (TF32 off) and bf16, causal and not, at lengths below, at, across and
    far past the one-pass kernels' 64 and 128 keys and the two-pass
    kernel's tiles, D = 64 and 128, and the two training shapes; then the
    autograd route: the Function's grads are the plain version's."""
    out = {}
    shapes = [((2, 3, t, d), f"T{t}/D{d}") for t in (1, 7, 37, 64, 127, 128, 129, 200, 255, 256,
                                                      512, 768, 1024)
              for d in (64, 128)]
    shapes += [((32, bh // 32, t, d), name) for name, (bh, t, d) in ATTN_TRAIN_SHAPES.items()]
    for shape, name in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                q, k, v = flash_inputs(7, shape, dtype, dev)[:3]
                before = sa.LAUNCHES
                got = sa.fused_attention(q, k, v, causal=causal)
                torch.cuda.synchronize()  # lint: allow(JIT502) — parity: one readback per case, after its kernel ran
                assert sa.LAUNCHES == before + 1 and sa.LAST_DISPATCH["impl"] == "cuda"
                ref = sa.attention_reference(q, k, v, causal)
                key = f"{name}/{str(dtype)[6:]}/{'causal' if causal else 'full'}"
                out[key] = kernel_err(got.flatten(0, 1), ref.flatten(0, 1), key)
    worst_grad = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        base = flash_inputs(8, (4, 100, 8, 64), dtype, dev)  # [B, T, H, D], as the model hands over
        grads = []
        for fn in (sa.fused_attention, sa.attention_reference):
            q, k, v = [x.clone().requires_grad_() for x in base[:3]]
            fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True).backward(
                base[3].transpose(1, 2))
            grads.append((q.grad, k.grad, v.grad))
        for a, b in zip(*grads):
            worst_grad = max(worst_grad, (a.float() - b.float()).abs().max().item())  # lint: allow(JIT502) — parity: one readback per case, after its kernel ran
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    return {"errors": {k: v for k, v in out.items() if "bfloat16" in k or "target" in k},
            "max_abs_err_f32": max(e for k, (e, _) in out.items() if "float32" in k),
            "max_head_rel_bf16": max(h for k, (_, h) in out.items() if "bfloat16" in k),
            "cases": len(out), "grad_max_abs_diff": worst_grad}


def rms_inputs(seed, shape, dtype, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    w = 1 + 0.1 * torch.randn(shape[-1], generator=g, device=dev)
    return x, w, torch.randn(shape, generator=g, device=dev).to(dtype)


def phase_rms_norm_parity(dev) -> dict:
    """The RMSNorm kernel against ``rms_norm_reference``, float32 and
    bf16, at the repo's widths and one width that is no multiple of 8;
    forward, and the analytic backward through the Function against
    autograd through the plain version."""
    out = {}
    for shape in RMS_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x, w, g = rms_inputs(9, shape, dtype, dev)
            before = rn.LAUNCHES
            xk, wk = x.clone().requires_grad_(), w.clone().requires_grad_()
            got = rn.fused_rms_norm(xk, wk, block_rows=min(256, shape[0]))
            got.backward(g)
            torch.cuda.synchronize()  # lint: allow(JIT502) — parity: one readback per case, after its kernel ran
            assert rn.LAUNCHES == before + 1 and rn.LAST_DISPATCH["impl"] == "cuda"
            xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
            ref = rn.rms_norm_reference(xr, wr)
            ref.backward(g)
            f32 = dtype == torch.float32
            torch.testing.assert_close(got.detach(), ref.detach(), **(RMS_F32_TOL if f32 else RMS_BF16_TOL))
            # grads: the same formula in float32 on both sides of autograd
            torch.testing.assert_close(xk.grad, xr.grad, rtol=1e-4 if f32 else 2.0 ** -6,
                                       atol=1e-5 if f32 else 2e-2)
            torch.testing.assert_close(wk.grad, wr.grad, rtol=1e-4 if f32 else 1e-3,
                                       atol=1e-4 if f32 else 1e-2 * shape[0] ** 0.5)
            out[f"{shape[0]}x{shape[1]}/{str(dtype)[6:]}"] = {
                "y": (got.detach().float() - ref.detach().float()).abs().max().item(),  # lint: allow(JIT502) — parity: one readback per case, after its kernel ran
                "dx": (xk.grad.float() - xr.grad.float()).abs().max().item(),  # lint: allow(JIT502) — parity: one readback per case, after its kernel ran
                "dw": (wk.grad - wr.grad).abs().max().item(),  # lint: allow(JIT502) — parity: one readback per case, after its kernel ran
            }
    return out


def attention_bound(bh: int, t: int, d: int) -> tuple[float, str]:
    """Least time for one causal bf16 short-attention call: q, k, v read
    and o written once, against 4 D flops per live (query, key) pair."""
    return bound_of(4 * bh * t * d * 2, 4 * d * bh * t * (t + 1) // 2, BF16_FLOPS_PER_S)


def phase_spec_kernel_timing(dev) -> dict:
    """The two kernels beside their plain versions, one library call and
    their bounds: attention at the target's training shape (bf16, causal,
    [256, 128, 128]), the draft's, and the draft's 500-token prefill
    ([4, 512, 64]: the two-pass kernel); RMSNorm at [4096, 1024] bf16."""
    out = {}
    for name, (bh, t, d) in {**ATTN_TRAIN_SHAPES, "prefill512": ATTN_PREFILL_SHAPE}.items():
        batch = 1 if name == "prefill512" else 32
        q, k, v = flash_inputs(10, (batch, bh // batch, t, d), torch.bfloat16, dev)[:3]
        ms, _ = device_ms(lambda: sa.attention_fwd(q, k, v, True), 50)
        plain_ms, _ = device_ms(lambda: sa.attention_reference(q, k, v, True), 20)
        lib_ms, _ = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 50)
        got = sa.attention_fwd(q, k, v, True)
        lib_err = (F.scaled_dot_product_attention(q, k, v, is_causal=True).float()  # lint: allow(JIT502) — the library call's error, read once per timed shape
                   - got.float()).abs().max().item()
        err = kernel_err(got.flatten(0, 1), sa.attention_reference(q, k, v, True).flatten(0, 1),
                         f"attention_{name}")
        bound_ms, bound_by = attention_bound(bh, t, d)
        out[f"attention_{name}"] = {"kernel_ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                                    "bound_ms": bound_ms, "bound_by": bound_by,
                                    "bound_share": bound_ms / ms,
                                    "gbytes_per_s": 4 * bh * t * d * 2 / ms / 1e6,
                                    "max_abs_err": err[0], "max_head_rel_err": err[1],
                                    "library_max_abs_err": lib_err}
    for key, (rows, d) in (("rms_norm", RMS_SHAPES[0]), ("rms_norm_4096", RMS_WIDE)):
        x, w, _ = rms_inputs(11, (rows, d), torch.bfloat16, dev)
        wb = w.to(torch.bfloat16)  # the library call takes the weight in x's dtype
        ms, _ = device_ms(lambda: rn.rms_norm_fwd(x, w), 100)
        plain_ms, _ = device_ms(lambda: rn.rms_norm_reference(x, w), 50)
        lib_ms, _ = device_ms(lambda: F.rms_norm(x, (d,), wb, 1e-5), 100)
        # x read and y written once, the weight read once; ~4 f32 operations
        # per element
        bound_ms, bound_by = bound_of(2 * rows * d * 2 + d * 4, 4 * rows * d, F32_FLOPS_PER_S)
        out[key] = {"kernel_ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": bound_ms / ms}
    return out


def reset_counts() -> None:
    reset_train_counts()
    sa.LAUNCHES = rn.LAUNCHES = pa.LAUNCHES = 0


def phase_train_pair(dev, card, out: str) -> tuple[dict, dict, dict]:
    """The pair trained by scripts/train_draft_pair_torch.py's
    ``train_pair`` (its recipe: Adam steps from seeded params on the
    corpus, then the held-out greedy agreement), which saves both as bare
    params under ``out`` (``target/``, ``draft/``) and writes
    ``pair.json``. Each training step runs the short-sequence attention
    kernel once per layer (T = 128) and the loss kernel once, flash
    attention never; the agreement's T = 64 forwards run short attention
    once per layer."""
    reset_counts()
    meta, trained = pair_script.train_pair(
        out, PAIR_TARGET, PAIR_DRAFT, PAIR_CORPUS, steps=PAIR_STEPS, batch=PAIR_BATCH,
        seq=PAIR_SEQ, lr=PAIR_LR, device=dev, log=lambda *a: None)
    counts = {"attention": sa.LAUNCHES, **train_counts()}
    layers = PAIR_TARGET.n_layers + PAIR_DRAFT.n_layers
    expect = {"attention": layers * (PAIR_STEPS + 1), "flash_fwd": 0, "flash_bwd_dq": 0,
              "flash_bwd_dkv": 0, "cross_entropy": 2 * PAIR_STEPS}
    assert counts == expect, (counts, expect)
    assert sa.LAST_DISPATCH["impl"] == "cuda" and xl.LAST_DISPATCH["impl"] == "cuda"
    with open(os.path.join(out, "pair.json")) as f:
        assert json.load(f) == json.loads(json.dumps(meta))
    reports = {}
    for name, (_, report) in trained.items():
        assert report["losses_finite"] and report["last_loss"] < report["first_loss"], report
        assert os.listdir(os.path.join(out, name)) == [f"step_{PAIR_STEPS:08d}"]
        reports[name] = {
            **{k: report[k] for k in ("params_m", "steps", "first_loss", "last_loss")},
            "step_ms": report["seconds"] * 1e3 / PAIR_STEPS,  # batch sampling on the host included
            "tok_per_s": PAIR_BATCH * (PAIR_SEQ - 1) * PAIR_STEPS / report["seconds"],
        }
    return {
        "phase": "train_pair", "card": card, "script": "scripts/train_draft_pair_torch.py",
        "batch": PAIR_BATCH, "seq": PAIR_SEQ, "optimizer": f"adam({PAIR_LR})",
        "corpus": PAIR_CORPUS, **reports,
        **{k: meta[k] for k in ("target_draft_agreement", "target_accuracy", "draft_accuracy",
                                "params_ratio")},
        "launches": counts,
        "attention_launches": counts["attention"], "xent_launches": counts["cross_entropy"],
    }, trained["target"][0], trained["draft"][0]


def bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes, for a bit-for-bit comparison."""
    return t.detach().contiguous().view(torch.uint8)


def assert_same_bytes(a: dict, b: dict) -> int:
    """Two param trees hold the same bytes, leaf by leaf -> their bytes."""
    la, lb = ttrainer.param_leaves(a), ttrainer.param_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(bits(x), bits(y))
    return sum(x.numel() * x.element_size() for x in la)


def phase_spec_small_reference(dev) -> dict:
    """Float32 TINY (two layers) on the card with TF32 off:
    ``generate_speculative`` equals ``generate`` token for token with a
    same-weights and an unrelated draft, and the engine with a draft
    equals the engine without, exactly. Every run stays under 30 new
    tokens (the TINY/seed-0 trajectory meets an exact float32 tie near
    38)."""
    cfg = dataclasses.replace(tfm.TINY, dtype=torch.float32)
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    other = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(123))
    prompt = torch.tensor([[5, 1, 4], [2, 9, 9]], device=dev)
    with torch.no_grad():
        ref = tfm.generate(params, prompt, cfg, 24)
    rates = {}
    for name, draft in (("same", params), ("unrelated", other)):
        got, stats = spec.generate_speculative(params, draft, prompt, cfg, cfg, 24, k=4)
        assert torch.equal(got, ref), f"generate_speculative ({name} draft) left greedy generate"
        rates[name] = stats.acceptance_rate
    assert rates["same"] > 0.8, rates
    requests = [([5, 1, 4], 24), ([2, 9, 9], 20), ([7, 3], 16), (list(range(1, 21)), 12)]
    streams = {}
    for name, kw in (("plain", {}), ("same", dict(draft_params=params, draft_cfg=cfg, spec_k=3)),
                     ("unrelated", dict(draft_params=other, draft_cfg=cfg, spec_k=4, spec_depth=2))):
        engine = InferenceEngine(params, cfg, device=dev, max_slots=2, max_len=64, **kw).start()
        try:
            handles = [engine.submit(p, n) for p, n in requests]
            streams[name] = [h.result(timeout=300) for h in handles]
            st = engine.stats()
        finally:
            engine.stop()
        assert st["requests_failed"] == 0
        assert (st["spec_rounds"] > 0) == (name != "plain")
    assert streams["same"] == streams["plain"] and streams["unrelated"] == streams["plain"]
    assert streams["plain"][0] == ref[0].tolist()
    return {"generate_speculative_acceptance": rates, "engine_streams_equal": True}


def logit_path_gaps(t_params, cfg, seqs, dev, rel: float = LOGIT_PATH_REL,
                    positions: int = SPEC_K + 1) -> dict:
    """The model's logits at the last ``positions`` positions of each
    sequence (default spec_k + 1), computed three ways from one prefilled
    pool laid out as the engine's (8 slots, parked ones with a zeroed
    table and positions from 0; as many blocks a slot as the longest
    sequence needs): that many ``decode_tokens_paged`` steps of 8 rows,
    one ``decode_block_paged`` of 8 x that many rows, and the
    full-sequence ``forward``. -> the largest
    absolute differences, which must be bf16 rounding (``rel`` of the
    largest logit): a verification row that read another row's table
    or length would differ by whole logits."""
    bs, k1, B = 64, positions, 8
    mb = -(-max(map(len, seqs)) // bs)
    n = len(seqs)
    pool = tfm.init_paged_pool(cfg, 1 + B * mb, bs, None, dev)
    tables = torch.zeros((B, mb), dtype=torch.int32, device=dev)
    tables[:n] = torch.arange(1, 1 + n * mb, dtype=torch.int32, device=dev).view(n, mb)
    tokens = torch.zeros((B, k1), dtype=torch.int64, device=dev)
    positions = torch.arange(k1, device=dev).repeat(B, 1)
    full = []
    with torch.no_grad():
        for i, seq in enumerate(seqs):
            toks = torch.tensor(seq, device=dev)
            start = len(seq) - k1
            tfm.prefill_chunk_paged(t_params, pool, tables[i], toks[:start], 0, cfg)
            tokens[i], positions[i] = toks[start:], torch.arange(start, len(seq), device=dev)
            full.append(tfm.forward(t_params, toks[None], cfg)[0, start:].float())
        steps = torch.stack([
            tfm.decode_tokens_paged(t_params, pool, tables, tokens[:, j], positions[:, j], cfg)[0]
            for j in range(k1)], dim=1)[:n]
        block = tfm.decode_block_paged(t_params, pool, tables, tokens, positions, cfg)[0][:n]
    gaps = {"verify_vs_decode": (block - steps).abs().max().item(),
            "forward_vs_decode": (torch.stack(full) - steps).abs().max().item(),
            "max_abs_logit": steps.abs().max().item()}
    ceiling = rel * gaps["max_abs_logit"]
    assert max(gaps["verify_vs_decode"], gaps["forward_vs_decode"]) <= ceiling, (gaps, ceiling)
    return gaps


def near_tie(t_params, prompt, a, b, bound, cfg=PAIR_TARGET) -> Optional[dict]:
    """None for two equal greedy streams. Where they part: the target's
    logits at the first differing position, recomputed by one
    full-sequence forward over the common prefix; both candidates must
    lie within ``bound`` (absolute logits, from ``logit_path_gaps``) of
    the top logit."""
    if a == b:
        return None
    pos = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
    toks = torch.tensor([prompt + a[:pos]], device=t_params["embed"].device)
    with torch.no_grad():
        logits = tfm.forward(t_params, toks, cfg)[0, -1]
    top = logits.max().item()
    gap = top - min(logits[a[pos]].item(), logits[b[pos]].item())
    assert gap <= bound, (f"streams part at {pos}: tokens {a[pos]} / {b[pos]} lie {gap} below "
                          f"the top logit {top}, beyond the near-tie bound {bound}")
    return {"position": pos, "tokens": [a[pos], b[pos]], "gap": gap, "bound": bound}


def spec_http(engine, body: dict) -> tuple[int, dict]:
    """(status, reply) of one POST to ``/generate_speculative``."""
    with http_server(engine, "draft-pair") as url:
        req = urllib.request.Request(url + "/generate_speculative", data=json.dumps(body).encode())
        try:
            with urllib.request.urlopen(req, timeout=300) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())


def drive_spec_engine(engine, requests) -> dict:
    """Submit every request at once and wait for all, with the kernels'
    launches, decode steps, spec dispatches and draft prefills counted
    over exactly this run: the paged-decode launches of the graph
    replays (the wrapper's own count stays at 0: ``prewarm`` captured
    every program), the short-attention launches of the eager draft
    prefills."""
    reset_counts()
    before = engine.stats()
    t0 = time.monotonic()
    handles = [engine.submit(p, n, **kw) for p, n, kw in requests]
    results = [h.result(timeout=600) for h in handles]
    wall = time.monotonic() - t0
    st = engine.stats()
    delta = {k: st[k] - before[k] for k in ("decode_steps", "spec_dispatches", "draft_prefills",
                                            "spec_rounds", "spec_proposed", "spec_accepted",
                                            "spec_committed", "tokens_generated",
                                            "spec_launch_s", "spec_readback_s",
                                            "paged_decode_launches", "graph_captures")}
    assert st["requests_failed"] == 0 and delta.pop("graph_captures") == 0
    # every decode step and every verification block is one paged-decode
    # launch per target layer; every draft prefill one short-attention
    # launch per draft layer (the target's prefill runs no kernel)
    verify = delta["spec_dispatches"] * engine.spec_depth
    assert pa.LAUNCHES == 0, f"{pa.LAUNCHES} launches outside the graphs"
    assert delta["paged_decode_launches"] == engine.cfg.n_layers * (delta["decode_steps"] + verify), delta
    if engine.draft_cfg is not None:
        assert sa.LAUNCHES == engine.draft_cfg.n_layers * delta["draft_prefills"], (sa.LAUNCHES, delta)
    else:
        assert sa.LAUNCHES == 0
    return {"results": results, "wall_s": wall, "tok_per_s": delta["tokens_generated"] / wall,
            "attention_launches": sa.LAUNCHES, **delta}


def phase_spec_engine(t_params, d_params, pair_dir, dev, card) -> dict:
    """The trained pair served from its checkpoints: the params
    ``load_serving_params`` restores equal the trained ones byte for
    byte; an engine with the draft and one without, both built by
    ``InferenceEngine.from_checkpoint``, beside an engine over the
    in-memory params, whose greedy streams the restored plain engine's
    equal token for token. Six greedy requests with corpus prompts, then
    one sampled request twice, then HTTP."""
    roots = {name: os.path.join(pair_dir, name) for name in ("target", "draft")}
    t0 = time.monotonic()
    restored = {name: load_serving_params(root, cfg, device=dev)
                for (name, root), cfg in zip(roots.items(), (PAIR_TARGET, PAIR_DRAFT))}
    restore_s = time.monotonic() - t0
    restored_bytes = 0
    for name, live in (("target", t_params), ("draft", d_params)):
        params, step = restored[name]
        assert step == PAIR_STEPS, (name, step)
        restored_bytes += assert_same_bytes(params, live)
    del restored
    sample = tdata.markov_sampler(**PAIR_CORPUS, device="cpu")
    prompts = [sample(1, n, seed=100 + i)[0].tolist() for i, n in enumerate(SPEC_PROMPT_LENS)]
    requests = [(p, SPEC_NEW_TOKENS, {}) for p in prompts]
    kw = dict(device=dev, max_slots=8, max_len=1024, block_size=64)
    engines = {
        "spec": InferenceEngine.from_checkpoint(
            roots["target"], PAIR_TARGET, draft_checkpoint=roots["draft"], draft_cfg=PAIR_DRAFT,
            spec_k=SPEC_K, spec_depth=1, **kw),
        "plain": InferenceEngine.from_checkpoint(roots["target"], PAIR_TARGET, **kw),
        "in_memory": InferenceEngine(t_params, PAIR_TARGET, **kw),
    }
    runs, warm = {}, {}
    try:
        for name, engine in engines.items():
            warm[name] = prewarm_engine(engine)
            engine.start()
            engine.submit(prompts[0], 4).result(timeout=600)  # warm-up, not counted
            runs[name] = drive_spec_engine(engine, requests)
            assert [len(r) for r in runs[name]["results"]] == [SPEC_NEW_TOKENS] * len(requests)
        assert runs["spec"]["spec_rounds"] > 0 and runs["plain"]["spec_rounds"] == 0
        assert runs["plain"]["results"] == runs["in_memory"]["results"], \
            "the restored engine's greedy streams differ from the in-memory params' engine"
        gaps = logit_path_gaps(
            t_params, PAIR_TARGET, [p + r for p, r in zip(prompts, runs["plain"]["results"])], dev)
        tie_bound = NEAR_TIE_GAPS * (gaps["verify_vs_decode"] + gaps["forward_vs_decode"])
        ties = [near_tie(t_params, p, a, b, tie_bound) for p, a, b in
                zip(prompts, runs["plain"]["results"], runs["spec"]["results"])]
        ties = [t for t in ties if t is not None]
        # the standalone path on the shorter prompts, one at a time: both
        # models prefill at the prompt's own length through the
        # short-sequence kernel, and the stream is the plain engine's
        reset_counts()
        standalone = spec.SpecStats()
        for p, want in zip(prompts[:4], runs["plain"]["results"]):
            got, st = spec.generate_speculative(
                t_params, d_params, torch.tensor([p], device=dev), PAIR_TARGET, PAIR_DRAFT,
                SPEC_NEW_TOKENS, k=SPEC_K)
            tie = near_tie(t_params, p, want, got[0].tolist(), tie_bound)
            ties += [tie] if tie else []
            standalone.accepted += st.accepted
            standalone.proposed += st.proposed
        standalone_launches = sa.LAUNCHES
        assert standalone_launches == 4 * (PAIR_TARGET.n_layers + PAIR_DRAFT.n_layers)
        # one sampled request, twice: it rides the speculative path and
        # repeats token for token from its seed
        sampled = [(prompts[2], 48, {"temperature": 0.8, "seed": 7})]
        first = drive_spec_engine(engines["spec"], sampled)
        again = drive_spec_engine(engines["spec"], sampled)
        assert first["spec_rounds"] > 0 and len(first["results"][0]) == 48
        assert first["results"] == again["results"], "a sampled stream must repeat from its seed"
        body = {"prompt_ids": prompts[3], "max_new_tokens": 16}
        code, reply = spec_http(engines["spec"], body)
        assert code == 200 and reply["speculative"]["rounds"] > 0, (code, reply)
        http_tie = near_tie(t_params, prompts[3], runs["spec"]["results"][3][:16], reply["tokens"],
                            tie_bound)
        code_plain, _ = spec_http(engines["plain"], body)
        assert code_plain == 501, code_plain
        code_bad, _ = spec_http(engines["spec"], {**body, "temperature": 0.0})
        assert code_bad == 400, code_bad
    finally:
        for engine in engines.values():
            engine.stop()
    line = {"phase": "spec_engine", "model": "draft-pair", "card": card, "spec_k": SPEC_K,
            "from_checkpoint": {"restore_s": restore_s, "bytes": restored_bytes,
                                "params_byte_equal": True, "streams_equal_in_memory": True},
            "prompt_lens": list(SPEC_PROMPT_LENS), "max_new_tokens": SPEC_NEW_TOKENS,
            "streams_identical": not ties, "near_ties": ties, "near_tie_bound": tie_bound,
            "logit_path_gaps": gaps, "logit_path_rel": LOGIT_PATH_REL,
            "acceptance_rate": runs["spec"]["spec_accepted"] / runs["spec"]["spec_proposed"],
            "tokens_per_round": runs["spec"]["spec_committed"] / runs["spec"]["spec_rounds"],
            # speculation pays only above 1
            "spec_over_plain_tok_per_s": runs["spec"]["tok_per_s"] / runs["plain"]["tok_per_s"],
            # host clock inside the engine's own rounds, per dispatch:
            # syncing the carry and queueing the graph, then the readback,
            # which waits for the card to finish the round
            "dispatch_host_ms": {
                part: runs["spec"][f"spec_{part}_s"] * 1e3 / runs["spec"]["spec_dispatches"]
                for part in ("launch", "readback")},
            "prewarm": warm,
            "generate_speculative": {"prompt_lens": list(SPEC_PROMPT_LENS[:4]),
                                     "acceptance_rate": standalone.acceptance_rate,
                                     "attention_launches": standalone_launches},
            "sampled": {"tokens": 48, "repeats": True, "spec_rounds": first["spec_rounds"],
                        "acceptance_rate": first["spec_accepted"] / first["spec_proposed"]},
            "http": {"status": 200, "speculative": reply["speculative"], "near_tie": http_tie,
                     "no_draft": code_plain, "sampling_field": code_bad}}
    for name, run in runs.items():
        line[name] = {k: v for k, v in run.items() if k != "results"}
    return line


# -- the fleet: Llama-2-7B torch replicas behind the port's gateway -------------
# two replicas of the int8_weights phase's checkpoint share the card, each
# with the server's 8 slots at the model's 4096-token max_len (17.2 GB of
# bf16 pool beside 13.5 GB of weights), so the 8 requests in flight never
# queue inside a replica and the load term never outweighs a context's
# prefix; the gateway routes by prefix (its shadow index at the engine's
# 64-token blocks); admission control is off, so no request of the burst
# waits in the gateway's queue or is refused
FLEET = {"replicas": 2, "max_slots": 8, "contexts": 3, "context_tokens": 512,
         "question_tokens": [8, 32], "requests": 24, "new_tokens": 32, "in_flight": 8,
         "ready_timeout_s": 600.0, "block_size": 64}
# the fleet's TTFT objective: the server's default (1 s at p99) is for a
# replica alone on its card, and two 7B replicas sharing one miss it on
# the burst's cold 512-token contexts; a replica in breach weighs its load
# up in the router (slo_pressure) and sheds its contexts, which the SLO
# gate below shows apart
FLEET_SLO_ENV = {"DEVSPACE_SLO_TTFT_P99_S": "10"}
# the short-lived replica of the SLO gate: a TTFT objective no request
# meets, a 3 s short window evaluated every 0.2 s
SLO_GATE_ENV = {"DEVSPACE_SLO_TTFT_P99_S": "0.000001", "DEVSPACE_SLO_SHORT_WINDOW_S": "3",
                "DEVSPACE_SLO_INTERVAL_S": "0.2", "MAX_SLOTS": "1", "PREWARM": "0"}


def replica_spec(ckpt_dir: str, model: str, **env):
    """A torch replica: ``python -m devspace_tpu_torch.serve`` over the
    checkpoint, every program built before its port opens."""
    from devspace_tpu_torch.serving import ReplicaSpec

    return ReplicaSpec(
        module="devspace_tpu_torch.serve",
        env={"MODEL": model, "CHECKPOINT": ckpt_dir, "PREWARM": "1",
             "MAX_SLOTS": str(FLEET["max_slots"]), "PYTHONPATH": REPO_ROOT, **env},
        ready_timeout_s=FLEET["ready_timeout_s"], probe_timeout_s=5.0, stop_grace_s=20.0)


def fleet_traffic(vocab: int) -> list:
    """Three 512-token contexts, each followed by a question of 8-32
    tokens: the 24 prompts in turn over the contexts (seed 5)."""
    rng = np.random.default_rng(5)
    contexts = [rng.integers(1, vocab, FLEET["context_tokens"]).tolist()
                for _ in range(FLEET["contexts"])]
    lo, hi = FLEET["question_tokens"]
    return [(i % FLEET["contexts"],
             contexts[i % FLEET["contexts"]] + rng.integers(1, vocab, rng.integers(lo, hi + 1))
             .tolist()) for i in range(FLEET["requests"])]


def stream_generate(url: str, prompt: list, n: int) -> list:
    """The tokens of one streamed greedy ``/generate``; the stream must
    end with ``{"done": true}``."""
    body = json.dumps({"prompt_ids": prompt, "max_new_tokens": n, "stream": True}).encode()
    with urllib.request.urlopen(urllib.request.Request(url + "/generate", data=body),
                                timeout=600) as resp:
        lines = [json.loads(ln) for ln in resp.read().splitlines() if ln.strip()]
    assert lines and lines[-1] == {"done": True}, lines[-3:]
    return [m["token"] for m in lines[:-1]]


def get_json(url: str, timeout: float = 60) -> tuple[int, dict]:
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def scrape(url: str) -> dict:
    from devspace_tpu_torch.obs.fleet import parse_exposition

    with urllib.request.urlopen(url + "/metrics", timeout=60) as resp:
        return parse_exposition(resp.read().decode())


def sample_value(snap: dict, name: str) -> float:
    return float(snap[name]["samples"][0][1]) if snap.get(name) else 0.0


def histogram_quantile(value: dict, q: float) -> Optional[float]:
    """The upper edge of the bucket holding quantile ``q`` of a snapshot
    histogram (bucket resolution, as the SLO evaluator reads it)."""
    if not value["count"]:
        return None
    for le, cum in value["buckets"]:
        if cum >= q * value["count"]:
            return le
    return math.inf


def start_seconds(replica) -> dict:
    """A stopped replica's own start report: the engine build (the
    checkpoint's load) and prewarm seconds it printed."""
    out = replica.output()
    times = {}
    for key, pattern in (("load_s", r"engine built in ([0-9.]+)s"),
                         ("prewarm_s", r"prewarmed \d+ programs in ([0-9.]+)s")):
        m = re.search(pattern, out)
        times[key] = float(m.group(1)) if m else None
    return times


def run_concurrent(fn, items: list, workers: int) -> list:
    """``fn`` over ``items`` with at most ``workers`` in flight, in order."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(fn, items))


def phase_fleet(ckpt_dir: str, card: str, tie_bound: float, dev, model: str = "llama2-7b",
                cfg=tfm.LLAMA2_7B) -> dict:
    """Two Llama-2-7B torch replicas (``ReplicaFleet``, each ``python -m
    devspace_tpu_torch.serve`` with ``CHECKPOINT`` and ``PREWARM=1``) on
    the one card behind the port's ``RoutingGateway`` (policy prefix) and
    ``TelemetryCollector``. A greedy burst of 24 requests over three
    512-token contexts, 8 in flight, after each context's first request:
    every stream equals the prompt served directly by one replica up to
    a near tie; each context's later requests land on its first replica,
    whose engine counts the prefix hits; the collector's federated token
    count equals the tokens the clients received; each replica that
    served ran the paged-decode kernel and captured no graph after
    prewarm. Then one replica is SIGKILLed: a request routed to it is
    rerouted before its first byte, and the fleet restarts it within its
    ready timeout. Last, a short-lived third replica's ``/readyz`` flips
    to 503 under an injected TTFT breach and comes back."""
    from devspace_tpu_torch.obs.collector import TelemetryCollector
    from devspace_tpu_torch.serving import ReplicaFleet
    from devspace_tpu_torch.serving.gateway import RoutingGateway
    from devspace_tpu_torch.serving.router import PrefixRouter, RouterConfig, loads_from_collector

    line = {"phase": "fleet", "model": model, "card": card, **FLEET,
            "note": "two replicas share one card: their tok/s is not a scaling figure"}
    traffic = fleet_traffic(cfg.vocab_size)
    n_new = FLEET["new_tokens"]
    fleet = ReplicaFleet(spec=replica_spec(ckpt_dir, model, **FLEET_SLO_ENV),
                         replicas=FLEET["replicas"], poll_interval=1.0)
    gw = collector = None
    stopped = []
    try:
        t0 = time.monotonic()
        fleet.start()
        line["fleet_start_s"] = time.monotonic() - t0
        names = fleet.names()
        urls = fleet.targets()
        assert sorted(urls) == sorted(names) and len(set(urls.values())) == len(names)
        health0 = {n: get_json(urls[n] + "/healthz")[1] for n in names}
        # the collector scrapes every replica each second; the router
        # reads its load signals (slots, queue, occupancy) from it
        collector = TelemetryCollector(sorted(urls.items()), interval_s=1.0, timeout_s=30)
        collector.scrape_once()
        collector.start()
        router = PrefixRouter(replicas_fn=fleet.targets,
                              loads_fn=lambda: loads_from_collector(collector),
                              config=RouterConfig(policy="prefix", admission=False,
                                                  block_size=FLEET["block_size"]))
        # the context of each routing decision, in routing order
        routes = []
        contexts = {tuple(traffic[c][1][:16]): c for c in range(FLEET["contexts"])}
        route = router.route

        def recorded_route(prompt_ids, *args, **kwargs):
            d = route(prompt_ids, *args, **kwargs)
            routes.append((contexts[tuple(prompt_ids[:16])], d))
            return d

        router.route = recorded_route
        gw = RoutingGateway(router, port=0, request_timeout_s=600)
        gw.start()
        before = {n: scrape(urls[n]) for n in names}

        # each context's first request, the three at once, then the rest
        firsts = list(range(FLEET["contexts"]))
        t0 = time.monotonic()
        got = dict(zip(firsts, run_concurrent(
            lambda i: stream_generate(gw.base_url, traffic[i][1], n_new), firsts, len(firsts))))
        # the router's load view is a scrape behind the replicas: take one
        # after the firsts, so the replica that served none is not seen
        # as idle beside the ones that did (the dispatch window's
        # occupancy is a lifetime mean, 0 until a replica decodes)
        collector.scrape_once()
        rest = list(range(FLEET["contexts"], FLEET["requests"]))
        got.update(zip(rest, run_concurrent(
            lambda i: stream_generate(gw.base_url, traffic[i][1], n_new), rest,
            FLEET["in_flight"])))
        burst_s = time.monotonic() - t0
        after = {n: scrape(urls[n]) for n in names}
        health = {n: get_json(urls[n] + "/healthz")[1] for n in names}
        received = sum(len(got[i]) for i in range(FLEET["requests"]))
        assert received == FLEET["requests"] * n_new

        # prefix affinity: each context's later requests follow its first
        home = {}
        for ctx, d in routes:
            home.setdefault(ctx, d.replica)
        later = routes[FLEET["contexts"]:]
        assert sorted(home) == firsts and len(routes) == FLEET["requests"]
        moved = [(ctx, d.replica, d.scores, d.overlap_tokens, d.reason) for ctx, d in later
                 if d.replica != home[ctx]]
        assert not moved, ("a context left its first replica", home, moved)
        assert all(d.overlap_tokens >= FLEET["context_tokens"] for _, d in later), \
            [d.overlap_tokens for _, d in later]
        hits = {n: sample_value(after[n], "engine_prefix_hit_tokens_total")
                - sample_value(before[n], "engine_prefix_hit_tokens_total") for n in names}
        # the engine caches whole blocks of its own size
        cached = FLEET["context_tokens"] // serve.BLOCK_SIZE * serve.BLOCK_SIZE
        for n in set(home.values()):
            assert hits[n] >= cached > 0, (n, hits)

        # federation: the collector's sum over the replicas
        collector.stop()
        collector.scrape_once()
        fed = collector.fleet_snapshot()
        assert all(t.up for t in collector.targets)
        fed_tokens = sample_value(fed, "engine_tokens_generated_total")
        assert fed_tokens == received, (fed_tokens, received)

        # the kernel ran on every replica that served (a replay counts its
        # launches on the card only); no graph after prewarm
        served = {n for n in names if sample_value(after[n], "engine_tokens_generated_total")}
        launches = {n: health[n]["paged_decode_launches"] - health0[n]["paged_decode_launches"]
                    for n in names}
        for n in served:
            assert launches[n] > 0 or dev.type != "cuda", (n, health[n])
        for n in names:
            assert health[n]["graph_captures"] == health0[n]["graph_captures"] > 0, n
            assert health[n]["requests_failed"] == 0

        # every stream equals the prompt served directly by one replica
        direct_url = urls[names[-1]]
        direct = run_concurrent(lambda i: stream_generate(direct_url, traffic[i][1], n_new),
                                list(range(FLEET["requests"])), FLEET["max_slots"])
        mismatched = [i for i in range(FLEET["requests"]) if got[i] != direct[i]]

        per_replica = {}
        for n in names:
            (_, ttft), = after[n]["ttft_seconds"]["samples"]
            tokens = (sample_value(after[n], "engine_tokens_generated_total")
                      - sample_value(before[n], "engine_tokens_generated_total"))
            per_replica[n] = {
                "requests": sum(1 for _, d in routes if d.replica == n),
                "tokens": tokens, "tok_per_s": tokens / burst_s,
                "ttft_s_median": histogram_quantile(ttft, 0.5),
                "ttft_s_p99": histogram_quantile(ttft, 0.99), "ttft_count": ttft["count"],
                "prefix_hit_tokens": hits[n],
                "paged_decode_launches": launches[n],
                "graph_captures": health[n]["graph_captures"],
            }
        router_counters = {name: fam["samples"][0][1] if len(fam["samples"]) == 1
                           else [[lb, v] for lb, v in fam["samples"]]
                           for name, fam in router.registry.snapshot().items()
                           if name.startswith("serving_router_") and fam["kind"] == "counter"}

        # SIGKILL one replica that holds a context, and route a request of
        # that context at once: the gateway meets the dead port before any
        # byte and reroutes
        victim = home[0]
        old = fleet.replica(victim)
        retries0 = sample_value(router.registry.snapshot(), "serving_router_retries_total")
        assert home[0] in urls
        fleet.kill(victim)
        t_kill = time.monotonic()
        old.proc.wait(timeout=60)
        rerouted = stream_generate(gw.base_url, traffic[0][1], n_new)
        retries = sample_value(router.registry.snapshot(), "serving_router_retries_total")
        assert retries == retries0 + 1, (retries0, retries)
        assert len(rerouted) == n_new
        stopped.append(old)
        restart_s = wait_restarted(fleet, victim, old.pid, t_kill)
        restarted = fleet.replica(victim)
        again = stream_generate(restarted.base_url, traffic[0][1], n_new)
        restarted_health = get_json(restarted.base_url + "/healthz")[1]
        assert restarted_health["paged_decode_launches"] > 0 or dev.type != "cuda"
        kill = {"victim": victim, "rerouted_tokens": len(rerouted),
                "gateway_retries": retries - retries0, "restart_s": restart_s,
                "restarted_stream_equals_direct": again == direct[0],
                "rerouted_stream_equals_direct": rerouted == direct[0]}
        for tokens in (rerouted, again):
            if tokens != direct[0]:
                mismatched.append(("kill", tokens))
        line.update({
            "replica_starts": {}, "burst_s": burst_s, "tokens_received": received,
            "paged_decode_launches": sum(launches.values()),
            "federated_tokens": fed_tokens, "per_replica": per_replica,
            "context_home": {str(k): v for k, v in home.items()},
            "router_counters": router_counters, "kill_restart": kill,
            "streams_equal_direct": not mismatched,
        })
    finally:
        if collector is not None:
            collector.stop()
        if gw is not None:
            gw.stop()
        fleet.stop()
    for replica in stopped + fleet.handles():
        line["replica_starts"].setdefault(f"{replica.name}:{replica.pid}", start_seconds(replica))

    # the SLO gate on a third, short-lived replica
    slo_fleet = ReplicaFleet(spec=replica_spec(ckpt_dir, model, **SLO_GATE_ENV), replicas=1,
                             name_prefix="slo", poll_interval=1.0)
    try:
        t0 = time.monotonic()
        slo_fleet.start()
        slo_start_s = time.monotonic() - t0
        url = next(iter(slo_fleet.targets().values()))
        code, ready = get_json(url + "/readyz")
        assert code == 200, ready  # no data is not a breach
        deadline = time.monotonic() + 30
        while not get_json(url + "/readyz")[1]["slo"].get("evaluated_at"):
            assert time.monotonic() < deadline, "the SLO evaluator never ran"
            time.sleep(0.1)
        time.sleep(0.3)  # an observation before the first evaluation is its baseline
        stream_generate(url, traffic[1][1][:64], 4)
        t0 = time.monotonic()
        while True:
            code, ready = get_json(url + "/readyz")
            if code == 503 and any(s["name"] == "ttft_p99" and s["status"] == "breach"
                                   for s in ready["slo"]["slos"]):
                break
            assert time.monotonic() - t0 < 30, ("readyz never flipped", code, ready)
            time.sleep(0.1)
        flipped_s = time.monotonic() - t0
        assert get_json(url + "/healthz")[0] == 200
        while get_json(url + "/readyz")[0] != 200:
            assert time.monotonic() - t0 < 60, "readyz never came back"
            time.sleep(0.2)
        line["slo_gate"] = {"start_s": slo_start_s, "flipped_after_s": flipped_s,
                            "recovered_after_s": time.monotonic() - t0, **SLO_GATE_ENV}
    finally:
        slo_fleet.stop()
    for replica in slo_fleet.handles():
        line["replica_starts"][f"{replica.name}:{replica.pid}"] = start_seconds(replica)

    # where a gateway stream and the direct one part, both tokens must be
    # near ties of an eager forward over the restored params
    ties = []
    if mismatched:
        params, _ = load_serving_params(ckpt_dir, cfg, device=dev)
        for item in mismatched:
            i, tokens = (0, item[1]) if isinstance(item, tuple) else (item, got[item])
            ties.append(near_tie(params, traffic[i][1], direct[i], tokens, tie_bound, cfg))
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    line.update({"near_ties": ties, "near_tie_bound": tie_bound})
    return line


# -- the serving chaos harness on the card ---------------------------------------
# Three scenarios of scripts/chaos_serving_check_torch.py (the reference's
# traffic, the port's loadgen) on two Llama-2-7B replicas sharing the
# card, started once: each prompt id mapped into the vocabulary, every
# stream held to the stream one replica alone serves for its prompt.
# Timeouts are the reference scenarios' (request, hang; seconds)
CHAOS = {
    "kill_mid_stream": {
        "trace": {"seed": 11, "kind": "poisson", "duration_s": 3.0, "rate_rps": 15,
                  "max_new_tokens": (24, 48)},
        "request_timeout_s": 10.0, "hang_timeout_s": 25.0, "max_attempts": 2},
    "router_kill_prefix_hot": {
        "waves": (21, 22, 23),
        "trace": {"kind": "chat", "duration_s": 2.0, "rate_rps": 10, "turns": (2, 3),
                  "max_new_tokens": (16, 24), "prompt_len": (64, 192)},
        "block_size": 64, "request_timeout_s": 10.0, "hang_timeout_s": 25.0,
        "max_attempts": 4},
    "disagg_kill_prefill": {
        "trace": {"seed": 31, "kind": "rag", "duration_s": 2.5, "rate_rps": 10,
                  "rag_contexts": 4, "rag_context_len": (512, 1024), "rag_long_fraction": 0.5,
                  "max_new_tokens": (12, 24)},
        "pool": "replica-1", "disagg_threshold_tokens": 32, "block_size": 64,
        "request_timeout_s": 15.0, "hang_timeout_s": 30.0, "max_attempts": 4},
    "in_flight": 8,
}
# the two changes to the reference scenarios' traffic
CHAOS_CHANGED = [
    {"scenario": "router-kill-prefix-hot", "field": "prompt_len", "reference": [4, 32],
     "here": [64, 192],
     "reason": "each session's first turn fills at least one 64-token block of the engine, "
               "so the router's shadow index (at the engine's block size) sees the prefix"},
    {"scenario": "disagg-kill-prefill", "field": "rag_context_len", "reference": [96, 128],
     "here": [512, 1024],
     "reason": "each context is 8-16 blocks of 64, so a chain migration is in flight long "
               "enough to be killed; 96-128 tokens are one or two blocks at this block size"},
]
# the replicas' host KV tier: a kv_source pull lands in it
CHAOS_ENV = {"DEVSPACE_KV_TIER": "host"}
# the chaos gateways' bounds on a replica's silence: the engine's server
# sends a stream's headers once the engine has queued the request, and
# answers a phase-1 prefill of the scenarios' longest prompt in well under
# a second; a replica silent past them is taken for dead, and the gateway
# reroutes the stream or degrades the placement to unified
CHAOS_GATEWAY_TIMEOUTS = {"header_timeout_s": 3.0, "prefill_timeout_s": 5.0}
# the replica that serves each scenario's expected streams alone: the
# one (a) does not kill, and (c)'s prefill pool, whose cache dies with it
CHAOS_DIRECT = "replica-1"
# (c)'s live migration before its kill: one fresh prompt of ten 64-token
# blocks (drawn from this seed), 16 new tokens
CHAOS_LIVE_SEED = 15
CHAOS_LIVE_TOKENS = 640
CHAOS_LIVE_NEW = 16


def in_vocab(trace: list, vocab: int) -> list:
    """``trace`` with every prompt id mapped into ``[1, vocab)`` by
    ``1 + (id - 1) % (vocab - 1)``: the loadgen draws ids from [1, 50000)
    and the engine refuses ids outside its vocabulary. One map for every
    event, so chat turns and RAG queries still share their prefixes."""
    return [{**e, "prompt_ids": [1 + (t - 1) % (vocab - 1) for t in e["prompt_ids"]]}
            for e in trace]


def request_key(event: dict) -> tuple:
    return tuple(event["prompt_ids"]), event["max_new_tokens"]


def expected_streams(url: str, trace: list, workers: int) -> dict:
    """{request_key: greedy stream} for each distinct request of
    ``trace``, served by the replica at ``url`` alone."""
    keys = sorted({request_key(e) for e in trace})
    streams = run_concurrent(lambda k: stream_generate(url, list(k[0]), k[1]), keys, workers)
    return dict(zip(keys, streams))


def wait_restarted(fleet, name: str, old_pid: int, t_kill: float) -> float:
    """Seconds from ``t_kill`` until ``name`` runs as a new process and the
    whole fleet is healthy again; raises past the fleet's ready timeout."""
    while time.monotonic() - t_kill < FLEET["ready_timeout_s"]:
        cur = fleet.replica(name)
        if cur is not None and cur.pid != old_pid and fleet.all_healthy():
            return time.monotonic() - t_kill
        time.sleep(0.5)
    raise AssertionError(f"{name} not restarted within {FLEET['ready_timeout_s']} s")


def wait_until(cond, timeout_s: float, what: str, interval: float = 0.02) -> None:
    deadline = time.monotonic() + timeout_s
    while not cond():
        assert time.monotonic() < deadline, f"timed out after {timeout_s} s waiting for {what}"
        time.sleep(interval)


class ReplicaWatch:
    """Each replica process's ``/healthz`` when it was first seen ready and
    when it was last read (a killed one: just before its kill)."""

    def __init__(self, fleet):
        self.fleet = fleet
        self.rows: dict = {}

    def key(self, name: str) -> str:
        return f"{name}:{self.fleet.replica(name).pid}"

    def read(self, name: str) -> dict:
        replica = self.fleet.replica(name)
        health = get_json(replica.base_url + "/healthz")[1]
        row = self.rows.setdefault(self.key(name), {"ready": health, "killed": False,
                                                    "replica": replica})
        row["last"] = health
        return health

    def seen(self) -> None:
        """Register every replica not yet seen (after a start or restart)."""
        for name in self.fleet.names():
            if self.key(name) not in self.rows:
                self.read(name)

    def kill(self, name: str, log: Optional["AttemptLog"] = None) -> int:
        """Read ``name`` once more, SIGKILL it; returns its pid. A thread
        records the seconds until the process is gone (``dead_after_s``):
        until then its listening socket still accepts connections. With
        ``log``, a ``kill`` row there holds when the kill began, when the
        signal went out and when the process was gone."""
        mark = log.add({"side": "kill", "start_s": log.now(), "victim": name}) if log else {}
        self.read(name)
        old = self.fleet.replica(name)
        row = self.rows[self.key(name)]
        row["killed"] = True
        t0 = time.monotonic()
        self.fleet.kill(name)
        if log:
            mark["signalled_s"] = log.now()

        def reaped():
            old.proc.wait()
            row["dead_after_s"] = time.monotonic() - t0
            if log:
                mark["dead_s"] = log.now()

        threading.Thread(target=reaped, daemon=True).start()
        return old.pid

    def tokens(self, *names: str) -> int:
        """The tokens these replicas have generated, read now."""
        return sum(self.read(name)["tokens_generated"] for name in names)

    def summary(self, dev) -> tuple[dict, int]:
        """Per process: captures at ready and last, launches and tokens
        between; none captured a graph after prewarm, and each that served
        and was not killed ran the kernel (on the card: a killed one may
        have been read at its first token, which prefill makes). Returns
        (rows, launches)."""
        out, launches = {}, 0
        for key, row in self.rows.items():
            first, last = row["ready"], row["last"]
            n = last["paged_decode_launches"] - first["paged_decode_launches"]
            tokens = last["tokens_generated"] - first["tokens_generated"]
            assert last["graph_captures"] == first["graph_captures"] > 0, (key, first, last)
            assert n > 0 or not tokens or row["killed"] or dev.type != "cuda", (key, last)
            out[key] = {"graph_captures_ready": first["graph_captures"],
                        "graph_captures_last": last["graph_captures"],
                        "paged_decode_launches": n, "tokens": tokens, "served": tokens > 0,
                        "killed": row["killed"], "dead_after_s": row.get("dead_after_s"),
                        "output_bytes": row["replica"].output_bytes}
            launches += n
        return out, launches


class AttemptLog:
    """Every attempt of a scenario's requests, at the client and at the
    gateway, and the kill, in seconds from the log's start: a hung or
    failed outcome's report carries its own attempts."""

    def __init__(self):
        self.lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        """Start over (a new wave: its ids repeat the last one's)."""
        with self.lock:
            self.t0 = time.monotonic()
            self.rows: list = []

    def now(self) -> float:
        return time.monotonic() - self.t0

    def add(self, row: dict) -> dict:
        with self.lock:
            self.rows.append(row)
        return row

    def timed(self, side: str, key, fn, *args):
        """``fn(*args)``, logged as one attempt under ``key``."""
        row = self.add({"side": side, "key": key, "start_s": self.now()})
        try:
            return fn(*args)
        except BaseException as e:
            row["error"] = repr(e)[:160]
            raise
        finally:
            row["end_s"] = self.now()

    def of(self, event: dict) -> list:
        keys = (event["id"], prompt_key(event["prompt_ids"]))
        with self.lock:
            return [r for r in self.rows if r.get("key") in keys or r["side"] == "kill"]


def prompt_key(prompt: list) -> str:
    return hashlib.blake2b(json.dumps(prompt).encode(), digest_size=8).hexdigest()


def timed_loadgen(log: AttemptLog, *args, **kw):
    """A ``LoadGenerator`` whose stream attempts ``log`` records."""
    from devspace_tpu_torch.serving import LoadGenerator

    class Timed(LoadGenerator):
        def _stream_once(self, url, event, deadline):
            return log.timed("client", event["id"], super()._stream_once, url, event, deadline)

    return Timed(*args, **kw)


def timed_gateway(log: AttemptLog, router):
    """A started ``RoutingGateway`` whose upstream opens and phase-1
    prefills ``log`` records."""
    from devspace_tpu_torch.serving.gateway import RoutingGateway

    class Timed(RoutingGateway):
        def _open_upstream(self, url, body, headers):
            key = prompt_key(json.loads(body)["prompt_ids"])
            return log.timed(f"gateway {url}", key, super()._open_upstream, url, body, headers)

        def _phase1_prefill(self, decision, body, headers):
            row = log.add({"side": f"prefill {decision.prefill_replica}",
                           "key": prompt_key(json.loads(body)["prompt_ids"]),
                           "start_s": log.now()})
            try:
                kv_source = super()._phase1_prefill(decision, body, headers)
            finally:
                row["end_s"] = log.now()
            row["ok"] = kv_source is not None
            return kv_source

    gw = Timed(router, port=0, **CHAOS_GATEWAY_TIMEOUTS)
    gw.start()
    return gw


def engine_rows(fleet, event: dict) -> dict:
    """Each live replica's request traces of ``event``'s shape (prompt
    length, new tokens), from its ``/debug/requests``."""
    out = {}
    for name, url in fleet.targets().items():
        try:
            rows = get_json(url + "/debug/requests?limit=400", timeout=10)[1]["requests"]
        except (OSError, KeyError, ValueError) as e:
            out[name] = repr(e)[:160]
            continue
        out[name] = [{k: r[k] for k in ("outcome", "queue_wait_s", "ttft_s", "events")}
                     for r in rows if r["prompt_len"] == len(event["prompt_ids"])
                     and r["max_new_tokens"] == event["max_new_tokens"]]
    return out


def run_while(gen, trace: list, action) -> tuple:
    """Replay ``trace`` through ``gen`` in a thread, run ``action()`` (the
    kill) meanwhile; (report, action's result)."""
    box = {}
    th = threading.Thread(target=lambda: box.__setitem__("report", gen.run(trace)),
                          daemon=True)
    th.start()
    try:
        result = action()
    finally:
        th.join(timeout=gen.hang_timeout_s + gen.request_timeout_s + 60)
    assert not th.is_alive(), "the loadgen did not finish"
    return box["report"], result


def held(scenario: str, report, trace: list, table: dict, corrupted: list,
         log: AttemptLog, fleet) -> dict:
    """The loadgen's report on ``trace``, with the failed and hung
    outcomes' errors, arrival, attempts (``log``) and engine traces:
    every request terminal, none hung; the corrupted ones kept for the
    near-tie check."""
    counts = report.counts()
    by_id = {e["id"]: e for e in trace}
    others = [{"id": o.id, "outcome": o.outcome, "attempts": o.attempts,
               "latency_s": o.latency_s, "error": o.error[:160], "at_s": by_id[o.id]["at"],
               "log": log.of(by_id[o.id]), "engine": engine_rows(fleet, by_id[o.id])}
              for o in report.outcomes if o.outcome in ("failed", "hung")]
    assert len(report.outcomes) == len(trace), (scenario, len(report.outcomes), len(trace))
    assert counts["hung"] == 0, (scenario, counts, json.dumps(others))
    for o in report.outcomes:
        if o.outcome == "corrupted":
            e = by_id[o.id]
            corrupted.append({"scenario": scenario, "id": o.id, "prompt": e["prompt_ids"],
                              "expected": table[request_key(e)],
                              "received": o.received, "error": o.error})
    return {**report.to_dict(), "failed_or_hung": others}


def router_counters(router) -> dict:
    return {name: fam["samples"][0][1] if len(fam["samples"]) == 1
            else [[lb, v] for lb, v in fam["samples"]]
            for name, fam in router.registry.snapshot().items()
            if name.startswith("serving_router_") and fam["kind"] == "counter"}


def chaos_kill_mid_stream(fleet, watch, cfg, corrupted: list) -> dict:
    """(a) Poisson traffic straight to the replicas; replica-0 is
    SIGKILLed once a stream from it has delivered a token."""
    from devspace_tpu_torch.serving import TraceSpec, generate_trace

    sc = CHAOS["kill_mid_stream"]
    trace = in_vocab(generate_trace(TraceSpec(**sc["trace"])), cfg.vocab_size)
    table = expected_streams(fleet.targets()[CHAOS_DIRECT], trace, CHAOS["in_flight"])
    log = AttemptLog()
    gen = timed_loadgen(log, fleet.targets, request_timeout_s=sc["request_timeout_s"],
                        hang_timeout_s=sc["hang_timeout_s"], max_attempts=sc["max_attempts"],
                        expected_fn=lambda e: table[request_key(e)])
    victim = fleet.names()[0]
    base = watch.tokens(victim)

    def kill():
        wait_until(lambda: watch.tokens(victim) > base, 60,
                   f"a token from {victim}")
        t = time.monotonic()
        return watch.kill(victim, log), t

    log.reset()
    report, (old_pid, t_kill) = run_while(gen, trace, kill)
    out = held("kill-mid-stream", report, trace, table, corrupted, log, fleet)
    healthy_s = wait_restarted(fleet, victim, old_pid, t_kill)
    watch.seen()
    assert out["counts"]["retried"] >= 1, ("no stream was cut", out)
    return {"trace": sc["trace"], "requests": len(trace), "distinct": len(table),
            "report": out, "victim": victim, "all_healthy_after_s": healthy_s,
            "timeouts_s": [sc["request_timeout_s"], sc["hang_timeout_s"]],
            "max_attempts": sc["max_attempts"]}


def chaos_router_kill_prefix_hot(fleet, watch, cfg, corrupted: list) -> dict:
    """(b) Three chat waves through the gateway; the replica holding the
    most shadow blocks is SIGKILLed while wave 22 streams; wave 23's p99
    TTFT must come back within the reference's bound of wave 21's."""
    from devspace_tpu_torch.serving import TraceSpec, generate_trace
    from devspace_tpu_torch.serving.router import PrefixRouter, RouterConfig

    sc = CHAOS["router_kill_prefix_hot"]
    router = PrefixRouter(replicas_fn=fleet.targets,
                          config=RouterConfig(admission=False, block_size=sc["block_size"]))
    log = AttemptLog()
    gw = timed_gateway(log, router)
    waves, reports = {}, {}
    try:
        for seed in sc["waves"]:
            trace = in_vocab(generate_trace(TraceSpec(seed=seed, **sc["trace"])),
                             cfg.vocab_size)
            table = expected_streams(fleet.targets()[CHAOS_DIRECT], trace, CHAOS["in_flight"])
            gen = timed_loadgen(
                log, lambda: {"gw": gw.base_url}, request_timeout_s=sc["request_timeout_s"],
                hang_timeout_s=sc["hang_timeout_s"], max_attempts=sc["max_attempts"],
                expected_fn=lambda e, t=table: t[request_key(e)])
            row = {"requests": len(trace), "distinct": len(table)}
            log.reset()
            if seed == sc["waves"][1]:
                names = fleet.names()
                base = watch.tokens(*names)

                def kill():
                    wait_until(lambda: watch.tokens(*names) > base, 60, "wave 22's first token")
                    blocks = router.stats()["shadow_blocks"]
                    hot = max(sorted(blocks), key=lambda n: blocks[n])
                    t = time.monotonic()
                    return hot, blocks, watch.kill(hot, log), t

                report, (hot, blocks, old_pid, t_kill) = run_while(gen, trace, kill)
                row["report"] = held(f"router-kill-prefix-hot/{seed}", report, trace, table,
                                     corrupted, log, fleet)
                row["all_healthy_after_s"] = wait_restarted(fleet, hot, old_pid, t_kill)
                row.update(victim=hot, shadow_blocks=blocks)
                watch.seen()
            else:
                report = gen.run(trace)
                row["report"] = held(f"router-kill-prefix-hot/{seed}", report, trace, table,
                                     corrupted, log, fleet)
            reports[seed] = report
            waves[str(seed)] = row
        p99_healthy = reports[sc["waves"][0]].ttft_quantile(0.99)
        p99_after = reports[sc["waves"][2]].ttft_quantile(0.99)
        bound = max(2.5 * p99_healthy, p99_healthy + 0.25)
        assert p99_after <= bound, ("p99 TTFT did not re-converge", p99_after, p99_healthy,
                                    bound)
        return {"trace": {**sc["trace"], "seeds": list(sc["waves"])}, "waves": waves,
                "p99_ttft_healthy_s": p99_healthy, "p99_ttft_recovered_s": p99_after,
                "p99_ttft_bound_s": bound, "router_retries":
                sample_value(router.registry.snapshot(), "serving_router_retries_total"),
                "router_counters": router_counters(router),
                "timeouts_s": [sc["request_timeout_s"], sc["hang_timeout_s"]],
                "max_attempts": sc["max_attempts"], "block_size": sc["block_size"]}
    finally:
        gw.stop()


def disagg_live_migration(fleet, watch, cfg, config, corrupted: list) -> dict:
    """One fresh prompt of CHAOS_LIVE_TOKENS through a gateway with
    two-phase placement, before any kill: it prefills on the pool, the
    other replica pulls its KVM1 chain and decodes, and the stream equals
    the one the pool serves for it directly (or parts at a near tie)."""
    from devspace_tpu_torch.serving.gateway import RoutingGateway
    from devspace_tpu_torch.serving.router import PrefixRouter

    pool = config.prefill_pool[0]
    prompt = np.random.default_rng(CHAOS_LIVE_SEED).integers(1, cfg.vocab_size, CHAOS_LIVE_TOKENS).tolist()
    before = {n: watch.read(n) for n in fleet.names()}
    router = PrefixRouter(replicas_fn=fleet.targets, config=config)
    gw = RoutingGateway(router, port=0, **CHAOS_GATEWAY_TIMEOUTS)
    gw.start()
    try:
        got = stream_generate(gw.base_url, prompt, CHAOS_LIVE_NEW)
        d = router.stats()["recent_decisions"][-1]
    finally:
        gw.stop()
    after = {n: watch.read(n) for n in fleet.names()}
    decode = d["replica"]
    delta = {f: after[decode][f] - before[decode][f]
             for f in ("kv_migrate_chains", "kv_migrate_blocks", "kv_migrate_bytes",
                       "kv_migrate_failures")}
    exported = after[pool]["kv_export_chains"] - before[pool]["kv_export_chains"]
    assert d["prefill_replica"] == pool and decode != pool, d
    assert delta["kv_migrate_chains"] >= 1 and delta["kv_migrate_bytes"] > 0, delta
    assert delta["kv_migrate_failures"] == 0 and exported >= 1, (delta, exported)
    direct = stream_generate(fleet.targets()[pool], prompt, CHAOS_LIVE_NEW)
    if got != direct:
        corrupted.append({"scenario": "disagg-live", "id": 0, "prompt": prompt,
                          "expected": direct, "received": got, "error": "gateway stream"})
    return {"prompt_tokens": len(prompt), "new_tokens": len(got), "decode_replica": decode,
            "prefill_replica": pool, **delta, "export_chains": exported,
            "stream_equals_direct": got == direct}


def chaos_disagg_kill_prefill(fleet, watch, cfg, corrupted: list) -> dict:
    """(c) Short chat and long RAG prompts through the gateway with
    two-phase placement, ``replica-1`` the prefill pool; the pool is
    SIGKILLed at the first two-phase placement. No request may fail, and
    every failed migration counts one recompute fallback."""
    from devspace_tpu_torch.serving import TraceSpec, generate_trace
    from devspace_tpu_torch.serving.router import PrefixRouter, RouterConfig

    sc = CHAOS["disagg_kill_prefill"]
    pool = sc["pool"]
    config = RouterConfig(admission=False, prefill_pool=(pool,), block_size=sc["block_size"],
                          disagg_threshold_tokens=sc["disagg_threshold_tokens"])
    live = disagg_live_migration(fleet, watch, cfg, config, corrupted)
    trace = in_vocab(generate_trace(TraceSpec(**sc["trace"])), cfg.vocab_size)
    table = expected_streams(fleet.targets()[CHAOS_DIRECT], trace, CHAOS["in_flight"])
    start = {watch.key(n): watch.read(n) for n in fleet.names()}
    router = PrefixRouter(replicas_fn=fleet.targets, config=config)
    log = AttemptLog()
    gw = timed_gateway(log, router)
    try:
        gen = timed_loadgen(
            log, lambda: {"gw": gw.base_url}, request_timeout_s=sc["request_timeout_s"],
            hang_timeout_s=sc["hang_timeout_s"], max_attempts=sc["max_attempts"],
            expected_fn=lambda e: table[request_key(e)])

        def kill():
            wait_until(lambda: any(d.get("prefill_replica")
                                   for d in router.stats()["recent_decisions"]),
                       60, "the first two-phase placement", interval=0.01)
            t = time.monotonic()
            return watch.kill(pool, log), t

        log.reset()
        report, (old_pid, t_kill) = run_while(gen, trace, kill)
        out = held("disagg-kill-prefill", report, trace, table, corrupted, log, fleet)
        assert out["counts"]["failed"] == 0, out
        snap = router.registry.snapshot()
        dispatches = sample_value(snap, "serving_router_prefill_dispatches_total")
        assert dispatches >= 1, "no two-phase placement fired"
        wait_until(lambda: router.stats()["prefill_tokens"] == {}, 20,
                   "the router's in-flight prefill accounting to drain", interval=0.05)
        healthy_s = wait_restarted(fleet, pool, old_pid, t_kill)
        watch.seen()
        # over the live fleet, since the scenario began: a process that
        # started since counts from zero
        failures = fallbacks = 0
        for name in fleet.names():
            now, before = watch.read(name), start.get(watch.key(name))
            failures += now["kv_migrate_failures"] - (before or {}).get("kv_migrate_failures", 0)
            fallbacks += now["kv_restore_fallbacks"] - (before or {}).get(
                "kv_restore_fallbacks", 0)
        assert failures == fallbacks, ("a failed migration was not degraded cleanly",
                                       failures, fallbacks)
        return {"live_migration": live, "trace": sc["trace"], "requests": len(trace),
                "distinct": len(table), "report": out, "victim": pool,
                "all_healthy_after_s": healthy_s,
                "prefill_dispatches": dispatches,
                "phase1_failures": sample_value(snap, "serving_router_prefill_failures_total"),
                "migrate_failures": failures, "recompute_fallbacks": fallbacks,
                "router_retries": sample_value(snap, "serving_router_retries_total"),
                "router_counters": router_counters(router),
                "disagg_threshold_tokens": sc["disagg_threshold_tokens"],
                "block_size": sc["block_size"],
                "timeouts_s": [sc["request_timeout_s"], sc["hang_timeout_s"]],
                "max_attempts": sc["max_attempts"]}
    finally:
        gw.stop()


def phase_chaos(ckpt_dir: str, card: str, tie_bound: float, dev, model: str = "llama2-7b",
                cfg=tfm.LLAMA2_7B) -> dict:
    """Three of the serving chaos scenarios (scripts/chaos_serving_check_torch.py)
    on two Llama-2-7B torch replicas of the checkpoint sharing the card
    (bf16, ``PREWARM=1``, 8 slots, the host KV tier), started once:
    (a) kill-mid-stream, (b) router-kill-prefix-hot, (c)
    disagg-kill-prefill, each with the reference's traffic through the
    port's ``LoadGenerator``, a SIGKILL of a replica while streams flow
    and a restart within the fleet's ready timeout. Every request ends
    terminal, none hung; a ``corrupted`` one must have left its expected
    stream at a near tie (``near_tie`` over the restored params, after
    the fleet stops), each token it delivered the argmax of an eager
    forward or a near tie there (``argmax_ties``), or the phase fails."""
    from devspace_tpu_torch.serving import ReplicaFleet

    line = {"phase": "chaos", "model": model, "card": card, "replicas": 2,
            "max_slots": FLEET["max_slots"], "env": {**FLEET_SLO_ENV, **CHAOS_ENV},
            "ready_timeout_s": FLEET["ready_timeout_s"], "in_flight": CHAOS["in_flight"],
            "changed": CHAOS_CHANGED, "prompt_ids": "1 + (id - 1) % (vocab - 1)",
            "sampled": "ignored by the server: every stream is greedy",
            "expected": "each distinct (prompt, max_new_tokens) served by one replica alone, "
                        f"{CHAOS['in_flight']} in flight, before its scenario (wave)",
            "note": "a killed replica's counts die with it: its row is its last /healthz "
                    "before the kill"}
    fleet = ReplicaFleet(spec=replica_spec(ckpt_dir, model, **FLEET_SLO_ENV, **CHAOS_ENV),
                         replicas=2, poll_interval=1.0)
    watch = ReplicaWatch(fleet)
    corrupted = []
    t0 = time.monotonic()
    try:
        fleet.start()
        line["fleet_start_s"] = time.monotonic() - t0
        watch.seen()
        for key, run in (("kill_mid_stream", chaos_kill_mid_stream),
                         ("router_kill_prefix_hot", chaos_router_kill_prefix_hot),
                         ("disagg_kill_prefill", chaos_disagg_kill_prefill)):
            t = time.monotonic()
            line[key] = run(fleet, watch, cfg, corrupted)
            line[key]["seconds"] = time.monotonic() - t
        for name in fleet.names():
            watch.read(name)
        line["replicas_seen"], line["paged_decode_launches"] = watch.summary(dev)
    finally:
        fleet.stop()
    # a corrupted stream must have left its expected one at a near tie,
    # and every token it delivered must be the argmax of an eager forward
    # over its own prefix or a near tie there
    ties = []
    if corrupted:
        params, _ = load_serving_params(ckpt_dir, cfg, device=dev)
        for c in corrupted:
            a, b = c["expected"], c["received"]
            assert any(x != y for x, y in zip(a, b)), ("corrupted, not at a near tie", c)
            ties.append({"scenario": c["scenario"], "id": c["id"],
                         **near_tie(params, c["prompt"], a, b, tie_bound, cfg),
                         "received": len(b), "received_near_ties":
                         len(argmax_ties(params, cfg, c["prompt"], b, tie_bound))})
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    line.update({"near_ties": ties, "near_tie_count": len(ties), "near_tie_bound": tie_bound,
                 "seconds": time.monotonic() - t0})
    return line

# -- parallel/ over torch.distributed ------------------------------------------
# examples/long-context/train.py's widths; its sequence of 32768 tokens is
# cut to the 4096 one rank of its 8-ring holds
LONG_CTX = tfm.TransformerConfig(vocab_size=32000, dim=2048, n_layers=16, n_heads=16,
                                 n_kv_heads=8, ffn_dim=5504, max_seq_len=32768)
PARALLEL = {"steps": 3, "long_seq": 4096, "ring_shape": (1, 4096, 16, 128), "ring_block": 512,
            "moe_batch": 2, "moe_seq": 2048}
# the mesh steps against the steps without a mesh: the same operations
# on the same values at one rank, so equal up to the loss's reduction order
PARALLEL_REL = 1e-3
def _stderr_to_file(tmp: str, rank: int) -> None:
    """Send this process's stderr to ``tmp``: an abort leaves no other trace."""
    os.dup2(os.open(os.path.join(tmp, f"stderr-{rank}"), os.O_WRONLY | os.O_CREAT | os.O_TRUNC),
            2)


def _run_pair(target, args: tuple, timeout: float) -> dict:
    """``target(rank, tmp, *args, results)`` in two spawned processes ->
    each rank's reported outcome; a rank that died reports its exit code
    and the end of its stderr."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="pair-") as tmp:
        results = ctx.Queue()
        procs = [ctx.Process(target=target, args=(r, tmp, *args, results)) for r in range(2)]
        for p in procs:
            p.start()
        got: dict = {}
        deadline = time.monotonic() + timeout
        while len(got) < 2 and time.monotonic() < deadline:
            try:
                rank, outcome = results.get(timeout=1.0)
                got[rank] = outcome
            except queue.Empty:
                if all(not p.is_alive() for p in procs):
                    break
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        for r, p in enumerate(procs):
            if r not in got:
                path = os.path.join(tmp, f"stderr-{r}")
                text = Path(path).read_text(errors="replace") if os.path.exists(path) else ""
                tail = [ln for ln in text.splitlines() if ln.strip()][-4:]
                got[r] = f"died (exit code {p.exitcode}): " + " | ".join(tail)[-800:]
    return {str(r): got[r] for r in range(2)}


def rel_update_err(before: dict, after_a: dict, after_b: dict) -> float:
    """Largest difference of two updates of the same params, per leaf over
    the first update's largest change."""
    worst = 0.0
    for p0, a, b in zip(ttrainer.param_leaves(before), ttrainer.param_leaves(after_a),
                        ttrainer.param_leaves(after_b)):
        da, db = a.detach().float() - p0.float(), b.detach().float() - p0.float()
        worst = max(worst, ((db - da).abs().max() / da.abs().max().clamp_min(1e-30)).item())  # lint: allow(JIT502) — one error a leaf, after the steps
    return worst


def rel_loss_err(a: list, b: list) -> float:
    return max(abs(x - y) / abs(x) for x, y in zip(a, b))


def _lm_runs(cfg, dev, base, batches, mesh) -> dict:
    """The bench LM's steps without a mesh, through the mesh step
    (``{"data": 1, "model": 1}``, the TP spec) and through FSDP, each from
    ``base``: losses, ms per step after the first, the params after, each
    mesh run's flash and loss launches, and the peak memory of its steps
    above what was allocated before the run was built (its params,
    grads, moments, activations and, for FSDP, gathered weights); for
    FSDP also the largest number of gathered bytes alive at once, and its
    step and train state for the elastic part."""
    opt = ttrainer.adamw(TRAIN_LR)
    spec = tfm.param_partition_spec(cfg)
    runs = {}
    for name in ("plain", "mesh", "fsdp"):
        sync(dev)
        before = torch.cuda.memory_allocated()
        params = trainable(base, dev)
        reset_train_counts()
        if name == "fsdp":
            fstep, shards, fopt = pfsdp.make_fsdp_train_step(
                ttrainer.lm_loss(tfm.forward, cfg), opt, mesh, params)
            del params
            state = {"params": shards, "opt_state": fopt}

            def step(state, batch):
                shards, fopt, loss = fstep(state["params"], state["opt_state"], batch)
                return {"params": shards, "opt_state": fopt}, loss
        else:
            if name == "mesh":
                params = pmesh.shard_tree(params, spec, mesh)
                step = ttrainer.make_lm_train_step(tfm.forward, cfg, opt, mesh=mesh,
                                                   param_spec=spec)
            else:
                step = ttrainer.make_lm_train_step(tfm.forward, cfg, opt)
            state = ttrainer.init_train_state(params, opt)
        rows = [shard_batch(b, mesh) for b in batches] if name != "plain" else batches
        sync(dev)
        torch.cuda.reset_peak_memory_stats()
        state, losses, step_ms, _ = timed_steps(step, state, rows, 1)
        runs[name] = {"losses": scalar_losses(losses), "step_ms": step_ms,
                      "launches": train_counts(), "params": state["params"],
                      "peak_gb": (torch.cuda.max_memory_allocated() - before) / 1e9}
        if name == "fsdp":  # gathered back at one rank: the shards are the leaves
            f_spec = pfsdp.fsdp_spec(base, mesh)
            runs[name]["params"] = pmesh.gather_tree(state["params"], f_spec, mesh)
            runs[name]["gathered_peak_gb"] = fstep.stats["gathered_peak_bytes"] / 1e9
            runs[name]["state"] = {"step": fstep, "state": state, "spec": f_spec,
                                   "batch": rows[-1], "mesh": mesh}
        del state
    return runs


def fsdp_gathered_bound(params, mesh) -> int:
    """Bytes of the LM head plus one layer's gathered (FSDP-sharded)
    leaves: what the layer-by-layer FSDP step may hold gathered at once."""
    spec = pfsdp.fsdp_spec(params, mesh)

    def gathered(tree, specs):
        return sum(x.numel() * x.element_size()
                   for x, s in zip(pmesh.tree_leaves(tree), pmesh.spec_leaves(specs, tree))
                   if pmesh.spec_axes(s))

    return (gathered(params["lm_head"], spec["lm_head"])
            + gathered(params["layers"][0], spec["layers"][0]))


def parallel_lm(dev) -> dict:
    """(a) the bench LM at 8 x 2048 through ``make_lm_train_step(mesh=
    {"data": 1, "model": 1}, param_spec=param_partition_spec(cfg))`` and
    (b) through ``make_fsdp_train_step``, 3 AdamW steps each, against the
    step without a mesh on the same params and tokens. FSDP gathers one
    layer at a time: its peak memory exceeds the mesh step's by no more
    than the LM head plus one layer's gathered leaves, and so does what
    it holds gathered at once. The FSDP run's state goes on to the
    elastic part (``fsdp_state``)."""
    cfg = BENCH_LM
    mesh = pmesh.create_mesh({"data": 1, "model": 1}, dev)
    base = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    sample = tdata.markov_sampler(device=dev)
    batches = [sample(TRAIN_BATCH, TRAIN_SEQ + 1, seed=s)
               for s in range(1, PARALLEL["steps"] + 1)]
    runs = _lm_runs(cfg, dev, base, batches, mesh)
    expect = {name: (1 if key is None else cfg.n_layers) * PARALLEL["steps"]
              for name, (key, _, _) in TRAIN_KERNELS.items()}
    out = {}
    for name in ("mesh", "fsdp"):
        r = runs[name]
        assert r["launches"] == expect, (name, r["launches"], expect)
        loss_err = rel_loss_err(runs["plain"]["losses"], r["losses"])
        update_err = rel_update_err(base, runs["plain"]["params"], r["params"])
        assert loss_err <= PARALLEL_REL and update_err <= PARALLEL_REL, (name, loss_err,
                                                                         update_err)
        out[name] = {"losses": r["losses"], "loss_rel_err": loss_err,
                     "update_rel_err": update_err, "launches": r["launches"],
                     "step_ms": statistics.median(r["step_ms"]), "step_ms_each": r["step_ms"],
                     "peak_gb": r["peak_gb"]}
    bound = fsdp_gathered_bound(base, mesh) / 1e9
    fsdp = out["fsdp"]
    fsdp.update({"gathered_peak_gb": runs["fsdp"]["gathered_peak_gb"],
                 "gathered_bound_gb": bound,
                 "peak_gb_over_mesh": fsdp["peak_gb"] - out["mesh"]["peak_gb"]})
    assert 0 < fsdp["gathered_peak_gb"] <= bound, (fsdp["gathered_peak_gb"], bound)
    assert fsdp["peak_gb_over_mesh"] <= bound, (fsdp["peak_gb"], out["mesh"]["peak_gb"], bound)
    out["plain"] = {"losses": runs["plain"]["losses"], "peak_gb": runs["plain"]["peak_gb"],
                    "step_ms": statistics.median(runs["plain"]["step_ms"])}
    out["fsdp_state"] = runs["fsdp"].pop("state")
    del runs["mesh"], runs["fsdp"]
    out["pipeline"] = parallel_pipelines(dev, cfg, base, batches, runs["plain"])
    return out


def parallel_elastic(dev, fsdp: dict) -> dict:
    """(f) elastic restore: the FSDP run's train state after its steps is
    saved from the mesh (``save_checkpoint(mesh=)``) and restored, AdamW
    moments included, onto the mesh step's TP layout
    (``param_partition_spec``) through a train-state
    ``sharded_template``; every moment block equals the saved moment cut
    by its parameter's spec, byte for byte. One mesh step from the
    restored state and one more FSDP step from the state before the save
    give the same loss within PARALLEL_REL."""
    cfg, mesh, state = BENCH_LM, fsdp["mesh"], fsdp["state"]
    tmp = tempfile.mkdtemp(prefix="elastic-")
    path = os.path.join(tmp, f"step_{PARALLEL['steps']:08d}")
    try:
        sync(dev)
        t0 = time.monotonic()
        save_checkpoint(path, {**state, "step": PARALLEL["steps"]}, mesh=mesh,
                        spec_tree=fsdp["spec"])
        save_s = time.monotonic() - t0
        spec = tfm.param_partition_spec(cfg)
        logical = tfm.init_params(cfg, torch.Generator(), device="meta")
        t0 = time.monotonic()
        restored = restore_checkpoint(path, sharded_template(
            {"params": logical, "opt_state": ttrainer.adamw(TRAIN_LR), "step": 0}, mesh, spec))
        sync(dev)
        restore_s = time.monotonic() - t0
        assert restored["step"] == PARALLEL["steps"]
        saved = torch.load(os.path.join(path, tckpt.OPT_FILE), weights_only=True,
                           map_location="cpu")
        pos = {n: i for i, n in enumerate(saved["param_names"])}
        opt = restored["opt_state"]
        specs = tckpt._named_specs(restored["params"], spec)
        held = [p for g in opt.param_groups for p in g["params"]]
        moment_bytes = 0
        for name, p in zip(tckpt.param_names(restored["params"], opt), held, strict=True):
            for key, value in opt.state[p].items():
                want = saved["state"][pos[name]][key]
                if want.dim():
                    want = pmesh.shard_tensor(want, specs[name], mesh)
                want = want.to(value.device)
                assert value.dtype == want.dtype and torch.equal(
                    bits(value.reshape(-1)), bits(want.reshape(-1))), (name, key)
                moment_bytes += value.numel() * value.element_size()
        reset_train_counts()
        mesh_step = ttrainer.make_lm_train_step(tfm.forward, cfg, ttrainer.adamw(TRAIN_LR),
                                                mesh=mesh, param_spec=spec)
        _, loss_tp = mesh_step(restored, fsdp["batch"])
        _, _, loss_fsdp = fsdp["step"](state["params"], state["opt_state"], fsdp["batch"])
        launches = train_counts()
        losses = scalar_losses([loss_tp, loss_fsdp])
        rel = rel_loss_err(losses[1:], losses[:1])
        assert rel <= PARALLEL_REL, (losses, rel)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"saved_from": "fsdp", "restored_onto": "tp", "step": restored["step"],
            "moments_byte_equal": True, "moment_gb": moment_bytes / 1e9,
            "save_s": save_s, "restore_s": restore_s,
            "loss_restored_tp": losses[0], "loss_fsdp": losses[1], "loss_rel_err": rel,
            "launches": launches}


def parallel_long_context(dev) -> dict:
    """(c) the long-context example's step (scripts/train_long_context_torch.py
    ``build``: ring attention over ``seq`` with the batch over ``data``,
    the vocab-parallel loss, remat, AdamW) at its widths on one sequence
    of 4096 tokens: every loss finite."""
    step, state, mesh, batch = long_script.build(LONG_CTX, dev)
    n_params = sum(p.numel() for p in ttrainer.param_leaves(state["params"]))
    tokens = tdata.synthetic_tokens(batch, PARALLEL["long_seq"] + 1, LONG_CTX.vocab_size,
                                    device=dev)
    rows = [shard_batch(next(tokens), mesh) for _ in range(PARALLEL["steps"])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_train_counts()
    state, losses, step_ms, _ = timed_steps(step, state, rows, 1)
    counts = train_counts()
    # ring attention and the vocab-parallel loss are plain torch
    assert counts == dict.fromkeys(TRAIN_KERNELS, 0), counts
    out = {"mesh": mesh.shape, "params_m": n_params / 1e6, "seq": PARALLEL["long_seq"],
           "reduced_from_seq": 32768, "losses": scalar_losses(losses),
           "step_ms": statistics.median(step_ms),
           "tok_per_s": PARALLEL["long_seq"] * 1e3 / statistics.median(step_ms),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del state, step
    return out


def parallel_ring_vs_flash(dev) -> dict:
    """(d) ``ring_attention`` (one rank, eight 512-key sub-blocks, causal)
    and ``ulysses_attention`` against the flash kernel on the same bf16
    ``[1, 4096, 16, 128]`` q/k/v: outputs, and ring's gradients against
    the flash backward's, within 1e-2 of each head's largest value."""
    mesh = pmesh.create_mesh({"seq": 1}, dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v, do = (torch.randn(PARALLEL["ring_shape"], generator=gen, device=dev,
                               dtype=torch.bfloat16) for _ in range(4))
    ring = ring_attention(mesh, "seq", causal=True, block_size=PARALLEL["ring_block"])
    ulysses = ulysses_attention(mesh, "seq", causal=True)

    def run(fn):
        qq, kk, vv = (x.detach().clone().requires_grad_() for x in (q, k, v))
        out = fn(qq, kk, vv)
        out.backward(do)
        return out.detach(), qq.grad, kk.grad, vv.grad

    def heads_first(x):  # [B*H, T, D]: kernel_err's rows are heads
        b, t, h, d = x.shape
        return x.transpose(1, 2).reshape(b * h, t, d)

    flash = run(tfm.default_attention)
    got = {}
    for name, fn in (("ring", ring), ("ulysses", ulysses)):
        res = run(fn)
        parts = ("o", "dq", "dk", "dv") if name == "ring" else ("o",)
        got[name] = {part: kernel_err(heads_first(res[i]), heads_first(flash[i]),
                                      f"{name} {part}")
                     for i, part in enumerate(parts)}
    times = {}
    for name, fn in (("flash", tfm.default_attention), ("ring", ring), ("ulysses", ulysses)):
        times[name] = device_ms(lambda fn=fn: fn(q, k, v), 5, warmup=1)[0]
    return {"shape": list(PARALLEL["ring_shape"]), "block": PARALLEL["ring_block"],
            "errors": got, "forward_ms": times}


def parallel_moe(dev) -> dict:
    """(e) the MoE at MIXTRAL_8X7B's widths, 2 layers, with ``moe_ffn``
    over ``data`` (one rank) as its expert layer: 3 AdamW steps at 2 x
    2049 tokens, ce and aux finite; ``moe_ffn`` against
    ``moe_ffn_reference`` on the same tokens and layer-0 params."""
    cfg = MOE_CFG
    mesh = pmesh.create_mesh({"data": 1}, dev)
    spec = moe.param_partition_spec(cfg, model_axis=None, expert_axis="data")
    params = moe.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    for p in ttrainer.param_leaves(params):
        p.requires_grad_()
    params = pmesh.shard_tree(params, spec, mesh)
    moe_fn = eparallel.moe_ffn(mesh, "data", k=cfg.experts_per_token,
                               capacity_factor=cfg.capacity_factor, activation=eparallel.swiglu)
    opt = ttrainer.adamw(MOE["lr"])
    step = ttrainer.make_moe_lm_train_step(moe.forward, cfg, opt, mesh=mesh, param_spec=spec,
                                           moe_fn=moe_fn)
    batches = list(itertools.islice(tdata.markov_tokens(
        PARALLEL["moe_batch"], PARALLEL["moe_seq"] + 1, seed=0, device=dev), PARALLEL["steps"]))
    reset_train_counts()
    state, metrics, step_ms, _ = timed_steps(
        step, ttrainer.init_train_state(params, opt), [shard_batch(b, mesh) for b in batches], 1)
    counts = train_counts()
    expect = {name: (1 if key is None else cfg.n_layers) * PARALLEL["steps"]
              for name, (key, _, _) in TRAIN_KERNELS.items()}
    assert counts == expect, (counts, expect)
    losses = scalar_losses(metrics)
    aux = [m["aux"].item() for m in metrics]
    assert all(math.isfinite(a) for a in aux), aux
    layer0 = {k: t.detach() for k, t in state["params"]["layers"][0]["moe"].items()}
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((PARALLEL["moe_batch"] * PARALLEL["moe_seq"], cfg.dim), generator=gen,
                    device=dev).to(cfg.dtype)
    with torch.no_grad():
        y, a = moe_fn(x, layer0)
        y_ref, a_ref = eparallel.moe_ffn_reference(
            x, layer0, k=cfg.experts_per_token, capacity_factor=cfg.capacity_factor,
            activation=eparallel.swiglu)
    err = (y.float() - y_ref.float()).abs().max().item()
    bound = 2.0 ** -8 * y_ref.float().abs().max().item()  # one bf16 rounding
    assert err <= bound and abs(a.item() - a_ref.item()) <= 1e-6, (err, bound, a, a_ref)
    del state, params, step, metrics
    return {"model": "mixtral-8x7b widths, 2 layers, bf16", "mesh": mesh.shape,
            "tokens": PARALLEL["moe_batch"] * PARALLEL["moe_seq"], "losses": losses, "aux": aux,
            "step_ms": statistics.median(step_ms), "launches": counts,
            "moe_ffn_max_abs_err": err, "moe_ffn_bound": bound}


def _two_rank_lm(rank: int, tmp: str, device_type: str, cfg, batch: int, seq: int,
                 results) -> None:
    """One of two processes on card 0 (or the CPU, rehearsed) in a gloo
    group: the LM's mesh step at ``{"data": 2, "model": 1}`` from (a)'s
    params and batches, this rank's half of the rows; reports the losses
    (the global means) and its ms per step."""
    import datetime
    import traceback

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    _stderr_to_file(tmp, rank)
    dev = torch.device(device_type, 0) if device_type == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), 2),
                            rank=rank, world_size=2, timeout=datetime.timedelta(seconds=120))
    try:
        # gloo on the card is built here by hand: create_mesh takes NCCL
        mesh = pmesh.Mesh(init_device_mesh(dev.type, (2, 1), mesh_dim_names=("data", "model")),
                          dev)
        spec = tfm.param_partition_spec(cfg)
        base = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
        sample = tdata.markov_sampler(device=dev)
        opt = ttrainer.adamw(TRAIN_LR)
        step = ttrainer.make_lm_train_step(tfm.forward, cfg, opt, mesh=mesh, param_spec=spec)
        state = ttrainer.init_train_state(pmesh.shard_tree(trainable(base, dev), spec, mesh),
                                          opt)
        losses, ms = [], []
        for s in range(1, PARALLEL["steps"] + 1):
            rows = shard_batch(sample(batch, seq + 1, seed=s), mesh)
            t0 = time.perf_counter()
            state, loss = step(state, rows)
            losses.append(loss.item())  # lint: allow(JIT502) — each step's loss is the result, read once a step
            ms.append((time.perf_counter() - t0) * 1e3)
        results.put((rank, {"losses": losses, "step_ms": ms[1:]}))
    except Exception:  # reported to the parent, which fails the phase
        results.put((rank, {"error": traceback.format_exc()[-1500:]}))
    finally:
        dist.destroy_process_group()


def parallel_two_ranks(world1_losses: list, dev) -> dict:
    """(a) at ``data = 2``: two processes on the one card over gloo (NCCL
    refuses them), each with 4 of the 8 rows, the gradients all-reduced
    through the host; the global losses within 1e-3 of (a)'s at one
    rank (the bf16 gradients summed in another order)."""
    got = _run_pair(_two_rank_lm, (dev.type, BENCH_LM, TRAIN_BATCH, TRAIN_SEQ), 600)
    for r in ("0", "1"):
        assert isinstance(got[r], dict) and "losses" in got[r], got
    losses = got["0"]["losses"]
    assert got["1"]["losses"] == losses, got
    err = rel_loss_err(world1_losses, losses)
    assert err <= PARALLEL_REL, (world1_losses, losses)
    return {"mesh": {"data": 2, "model": 1}, "backend": "gloo", "losses": losses,
            "loss_rel_err_vs_world1": err,
            "step_ms_host": statistics.median(got["0"]["step_ms"])}


# -- parallel part 2: pipelines, tensor-parallel serving, the seam on a mesh ------
# (a) the bench LM's batches cut into M microbatches, through 1F1B and the
# interleaved step (V chunks a rank) at pipe = 1
PIPE = {"micro": 4, "chunks": 2}
# first-step gradients against the plain step's, per leaf over its largest
# value: bf16, M microbatches' gradients summed in float32 and rounded once
# against the batch's gradient rounded once. The embedding's apart: the
# plain step's autograd accumulates it in bf16 over the batch's 16384
# positions (255 distinct Markov tokens, up to 147 rows each), 2.0% of the
# leaf's largest value off a float32 accumulation of the same rows on the
# CPU; the pipeline accumulates it in float32
PIPE_GRAD_REL = 2e-2
PIPE_EMBED_GRAD_REL = 5e-2


def leaf_names(tree, prefix: str = "") -> list:
    """``param_leaves`` order's names (``layers.3.wq``)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def pipeline_launches(cfg, steps: int) -> dict:
    """The kernels' launches the schedule predicts: every microbatch and
    layer runs the flash forward at its F tick and again at its B tick's
    recompute, one flash backward, and the last stage one loss kernel a
    microbatch."""
    per_layer = PIPE["micro"] * cfg.n_layers * steps
    return {"flash_fwd": 2 * per_layer, "flash_bwd_dq": per_layer, "flash_bwd_dkv": per_layer,
            "cross_entropy": PIPE["micro"] * steps}


def _pipeline_layout(kind: str, params, mesh):
    """This rank's staged params and the inverse of the layout."""
    if kind == "1f1b":
        return (pmesh.shard_tree(ppipe.transformer_stage_params(params, 1),
                                 ppipe.pipeline_param_specs(), mesh),
                ppipe.transformer_unstage_params)
    staged = ppipe.transformer_interleaved_stage_params(params, 1, PIPE["chunks"])
    return (pmesh.shard_tree(staged, ppipe.interleaved_param_specs(), mesh),
            ppipe.transformer_uninterleave_params)


def _pipeline_step(kind: str, cfg, opt, mesh):
    if kind == "1f1b":
        return ppipe.make_pipeline_lm_train_step(mesh, cfg, opt, PIPE["micro"])
    return ppipe.make_interleaved_pipeline_lm_train_step(mesh, cfg, opt, PIPE["micro"],
                                                         PIPE["chunks"])


def parallel_pipelines(dev, cfg, base, batches, plain) -> dict:
    """(a) 1F1B and the interleaved step at ``pipe = 1`` on the plain
    step's params and tokens (each batch as M microbatches): losses and
    update differences against the plain step, ms a step after the
    first, peak memory, and the flash and loss launches against the
    schedule's prediction; the first step's gradients (through
    ``pipeline_lm_loss_and_grads`` alone) against the plain step's; one
    profiled 1F1B step, its device busy time and idle share."""
    mesh = pmesh.create_mesh({"pipe": 1}, dev)
    opt = ttrainer.adamw(TRAIN_LR)
    m = PIPE["micro"]
    micro = [b.view(m, -1, b.shape[-1]) for b in batches]
    ref = trainable(base, dev)
    ttrainer.lm_loss(tfm.forward, cfg)(ref, batches[0]).backward()
    ref_grads = [p.grad for p in ttrainer.param_leaves(ref)]
    names = leaf_names(ref)
    del ref
    out = {"mesh": {"pipe": 1}, "micro": m, "chunks": PIPE["chunks"], "grad_rel": PIPE_GRAD_REL,
           "embed_grad_rel": PIPE_EMBED_GRAD_REL}
    for kind in ("1f1b", "interleaved"):
        local, unstage = _pipeline_layout(kind, trainable(base, dev), mesh)
        if kind == "1f1b":
            fn = ppipe.pipeline_lm_loss_and_grads(mesh, cfg, m)
        else:
            fn = ppipe.interleaved_pipeline_lm_loss_and_grads(mesh, cfg, m, PIPE["chunks"])
        _, grads = fn(local, micro[0])
        got = ttrainer.param_leaves(unstage(grads))
        errs = {name: ((g - r.float()).abs().max() / r.float().abs().max()).item()  # lint: allow(JIT502) — one error a leaf, after the steps
                for name, g, r in zip(names, got, ref_grads, strict=True)}
        embed_err = errs.pop("embed")
        grad_err = max(errs.values())
        worst = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
        del grads, got
        state = ttrainer.init_train_state(local, opt)
        step = _pipeline_step(kind, cfg, opt, mesh)
        reset_train_counts()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        state, losses, step_ms, _ = timed_steps(step, state, micro, 1)
        launches = train_counts()
        expect = pipeline_launches(cfg, len(micro))
        assert launches == expect, (kind, launches, expect)
        losses = scalar_losses(losses)
        loss_err = rel_loss_err(plain["losses"], losses)
        after = unstage(state["params"])
        assert loss_err <= PARALLEL_REL, (kind, loss_err)
        assert grad_err <= PIPE_GRAD_REL and embed_err <= PIPE_EMBED_GRAD_REL, (
            kind, worst, embed_err)
        out[kind] = {"losses": losses, "loss_rel_err": loss_err, "grad_rel_err": grad_err,
                     "grad_rel_err_worst_leaves": worst, "embed_grad_rel_err": embed_err,
                     "update_l2_rel": update_l2_rel(base, plain["params"], after),
                     "launches": launches, "predicted_launches": expect,
                     "step_ms": statistics.median(step_ms), "step_ms_each": step_ms,
                     "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9
                     if dev.type == "cuda" else None}
        if kind == "1f1b":
            # one more step under the profiler (its launches are not
            # counted above): the device's busy time against the step's
            # wall time; the interleaved step does the same work
            profiled = device_breakdown(lambda: step(state, micro[-1]))
            profiled.pop("top_kernels", None)
            out[kind]["profiled_step"] = profiled
        del state, after, local
        gc.collect()
    out["plain_step_ms"] = statistics.median(plain["step_ms"])
    return out


def update_l2_rel(before: dict, after_a: dict, after_b: dict) -> float:
    """The worst leaf's ``||du_b - du_a|| / ||du_a||``: unlike the largest
    elementwise difference it is not set by elements whose gradient is
    near zero, where AdamW's first steps move by +-lr on the sign alone."""
    worst = 0.0
    for p0, a, b in zip(ttrainer.param_leaves(before), ttrainer.param_leaves(after_a),
                        ttrainer.param_leaves(after_b)):
        da, db = a.detach().float() - p0.float(), b.detach().float() - p0.float()
        worst = max(worst, (torch.linalg.norm(db - da) / torch.linalg.norm(da)  # lint: allow(JIT502) — one error a leaf, after the steps
                            .clamp_min(1e-30)).item())
    return worst


def _tp_serve(engine, requests, want, steady: bool) -> dict:
    """A tensor-parallel engine after ``prewarm``: the requests' streams
    equal ``want``, the paged kernel on local heads, nothing captured in
    the run; with ``steady`` the steady burst too."""
    warm = prewarm_engine(engine)
    impl = "cuda" if engine.device.type == "cuda" else "reference"
    assert pa.LAST_DISPATCH == {"impl": impl, "tp": True}, pa.LAST_DISPATCH
    engine.start()
    try:
        run = drive_engine(engine, requests)
        results = run.pop("results")
        assert results == want, (results, want)
        line = {"prewarm": warm, "streams_equal_plain": True,
                "ttft_s_median": statistics.median(run.pop("ttft_s")), **run}
        if steady:
            line["steady"] = steady_burst(engine)
        line["watched"] = watched_wave(engine, requests, "tp_engine")
        st = engine.stats()
        assert st["requests_failed"] == 0
        assert st["graph_captures"] == warm["captures"], "a graph was captured after prewarm"
        line["graph_captures_after_prewarm"] = st["graph_captures"] - warm["captures"]
    finally:
        engine.stop()
    return line


def parallel_tp_engine(dev, serving: dict) -> dict:
    """(b) and (c): Llama-2-7B over ``mesh={"model": 1}`` (NCCL at one
    rank). The checkpoint the int8_weights phase wrote is restored
    through ``load_serving_params(mesh=)`` (every leaf byte for byte the
    params in memory) and served by ``InferenceEngine.from_checkpoint(mesh=)``
    on a bf16 pool: the serving requests and the steady burst; the params
    in memory by ``InferenceEngine(mesh=)`` on an int8 pool: the int8
    pool's requests. Every stream equal to the plain engine's, token for
    token."""
    cfg, params, path = serving["cfg"], serving["params"], serving["checkpoint"]
    mesh = pmesh.create_mesh({"model": 1}, dev)
    max_len = min(2048, cfg.max_seq_len)
    sync(dev)
    t0 = time.monotonic()
    restored, step = load_serving_params(path, cfg, mesh=mesh)
    sync(dev)
    load_s = time.monotonic() - t0
    nbytes = assert_same_bytes(restored, params)
    del restored
    gc.collect()
    out = {"mesh": {"model": 1},
           "seam": {"step": step, "load_s": load_s, "load_gbps": nbytes / load_s / 1e9,
                    "params_byte_equal": True}}
    for pool in ("bf16", "int8"):
        if pool == "bf16":
            engine = InferenceEngine.from_checkpoint(path, cfg, mesh=mesh, max_slots=8,
                                                     max_len=max_len)
            requests, want = serving["requests"], serving["results"]
        else:
            engine = InferenceEngine(params, cfg, mesh=mesh, max_slots=8, max_len=max_len,
                                     kv_dtype="int8")
            requests, want = serving["int8_requests"], serving["int8_results"]
        out[pool] = _tp_serve(engine, requests, want, steady=pool == "bf16")
        del engine
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    out["bf16"]["built_by"] = "from_checkpoint(mesh=)"
    out["int8"]["built_by"] = "InferenceEngine(params, mesh=)"
    out["bf16"]["plain_steady_ms_per_step"] = serving["steady_ms"]
    out["bf16"]["steady_over_plain"] = (out["bf16"]["steady"]["ms_per_step"]
                                        / serving["steady_ms"])
    return out


def parallel_tp_kv_tier(dev, serving: dict) -> dict:
    """(g) the host KV tier under tensor-parallel serving: the kv_tier
    phase's four waves on Llama-2-7B over ``mesh={"model": 1}`` with
    ``kv_tier="host"`` on a bf16 pool, the params restored through
    ``from_checkpoint(mesh=)``, prewarmed: the streams, the tier counters
    and the KVM1 export of the shared chain equal the plain tier-on
    engine's (``serving["kv_tier"]``), nothing is captured after
    ``prewarm`` and paged decode runs on local heads."""
    ref = serving["kv_tier"]
    cfg, sizes = serving["cfg"], ref["sizes"]
    mesh = pmesh.create_mesh({"model": 1}, dev)
    waves = kv_tier_waves(cfg, sizes)
    engine = InferenceEngine.from_checkpoint(
        serving["checkpoint"], cfg, mesh=mesh, max_slots=sizes["max_slots"],
        max_len=sizes["max_len"], block_size=sizes["block_size"], n_blocks=sizes["n_blocks"],
        kv_tier="host", kv_tier_bytes=sizes["tier_bytes"])
    warm = prewarm_engine(engine)
    impl = "cuda" if engine.device.type == "cuda" else "reference"
    assert pa.LAST_DISPATCH == {"impl": impl, "tp": True}, pa.LAST_DISPATCH
    engine.start()
    try:
        reset_counts()
        runs = run_waves(engine, waves, sizes["new_tokens"])
        assert pa.LAUNCHES == 0, f"{pa.LAUNCHES} launches outside the graphs"
        st = engine.stats()
    finally:
        engine.stop()
    assert st["graph_captures"] == warm["captures"], "a graph was captured after prewarm"
    assert st["requests_failed"] == 0
    streams = [w["tokens"] for w in runs]
    assert streams == ref["streams"], (streams, ref["streams"])
    counters = {k: st[k] for k in TIER_COUNTERS}
    assert counters == ref["counters"], (counters, ref["counters"])
    export = chain_export(engine, waves[0])
    assert export == ref["export"], (export, ref["export"])
    del engine
    gc.collect()
    return {"mesh": {"model": 1}, "built_by": "from_checkpoint(mesh=)", "kv_pool": "bf16",
            "prewarm": warm, "graph_captures_after_prewarm": 0, "streams_equal_plain": True,
            "counters_equal_plain": True, **counters, "kv_spill_bytes": st["kv_spill_bytes"],
            "export_byte_equal_plain": True, "export": export,
            "wave4_ttft_s": runs[3]["ttft_s"], "launches": sum(w["launches"] for w in runs)}


def phase_parallel(dev, card, serving: dict) -> dict:
    """parallel/ on the card inside one world-of-one process group
    (NCCL on the card; gloo when rehearsed on the CPU): (a)-(e) above,
    then part 2: ``pipeline`` (the 1F1B and interleaved steps beside (a)'s
    plain step) and ``tp_engine`` over ``serving`` (the Llama-2-7B params,
    the plain engines' requests and streams, their steady ms a step and
    the int8_weights phase's checkpoint); then (f) ``elastic`` (the FSDP
    run's train state restored onto the TP layout) and (g)
    ``tp_engine.kv_tier`` (the kv_tier phase's waves over the mesh, held
    to ``serving["kv_tier"]``); ``part_seconds`` times each part."""
    with pmesh.distributed(dev):
        out = {"phase": "parallel", "card": card,
               "backend": torch.distributed.get_backend(),
               "world": torch.distributed.get_world_size()}
        t0 = time.monotonic()
        parts = {}

        def part(name, fn, *args):
            t = time.monotonic()
            result = fn(*args)
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            parts[name] = time.monotonic() - t
            return result

        out["lm_mesh"] = part("lm_mesh_and_pipeline", parallel_lm, dev)
        out["pipeline"] = out["lm_mesh"].pop("pipeline")
        out["elastic"] = part("elastic", parallel_elastic, dev, out["lm_mesh"].pop("fsdp_state"))
        out["lm_mesh"]["data2_gloo"] = part("data2_gloo", parallel_two_ranks,
                                            out["lm_mesh"]["mesh"]["losses"], dev)
        out["long_context"] = part("long_context", parallel_long_context, dev)
        out["ring_vs_flash"] = part("ring_vs_flash", parallel_ring_vs_flash, dev)
        out["expert_parallel"] = part("expert_parallel", parallel_moe, dev)
        out["tp_engine"] = part("tp_engine", parallel_tp_engine, dev, serving)
        out["tp_engine"]["kv_tier"] = part("tp_engine_kv_tier", parallel_tp_kv_tier, dev,
                                           serving)
        out["part_seconds"] = parts
        out["seconds"] = time.monotonic() - t0
    return out


# -- the analysis tooling (devspace_tpu_torch/lint) ------------------------------
SHD_MODEL_AXES = (1, 2, 3, 4, 8)  # model = 3 divides no head or FFN width
SHD_PIPE, SHD_DATA = 4, 8


def watched_wave(engine, requests, label: str) -> dict:
    """One more wave of ``requests`` on an engine after ``prewarm``, under
    ``CompileWatch``: the programs it builds (graph captures; must be 0,
    and equal the engine's own ``graph_captures`` delta) and the
    paged-decode launches its replays make (> 0, ``n_layers`` a step)."""
    reset_counts()
    before = engine.stats()
    with CompileWatch(label) as watch:
        for h in [engine.submit(p, n, **kw) for p, n, kw in requests]:
            h.result(timeout=600)
    st = engine.stats()
    line = {"captures": watch.count,
            "graph_captures_delta": st["graph_captures"] - before["graph_captures"],
            "decode_steps": st["decode_steps"] - before["decode_steps"],
            "paged_decode_launches": (st["paged_decode_launches"]
                                      - before["paged_decode_launches"])}
    assert line["captures"] == line["graph_captures_delta"], line
    watch.assert_no_recompiles()
    assert pa.LAUNCHES == 0, f"{pa.LAUNCHES} launches outside the graphs"
    assert line["paged_decode_launches"] == engine.cfg.n_layers * line["decode_steps"] > 0, line
    return line


def shd_summary(findings) -> dict:
    """A preflight's findings by rule, and the leaves they name (layer
    indices folded)."""
    return {"findings": len(findings), "rules": sorted({f.rule_id for f in findings}),
            "leaves": sorted({re.sub(r"\.\d+\.", ".*.", f.location) for f in findings})}


def analysis_sharding(params, cfg) -> dict:
    """SHD300-303 from shapes alone: the live serving params under
    ``param_partition_spec`` (as ``shard_serving_params`` places them) on
    declared meshes of ``model`` = 1, 2, 3, 4 and 8; the bench LM's 1F1B
    and interleaved layouts at ``pipe`` = 4 and its FSDP specs at ``data``
    = 8, over meta params of its config (the train phase's shapes)."""
    serving = lint.tree_shardings(params, tfm.param_partition_spec(cfg))
    out = {"serving_leaf_count": len(serving),
           "model": {str(m): shd_summary(lint.sharding_preflight({"model": m}, serving))
                     for m in SHD_MODEL_AXES}}
    for m in SHD_MODEL_AXES:
        got = out["model"][str(m)]
        if m == 3:
            assert got["rules"] == ["SHD302"] and got["findings"] > 0, (m, got)
        else:
            assert got["findings"] == 0, (m, got)
    meta = tfm.init_params(BENCH_LM, torch.Generator(), device="meta")
    layouts = {
        "1f1b": (ppipe.transformer_stage_params(meta, SHD_PIPE), ppipe.pipeline_param_specs(),
                 {"pipe": SHD_PIPE}),
        "interleaved": (ppipe.transformer_interleaved_stage_params(meta, SHD_PIPE, PIPE["chunks"]),
                        ppipe.interleaved_param_specs(), {"pipe": SHD_PIPE}),
        "fsdp": (meta, pmesh.tree_map(lambda p: pfsdp.fsdp_leaf_spec(tuple(p.shape), "data",
                                                                     SHD_DATA), meta),
                 {"data": SHD_DATA}),
    }
    for name, (tree, spec, axes) in layouts.items():
        shardings = lint.tree_shardings(tree, spec)
        out[name] = {"mesh": axes, "leaf_count": len(shardings),
                     **shd_summary(lint.sharding_preflight(axes, shardings))}
        assert out[name]["findings"] == 0, (name, out[name])
    return out


def analysis_donation(cfg) -> dict:
    """SHD304 with each function run on meta tensors: the trainer's update
    (the bench LM's params in, AdamW, the params out, donated) and a
    decode program over the serving config's pool (a step through the
    paged functions, the pool and the carry's tokens and positions
    written back in place, donated) give no finding; a seeded
    dtype-changing function gives one."""
    params = pmesh.tree_map(lambda t: t.requires_grad_(),
                            tfm.init_params(BENCH_LM, torch.Generator(), device="meta"))
    tokens = torch.empty((TRAIN_BATCH, TRAIN_SEQ + 1), dtype=torch.long, device="meta")

    def update(params, tokens):
        state = ttrainer.init_train_state(params, ttrainer.adamw(3e-4))
        state, _ = ttrainer.make_lm_train_step(tfm.forward, BENCH_LM, None)(state, tokens)
        return state["params"]

    slots, max_len, bs = 8, 2048, 64
    pool = tfm.init_paged_pool(cfg, slots * max_len // bs + 1, bs, device="meta")
    carry = (torch.empty((slots, max_len // bs), dtype=torch.int32, device="meta"),
             torch.empty(slots, dtype=torch.long, device="meta"),
             torch.empty(slots, dtype=torch.long, device="meta"))

    @torch.no_grad()
    def decode_program(params, pool, tables, tokens, positions):
        logits, pool = tfm.decode_tokens_paged(params, pool, tables, tokens, positions, cfg)
        tokens.copy_(logits.argmax(-1))
        positions.add_(1)
        return pool, tokens, positions

    out = {}
    for name, fn, args, donate in (
        ("update", update, (params, tokens), (0,)),
        ("decode_program", decode_program,
         (tfm.init_params(cfg, torch.Generator(), device="meta"), pool, *carry), (1, 3, 4)),
        ("seeded_cast", lambda x: x.to(torch.bfloat16),
         (torch.empty(64, device="meta"),), (0,)),
    ):
        t0 = time.monotonic()
        findings = lint.donation_preflight(fn, args, donate_argnums=donate)
        out[name] = {"findings": [f.rule_id for f in findings], "seconds": time.monotonic() - t0}
    assert out["update"]["findings"] == out["decode_program"]["findings"] == [], out
    assert out["seeded_cast"]["findings"] == ["SHD304"], out
    return out


def phase_analysis(params, cfg, card, tripwire: dict) -> dict:
    """The analysis tooling on the card's machine: ``tripwire``, the
    ``watched_wave`` lines of the plain 7B engine and the TP engine's
    pools (read here); the sharding and donation preflights (host only);
    the static legs of ``scripts/analysis_gate_torch.py`` (self-lint,
    catalogs, fixtures), whose findings outside the baseline must be 0."""
    t0 = time.monotonic()
    line = {"phase": "analysis", "card": card, "tripwire": tripwire}
    for name, wave in tripwire.items():
        assert wave["captures"] == wave["graph_captures_delta"] == 0, (name, wave)
        assert wave["paged_decode_launches"] > 0, (name, wave)
    line["sharding"] = analysis_sharding(params, cfg)
    line["donation"] = analysis_donation(cfg)
    t = time.monotonic()
    problems, line["self_lint"] = gate_script.self_lint()
    problems += gate_script.catalog_lint() + gate_script.fixture_detection()
    line["static_gate_s"] = time.monotonic() - t
    assert not problems, problems
    line["seconds"] = time.monotonic() - t0
    return line


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card", file=sys.stderr)
        return 1
    t_start = time.monotonic()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "card": card, "kind": kind, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.monotonic()
    nvcc_s = _build.build(*SOURCES)
    ptxas = {name: [ln.strip() for ln in _build.BUILD_LOG.get(name, "").splitlines()
                    if any(w in ln for w in ("registers", "spill", "Compiling entry",
                                             "Performance Loss"))]
             for name in SOURCES}
    emit({"phase": "build", "seconds": time.monotonic() - t0, "nvcc_s": nvcc_s,
          "ptxas": ptxas})

    errs, head_rel = phase_parity(dev)
    emit({"phase": "kernel_parity", "card": card, "max_abs_err": errs,
          "max_head_rel_err": head_rel, "f32_tol": [F32_RTOL, F32_ATOL],
          "bf16_max_abs": BF16_MAX_ABS, "bf16_head_rel": BF16_HEAD_REL})
    timing = phase_timing(dev)
    emit({"phase": "kernel_timing", "card": card,
          "shape": "H=Hkv=32 D=128 bs=64; bf16/int8: B=8 len=1024",
          "cases": {k: {"lengths": v[0][:1] + [len(v[0])], "mb": v[1]}
                    for k, v in PAGED_TIMING.items()}, **timing})
    emit({"phase": "small_reference", "card": card, "max_abs_logit_err": phase_small_reference(dev)})

    emit({"phase": "train_kernel_parity", "card": card, "f32_tol": [F32_RTOL, F32_ATOL],
          "bf16_head_rel": BF16_HEAD_REL, "xent_tol": [XENT_RTOL, XENT_ATOL],
          "shapes": {**FLASH_SHAPES, "xent": XENT_SHAPE},
          "errors": (train_parity := phase_train_kernel_parity(dev))})
    train_timing = phase_train_kernel_timing(dev)
    emit({"phase": "train_kernel_timing", "card": card,
          "shape": "flash bf16 causal [B*H=128, T=2048, D=64]; xent f32 [16384, 32000]",
          **train_timing})
    emit({"phase": "train_small_reference", "card": card, **phase_train_small_reference(dev)})
    train_line = phase_train(dev, card)
    emit(train_line)
    torch.cuda.empty_cache()

    zoo_parity = phase_zoo_kernel_parity(dev)
    emit({"phase": "zoo_kernel_parity", "card": card, "xent_tol": [XENT_RTOL, XENT_ATOL],
          "bf16_head_rel": BF16_HEAD_REL, "errors": zoo_parity})
    zoo_timing = phase_zoo_kernel_timing(dev)
    emit({"phase": "zoo_kernel_timing", "card": card,
          "shape": f"xent f32 {list(ZOO_XENT_SHAPES.values())}; "
                   f"flash bf16 causal [B*H, T, D] {list(ZOO_FLASH_SHAPE)}",
          **zoo_timing})
    with cudnn_benchmark():
        emit({"phase": "zoo_small_reference", "card": card, **phase_zoo_small_reference(dev)})
        resnet_line = phase_resnet50_train(dev, card)
        emit(resnet_line)
        mnist_line = phase_mnist_train(dev, card)
        emit(mnist_line)
        vit_line = phase_vit_train(dev, card)
        emit(vit_line)
    moe_line = phase_moe_train(dev, card)
    emit(moe_line)
    gc.collect()
    torch.cuda.empty_cache()
    deploy_line = phase_deploy(dev, card)
    emit(deploy_line)
    cluster_line = phase_cluster(dev, card)
    emit(cluster_line)

    attn_parity = phase_short_attention_parity(dev)
    emit({"phase": "short_attention_parity", "card": card, "f32_tol": [F32_RTOL, F32_ATOL],
          "bf16_head_rel": BF16_HEAD_REL, **attn_parity})
    rms_parity = phase_rms_norm_parity(dev)
    emit({"phase": "rms_norm_parity", "card": card, "f32_tol": RMS_F32_TOL,
          "bf16_tol": RMS_BF16_TOL, "max_abs_err": rms_parity})
    spec_timing = phase_spec_kernel_timing(dev)
    emit({"phase": "spec_kernel_timing", "card": card,
          "shape": f"attention bf16 causal [B*H, T, D] {ATTN_TRAIN_SHAPES}, "
                   f"prefill512 {ATTN_PREFILL_SHAPE}; rms_norm bf16 {list(RMS_SHAPES[0])}, "
                   f"rms_norm_4096 bf16 {list(RMS_WIDE)}",
          **spec_timing})
    pair_dir = tempfile.mkdtemp(prefix="spec-pair-")
    try:
        pair_line, t_params, d_params = phase_train_pair(dev, card, pair_dir)
        emit(pair_line)
        emit({"phase": "spec_small_reference", "card": card, **phase_spec_small_reference(dev)})
        spec_line = phase_spec_engine(t_params, d_params, pair_dir, dev, card)
        emit(spec_line)
    finally:
        shutil.rmtree(pair_dir, ignore_errors=True)
    del t_params, d_params
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.monotonic()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tfm.init_params(tfm.LLAMA2_7B, gen)
    torch.cuda.synchronize()
    emit({"phase": "init", "model": "llama2-7b", "seconds": time.monotonic() - t0,
          "param_gb": sum(t.numel() * t.element_size() for t in
                          [params["embed"], params["lm_head"], params["final_norm"]]
                          + [v for layer in params["layers"] for v in layer.values()]) / 1e9})
    engine_line, engine, results, prefix_results = phase_engine(params, dev, card)
    emit(engine_line)
    try:
        emit(phase_http(engine, card))
        plain_wave = watched_wave(engine, serving_requests(tfm.LLAMA2_7B), "llama2-7b")
    finally:
        engine.stop()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    emit(phase_engine_variants(params, dev, card, results, prefix_results))
    int8_line = phase_engine_int8(params, dev, card)
    int8_ref = int8_line.pop("reference")
    emit(int8_line)
    kv_line = phase_kv_tier(params, dev, card, engine_line["near_tie_bound"])
    kv_ref = {"sizes": KV_TIER, **kv_line["bf16"].pop("reference")}
    kv_line["int8"].pop("reference")
    emit(kv_line)
    gc.collect()
    torch.cuda.empty_cache()
    # the 7B checkpoint int8_weights saves is the fleet's replicas' too
    ckpt_dir = tempfile.mkdtemp(prefix="llama2-7b-")
    try:
        int8w_line = phase_int8_weights(params, dev, card,
                                        engine_line["decode_step_b8_ctx1024"]["graph_ms"],
                                        ckpt_dir)
        emit(int8w_line)
        # the replicas need the card: the parent holds no engine and no params
        del params
        gc.collect()
        torch.cuda.empty_cache()
        fleet_line = phase_fleet(ckpt_dir, card, engine_line["near_tie_bound"], dev)
        emit(fleet_line)
        chaos_line = phase_chaos(ckpt_dir, card, engine_line["near_tie_bound"], dev)
        emit(chaos_line)
        gc.collect()
        torch.cuda.empty_cache()
        # the same seed: the params the engines above served
        params = tfm.init_params(tfm.LLAMA2_7B, torch.Generator(device=dev).manual_seed(0))
        serving = {"cfg": tfm.LLAMA2_7B, "params": params,
                   "requests": serving_requests(tfm.LLAMA2_7B), "results": results,
                   "int8_requests": int8_ref["requests"], "int8_results": int8_ref["results"],
                   "steady_ms": engine_line["steady"]["ms_per_step"], "checkpoint": ckpt_dir,
                   "kv_tier": kv_ref}
        parallel_line = phase_parallel(dev, card, serving)
        emit(parallel_line)
        tripwire = {"llama2-7b": plain_wave,
                    **{f"tp_engine_{pool}": parallel_line["tp_engine"][pool]["watched"]
                       for pool in ("bf16", "int8")}}
        analysis_line = phase_analysis(params, tfm.LLAMA2_7B, card, tripwire)
        emit(analysis_line)
        del params, serving
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    parallel_launches = {
        name: sum(parallel_line[part][sub]["launches"][name] if sub else
                  parallel_line[part]["launches"][name]
                  for part, sub in (("lm_mesh", "mesh"), ("lm_mesh", "fsdp"),
                                    ("expert_parallel", None), ("pipeline", "1f1b"),
                                    ("pipeline", "interleaved"), ("elastic", None)))
        for name in TRAIN_KERNELS}
    tp_paths = {pool: parallel_line["tp_engine"][pool]["launches"] for pool in ("bf16", "int8")}

    kernels = []
    for variant, line in (("bf16", engine_line), ("int8", int8_line)):
        t = timing[variant]
        pool = "float" if variant == "bf16" else "int8"
        # the speculative path's pool is bf16: its decode steps and its
        # [B*K] verification blocks
        by_path = {"serving": line["launches"], "kv_tier": kv_line[variant]["launches"]}
        if variant == "int8":
            by_path["kv_migration"] = kv_line["migration"]["launches"]
        err_by_path = {"serving": max(errs[f"mha/bfloat16/{pool}"], errs[f"gqa/bfloat16/{pool}"])}
        # the tensor-parallel engine at one NCCL rank (bf16: restored
        # from the checkpoint on the mesh)
        by_path["tp_engine"] = tp_paths[variant]
        err_by_path["tp_engine"] = err_by_path["serving"]
        if variant == "bf16":
            # the kv_tier phase's waves on the tensor-parallel engine
            by_path["tp_engine_kv_tier"] = parallel_line["tp_engine"]["kv_tier"]["launches"]
            err_by_path["tp_engine_kv_tier"] = err_by_path["serving"]
        # the waves the analysis phase watched for captures: the plain
        # engine's (bf16) and the TP engine's on each pool
        by_path["analysis"] = sum(wave["paged_decode_launches"] for name, wave in tripwire.items()
                                  if name.endswith("int8") == (variant == "int8"))
        err_by_path["analysis"] = err_by_path["serving"]
        if variant == "bf16":
            by_path["speculative"] = spec_line["spec"]["paged_decode_launches"]
            err_by_path["speculative"] = errs["verify/bfloat16/float"]
            # int8 weights from a checkpoint, over a bf16 pool
            by_path["int8_weights"] = int8w_line["launches"]
            err_by_path["int8_weights"] = err_by_path["serving"]
            # the fleet's replicas during the gateway burst, as each
            # replica's /healthz counts its replays
            by_path["fleet"] = fleet_line["paged_decode_launches"]
            err_by_path["fleet"] = err_by_path["serving"]
            # the chaos phase's replicas, from each process's /healthz (a
            # killed one's up to its last read before the kill)
            by_path["chaos"] = chaos_line["paged_decode_launches"]
            err_by_path["chaos"] = err_by_path["serving"]
        kernels.append({
            "name": f"paged_decode[{variant} pool]",
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": KERNEL_REPLACES,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(err_by_path.values()),
            "max_abs_err_by_path": err_by_path,
            "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "bound_share": t["bound_share"],
            "library_ms": t["library_ms"],
            "plan": t["plan"],
        })
        if variant == "bf16":
            # the engine's table width and one long row beside the decode step
            kernels[-1]["other_shapes"] = {
                shape: {f: timing[shape][f] for f in ("kernel_ms", "plain_ms", "library_ms",
                                                      "bound_ms", "bound_share", "plan")}
                for shape in ("b8_mb32_ctx1024", "b1_ctx4096", "verify_b40")}
    for name, (key, source, replaces) in TRAIN_KERNELS.items():
        t = train_timing["xent" if key is None else key]
        if key is None:
            err = train_parity["xent/float32"]["loss"]
        else:
            part = {"fwd": "o", "bwd_dq": "dq", "bwd_dkv": "dk"}[key]
            err = max(train_parity["bench/bfloat16/causal"][p][0]
                      for p in ((part, "dv") if part == "dk" else (part,)))
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": train_line["launches"][name], "max_abs_err": err,
            "ms": t["kernel_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        }
        if key is not None:
            entry.update({f: t[f] for f in ("tflops", "bound_share", "gflop", "tensor_gflop",
                                             "tensor_tflops")})
        if key in ("bwd_dq", "bwd_dkv"):
            # one SDPA backward computes dq, dk and dv: no library call
            # computes either kernel's part alone
            entry["library_ms"] = train_timing["bwd_pair"]["library_ms"]
            entry["library_covers"] = "dq, dk and dv together (SDPA backward)"
        if name == "cross_entropy":
            entry["launches_by_path"] = {"train": entry["launches"],
                                         "train_pair": pair_line["xent_launches"],
                                         "resnet50": resnet_line["xent_launches"],
                                         "mnist": mnist_line["xent_launches"],
                                         "deploy": deploy_line["xent_launches"],
                                         "cluster": cluster_line["xent_launches"],
                                         "vit": vit_line["xent_launches"],
                                         "moe": moe_line["launches"][name],
                                         "parallel": parallel_launches[name]}
            # the classifiers' and the MoE LM's logits
            entry["other_shapes"] = {
                f"{b}x{v}": {**zoo_timing[f"xent/{b}x{v}"],
                             "max_abs_err": zoo_parity[f"xent/{b}x{v}"]["loss"]}
                for b, v in ZOO_XENT_SHAPES.values()}
        else:
            entry["launches_by_path"] = {"train": entry["launches"],
                                         "moe": moe_line["launches"][name],
                                         "parallel": parallel_launches[name]}
            part = {"fwd": "o", "bwd_dq": "dq", "bwd_dkv": "dk"}[key]
            d128 = zoo_parity["flash/bfloat16/causal/" + "x".join(map(str, ZOO_FLASH_SHAPE))]
            t128 = zoo_timing["flash_d128"][key]
            entry["other_shapes"] = {"x".join(map(str, ZOO_FLASH_SHAPE)): {
                **{f: t128[f] for f in ("kernel_ms", "plain_ms", "bound_ms", "bound_by",
                                        "bound_share", "tflops", "library_ms")},
                "max_abs_err": max(d128[p][0] for p in ((part, "dv") if part == "dk"
                                                         else (part,)))}}
            if key != "fwd":
                entry["other_shapes"]["x".join(map(str, ZOO_FLASH_SHAPE))]["library_ms"] = \
                    zoo_timing["flash_d128"]["bwd_pair"]["library_ms"]
        entry["launches"] = sum(entry["launches_by_path"].values())
        kernels.append(entry)
    attn_paths = {"train_pair": pair_line["attention_launches"],
                  "spec_engine": spec_line["spec"]["attention_launches"],
                  "generate_speculative": spec_line["generate_speculative"]["attention_launches"]}
    for name, (source, replaces), paths, err, t in (
        ("short_attention", ATTN_KERNEL, attn_paths,
         attn_parity["errors"]["target/bfloat16/causal"][0], spec_timing["attention_target"]),
        # on no model's path, as in the JAX package: launched by the
        # parity and timing phases only
        ("rms_norm", RMS_KERNEL, {}, rms_parity["4096x1024/bfloat16"]["y"],
         spec_timing["rms_norm"]),
    ):
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(paths.values()), "launches_by_path": paths, "max_abs_err": err,
            "ms": t["kernel_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        }
        entry["bound_share"] = t["bound_share"]
        fields = ("kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_share")
        if name == "short_attention":
            # the draft's training shape and its long prefill beside the
            # target's shape above
            entry["other_shapes"] = {shape: {f: spec_timing[f"attention_{shape}"][f]
                                             for f in fields}
                                     for shape in ("draft", "prefill512")}
        else:
            entry["other_shapes"] = {"x".join(map(str, RMS_WIDE)):
                                     {f: spec_timing["rms_norm_4096"][f] for f in fields}}
        kernels.append(entry)
    emit({"phase": "done", "seconds": time.monotonic() - t_start, "card": card})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        if left := stop_children():
            print(f"chip_smoke: stopped child processes left running: {left}", file=sys.stderr)
    sys.exit(rc)
