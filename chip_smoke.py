#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (devspace_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA Hopper GPU
and the CUDA toolkit. It builds the port's CUDA kernels from the sources
in the checkout (one nvcc per source, all started together), holds each
against its plain PyTorch version and times it, then drives the port's
two paths:

- training: the LM that bench.py trains on a chip (vocab 32000, dim
  1024, 8 layers, 16 heads, ffn 4096, bf16; random weights from seed 0)
  takes AdamW steps at batch 8 x 2048 through the flash-attention and
  cross-entropy kernels;
- serving: at the full width and depth of Llama-2-7B, the engine answers
  concurrent requests with a bf16 KV pool and an int8 one through the
  paged-decode kernel, and one request goes through the HTTP server.

Each phase prints one JSON line; any failure raises and exits non-zero.
The line before the last lists the kernels; the last is
``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero and
prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from devspace_tpu_torch import serve
from devspace_tpu_torch.inference import InferenceEngine
from devspace_tpu_torch.models import transformer as tfm
from devspace_tpu_torch.ops import _build
from devspace_tpu_torch.ops import flash_attention as fa
from devspace_tpu_torch.ops import losses as xl
from devspace_tpu_torch.ops import paged_attention as pa
from devspace_tpu_torch.training import data as tdata
from devspace_tpu_torch.training import trainer as ttrainer

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
SOURCES = ("paged_decode", "flash_attention", "cross_entropy")
# the kernels of the training path: name -> (launch counter, source, the
# TPU kernel body it replaces)
TRAIN_KERNELS = {
    "flash_fwd": ("fwd", "devspace_tpu_torch/csrc/flash_attention.cu",
                  "devspace_tpu/ops/flash_attention.py:29"),  # _fwd_kernel
    "flash_bwd_dq": ("bwd_dq", "devspace_tpu_torch/csrc/flash_attention.cu",
                     "devspace_tpu/ops/flash_attention.py:126"),  # _bwd_dq_kernel
    "flash_bwd_dkv": ("bwd_dkv", "devspace_tpu_torch/csrc/flash_attention.cu",
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


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


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
def paged_inputs(seed, lengths, H, Hkv, D, bs, dtype, int8, dev):
    """Random q and pools, each row's table a run of distinct blocks."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B = len(lengths)
    mb = max(1, max(-(-n // bs) for n in lengths))
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


def bound(q, pk, tables, lengths, int8) -> tuple[float, str]:
    """Least time the card could take: each input read once, the output
    written once, K/V only for the positions this run's lengths cover."""
    B, H, D = q.shape
    _, Hkv, _, _ = pk.shape
    tokens = int(lengths.sum().item())
    nbytes = 2 * tokens * Hkv * D * pk.element_size()
    if int8:
        nbytes += 2 * tokens * Hkv * 4  # f32 scales
    nbytes += 2 * q.numel() * q.element_size() + tables.numel() * 4 + lengths.numel() * 4
    flops = 4 * tokens * H * D
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# -- phases -------------------------------------------------------------------
def phase_parity(dev) -> dict:
    """Kernel vs plain version at main-path shapes: D=128, bs=64; ragged
    lengths (full table >= 2048, partial last block, length 1, dead
    slot); MHA (H=Hkv=32, Llama-2-7B) and GQA (H=32, Hkv=8); float and
    int8 pools, bf16 and f32."""
    lengths = [2560, 700, 1, 0, 2100]
    errs, head_rel = {}, {}
    for H, Hkv in ((32, 32), (32, 8)):
        for dtype in (torch.bfloat16, torch.float32):
            for int8 in (False, True):
                args = paged_inputs(1, lengths, H, Hkv, 128, 64, dtype, int8, dev)
                got = pa.paged_decode_attention(*args)
                torch.cuda.synchronize()
                assert pa.LAST_DISPATCH["impl"] == "cuda"
                ref = pa.paged_decode_reference(*args)
                live = args[4] > 0
                assert (got[~live] == 0).all(), "dead rows must be exactly zero"
                diff = (got[live].float() - ref[live].float()).abs()
                err = diff.max().item()
                rel = (diff.amax(-1) / ref[live].float().abs().amax(-1)).max().item()
                name = f"{'mha' if H == Hkv else 'gqa'}/{str(dtype)[6:]}/{'int8' if int8 else 'float'}"
                if dtype == torch.float32:
                    torch.testing.assert_close(got[live], ref[live], rtol=F32_RTOL, atol=F32_ATOL)
                else:
                    assert err <= BF16_MAX_ABS, f"{name}: bf16 max abs error {err}"
                    assert rel <= BF16_HEAD_REL, f"{name}: bf16 per-head relative error {rel}"
                errs[name], head_rel[name] = err, rel
    return errs, head_rel


def phase_timing(dev) -> dict:
    """B=8, every length 1024, H=Hkv=32, D=128, bs=64 (a Llama-2-7B decode
    step's attention, per layer); q bf16, pool bf16 or int8. The K/V read
    (134 MB bf16, 67 MB int8) exceeds the 50 MB L2, so it comes from HBM."""
    out = {}
    for int8 in (False, True):
        args = paged_inputs(2, [1024] * 8, 32, 32, 128, 64, torch.bfloat16, int8, dev)
        q, pk, pv, tables, lengths, ks, vs = args
        kernel = pa._kernel()
        out_buf = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream
        raw = (1, int(int8), q.data_ptr(), pk.data_ptr(), pv.data_ptr(),
               ks.data_ptr() if int8 else None, vs.data_ptr() if int8 else None,
               tables.data_ptr(), lengths.data_ptr(), out_buf.data_ptr(),
               8, 32, 32, 128, 64, tables.shape[1], pk.shape[0], stream)

        def launch():
            err = kernel(*raw)
            if err:
                raise RuntimeError(f"paged_decode launch failed: cudaError {err}")

        ms, _ = device_ms(launch, 200)
        torch.testing.assert_close(out_buf, pa.paged_decode_attention(*args), rtol=0, atol=0)
        plain, _ = device_ms(lambda: pa.paged_decode_reference(*args), 20)
        lib, _ = device_ms(lambda: library_attention(*args), 50)
        lib_err = (library_attention(*args).float() - out_buf.float()).abs().max().item()
        bound_ms, bound_by = bound(q, pk, tables, lengths, int8)
        out["int8" if int8 else "bf16"] = {
            "kernel_ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_max_abs_err": lib_err,
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
        err = max(err, (logits[dev].cpu() - logits[cpu]).abs().max().item())
        tables = torch.tensor([[3, 5, 1, 7], [2, 4, 0, 0]], dtype=torch.int32)
        tok = torch.stack([logits[cpu][-1].argmax(), torch.tensor(9)])
        pos = torch.tensor([13, 0])
        for _ in range(6):
            step = {}
            for d, p in ((cpu, params), (dev, gparams)):
                step[d], _ = tfm.decode_tokens_paged(p, pools[d], tables.to(d), tok.to(d),
                                                     pos.to(d), cfg)
            err = max(err, (step[dev].cpu() - step[cpu]).abs().max().item())
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
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            step()
            end.record()
            host.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            eager.append(start.elapsed_time(end))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        graph_ms, _ = device_ms(graph.replay, 10)
    return {"eager_ms": statistics.median(eager), "host_ms": statistics.median(host),
            "graph_ms": graph_ms}


def drive_engine(engine, requests) -> dict:
    """Submit every request at once, wait for all; kernel launches and
    decode steps counted over exactly this run."""
    pa.LAUNCHES = 0
    steps0 = engine.decode_steps
    t0 = time.monotonic()
    handles = [engine.submit(p, n, **kw) for p, n, kw in requests]
    results = [h.result(timeout=600) for h in handles]
    wall = time.monotonic() - t0
    launches = pa.LAUNCHES
    steps = engine.decode_steps - steps0
    assert pa.LAST_DISPATCH["impl"] == "cuda"
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
    }


def phase_engine(params, dev, card) -> tuple[dict, InferenceEngine]:
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
    engine.start()
    engine.submit(list(range(1, 9)), 4).result(timeout=600)  # warm-up, not counted
    rng = np.random.default_rng(0)
    S, E = 1234, 4321  # forced token, EOS id
    requests = [
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
    run = drive_engine(engine, requests)
    results = run.pop("results")
    assert [len(r) for r in results[:5]] == [32] * 5, [len(r) for r in results]
    assert results[5] == [S] * 4, results[5]
    st = engine.stats()
    assert st["requests_failed"] == 0 and st["free_blocks"] == st["total_blocks"]
    return {
        "phase": "engine", "model": "llama2-7b", "kv_pool": "bf16", "card": card,
        "prompt_lens": [len(p) for p, _, _ in requests], "max_new_tokens": 32,
        "decode_step_b8_ctx1024": step,
        "ttft_s_median": statistics.median(run["ttft_s"]), "ttft_s_max": max(run["ttft_s"]),
        **{k: v for k, v in run.items() if k != "ttft_s"},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }, engine


def phase_http(engine, card) -> dict:
    httpd = serve.make_http_server(serve.Server(engine, "llama2-7b"), "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        body = json.dumps({"prompt_ids": list(range(100, 140)), "max_new_tokens": 8}).encode()
        t0 = time.monotonic()
        with urllib.request.urlopen(urllib.request.Request(url + "/generate", data=body),
                                    timeout=300) as resp:
            assert resp.status == 200
            tokens = json.loads(resp.read())["tokens"]
        elapsed = time.monotonic() - t0
        with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    assert len(tokens) == 8 and all(0 <= t < engine.cfg.vocab_size for t in tokens)
    assert health["ok"] and health["requests_failed"] == 0
    return {"phase": "http", "card": card, "tokens": len(tokens), "round_trip_s": elapsed}


def phase_engine_int8(params, dev, card) -> dict:
    cfg = tfm.LLAMA2_7B
    engine = InferenceEngine(params, cfg, device=dev, max_slots=8, max_len=2048, kv_dtype="int8")
    engine.start()
    try:
        rng = np.random.default_rng(1)
        requests = [(rng.integers(1, cfg.vocab_size, n).tolist(), 16, {}) for n in (7, 100, 300, 600)]
        run = drive_engine(engine, requests)
        assert [len(r) for r in run.pop("results")] == [16] * 4
        assert engine.stats()["requests_failed"] == 0
    finally:
        engine.stop()
    return {
        "phase": "engine", "model": "llama2-7b", "kv_pool": "int8", "card": card,
        "ttft_s_median": statistics.median(run["ttft_s"]),
        **{k: v for k, v in run.items() if k != "ttft_s"},
    }


# -- training path ------------------------------------------------------------
def bound_of(nbytes: float, flops: float, flops_per_s: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def flash_bound(kernel: str, bh: int, t: int, d: int, causal: bool, elem: int):
    """Least time for one flash kernel: its inputs read once and outputs
    written once, against 4 D (forward), 6 D (dq) or 8 D (dk/dv) flops
    per live (query, key) pair, at the dense bf16 peak."""
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = bh * pairs * d * {"fwd": 4, "bwd_dq": 6, "bwd_dkv": 8}[kernel]
    rows, vec = bh * t * d * elem, bh * t * 4
    nbytes = {"fwd": 4 * rows + vec,                 # q, k, v in; o, lse out
              "bwd_dq": 5 * rows + 2 * vec,          # q, k, v, dO, lse, delta in; dq out
              "bwd_dkv": 6 * rows + 2 * vec}[kernel]  # ...; dk, dv out
    return bound_of(nbytes, flops, BF16_FLOPS_PER_S)


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
                torch.cuda.synchronize()
                assert fa.LAST_DISPATCH["impl"] == "cuda"
                ro, rlse = fa.flash_fwd_reference(q, k, v, causal)
                rdk, rdv = fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal)
                rdq = fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, causal)
                name = f"{shape_name}/{str(dtype)[6:]}/{'causal' if causal else 'full'}"
                torch.testing.assert_close(lse, rlse, rtol=F32_RTOL, atol=1e-4, msg=name + " lse")
                line = {t: kernel_err(g, r, f"{name} {t}")
                        for t, g, r in (("o", o, ro), ("dq", dq, rdq), ("dk", dk, rdk),
                                        ("dv", dv, rdv))}
                line["lse"] = (lse - rlse).abs().max().item()
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
        torch.cuda.synchronize()
        assert xl.LAST_DISPATCH["impl"] == "cuda"
        rloss, rlse = xl._xent_fwd_reference(logits, labels)
        torch.testing.assert_close(loss, rloss, rtol=XENT_RTOL, atol=XENT_ATOL)
        torch.testing.assert_close(lse, rlse, rtol=XENT_RTOL, atol=XENT_ATOL)
        out[f"xent/{str(dtype)[6:]}"] = {"loss": (loss - rloss).abs().max().item(),
                                         "lse": (lse - rlse).abs().max().item()}
        del logits
    return out


def phase_train_kernel_timing(dev) -> dict:
    """Each kernel at the bench step's shape (bf16, causal [128, 2048,
    64]; logits f32 [16384, 32000]) beside its plain version, one library
    call computing the same function (SDPA forward; SDPA backward for dq
    and dk/dv together; F.cross_entropy) and its bound."""
    bh, t, d = FLASH_SHAPES["bench"]
    q, k, v, do = flash_inputs(5, (bh, t, d), torch.bfloat16, dev)
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
                     "bound_by": bound_by, "library_ms": None}
    q4, k4, v4 = [x.view(8, 16, t, d).detach().requires_grad_() for x in (q, k, v)]
    out["fwd"]["library_ms"], _ = device_ms(
        lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True), 20)
    sdpa = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    lib_bwd, _ = device_ms(
        lambda: torch.autograd.grad(sdpa, (q4, k4, v4), do.view(8, 16, t, d), retain_graph=True), 20)
    out["bwd_pair"] = {"kernel_ms": out["bwd_dq"]["kernel_ms"] + out["bwd_dkv"]["kernel_ms"],
                       "library_ms": lib_bwd}
    out["fwd"]["library_max_abs_err"] = (sdpa.detach().view(bh, t, d).float() - o.float()).abs().max().item()
    del q, k, v, do, o, lse, delta, q4, k4, v4, sdpa
    torch.cuda.empty_cache()
    b, vocab = XENT_SHAPE
    g = torch.Generator(device=dev).manual_seed(6)
    logits = 3 * torch.randn((b, vocab), generator=g, device=dev)
    labels = torch.randint(0, vocab, (b,), generator=g, device=dev)
    ms, _ = device_ms(lambda: xl.xent_fwd(logits, labels), 20)
    plain_ms, _ = device_ms(lambda: xl._xent_fwd_reference(logits, labels), 5)
    lib_ms, _ = device_ms(lambda: F.cross_entropy(logits, labels, reduction="none"), 20)
    bound_ms, bound_by = xent_bound(b, vocab, 4)
    out["xent"] = {"kernel_ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by}
    del logits
    torch.cuda.empty_cache()
    return out


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
        result[d] = (loss.item(), [p.grad.cpu() for p in ttrainer.param_leaves(state["params"])])
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


def device_breakdown(step_fn) -> dict:
    """One step under torch.profiler: device time by kind of kernel (the
    port's kernels, matrix products, the rest) against the step's wall
    time, whose remainder is the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kinds = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0, "cross_entropy": 0.0,
             "matmul": 0.0, "other": 0.0}
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
        if "flash_fwd_kernel" in name:
            kind = "flash_fwd"
        elif "flash_bwd_dq_kernel" in name:
            kind = "flash_bwd_dq"
        elif "flash_bwd_dkv_kernel" in name:
            kind = "flash_bwd_dkv"
        elif "xent_kernel" in name:
            kind = "cross_entropy"
        elif any(s in name.lower() for s in ("gemm", "xmma", "cutlass", "sm90_", "wgmma", "nvjet")):
            kind = "matmul"
        else:
            kind = "other"
        kinds[kind] += us / 1e3
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
    losses = []
    for tokens in batches[:TRAIN_WARMUP]:
        state, loss = step(state, tokens)
        losses.append(loss)
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(TRAIN_STEPS)]
    t0 = time.perf_counter()
    for (start, end), tokens in zip(events, batches[TRAIN_WARMUP:TRAIN_WARMUP + TRAIN_STEPS]):
        start.record()
        state, loss = step(state, tokens)
        end.record()
        losses.append(loss)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = train_counts()
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    expect = {name: (1 if key is None else cfg.n_layers) * n_steps
              for name, (key, _, _) in TRAIN_KERNELS.items()}
    assert counts == expect, (counts, expect)
    assert fa.LAST_DISPATCH["impl"] == "cuda" and xl.LAST_DISPATCH["impl"] == "cuda"
    losses = [x.item() for x in losses]
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], losses
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = [s.elapsed_time(e) for s, e in events]
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
                    if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
             for name in SOURCES}
    emit({"phase": "build", "seconds": time.monotonic() - t0, "nvcc_s": nvcc_s,
          "ptxas": ptxas})

    errs, head_rel = phase_parity(dev)
    emit({"phase": "kernel_parity", "card": card, "max_abs_err": errs,
          "max_head_rel_err": head_rel, "f32_tol": [F32_RTOL, F32_ATOL],
          "bf16_max_abs": BF16_MAX_ABS, "bf16_head_rel": BF16_HEAD_REL})
    timing = phase_timing(dev)
    emit({"phase": "kernel_timing", "card": card, "shape": "B=8 len=1024 H=Hkv=32 D=128 bs=64",
          **timing})
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

    t0 = time.monotonic()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tfm.init_params(tfm.LLAMA2_7B, gen)
    torch.cuda.synchronize()
    emit({"phase": "init", "model": "llama2-7b", "seconds": time.monotonic() - t0,
          "param_gb": sum(t.numel() * t.element_size() for t in
                          [params["embed"], params["lm_head"], params["final_norm"]]
                          + [v for layer in params["layers"] for v in layer.values()]) / 1e9})
    engine_line, engine = phase_engine(params, dev, card)
    emit(engine_line)
    try:
        emit(phase_http(engine, card))
    finally:
        engine.stop()
    del engine
    torch.cuda.empty_cache()
    int8_line = phase_engine_int8(params, dev, card)
    emit(int8_line)

    kernels = []
    for variant, line in (("bf16", engine_line), ("int8", int8_line)):
        t = timing[variant]
        pool = "float" if variant == "bf16" else "int8"
        kernels.append({
            "name": f"paged_decode[{variant} pool]",
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": KERNEL_REPLACES,
            "launches": line["launches"],
            "max_abs_err": max(errs[f"mha/bfloat16/{pool}"], errs[f"gqa/bfloat16/{pool}"]),
            "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
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
        if key in ("bwd_dq", "bwd_dkv"):
            # one SDPA backward computes dq, dk and dv: no library call
            # computes either kernel's part alone
            entry["library_ms"] = train_timing["bwd_pair"]["library_ms"]
            entry["library_covers"] = "dq, dk and dv together (SDPA backward)"
        kernels.append(entry)
    emit({"phase": "done", "seconds": time.monotonic() - t_start, "card": card})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
