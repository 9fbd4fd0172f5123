#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (devspace_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA Hopper GPU
and the CUDA toolkit. It builds the port's CUDA kernels from the sources
in the checkout, holds each against its plain PyTorch version, times it,
then drives the serving path at the full width and depth of Llama-2-7B
(random weights from seed 0): the engine answers concurrent requests
with a bf16 KV pool and an int8 one, and one request goes through the
HTTP server. Each phase prints one JSON line; any failure raises and
exits non-zero. The line before the last lists the kernels; the last is
``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero and
prints no result.
"""

from __future__ import annotations

import dataclasses
import json
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
from devspace_tpu_torch.ops import paged_attention as pa

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth, dense bf16
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
# kernel vs plain version: float32 as tests/test_models_ops.py holds the
# Pallas kernel. bf16: both accumulate in f32 and round the output to
# bf16, so they differ by about one bf16 ulp (2^-8 of an element): a max
# abs error of 2e-2 on unit-normal inputs, and, per live (row, head), a
# max error of at most 1e-2 of that head's largest output — the check
# that still binds on long rows, whose outputs are ~0.03
F32_RTOL, F32_ATOL = 2e-4, 2e-5
BF16_MAX_ABS = 2e-2
BF16_HEAD_REL = 1e-2
# the one kernel of the serving path, and the TPU kernel it replaces
KERNEL_SOURCE = "devspace_tpu_torch/csrc/paged_decode.cu"
KERNEL_REPLACES = "devspace_tpu/ops/paged_attention.py:95"  # _kernel


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
    nvcc_s = _build.build("paged_decode")
    ptxas = [ln.strip() for ln in _build.BUILD_LOG.get("paged_decode", "").splitlines()
             if "registers" in ln or "spill" in ln]
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
    emit({"phase": "done", "seconds": time.monotonic() - t_start, "card": card})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
