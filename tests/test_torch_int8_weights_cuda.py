"""Weight-only int8 on the card (devspace_tpu_torch/inference/quantization.py).
Imports no JAX; skips where there is no CUDA device. Run on the card with

    python -m pytest -m cuda tests/test_torch_int8_weights_cuda.py

- The card's ``QuantizedLinear`` product (bf16 ``x`` through one matrix
  product with float32 output, then the scale) against the plain
  version on the same inputs, at Llama-2-7B's decode shapes: within one
  bf16 ulp (``rtol=2**-7``; both round one float32 result once, summed in
  another order), with ``atol`` 1e-6 of the largest output for sums
  that cancel. A float32 ``x`` takes the plain version on the card:
  against the CPU's within ``rtol=1e-5, atol=1e-6`` (TF32 off).
- ``quantize_weight`` on the card makes the same ``q`` and ``scale``
  bytes as on the CPU, bf16 and float32, a zero column included.
- An engine over int8 params captures nothing after ``prewarm`` and its
  greedy streams equal ``generate`` run eagerly on the card (float32
  TINY, with and without a draft); a decode step with int8 weights
  replayed from a CUDA graph equals the same step run eagerly, bit for
  bit (bf16 TINY).
"""

import dataclasses

import pytest
import torch

from devspace_tpu_torch.inference import InferenceEngine
from devspace_tpu_torch.inference import quantization as wq
from devspace_tpu_torch.models import transformer as tfm

F32 = dataclasses.replace(tfm.TINY, dtype=torch.float32)
PROMPTS = [[5, 1, 4], [2, 9, 9, 7], list(range(1, 21))]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def weight(shape, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(shape, generator=g, device=dev) * 0.02
    w[:, 7] = 0.0
    return w.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("rows, d_in, d_out", [(8, 4096, 11008), (8, 11008, 4096),
                                               (8, 4096, 32000), (40, 1024, 2816)])
def test_card_product_matches_the_plain_version(dev, rows, d_in, d_out):
    ql = wq.quantize_weight(weight((d_in, d_out), torch.bfloat16, dev))
    x = torch.randn((rows, d_in), generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev).to(torch.bfloat16)
    got = x @ ql
    ref = wq.quantized_matmul_plain(x, ql.q, ql.scale)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    torch.testing.assert_close(got.float(), ref.float(), rtol=2.0 ** -7,
                               atol=1e-6 * ref.float().abs().max().item())
    # [B, T, D] inputs go through the same product
    got3 = x.view(2, rows // 2, d_in) @ ql
    assert torch.equal(got3.view(rows, d_out), got)


@pytest.mark.cuda
def test_card_product_in_float32_is_the_plain_version(dev):
    ql = wq.quantize_weight(weight((256, 384), torch.float32, dev))
    x = torch.randn((5, 256), generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    got = (x @ ql).cpu()
    ref = wq.quantized_matmul_plain(x.cpu(), ql.q.cpu(), ql.scale.cpu())
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_card_quantize_weight_bytes_equal_the_cpu(dev, dtype):
    w = weight((4096, 11008), dtype, dev, seed=3)
    card, cpu = wq.quantize_weight(w), wq.quantize_weight(w.cpu())
    assert torch.equal(card.q.cpu(), cpu.q)
    assert torch.equal(card.scale.cpu().view(torch.int32), cpu.scale.view(torch.int32))
    assert card.scale[7].item() == 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("draft", [False, True], ids=["plain", "draft"])
def test_int8_engine_captures_nothing_after_prewarm(dev, draft):
    params = wq.quantize_params(tfm.init_params(F32, torch.Generator(device=dev).manual_seed(0)))
    extra = dict(draft_params=params, draft_cfg=F32, spec_k=3) if draft else {}
    engine = InferenceEngine(params, F32, device=dev, max_slots=2, max_len=64, block_size=16,
                             **extra)
    engine.prewarm()
    captures = engine.stats()["graph_captures"]
    engine.start()
    try:
        got = [h.result(timeout=300) for h in [engine.submit(p, 20) for p in PROMPTS]]
        st = engine.stats()
    finally:
        engine.stop()
    assert st["graph_captures"] == captures and st["requests_failed"] == 0
    assert (st["spec_rounds"] > 0) == draft
    with torch.no_grad():
        want = [tfm.generate(params, torch.tensor([p], device=dev), F32, 20)[0].tolist()
                for p in PROMPTS]
    assert got == want


@pytest.mark.cuda
def test_int8_decode_step_replays_bit_for_bit(dev):
    cfg = tfm.TINY
    params = wq.quantize_params(tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0)))
    pool = tfm.init_paged_pool(cfg, 9, 16, None, dev)
    g = torch.Generator(device=dev).manual_seed(4)
    for t in pool.values():
        t.copy_(torch.randn(t.shape, generator=g, device=dev).to(t.dtype))
    tables = torch.arange(1, 9, dtype=torch.int32, device=dev).view(2, 4)
    tok = torch.tensor([3, 17], device=dev)
    pos = torch.tensor([20, 41], device=dev)

    def step():
        return tfm.decode_tokens_paged(params, pool, tables, tok, pos, cfg)[0]

    with torch.no_grad():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        saved = {k: v.clone() for k, v in pool.items()}
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = step()
        for k in pool:
            pool[k].copy_(saved[k])
        graph.replay()
        torch.cuda.synchronize()
        replayed = out.clone()
        for k in pool:
            pool[k].copy_(saved[k])
        eager = step()
    assert torch.equal(replayed, eager)
