"""The Hopper kernels against their plain PyTorch versions, on the card:
paged decode, flash attention (forward, backward dq, backward dk/dv), the
fused cross-entropy, short-sequence attention and RMSNorm. Imports no JAX (the machine with the card has
none); skips where there is no CUDA device. Run on the card with

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: float32 ``rtol=2e-4, atol=2e-5`` (tests/test_models_ops.py
holds the Pallas kernel to the same); bfloat16 max abs error <= 2e-2 on
unit-normal inputs and, per live (row, head), a max error of at most
1e-2 of that head's largest output (both accumulate in float32; outputs
round to bf16, so they differ by about one bf16 ulp). Live rows only;
dead rows (length 0) must be exactly zero. Flash attention: float32
(TF32 off) the same ``rtol=2e-4, atol=2e-5`` on O, lse, dq, dk and dv;
bfloat16 per (batch·head) a max error of at most 1e-2 of that head's
largest reference value (both round P for P·V and dS for dS·K to bf16
and the outputs to bf16, about one bf16 ulp apart). Cross-entropy: both
compute in float32 from the same values, ``rtol=1e-5, atol=1e-5``.
Short-sequence attention is held like flash attention's O (its bf16
kernel rounds the normalised P to bf16 for P·V where the plain version
keeps it in float32: within the same per-head bound); RMSNorm states its
own tolerances.
"""

import numpy as np
import pytest
import torch

from devspace_tpu_torch.ops import attention as tattn
from devspace_tpu_torch.ops import flash_attention as tfa
from devspace_tpu_torch.ops import losses as tlosses
from devspace_tpu_torch.ops import normalization as tnorm
from devspace_tpu_torch.ops import paged_attention as tpa

RTOL, ATOL = 2e-4, 2e-5
BF16_MAX_ABS, BF16_HEAD_REL = 2e-2, 1e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def make_inputs(seed, B, H, Hkv, D, n_blocks, bs, MB):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    pool_k = rng.normal(size=(n_blocks, Hkv, bs, D)).astype(np.float32)
    pool_v = rng.normal(size=(n_blocks, Hkv, bs, D)).astype(np.float32)
    tables = rng.integers(0, n_blocks, size=(B, MB)).astype(np.int32)
    return q, pool_k, pool_v, tables


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("shape", [(8, 2, 16, 8), (32, 32, 128, 64), (32, 8, 128, 64)],
                         ids=["small-gqa", "7b-mha", "gqa-128"])
def test_cuda_kernel_matches_plain_version(cuda_device, dtype, int8, shape):
    H, Hkv, D, bs = shape
    MB = 5
    q, pk, pv, tables = make_inputs(7, B=4, H=H, Hkv=Hkv, D=D, bs=bs, n_blocks=12, MB=MB)
    lengths = np.asarray([MB * bs, 2 * bs + 5, 1, 0], np.int32)
    dev = cuda_device
    tq = torch.from_numpy(q).to(dev, dtype)
    if int8:
        pk8, ks = tpa.quantize_kv(torch.from_numpy(pk))
        pv8, vs = tpa.quantize_kv(torch.from_numpy(pv))
        pools = [t.to(dev) for t in (pk8, pv8)]
        scales = [t.to(dev) for t in (ks, vs)]
    else:
        pools = [torch.from_numpy(a).to(dev, dtype) for a in (pk, pv)]
        scales = [None, None]
    tt, tl = torch.from_numpy(tables).to(dev), torch.from_numpy(lengths).to(dev)
    before = tpa.LAUNCHES
    got = tpa.paged_decode_attention(tq, *pools, tt, tl, *scales)
    torch.cuda.synchronize()
    assert tpa.LAUNCHES == before + 1 and tpa.LAST_DISPATCH["impl"] == "cuda"
    ref = tpa.paged_decode_reference(tq, *pools, tt, tl, *scales)
    live = torch.from_numpy(lengths > 0).to(dev)
    if dtype == torch.float32:
        torch.testing.assert_close(got[live], ref[live], rtol=RTOL, atol=ATOL)
    else:
        diff = (got[live].float() - ref[live].float()).abs()
        assert diff.max().item() <= BF16_MAX_ABS
        head_max = ref[live].float().abs().amax(-1)
        assert (diff.amax(-1) <= BF16_HEAD_REL * head_max).all()
    assert (got[~live] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_cuda_kernel_matches_plain_version_on_verify_rows(cuda_device, dtype, int8):
    """The flat [B*K] rows of a speculative verification block: 8 slots x
    5 rows, H = Hkv = 8, D = 128, each slot's table repeated for its
    rows, row (b, j) of length pos_b + j + 1; parked slots have a zeroed
    table and lengths 1..5."""
    B, K, H, D, bs, MB = 8, 5, 8, 128, 64, 16
    q, pk, pv, _ = make_inputs(11, B=B * K, H=H, Hkv=H, D=D, bs=bs, n_blocks=1 + B * MB, MB=MB)
    rng = np.random.default_rng(12)
    tables = (1 + rng.permutation(B * MB)).reshape(B, MB).astype(np.int32)
    pos = np.asarray([8, 64, 250, 563, 0, 1, 1019, 0])
    parked = np.asarray([False, False, False, False, True, False, False, True])
    tables[parked] = 0
    lengths = (pos[:, None] + np.arange(K)[None] + 1).reshape(-1).astype(np.int32)
    dev = cuda_device
    tq = torch.from_numpy(q).to(dev, dtype)
    if int8:
        pk8, ks = tpa.quantize_kv(torch.from_numpy(pk))
        pv8, vs = tpa.quantize_kv(torch.from_numpy(pv))
        pools = [t.to(dev) for t in (pk8, pv8)]
        scales = [t.to(dev) for t in (ks, vs)]
    else:
        pools = [torch.from_numpy(a).to(dev, dtype) for a in (pk, pv)]
        scales = [None, None]
    tt = torch.from_numpy(tables).to(dev).repeat_interleave(K, dim=0).contiguous()
    tl = torch.from_numpy(lengths).to(dev)
    before = tpa.LAUNCHES
    got = tpa.paged_decode_attention(tq, *pools, tt, tl, *scales)
    torch.cuda.synchronize()
    assert tpa.LAUNCHES == before + 1 and tpa.LAST_DISPATCH["impl"] == "cuda"
    ref = tpa.paged_decode_reference(tq, *pools, tt, tl, *scales)
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
    else:
        diff = (got.float() - ref.float()).abs()
        assert diff.max().item() <= BF16_MAX_ABS
        assert (diff.amax(-1) <= BF16_HEAD_REL * ref.float().abs().amax(-1)).all()


# the split kernel's cases: (B, H, Hkv, MB, lengths) at D = 128, block 64
SPLIT_CASES = {
    # one row at context 4096: the planner cuts its 64 blocks over many blocks
    "b1-ctx4096": (1, 32, 32, 64, [4096]),
    # the engine's table width (max_len 2048 / 64) at context 1024
    "b8-mb32-ctx1024": (8, 32, 32, 32, [1024] * 8),
    # lengths on and beside tile and split edges, a full table, a dead row;
    # GQA with 8 query heads a KV head
    "edges-gqa": (10, 32, 4, 64, [1, 63, 64, 65, 1023, 1024, 1025, 4095, 4096, 0]),
}


def split_inputs(case, dtype, int8, dev, seed=31):
    """q, pools and distinct tables of one SPLIT_CASES entry on the card."""
    B, H, Hkv, MB, lengths = SPLIT_CASES[case]
    D, bs = 128, 64
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(B, H, D)).astype(np.float32)).to(dev, dtype)
    pk, pv = [torch.from_numpy(rng.normal(size=(1 + B * MB, Hkv, bs, D)).astype(np.float32))
              for _ in range(2)]
    if int8:
        (pk, ks), (pv, vs) = tpa.quantize_kv(pk), tpa.quantize_kv(pv)
        scales = [ks.to(dev), vs.to(dev)]
    else:
        pk, pv = pk.to(dtype), pv.to(dtype)
        scales = [None, None]
    tables = torch.from_numpy((1 + rng.permutation(B * MB)).reshape(B, MB).astype(np.int32))
    lengths = torch.tensor(lengths, dtype=torch.int32)
    return [q, pk.to(dev), pv.to(dev), tables.to(dev), lengths.to(dev), *scales]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_cuda_split_kernel_matches_plain_version(cuda_device, dtype, int8, case):
    """Rows cut over several blocks (split-K) and merged by the combine
    pass, against the plain version: live rows within the tolerances
    above, dead rows exactly zero."""
    args = split_inputs(case, dtype, int8, cuda_device)
    q, pk, tables = args[0], args[1], args[3]
    plan = tpa.plan_splits(q.shape[0], pk.shape[1], tables.shape[1], 64, 128, pk.element_size(),
                           int8, torch.cuda.get_device_properties(0).multi_processor_count)
    # few rows split; eight rows of 32 heads already fill the card
    assert plan.n_split == 1 if case.startswith("b8") else plan.n_split > 1
    before = tpa.LAUNCHES
    got = tpa.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert tpa.LAUNCHES == before + 1 and tpa.LAST_DISPATCH["impl"] == "cuda"
    ref = tpa.paged_decode_reference(*args)
    live = args[4] > 0
    if dtype == torch.float32:
        torch.testing.assert_close(got[live], ref[live], rtol=RTOL, atol=ATOL)
    else:
        diff = (got[live].float() - ref[live].float()).abs()
        assert diff.max().item() <= BF16_MAX_ABS
        assert (diff.amax(-1) <= BF16_HEAD_REL * ref[live].float().abs().amax(-1)).all()
    assert (got[~live] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("n_split", [1, 2, 3, 5, 16, 64])
def test_cuda_any_split_count_matches_plain_version(cuda_device, int8, n_split):
    """The kernel's C entry point at split counts the planner would not
    pick for these rows (lengths on and beside tile and split edges, a
    dead row, GQA): as many splits as the longest row has blocks, an
    uneven 3 and 5, more splits than most rows have blocks."""
    q, pk, pv, tables, lengths, ks, vs = split_inputs("edges-gqa", torch.bfloat16, int8,
                                                      cuda_device)
    B, H, D = q.shape
    _, Hkv, bs, _ = pk.shape
    plan = tpa.plan_splits(B, Hkv, tables.shape[1], bs, D, pk.element_size(), int8)
    plan = plan._replace(n_split=n_split)
    scratch = torch.empty(max(1, tpa.scratch_floats(plan, B, H, D)), device=cuda_device)
    out = torch.empty_like(q)
    err = tpa._kernel()(
        1, int(int8), q.data_ptr(), pk.data_ptr(), pv.data_ptr(),
        ks.data_ptr() if int8 else None, vs.data_ptr() if int8 else None,
        tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, H, Hkv, D, bs,
        tables.shape[1], pk.shape[0], plan.n_split, plan.stages, scratch.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    ref = tpa.paged_decode_reference(q, pk, pv, tables, lengths, ks, vs)
    live = lengths > 0
    diff = (out[live].float() - ref[live].float()).abs()
    assert diff.max().item() <= BF16_MAX_ABS
    assert (diff.amax(-1) <= BF16_HEAD_REL * ref[live].float().abs().amax(-1)).all()
    assert (out[~live] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_cuda_paged_decode_repeats_bitwise(cuda_device, int8, case):
    """The splits merge in a fixed order (no atomics): two launches agree
    bit for bit."""
    args = split_inputs(case, torch.bfloat16, int8, cuda_device)
    a = tpa.paged_decode_attention(*args)
    b = tpa.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["b1-ctx4096", "edges-gqa"])
def test_cuda_paged_decode_graph_replay_is_the_eager_launch(cuda_device, case):
    """Captured in a CUDA graph (the split count comes from shapes, the
    lengths are read on the card) and replayed: bit for bit the eager
    launch, also after the lengths change in place."""
    args = split_inputs(case, torch.bfloat16, False, cuda_device)
    eager = tpa.paged_decode_attention(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tpa.paged_decode_attention(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = tpa.paged_decode_attention(*args)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)
    lengths = args[4]
    lengths.copy_(torch.clamp(lengths - 100, min=0))
    graph.replay()
    again = tpa.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(captured, again)
    assert not torch.equal(captured, eager)


@pytest.mark.cuda
def test_cuda_empty_batch_launches_nothing(cuda_device):
    q, pk, pv, tables = make_inputs(3, B=2, H=4, Hkv=4, D=16, bs=8, n_blocks=4, MB=2)
    dev = cuda_device
    t = [torch.from_numpy(a).to(dev) for a in (q[:0], pk, pv, tables[:0])]
    lengths = torch.zeros(0, dtype=torch.int32, device=dev)
    before = tpa.LAUNCHES
    out = tpa.paged_decode_attention(t[0], t[1], t[2], t[3], lengths)
    assert out.shape == (0, 4, 16) and tpa.LAUNCHES == before


def assert_kernel_close(got, ref, name):
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL, msg=name)
        return
    diff = (got.float() - ref.float()).abs().flatten(1).amax(-1)
    head_max = ref.float().abs().flatten(1).amax(-1)
    assert (diff <= BF16_HEAD_REL * head_max).all(), (name, (diff / head_max).max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("T", [256, 129, 200, 1000, 2048 - 37],
                         ids=["T256", "T129-ragged", "T200-ragged", "T1000-ragged", "T2011-ragged"])
def test_cuda_flash_kernels_match_plain_versions(cuda_device, dtype, causal, D, T):
    """T = 1000 and 2011 span many of the kernels' tiles (128 rows a
    block, 128, 64 or 32 a ring stage) and end ragged in all three;
    T = 129 is one forward block and k-tile plus one row."""
    rng = np.random.default_rng(11)
    q, k, v, do = [torch.from_numpy(rng.normal(size=(6, T, D)).astype(np.float32))
                   .to(cuda_device, dtype) for _ in range(4)]
    before = dict(tfa.LAUNCHES)
    o, lse = tfa.flash_fwd(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1)
    dq = tfa.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert tfa.LAST_DISPATCH["impl"] == "cuda"
    assert tfa.LAUNCHES == {key: n + 1 for key, n in before.items()}
    ro, rlse = tfa.flash_fwd_reference(q, k, v, causal)
    assert_kernel_close(o, ro, "o")
    torch.testing.assert_close(lse, rlse, rtol=RTOL, atol=1e-4 if dtype == torch.bfloat16 else ATOL)
    # the backward kernels from the kernel's own residuals
    assert_kernel_close(dq, tfa.flash_bwd_dq_reference(q, k, v, do, lse, delta, causal), "dq")
    rdk, rdv = tfa.flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal)
    assert_kernel_close(dk, rdk, "dk")
    assert_kernel_close(dv, rdv, "dv")


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_cuda_flash_backward_kernels_repeat_bitwise_at_bench_shape(cuda_device, causal):
    """dq, dk and dv straight from the two backward kernels at the bench
    LM's shape ([B*H = 128, T = 2048, D = 64], bf16): each block owns its
    output rows (no atomics), so two launches agree bit for bit."""
    rng = np.random.default_rng(13)
    q, k, v, do = [torch.from_numpy(rng.normal(size=(128, 2048, 64)).astype(np.float32))
                   .to(cuda_device, torch.bfloat16) for _ in range(4)]
    o, lse = tfa.flash_fwd(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1)
    runs = [(tfa.flash_bwd_dq(q, k, v, do, lse, delta, causal),
             *tfa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)) for _ in range(2)]
    torch.cuda.synchronize()
    assert tfa.LAST_DISPATCH["impl"] == "cuda"
    for name, a, b in zip(("dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_cuda_flash_forward_repeats_bitwise_at_bench_shape(cuda_device, causal):
    """O and lse straight from the forward kernel at the bench LM's shape
    ([B*H = 128, T = 2048, D = 64], bf16): each block owns its output rows
    (no atomics), so two launches agree bit for bit."""
    rng = np.random.default_rng(14)
    q, k, v = [torch.from_numpy(rng.normal(size=(128, 2048, 64)).astype(np.float32))
               .to(cuda_device, torch.bfloat16) for _ in range(3)]
    runs = [tfa.flash_fwd(q, k, v, causal) for _ in range(2)]
    torch.cuda.synchronize()
    assert tfa.LAST_DISPATCH["impl"] == "cuda"
    for name, a, b in zip(("o", "lse"), *runs):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_cuda_flash_autograd_is_deterministic_and_counts(cuda_device):
    """bf16 grads through the autograd Function: every kernel owns its
    outputs (no atomics), so two runs agree bit for bit."""
    rng = np.random.default_rng(12)
    x = [torch.from_numpy(rng.normal(size=(2, 4, 1280, 64)).astype(np.float32))
         .to(cuda_device, torch.bfloat16) for _ in range(4)]
    runs = []
    for _ in range(2):
        q, k, v = [t.clone().requires_grad_() for t in x[:3]]
        before = dict(tfa.LAUNCHES)
        tattn.fused_attention(q, k, v).backward(x[3])
        torch.cuda.synchronize()
        assert tfa.LAUNCHES == {key: n + 1 for key, n in before.items()}
        runs.append([q.grad, k.grad, v.grad])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("T", [1, 7, 37, 64, 65, 127, 128, 129, 200, 255, 256, 257, 512, 768,
                               1024])
def test_cuda_short_attention_matches_plain_version(cuda_device, dtype, causal, D, T):
    """Every kind of T the route sends to the kernel: below, at and past
    the one-pass kernels' 64 and 128 keys, both sides of 256, no multiple
    of any tile (64 or 128 rows bf16, 32 f32), and the three long ones.
    The route sends T = 257 to the plain version (256 does not divide it),
    so that case calls the kernel's wrapper itself."""
    rng = np.random.default_rng(21)
    q, k, v = [torch.from_numpy(rng.normal(size=(2, 3, T, D)).astype(np.float32))
               .to(cuda_device, dtype) for _ in range(3)]
    before = tattn.LAUNCHES
    fn = tattn.attention_fwd if T == 257 else tattn.fused_attention
    got = fn(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tattn.LAUNCHES == before + 1 and tattn.LAST_DISPATCH["impl"] == "cuda"
    ref = tattn.attention_reference(q, k, v, causal)
    assert got.shape == ref.shape and got.dtype == dtype
    assert_kernel_close(got.flatten(0, 1), ref.flatten(0, 1), f"T={T} D={D}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_short_attention_grads_are_the_plain_versions(cuda_device, dtype):
    """The Function's backward differentiates the plain version on the
    saved q, k, v: the same grads as the plain version's own autograd,
    from a non-contiguous [B, T, H, D] layout as the model hands over."""
    rng = np.random.default_rng(22)
    base = [torch.from_numpy(rng.normal(size=(2, 100, 4, 64)).astype(np.float32))
            .to(cuda_device, dtype) for _ in range(4)]
    grads = []
    for fn in (tattn.fused_attention, tattn.attention_reference):
        q, k, v = [x.clone().requires_grad_() for x in base[:3]]
        out = fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True)
        out.backward(base[3].transpose(1, 2))
        grads.append([q.grad, k.grad, v.grad])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_indivisible_length_takes_the_plain_version(cuda_device):
    """T = 300 (256 does not divide it) is computed by the plain version in
    the JAX package even on a TPU, and here too: no launch."""
    q = torch.randn(1, 2, 300, 64, device=cuda_device)
    before = tattn.LAUNCHES
    out = tattn.fused_attention(q, q, q)
    assert tattn.LAUNCHES == before
    torch.testing.assert_close(out, tattn.attention_reference(q, q, q))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(4096, 1024), (512, 256), (8, 4096), (2, 3, 64), (5, 1001), (1, 7)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_rms_norm_matches_plain_version(cuda_device, dtype, shape):
    """Forward (float32 ``rtol=1e-5, atol=1e-6``: the same f32 arithmetic,
    summed in another order; bf16 within one bf16 ulp, ``rtol=2**-7``) and
    the analytic backward through the Function against autograd through
    the plain version."""
    rms_norm_case(cuda_device, dtype, shape)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(4096, 4096), (16, 1024), (16, 2048), (16, 2056), (16, 4096),
                                   (16, 1001)], ids=lambda s: "x".join(map(str, s)))
def test_cuda_rms_norm_register_widths_match_plain_version(cuda_device, dtype, shape):
    """Widths on each side of the register kernel's instances: one warp a
    row up to 256 16-byte vectors (1024 = 128 bf16 / 256 f32 vectors,
    2048 = 256 / 512), four warps beyond (2056, 4096: the 7B width,
    at 4096 rows), the first design's loop for 1001; as above."""
    rms_norm_case(cuda_device, dtype, shape)


def rms_norm_case(cuda_device, dtype, shape):
    rng = np.random.default_rng(23)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda_device, dtype)
    w = torch.from_numpy(rng.normal(size=shape[-1]).astype(np.float32)).to(cuda_device)
    g = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda_device, dtype)
    rows = x.numel() // shape[-1]
    before = tnorm.LAUNCHES
    xk, wk = x.clone().requires_grad_(), w.clone().requires_grad_()
    got = tnorm.fused_rms_norm(xk, wk, block_rows=min(256, rows))
    got.backward(g)
    torch.cuda.synchronize()
    assert tnorm.LAUNCHES == before + 1 and tnorm.LAST_DISPATCH["impl"] == "cuda"
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    ref = tnorm.rms_norm_reference(xr, wr)
    ref.backward(g)
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32 else dict(rtol=2**-7, atol=1e-6)
    torch.testing.assert_close(got.detach(), ref.detach(), **tol)
    gtol = dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else dict(rtol=2**-6, atol=2e-2)
    torch.testing.assert_close(xk.grad, xr.grad, **gtol)
    torch.testing.assert_close(wk.grad, wr.grad, rtol=1e-3 if dtype == torch.bfloat16 else 1e-4,
                               atol=1e-2 * rows**0.5 if dtype == torch.bfloat16 else 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(64, 32000), (7, 1001)], ids=["64x32000", "7x1001-unaligned"])
def test_cuda_cross_entropy_matches_plain_version(cuda_device, dtype, shape):
    b, v = shape
    rng = np.random.default_rng(13)
    logits = torch.from_numpy((3 * rng.normal(size=(b, v))).astype(np.float32)).to(cuda_device, dtype)
    labels = torch.from_numpy(rng.integers(0, v, size=b)).to(cuda_device)
    before = tlosses.LAUNCHES
    x = logits.clone().requires_grad_()
    loss = tlosses.fused_cross_entropy(x, labels)
    g = torch.from_numpy(rng.normal(size=b).astype(np.float32)).to(cuda_device)
    loss.backward(g)
    torch.cuda.synchronize()
    assert tlosses.LAUNCHES == before + 1 and tlosses.LAST_DISPATCH["impl"] == "cuda"
    ref_x = logits.clone().requires_grad_()
    ref = tlosses.cross_entropy_reference(ref_x, labels)
    ref.backward(g)
    torch.testing.assert_close(loss.detach(), ref.detach(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(x.grad.float(), ref_x.grad.float(), rtol=1e-4,
                               atol=1e-6 if dtype == torch.float32 else 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("labels", [[0, 3, 16, -1], [0, 3, -17, -20]], ids=["16,-1", "-17,-20"])
def test_cuda_cross_entropy_out_of_range_labels_match_plain_version(cuda_device, dtype, labels):
    """A label in [-V, 0) wraps to label + V, any other outside [0, V)
    gives NaN, on the kernel as on the plain version (NaN where NaN), and
    the gradients agree."""
    logits = torch.from_numpy(np.random.RandomState(0).randn(4, 16).astype(np.float32))
    logits = logits.to(cuda_device, dtype)
    labels = torch.tensor(labels, device=cuda_device)
    g = torch.arange(1, 5, dtype=torch.float32, device=cuda_device)
    before = tlosses.LAUNCHES
    x = logits.clone().requires_grad_()
    loss = tlosses.fused_cross_entropy(x, labels)
    loss.backward(g)
    torch.cuda.synchronize()
    assert tlosses.LAUNCHES == before + 1 and tlosses.LAST_DISPATCH["impl"] == "cuda"
    ref_x = logits.clone().requires_grad_()
    ref = tlosses.cross_entropy_reference(ref_x, labels)
    ref.backward(g)
    torch.testing.assert_close(loss.detach(), ref.detach(), rtol=1e-5, atol=1e-5, equal_nan=True)
    torch.testing.assert_close(x.grad.float(), ref_x.grad.float(), rtol=1e-4,
                               atol=1e-6 if dtype == torch.float32 else 1e-2)
