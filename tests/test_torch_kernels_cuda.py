"""The Hopper paged-decode kernel against its plain PyTorch version, on
the card. Imports no JAX (the machine with the card has none); skips
where there is no CUDA device. Run on the card with

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: float32 ``rtol=2e-4, atol=2e-5`` (tests/test_models_ops.py
holds the Pallas kernel to the same); bfloat16 max abs error <= 2e-2 on
unit-normal inputs and, per live (row, head), a max error of at most
1e-2 of that head's largest output (both accumulate in float32; outputs
round to bf16, so they differ by about one bf16 ulp). Live rows only;
dead rows (length 0) must be exactly zero.
"""

import numpy as np
import pytest
import torch

from devspace_tpu_torch.ops import paged_attention as tpa

RTOL, ATOL = 2e-4, 2e-5
BF16_MAX_ABS, BF16_HEAD_REL = 2e-2, 1e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
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
def test_cuda_empty_batch_launches_nothing(cuda_device):
    q, pk, pv, tables = make_inputs(3, B=2, H=4, Hkv=4, D=16, bs=8, n_blocks=4, MB=2)
    dev = cuda_device
    t = [torch.from_numpy(a).to(dev) for a in (q[:0], pk, pv, tables[:0])]
    lengths = torch.zeros(0, dtype=torch.int32, device=dev)
    before = tpa.LAUNCHES
    out = tpa.paged_decode_attention(t[0], t[1], t[2], t[3], lengths)
    assert out.shape == (0, 4, 16) and tpa.LAUNCHES == before
