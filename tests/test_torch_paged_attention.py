"""Paged-decode attention in the PyTorch port vs the JAX package.

The same numpy inputs (``np.random.default_rng``) go through
``devspace_tpu.ops.paged_attention`` (the gather reference, and the Pallas
kernel in interpret mode, as tests/test_models_ops.py runs it) and
through ``devspace_tpu_torch.ops.paged_attention``. Tolerances: float32
``rtol=2e-4, atol=2e-5``, the ones the JAX package holds its own kernel
to; int8 payloads bit-exact.

The Hopper kernel itself is held against the plain version on the card
by tests/test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devspace_tpu.ops import paged_attention as jpa
from devspace_tpu_torch import device as tdevice
from devspace_tpu_torch.ops import paged_attention as tpa

RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("DEVSPACE_PALLAS_INTERPRET", "1")


def make_inputs(seed, B=4, H=8, Hkv=2, D=16, n_blocks=9, bs=8, MB=3, lengths=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    pool_k = rng.normal(size=(n_blocks, Hkv, bs, D)).astype(np.float32)
    pool_v = rng.normal(size=(n_blocks, Hkv, bs, D)).astype(np.float32)
    tables = rng.integers(0, n_blocks, size=(B, MB)).astype(np.int32)
    if lengths is None:
        # ragged: full slot, partial block, single entry, DEAD slot
        lengths = [MB * bs, bs + 3, 1, 0]
    return q, pool_k, pool_v, tables, np.asarray(lengths, np.int32)


def quantize_np(x):
    q, s = jpa.quantize_kv(jnp.asarray(x))
    return np.asarray(q), np.asarray(s)


def test_quantize_kv_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 4, 32)).astype(np.float32) * 3.0
    x[0, 0] = 0.0  # all-zero vector: the eps floor, no NaN
    jq, js = quantize_np(x)
    tq, ts = tpa.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and tuple(ts.shape) == (5, 4)
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-7, atol=0)
    back = tpa.dequantize_kv(tq, ts, torch.float32).numpy()
    jback = np.asarray(jpa.dequantize_kv(jnp.asarray(jq), jnp.asarray(js), jnp.float32))
    np.testing.assert_allclose(back, jback, rtol=1e-7, atol=0)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("heads", [(8, 2), (8, 8)], ids=["gqa", "mha"])
def test_paged_decode_reference_matches_jax(pallas_interpret, int8, heads):
    H, Hkv = heads
    q, pk, pv, tables, lengths = make_inputs(4 if int8 else 0, H=H, Hkv=Hkv)
    scales = ()
    if int8:
        pk, ks = quantize_np(pk)
        pv, vs = quantize_np(pv)
        scales = (ks, vs)
    jargs = [jnp.asarray(a) for a in (q, pk, pv, tables, lengths, *scales)]
    targs = [torch.from_numpy(np.array(a)) for a in (q, pk, pv, tables, lengths, *scales)]
    got = tpa.paged_decode_reference(*targs).numpy()
    ref = np.asarray(jpa.paged_decode_reference(*jargs))
    # the plain versions agree on every row, dead slot included
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    # and with the Pallas kernel on live rows (the kernel zeroes dead ones)
    pallas = np.asarray(jpa._paged_decode_pallas(*jargs))
    live = lengths > 0
    np.testing.assert_allclose(got[live], pallas[live], rtol=RTOL, atol=ATOL)
    assert (pallas[~live] == 0).all()


def test_paged_decode_attention_cpu_takes_plain_version():
    before = tpa.LAUNCHES
    q, pk, pv, tables, lengths = (torch.from_numpy(a) for a in make_inputs(1))
    out = tpa.paged_decode_attention(q, pk, pv, tables, lengths)
    assert tpa.LAST_DISPATCH["impl"] == "reference"
    assert tpa.LAUNCHES == before == 0
    torch.testing.assert_close(out, tpa.paged_decode_reference(q, pk, pv, tables, lengths))


def test_empty_batch_counts_no_launch():
    # an empty batch is validated and answered without a launch, so the
    # launch count (and the dispatch record) must not move; nothing is
    # built, so this holds on a machine without nvcc
    q, pk, pv, tables, lengths = (torch.from_numpy(a) for a in make_inputs(3))
    before, impl = tpa.LAUNCHES, tpa.LAST_DISPATCH["impl"]
    out = tpa._launch_kernel(q[:0], pk, pv, tables[:0], lengths[:0], None, None)
    assert out.shape == (0, *q.shape[1:]) and out.dtype == q.dtype
    assert tpa.LAUNCHES == before and tpa.LAST_DISPATCH["impl"] == impl


def test_no_silent_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdevice.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdevice.resolve_device("cuda")
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    # meta tensors (shapes, no data) trace the plain version, as the
    # sharding preflight runs a function (ops.dispatch.on_cuda): nothing
    # is computed; a mix of devices is refused, not quietly computed
    # some other way
    cpu = [torch.from_numpy(a) for a in make_inputs(1)]
    meta = [t.to("meta") for t in cpu]
    out = tpa.paged_decode_attention(*meta)
    assert out.device.type == "meta" and out.shape == cpu[0].shape
    with pytest.raises(ValueError):
        tpa.paged_decode_attention(cpu[0], *meta[1:])
    with pytest.raises(ValueError):
        tpa.paged_decode_attention(*cpu[:-1], meta[-1])


@pytest.mark.parametrize(
    "bad, match",
    [
        (lambda a: {**a, "q": a["q"].double()}, "q dtype"),
        (lambda a: {**a, "tables": a["tables"].long()}, "int32"),
        (lambda a: {**a, "pool_v": a["pool_v"].bfloat16()}, "dtypes differ"),
        (lambda a: {**a, "q": a["q"].transpose(0, 1).contiguous().transpose(0, 1)}, "contiguous"),
        (lambda a: {**a, "pool_k": a["pool_k"][:, :, :4].contiguous()}, "shapes differ"),
    ],
    ids=["q-dtype", "tables-dtype", "pool-dtype", "layout", "pool-shape"],
)
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(bad, match):
    # validation runs before anything is built or launched
    q, pk, pv, tables, lengths = (torch.from_numpy(a) for a in make_inputs(2))
    args = bad({"q": q, "pool_k": pk, "pool_v": pv, "tables": tables, "lengths": lengths})
    with pytest.raises(ValueError, match=match):
        tpa._launch_kernel(args["q"], args["pool_k"], args["pool_v"], args["tables"],
                           args["lengths"], None, None)
