"""The split design of the paged-decode kernel, on the CPU.

The kernel (``csrc/paged_decode.cu``) cuts each row's live blocks into
``plan_splits(...).n_split`` runs (``split_range``), reduces each run to
f32 partials (running max m, sum l, unnormalised acc) and merges them in
split order. Here the planner is held to its contract (shapes alone,
every table column once, one split where the grid already fills the
card), and a plain PyTorch emulation of that arithmetic — partials per
split, merged in order — is held to the JAX package's
``paged_decode_reference`` and its Pallas kernel in interpret mode (as
tests/test_torch_paged_attention.py runs it) on live rows, at the float32
tolerances the JAX package holds its own kernel to (``rtol=2e-4,
atol=2e-5``); a dead row must come out as zeros. The kernel itself is
held to the plain version on the card by tests/test_torch_kernels_cuda.py.
"""

import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devspace_tpu.ops import paged_attention as jpa
from devspace_tpu_torch.ops import paged_attention as tpa

RTOL, ATOL = 2e-4, 2e-5
BS, MB, D = 8, 8, 16
# 1; on and beside the split edges of a full 8-block table cut in 4
# (blocks 2, 4, 6: positions 16, 32, 48) and of a 3-block row; the full
# table; a dead row
LENGTHS = [1, 15, 16, 17, 33, 47, 48, 49, MB * BS, 0]


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("DEVSPACE_PALLAS_INTERPRET", "1")


def split_emulation(q, pool_k, pool_v, tables, lengths, n_split, k_scale=None, v_scale=None):
    """The kernel's arithmetic in plain PyTorch: per (row, head) and split,
    the partials (m, l, acc) over the split's live positions, then one
    merge in split order; a row with no live position gives zeros."""
    b, h, d = q.shape
    _, hkv, bs, _ = pool_k.shape
    n_rep = h // hkv
    n = pool_k.shape[0]
    out = torch.zeros(b, h, d, dtype=torch.float32)
    for row in range(b):
        length = max(0, min(int(lengths[row]), tables.shape[1] * bs))
        n_blk = -(-length // bs)
        for head in range(h):
            hk = head // n_rep
            parts = []
            for s in range(n_split):
                j0, j1 = tpa.split_range(s, n_blk, n_split)
                if j1 == j0:
                    continue
                blocks = tables[row, j0:j1].long().clamp(0, n - 1)
                keys, vals = pool_k[blocks, hk], pool_v[blocks, hk]  # [j, bs, D]
                if k_scale is not None:
                    keys = tpa.dequantize_kv(keys, k_scale[blocks, hk], q.dtype)
                    vals = tpa.dequantize_kv(vals, v_scale[blocks, hk], q.dtype)
                keys = keys.reshape(-1, d).float()[: length - j0 * bs]
                vals = vals.reshape(-1, d).float()[: length - j0 * bs]
                scores = keys @ q[row, head].float() / math.sqrt(d)
                m = scores.max()
                p = torch.exp(scores - m)
                parts.append((m, p.sum(), p @ vals))
            if not parts:
                continue
            mx = max(m for m, _, _ in parts)
            total = sum(l * torch.exp(m - mx) for m, l, _ in parts)
            acc = sum(a * torch.exp(m - mx) for m, _, a in parts)
            out[row, head] = acc / total
    return out.to(q.dtype)


def make_inputs(seed, h, hkv, lengths=LENGTHS, int8=False):
    rng = np.random.default_rng(seed)
    b, n_blocks = len(lengths), 1 + len(lengths) * MB
    q = rng.normal(size=(b, h, D)).astype(np.float32)
    pool_k = rng.normal(size=(n_blocks, hkv, BS, D)).astype(np.float32)
    pool_v = rng.normal(size=(n_blocks, hkv, BS, D)).astype(np.float32)
    tables = (1 + rng.permutation(b * MB)).reshape(b, MB).astype(np.int32)
    tables[-1, 0] = n_blocks + 5  # out of range: clamped to the last block
    arrays = [q, pool_k, pool_v, tables, np.asarray(lengths, np.int32)]
    if int8:
        pk, ks = jpa.quantize_kv(jnp.asarray(pool_k))
        pv, vs = jpa.quantize_kv(jnp.asarray(pool_v))
        arrays[1:3] = [np.asarray(pk), np.asarray(pv)]
        arrays += [np.asarray(ks), np.asarray(vs)]
    return arrays


def test_planner_reads_shapes_only():
    params = list(inspect.signature(tpa.plan_splits).parameters)
    assert "lengths" not in params and "tables" not in params
    args = (8, 32, 16, 64, 128, 2, False)
    assert tpa.plan_splits(*args) == tpa.plan_splits(*args)
    assert all(isinstance(v, int) for v in tpa.plan_splits(*args))


@pytest.mark.parametrize("shape", [
    (8, 32, 16, 64, 128, 2, False),  # a Llama-2-7B decode step, context 1024
    (8, 32, 32, 64, 128, 2, False),  # the engine's table width (max_len 2048)
    (1, 32, 64, 64, 128, 2, False),  # one row at context 4096
    (8, 32, 16, 64, 128, 1, True),   # int8 pool
    (4, 2, 3, 8, 16, 4, False),      # GQA, a short f32 table
    (6, 8, 13, 16, 64, 2, False),    # uneven runs
], ids=["7b-ctx1024", "engine-mb32", "b1-ctx4096", "int8", "gqa-f32", "gqa-uneven"])
def test_every_table_column_is_walked_once(shape):
    """For every row length the table allows, the splits' runs tile the
    row's live blocks [0, n_blk) in order, each column exactly once."""
    plan = tpa.plan_splits(*shape)
    mb = shape[2]
    assert plan.n_split >= 1 and 1 <= plan.stages <= tpa.MAX_STAGES
    assert plan.n_split == 1 or mb // plan.n_split >= tpa.MIN_SPLIT_TILES
    for n_blk in range(mb + 1):
        runs = [tpa.split_range(s, n_blk, plan.n_split) for s in range(plan.n_split)]
        cols = [j for j0, j1 in runs for j in range(j0, j1)]
        assert cols == list(range(n_blk))
        assert max(j1 - j0 for j0, j1 in runs) - min(j1 - j0 for j0, j1 in runs) <= 1


def test_planner_splits_where_rows_are_few_and_long():
    # the card's 132 SMs want one bf16 block each in flight (a 64 KB ring),
    # two int8 ones (50 KB rings): one row at Llama-2-7B widths is 32
    # blocks a split
    assert tpa.plan_splits(1, 32, 64, 64, 128, 2, False).n_split == 4
    assert tpa.plan_splits(1, 32, 64, 64, 128, 1, True).n_split == 8
    assert tpa.plan_splits(2, 32, 64, 64, 128, 2, False).n_split == 2
    assert tpa.plan_splits(4, 32, 64, 64, 128, 1, True).n_split == 2
    assert tpa.plan_splits(1, 8, 64, 64, 128, 2, False).n_split == 16  # GQA: 8 KV heads
    # the grid already fills the card: one split
    assert tpa.plan_splits(4, 32, 64, 64, 128, 2, False).n_split == 1
    assert tpa.plan_splits(8, 32, 16, 64, 128, 2, False).n_split == 1  # a 7B decode step
    assert tpa.plan_splits(8, 32, 16, 64, 128, 1, True).n_split == 1
    assert tpa.plan_splits(8, 32, 32, 64, 128, 2, False).n_split == 1  # the engine's tables
    assert tpa.plan_splits(40, 8, 16, 64, 128, 2, False).n_split == 1  # verify rows
    # a one-block table cannot be split
    assert tpa.plan_splits(1, 1, 1, 64, 128, 2, False).n_split == 1
    # a bf16 tile pair of 32 KB: two ring stages; an int8 one (16.5 KB): three
    assert tpa.plan_splits(8, 32, 16, 64, 128, 2, False).stages == 2
    assert tpa.plan_splits(8, 32, 16, 64, 128, 1, True).stages == 3


def test_scratch_holds_every_split_partial():
    plan = tpa.SplitPlan(n_split=3, stages=3)
    assert tpa.scratch_floats(plan, 8, 32, 128) == 3 * 8 * 32 * (128 + 2)
    assert tpa.scratch_floats(tpa.SplitPlan(1, 3), 8, 32, 128) == 0


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("heads", [(4, 4), (8, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("sms", [2, 4, 132])
def test_split_emulation_matches_jax(pallas_interpret, int8, heads, sms):
    h, hkv = heads
    arrays = make_inputs(7 if int8 else 6, h, hkv, int8=int8)
    t = [torch.from_numpy(np.array(a)) for a in arrays]
    scales = t[5:] if int8 else []
    plan = tpa.plan_splits(len(LENGTHS), hkv, MB, BS, D, 1 if int8 else 4, int8, sms)
    got = split_emulation(*t[:5], plan.n_split, *scales).numpy()
    jargs = [jnp.asarray(a) for a in arrays]
    ref = np.asarray(jpa.paged_decode_reference(*jargs))
    pallas = np.asarray(jpa._paged_decode_pallas(*jargs))
    live = np.asarray(LENGTHS) > 0
    np.testing.assert_allclose(got[live], ref[live], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[live], pallas[live], rtol=RTOL, atol=ATOL)
    assert (got[~live] == 0).all()
    # and with the port's own plain version, which the card holds the kernel to
    plain = tpa.paged_decode_attention(*t[:5], *scales).numpy()
    np.testing.assert_allclose(got[live], plain[live], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n_split", [1, 2, 3, 4, 8])
def test_split_count_does_not_change_the_result(n_split):
    """Any cut of the cache merges to the same attention (an uneven 3 and
    more splits than a short row has blocks included)."""
    t = [torch.from_numpy(np.array(a)) for a in make_inputs(8, 8, 2)]
    got = split_emulation(*t[:5], n_split)
    ref = split_emulation(*t[:5], 1)
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
