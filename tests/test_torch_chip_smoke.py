"""chip_smoke.py's bookkeeping, on the CPU: which kind each profiled
kernel counts under, the flash kernels' work and rates, and that it
builds every CUDA source of the port; and a rehearsal of the kv_tier
phase's control flow at TINY. The script itself runs on the card
(``python3 chip_smoke.py``); these are the parts a reader takes on trust
from its output."""

import json

import pytest
import torch

import chip_smoke as cs
from devspace_tpu_torch.ops import _build


@pytest.mark.parametrize("name, kind", [
    # the backward kernels' symbols contain "sm90_", which also marks
    # cuBLAS's matrix products: they must count as flash kernels
    ("void (anonymous namespace)::flash_bwd_dkv_sm90_kernel<64>(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, float const*, int, int)", "flash_bwd_dkv"),
    ("void (anonymous namespace)::flash_bwd_dq_sm90_kernel<128>(__nv_bfloat16 const*, int, int)",
     "flash_bwd_dq"),
    ("void (anonymous namespace)::flash_bwd_dq_f32_kernel<16>(float const*, int, int)",
     "flash_bwd_dq"),
    ("void (anonymous namespace)::flash_bwd_dkv_f32_kernel<32>(float const*, int, int)",
     "flash_bwd_dkv"),
    ("void (anonymous namespace)::flash_fwd_kernel<float, 64>(float const*, int, int)",
     "flash_fwd"),
    ("void (anonymous namespace)::flash_fwd_sm90_kernel<64>(__nv_bfloat16 const*, "
     "__nv_bfloat16*, float*, int, int, int)", "flash_fwd"),
    # short attention: the one-pass and two-pass bf16 kernels (the latter
    # with "sm90_" in its name) and the f32 one
    ("void (anonymous namespace)::attention_fwd_onepass_kernel<128, 128>(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, int, int)", "short_attention"),
    ("void (anonymous namespace)::attention_fwd_sm90_kernel<64>(__nv_bfloat16 const*, "
     "__nv_bfloat16*, int, int, int)", "short_attention"),
    ("void (anonymous namespace)::attention_fwd_kernel<float, 128>(float const*, int, int)",
     "short_attention"),
    ("void (anonymous namespace)::xent_kernel<float>(float const*, long const*, float*, int)",
     "cross_entropy"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1",
     "matmul"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_TNT", "matmul"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>(int)",
     "other"),
])
def test_kernel_kind(name, kind):
    assert cs.kernel_kind(name) == kind


def test_flash_rates_count_work_and_the_split():
    """The work is flash_bound's (6 D per live pair for dq, 8 D for
    dk/dv); the dk/dv kernel issues 12 D on the tensor cores."""
    bh, t, d = cs.FLASH_SHAPES["bench"]
    pairs = t * (t + 1) // 2
    for kernel, work_d, tensor_d in (("fwd", 4, 4), ("bwd_dq", 6, 6), ("bwd_dkv", 8, 12)):
        bound_ms, _ = cs.flash_bound(kernel, bh, t, d, True, 2)
        r = cs.flash_rates(kernel, bh, t, d, True, 2.0, bound_ms)
        assert r["gflop"] == pytest.approx(bh * pairs * d * work_d / 1e9)
        assert r["tensor_gflop"] == pytest.approx(bh * pairs * d * tensor_d / 1e9)
        assert r["tflops"] == pytest.approx(r["gflop"] / 2.0)
        assert r["tensor_tflops"] == pytest.approx(r["tensor_gflop"] / 2.0)
        assert r["bound_share"] == pytest.approx(bound_ms / 2.0)
        # the bound is the work at the dense bf16 peak (operations bound)
        assert bound_ms == pytest.approx(r["gflop"] * 1e9 / cs.BF16_FLOPS_PER_S * 1e3)


def test_builds_every_source_and_names_the_backward_source():
    assert set(cs.SOURCES) == {p.stem for p in _build.CSRC_DIR.glob("*.cu")}
    for name, (_, source, _) in cs.TRAIN_KERNELS.items():
        assert (_build.PACKAGE_DIR.parent / source).exists(), name
    assert cs.TRAIN_KERNELS["flash_bwd_dq"][1].endswith("csrc/flash_backward.cu")
    assert cs.TRAIN_KERNELS["flash_bwd_dkv"][1].endswith("csrc/flash_backward.cu")


def test_every_header_reaches_a_built_source():
    """Each csrc/*.cuh is included by a source that chip_smoke.py builds;
    the streaming forward's header by both attention sources, and the
    Hopper helpers by it and by the backward."""
    sources = {name: (_build.CSRC_DIR / f"{name}.cu").read_text() for name in cs.SOURCES}
    headers = {p.name for p in _build.CSRC_DIR.glob("*.cuh")}
    included = {h: {n for n, text in sources.items() if f'#include "{h}"' in text} for h in headers}
    assert all(included[h] for h in headers), included
    assert included["attention_fwd.cuh"] == {"flash_attention", "attention"}
    assert '#include "hopper.cuh"' in (_build.CSRC_DIR / "attention_fwd.cuh").read_text()
    assert "flash_backward" in included["hopper.cuh"]


def test_attention_bound_is_bytes_at_the_main_paths_shapes():
    """Short attention at the target's training shape and at the draft's
    500-token prefill moves 8 D bytes a row, which bound it (causal, T <=
    1024)."""
    for bh, t, d in (cs.ATTN_TRAIN_SHAPES["target"], cs.ATTN_PREFILL_SHAPE):
        bound_ms, by = cs.attention_bound(bh, t, d)
        assert by == "bytes"
        assert bound_ms == pytest.approx(4 * bh * t * d * 2 / cs.HBM_BYTES_PER_S * 1e3)


# -- a CPU rehearsal of the kv_tier phase -------------------------------------
TINY_KV_TIER = {"max_slots": 2, "max_len": 128, "block_size": 8, "n_blocks": 17,
                "tier_bytes": 1 << 20, "shared": 32, "distinct": 64, "tail": 8, "new_tokens": 16}


def test_kv_tier_phase_rehearsed_on_the_cpu(monkeypatch):
    """The kv_tier phase's control flow and checks at TINY on the CPU
    (the waves scaled with the pool: the shared chain is 4 blocks): the
    paged-decode calls a replay would launch are counted by a stand-in,
    ``prewarm_engine`` builds without the card's launch accounting, and
    the bf16 tie bound only has to admit this TINY's own rounding."""
    from devspace_tpu_torch.inference import graphs
    from devspace_tpu_torch.models import transformer as tfm

    calls = [0]
    real_attention, real_run = tfm.paged_decode_attention, graphs.ProgramTable.run

    def counting_attention(*args, **kwargs):
        calls[0] += 1
        return real_attention(*args, **kwargs)

    def counting_run(self, key):
        before = calls[0]
        real_run(self, key)
        self.paged_decode_launches += calls[0] - before

    def cpu_prewarm(engine):
        engine.prewarm()
        return {"captures": engine.stats()["graph_captures"]}

    monkeypatch.setattr(tfm, "paged_decode_attention", counting_attention)
    monkeypatch.setattr(graphs.ProgramTable, "run", counting_run)
    monkeypatch.setattr(cs, "prewarm_engine", cpu_prewarm)
    params = tfm.init_params(tfm.TINY, torch.Generator().manual_seed(0))
    line = cs.phase_kv_tier(params, torch.device("cpu"), "cpu", tie_bound=0.5, cfg=tfm.TINY,
                            sizes=TINY_KV_TIER, model="tiny")
    assert line["phase"] == "kv_tier" and line["waves"] == [32, 64, 64, 40]
    for pool in ("bf16", "int8"):
        got = line[pool]
        assert got["restore_hits"] == 4 and got["recompute_tokens_saved"] == 32
        assert got["kv_spill_blocks"] > 0 and got["kv_restore_fallbacks"] == 0
        assert got["wave4_paged_decode_launches"] == tfm.TINY.n_layers * 15
        assert got["launches"] > got["wave4_paged_decode_launches"]
    assert line["int8"]["wave4_equal_tokens"] == 16
    assert line["migration"]["blocks"] == 4 and line["migration"]["envelope_bytes"] > 0
    json.dumps(line)  # one JSON line
