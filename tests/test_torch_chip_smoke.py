"""chip_smoke.py's bookkeeping, on the CPU: which kind each profiled
kernel counts under, the flash kernels' work and rates, and that it
builds every CUDA source of the port. The script itself runs on the card
(``python3 chip_smoke.py``); these are the parts a reader takes on trust
from its output."""

import pytest

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
