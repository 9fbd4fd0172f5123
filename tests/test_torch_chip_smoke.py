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
    ("void (anonymous namespace)::flash_fwd_kernel<__nv_bfloat16, 64>(__nv_bfloat16 const*, int, int)",
     "flash_fwd"),
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
