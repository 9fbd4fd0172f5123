"""chip_smoke.py's bookkeeping, on the CPU: which kind each profiled
kernel counts under, the flash kernels' work and rates, and that it
builds every CUDA source of the port; and rehearsals of the kv_tier,
int8_weights and fleet phases' control flow at TINY. The script itself runs on the card
(``python3 chip_smoke.py``); these are the parts a reader takes on trust
from its output."""

import copy
import json
import time

import numpy as np
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


def test_int8_product_shapes_are_one_7b_step():
    """The products ``int8_product_times`` sums are one Llama-2-7B decode
    step's: every matmul weight of every layer, and lm_head once."""
    from devspace_tpu_torch.inference import quantization as wq
    from devspace_tpu_torch.models import transformer as tfm

    params = tfm.init_params(tfm.LLAMA2_7B, torch.Generator(), device="meta")
    shapes = [tuple(t.shape) for layer in params["layers"] for name, t in layer.items()
              if name in wq._MATMUL_LEAVES] + [tuple(params["lm_head"].shape)]
    want = {}
    for shape in shapes:
        want[shape] = want.get(shape, 0) + 1
    assert {shape: count for shape, count in cs.INT8_PRODUCT_SHAPES.values()} == want


# -- a CPU rehearsal of the kv_tier phase -------------------------------------
TINY_KV_TIER = {"max_slots": 2, "max_len": 128, "block_size": 8, "n_blocks": 17,
                "tier_bytes": 1 << 20, "shared": 32, "distinct": 64, "tail": 8, "new_tokens": 16}


@pytest.fixture
def counting_launches(monkeypatch):
    """Stand-ins for the card's launch accounting: each paged-decode call
    a program makes is counted as a replay's launch, and
    ``prewarm_engine`` builds without the card's checks."""
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


def tiny_serving_requests(cfg):
    """serving_requests' six kinds at TINY's 128 positions: greedy at
    rows 0, 1, 3 and 4, sampled at 2, forced tokens and a stop at 5."""
    rng = np.random.default_rng(0)
    S, E = 123, 45
    return [
        (rng.integers(1, cfg.vocab_size, 7).tolist(), 32, {}),
        (rng.integers(1, cfg.vocab_size, 20).tolist(), 32, {}),
        (rng.integers(1, cfg.vocab_size, 33).tolist(), 32,
         {"temperature": 0.8, "top_p": 0.9, "seed": 7}),
        (rng.integers(1, cfg.vocab_size, 50).tolist(), 32, {}),
        (rng.integers(1, cfg.vocab_size, 70).tolist(), 32, {}),
        (rng.integers(1, cfg.vocab_size, 16).tolist(), 32,
         {"eos_id": E, "stop": [[S, S]], "min_new_tokens": 4, "logit_bias": {S: 1e4}}),
    ]


def test_int8_weights_phase_rehearsed_on_the_cpu(monkeypatch, counting_launches, tmp_path):
    """The int8_weights phase's control flow and checks at TINY on the
    CPU: the save, the byte-equal restore, q and scale made twice,
    ``build_engine(checkpoint=, quantize="int8")`` serving the smoke
    requests (sized for TINY, the forced token 123) and a steady burst
    of 4 x 24, greedy streams against the eager argmax, captures flat.
    The timings (CUDA events) are stand-ins."""
    from devspace_tpu_torch.inference import quantization as wq
    from devspace_tpu_torch.models import transformer as tfm

    tiny = tiny_serving_requests(tfm.TINY)
    monkeypatch.setattr(cs, "serving_requests", lambda cfg: tiny)
    monkeypatch.setattr(cs, "STEADY", {"requests": 4, "prompt": 8, "new_tokens": 24})
    monkeypatch.setattr(cs, "decode_step_times", lambda engine: {"graph_ms": 2.0})
    monkeypatch.setattr(cs, "int8_product_times", lambda dev: {})  # CUDA events only
    real_drive = cs.drive_engine

    def drive(engine, requests):
        run = real_drive(engine, requests)
        assert run["results"][5] == [123] * 4  # the forced token, cut by its stop
        run["results"][5] = [1234] * 4  # the 7B requests force 1234
        return run

    monkeypatch.setattr(cs, "drive_engine", drive)
    params = tfm.init_params(tfm.TINY, torch.Generator().manual_seed(0))
    line = cs.phase_int8_weights(params, torch.device("cpu"), "cpu", 1.0, str(tmp_path),
                                 cfg=tfm.TINY, model="tiny")
    assert line["phase"] == "int8_weights" and line["dense_params_byte_equal"]
    assert line["q_scale_card_equals_cpu"] == ["layers.0.w_down", "layers.1.w_down", "lm_head"]
    assert line["launches"] == tfm.TINY.n_layers * line["decode_steps"] > 0
    assert line["graph_captures_after_prewarm"] == 0 and line["graph_ms_over_bf16"] == 2.0
    assert line["steady"]["decode_steps"] > 0 and line["peak_mem_gb"] is None
    # one byte a matmul weight and four a column's scale; the embedding
    # and the norms stay dense
    leaves = [(name, t) for name, t in params.items() if name != "layers"]
    leaves += [item for layer in params["layers"] for item in layer.items()]
    want = sum(t.numel() + 4 * t.shape[1] if name in wq._MATMUL_LEAVES
               else t.numel() * t.element_size() for name, t in leaves)
    assert line["int8_weight_gb"] == want / 1e9
    json.dumps(line)  # one JSON line


def test_kv_tier_phase_rehearsed_on_the_cpu(counting_launches):
    """The kv_tier phase's control flow and checks at TINY on the CPU
    (the waves scaled with the pool: the shared chain is 4 blocks), the
    bf16 tie bound only has to admit this TINY's own rounding."""
    from devspace_tpu_torch.models import transformer as tfm

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


# -- the model zoo's phases ---------------------------------------------------
@pytest.mark.parametrize("name, kind", [
    ("void at::native::batch_norm_collect_statistics_channels_last_kernel<at::native::Var, "
     "c10::BFloat16, float, 4>(c10::BFloat16 const*, int, int)", "elementwise"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous namespace)::"
     "launch_clamp_scalar(at::TensorIteratorBase&)>(int)", "elementwise"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>(float)", "elementwise"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64",
     "conv_matmul"),
    ("sm80_xmma_wgrad_implicit_gemm_indexed_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "conv_matmul"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16>(int)", "conv_matmul"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_TNT", "conv_matmul"),
    ("void at::native::(anonymous namespace)::max_pool_forward_nhwc<c10::BFloat16>(int)",
     "other"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::native::"
     "(anonymous namespace)::TensorListMetadata<3>>(int)", "optimizer"),
    ("void (anonymous namespace)::xent_kernel<float>(float const*, long const*, float*, int)",
     "loss_kernel"),
    ("void (anonymous namespace)::flash_bwd_dkv_sm90_kernel<128>(__nv_bfloat16 const*, int)",
     "flash"),
    ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, c10::BFloat16>(float)",
     "elementwise"),
])
def test_zoo_kernel_kind(name, kind):
    assert cs.zoo_kernel_kind(name) == kind
    assert kind in cs.ZOO_KINDS


def test_zoo_flop_counts():
    """ViT-B/16's train step at 224^2 is 3 x its forward's products; the
    MoE's active parameters are attention, the router, two of eight
    experts and lm_head; its dispatch and combine products at 4096
    tokens, C = 2048, are counted apart."""
    gflop = cs.vit_train_flop_per_image(768, 12, 3072, 16, 224, 1000) / 1e9
    assert gflop == pytest.approx(3 * 35.13, rel=1e-3)
    cfg = cs.MOE_CFG
    assert (cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.ffn_dim, cfg.num_experts,
            cfg.experts_per_token, cfg.n_layers) == (4096, 32, 8, 14336, 8, 2, 2)
    per_layer = 4096 * (2 * 4096 + 2 * 1024) + 4096 * 8 + 2 * 3 * 4096 * 14336
    assert cs.moe_active_params(cfg) == 2 * per_layer + 4096 * 32000
    assert cs.moe_dispatch_flop(cfg, 4096) == 2 * 3 * 2 * 2 * 4096 * 8 * 2048 * 4096


class FakeEvent:
    """A CUDA event's timing on the host clock."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


@pytest.fixture
def cpu_card(monkeypatch):
    """The card's calls as stand-ins on the CPU: synchronisation, events
    and peak memory, the profiled step (run once, unprofiled), and the
    kernels' launch counts, moved by every call of the loss and flash
    entry points as a launch on the card would. The counts and the last
    dispatch are put back afterwards."""
    from devspace_tpu_torch.ops import flash_attention as fa
    from devspace_tpu_torch.ops import losses as xl

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a, **k: 0)

    def breakdown(step_fn, *args, **kwargs):
        step_fn()
        return {"stand_in": True}

    monkeypatch.setattr(cs, "device_breakdown", breakdown)
    for module in (xl, fa):
        monkeypatch.setattr(module, "LAUNCHES", copy.copy(module.LAUNCHES))
        monkeypatch.setattr(module, "LAST_DISPATCH", dict(module.LAST_DISPATCH))

    def counted(module, fn_name, count):
        real = getattr(module, fn_name)

        def fn(*args, **kwargs):
            out = real(*args, **kwargs)
            if count is None:
                module.LAUNCHES += 1
            else:
                module.LAUNCHES[count] += 1
            module.LAST_DISPATCH["impl"] = "cuda"
            return out

        monkeypatch.setattr(module, fn_name, fn)

    counted(xl, "xent_fwd", None)
    for fn_name, count in (("flash_fwd", "fwd"), ("flash_bwd_dq", "bwd_dq"),
                           ("flash_bwd_dkv", "bwd_dkv")):
        counted(fa, fn_name, count)


@pytest.fixture
def few_torch_threads():
    """At most two torch threads: the suite's workers share the cores, and
    torch's many small ops on all of them spin against each other (ten
    times slower under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_zoo_phases_rehearsed_on_the_cpu(monkeypatch, cpu_card, few_torch_threads):
    """The zoo's phases at tiny sizes on the CPU, their checks included:
    the phases' ResNet-50 and ViT-B/16 stand in as a 2-stage, 8-filter
    ResNet (both stems) and a 1-block, 32-wide ViT; the ResNet against
    itself at 2 x 32^2; bench.py's harness at 4 x 32^2 for 1 + 2 steps and
    conv7 for 1 + 1; the MLP's 200 steps as on the card; the ViT at 2 x
    32^2; the MoE at TINY_MOE's widths with T = 1280 (the flash path).
    Timings are host-clock stand-ins."""
    import dataclasses
    import functools

    from devspace_tpu_torch.models import moe, resnet, vit

    cpu = torch.device("cpu")
    monkeypatch.setattr(cs.resnet, "ResNet50", functools.partial(
        resnet.ResNet, stage_sizes=[1, 1], num_filters=8))
    monkeypatch.setattr(cs.vit, "ViT_B16", functools.partial(
        vit.ViT, hidden_dim=32, depth=1, num_heads=2, mlp_dim=64))
    monkeypatch.setattr(cs, "ZOO_SMALL", {"batch": 2, "image": 32})
    monkeypatch.setattr(cs, "RESNET", {**cs.RESNET, "batch": 4, "image": 32, "warmup": 1,
                                       "steps": 2, "conv7_warmup": 1, "conv7_steps": 1})
    monkeypatch.setattr(cs, "VIT", {**cs.VIT, "batch": 2, "image": 32, "warmup": 1, "steps": 2})
    monkeypatch.setattr(cs, "MOE_CFG", dataclasses.replace(moe.TINY_MOE, dtype=torch.float32))
    monkeypatch.setattr(cs, "MOE", {**cs.MOE, "seq": 1280, "batch": 1, "warmup": 1, "steps": 1})
    with cs.cudnn_benchmark():
        small = cs.phase_zoo_small_reference(cpu)
        assert small["logit_rel_err"] == small["loss_rel_err"] == small["stats_rel_err"] == 0
        line = cs.phase_resnet50_train(cpu, "cpu")
        # the warm-up, the timed steps, the profiled step, then conv7's
        assert line["xent_launches"] == 1 + 2 + 1 + 2 and line["conv7"]["xent_launches"] == 2
        assert line["cudnn_benchmark"] is True and line["profiled_step"] == {"stand_in": True}
        assert line["losses"][-1] < line["losses"][0]
        json.dumps(line)
        line = cs.phase_mnist_train(cpu, "cpu")
        assert line["xent_launches"] == 200 and line["loss_at_check_step"] < 1e-3
        json.dumps(line)
        line = cs.phase_vit_train(cpu, "cpu")
        assert line["xent_launches"] == 3 and line["losses"][-1] < line["losses"][0]
        json.dumps(line)
    assert torch.backends.cudnn.benchmark is False
    line = cs.phase_moe_train(cpu, "cpu")
    n = cs.MOE_CFG.n_layers * 2
    assert line["launches"] == {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n,
                                "cross_entropy": 2}
    assert len(line["ce"]) == len(line["aux"]) == 2
    json.dumps(line)


def test_deploy_phase_rehearsed_on_the_cpu(monkeypatch):
    """The deploy phase's control flow and checks on the CPU: the project
    scaffolded, loaded, preflighted (no finding) and rendered by the port,
    the StatefulSet's container run through torchrun with only the
    phase's substitutions (and ``--device=cpu``), a gloo world of one
    training the MNIST example to step 100 with no kernel launched."""
    monkeypatch.setitem(cs.DEPLOY, "steps", 101)
    line = cs.phase_deploy(torch.device("cpu"), "cpu")
    assert line["findings"] == [] and line["objects"] == 3
    assert line["kinds"] == ["PodDisruptionBudget", "Service", "StatefulSet"]
    assert line["argv"][:6] == ["torchrun", "--nnodes=1", "--nproc-per-node=1",
                                "--node-rank=0", "--master-addr=127.0.0.1",
                                f"--master-port={line['argv'][5].split('=')[1]}"]
    assert line["argv"][6:] == ["train.py", "--steps", "101", "--device=cpu"]
    # a master port the OS assigned stands in for the chart's 29500
    port = line["argv"][5].split("=")[1]
    assert line["env"] == {"NODE_RANK": "0"} and len(line["substitutions"]) == 5
    assert f"--master-port=29500 -> --master-port={port}" in line["substitutions"]
    assert line["world"].endswith("backend gloo, world 1")
    assert len(line["losses_every_100"]) == 2 and line["loss_at_check_step"] < 1e-3
    assert line["xent_launches"] == 0
    json.dumps(line)


def test_cluster_phase_rehearsed_on_the_cpu(monkeypatch):
    """The cluster phase's control flow and checks on the CPU: the port's
    CLI adds a provider on the phase's fake cloud, logs in, creates and
    binds a Space and vendors a one-ConfigMap package, then deploys the
    project into its fake cluster in the Space's namespace, reports it and
    prints the applied documents; the applied StatefulSet's command runs
    in worker 0 through the fake's exec with ``NODE_RANK`` from the pod's
    env (and ``--device=cpu``), a gloo world of one training the MNIST
    example to step 100 with no kernel launched; purge empties the fake
    and ``remove space`` the fake cloud and the kubeconfig."""
    monkeypatch.setitem(cs.DEPLOY, "steps", 101)
    line = cs.phase_cluster(torch.device("cpu"), "cpu")
    args = [c["args"] for c in line["cli"]]
    assert args[0][:4] == ["add", "provider", "smoke", "--host"]
    assert args[1:] == [["login", "--key", cs.CLOUD["key"], "--no-browser"],
                        ["create", "space", "smoke"], ["list", "spaces"],
                        ["add", "package", "settings", "--repo", args[4][4]],
                        ["list", "packages"], ["deploy"], ["status", "deployments"],
                        ["print", "--manifests"], ["purge"], ["remove", "space", "smoke"]]
    assert all(c["rc"] == 0 for c in line["cli"])
    assert line["space"] == {"name": "smoke", "id": 1, "namespace": "space-smoke-1",
                             "context": "devspace-smoke"}
    assert line["namespaces"] == ["space-smoke-1"]
    assert line["package"].endswith("-settings")
    assert line["applied_kinds"] == ["ConfigMap", "PodDisruptionBudget", "Service",
                                     "StatefulSet"]
    assert line["left_after_remove_space"] == {"spaces": [], "contexts": []}
    assert line["worker"].endswith("-0") and line["pod_env"] == {"NODE_RANK": "0"}
    assert line["argv"][3] == "--node-rank=0"
    assert line["argv"][6:] == ["train.py", "--steps", "101", "--device=cpu"]
    assert not any(s.startswith("NODE_RANK") for s in line["substitutions"])
    assert line["world"].endswith("backend gloo, world 1")
    assert len(line["losses_every_100"]) == 2 and line["loss_at_check_step"] < 1e-3
    assert line["xent_launches"] == 0
    assert line["left_after_purge"] == {"objects": [], "pods": []}
    json.dumps(line)


# -- a CPU rehearsal of the fleet phase -----------------------------------------
def test_fleet_phase_rehearsed_on_the_cpu(monkeypatch, tmp_path):
    """The fleet phase's control flow and checks at TINY on the CPU: two
    replicas of a saved TINY checkpoint (``--device cpu``) behind the
    gateway, the burst scaled to TINY's 128 positions (three 80-token
    contexts, one engine block each, on 16-token shadow blocks, 8-16-token
    questions, 16 new tokens), the kill and restart, the SLO gate on a
    third replica."""
    import dataclasses

    from devspace_tpu_torch.models import transformer as tfm
    from devspace_tpu_torch.serving import ReplicaSpec
    from devspace_tpu_torch.training.checkpoint import save_checkpoint

    @dataclasses.dataclass
    class CpuSpec(ReplicaSpec):
        def command(self, port):
            return super().command(port) + ["--device", "cpu"]

    real_spec = cs.replica_spec

    def cpu_spec(ckpt_dir, model, **env):
        spec = real_spec(ckpt_dir, model, SPEC="0", **env)  # tiny drafts for itself
        return CpuSpec(**{f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)})

    monkeypatch.setattr(cs, "replica_spec", cpu_spec)
    monkeypatch.setattr(cs, "FLEET", {**cs.FLEET, "context_tokens": 80,
                                      "question_tokens": [8, 16], "new_tokens": 16,
                                      "ready_timeout_s": 120.0, "block_size": 16})
    ckpt = str(tmp_path / "tiny")
    save_checkpoint(ckpt, tfm.init_params(tfm.TINY, torch.Generator().manual_seed(0)))
    line = cs.phase_fleet(ckpt, "cpu", 1.0, torch.device("cpu"), model="tiny", cfg=tfm.TINY)
    assert line["phase"] == "fleet" and line["tokens_received"] == cs.FLEET["requests"] * 16
    assert line["federated_tokens"] == line["tokens_received"]
    assert line["kill_restart"]["gateway_retries"] == 1
    assert line["slo_gate"]["flipped_after_s"] < 30
    assert len(line["replica_starts"]) == 4  # two, the restarted one, the SLO gate's
    assert all(v["prewarm_s"] is not None for k, v in line["replica_starts"].items()
               if not k.startswith("slo"))
    for row in line["per_replica"].values():
        assert row["graph_captures"] > 0
    json.dumps(line)  # one JSON line


# -- a CPU rehearsal of the parallel phase --------------------------------------
def tiny_serving_reference(tmp_path, kv_dtype=None, requests=None):
    """What the parallel phase's part 2 is handed at TINY (bf16): the
    params, the smoke requests and the streams a plain engine on the CPU
    serves them with."""
    from devspace_tpu_torch.inference import InferenceEngine
    from devspace_tpu_torch.models import transformer as tfm

    params = tfm.init_params(tfm.TINY, torch.Generator().manual_seed(0))
    requests = requests or tiny_serving_requests(tfm.TINY)
    engine = InferenceEngine(params, tfm.TINY, device="cpu", max_slots=8, max_len=128,
                             kv_dtype=kv_dtype).start()
    try:
        results = [h.result(timeout=120) for h in [engine.submit(p, n, **kw)
                                                     for p, n, kw in requests]]
    finally:
        engine.stop()
    return params, requests, results


def test_parallel_phase_rehearsed_on_the_cpu(monkeypatch, cpu_card, counting_launches,
                                             few_torch_threads, tmp_path):
    """The parallel phase's control flow and checks on the CPU, in a gloo
    world of one formed and torn down by the phase: the bench LM as
    float32 TINY at 2 x 1280 (the flash path) through the mesh step and
    FSDP against the plain step, and at ``data = 2`` in two spawned
    processes over gloo; the long-context build at TINY's widths
    on 256 tokens; ring and Ulysses against the flash path at [1, 1280,
    2, 16] (float32: the kernel tolerances' float32 branch); the MoE at
    TINY_MOE's widths on 1 x 1280 tokens. Part 2: the 1F1B and
    interleaved steps (V = 2, one layer a chunk) on the same batches as 2
    microbatches of 1 x 1280, launches as predicted; TINY (bf16) through
    a checkpoint of the params through ``load_serving_params(mesh=)``
    and ``from_checkpoint(mesh={"model": 1})`` on the smoke requests and a
    steady burst of 4 x 24, and ``InferenceEngine(mesh=)`` on an int8
    pool with four short prompts, each stream equal to a plain CPU
    engine's. The new parts: FSDP's gathered peak within the head plus
    one layer, the FSDP state restored onto the TP layout with its
    moments byte for byte and the same next loss, and the kv_tier waves
    (TINY_KV_TIER, bf16 pool) on ``from_checkpoint(mesh=, kv_tier=
    "host")`` equal to a plain CPU tier engine's streams, counters and
    KVM1 export.
    Timings and peak memory are host-clock and zero stand-ins; every
    kernel counter is put back."""
    import dataclasses

    import torch.distributed as dist

    from devspace_tpu_torch.models import moe, transformer as tfm
    from devspace_tpu_torch.ops import attention as sa
    from devspace_tpu_torch.ops import normalization as rn
    from devspace_tpu_torch.ops import paged_attention as pa
    from devspace_tpu_torch.training.checkpoint import save_checkpoint

    for module in (pa, sa, rn):
        monkeypatch.setattr(module, "LAUNCHES", module.LAUNCHES)
    monkeypatch.setattr(pa, "LAST_DISPATCH", dict(pa.LAST_DISPATCH))
    monkeypatch.setattr(cs, "STEADY", {"requests": 4, "prompt": 8, "new_tokens": 24})
    monkeypatch.setattr(cs, "PIPE", {"micro": 2, "chunks": 2})
    params, requests, results = tiny_serving_reference(tmp_path)
    rng = np.random.default_rng(1)
    int8_requests = [(rng.integers(1, 256, n).tolist(), 16, {}) for n in (7, 20, 30, 50)]
    _, _, int8_results = tiny_serving_reference(tmp_path, "int8", int8_requests)
    save_checkpoint(str(tmp_path / "step_00000001"), params)
    tier_line, _ = cs.kv_pool_run(params, tfm.TINY, torch.device("cpu"), TINY_KV_TIER,
                                  cs.kv_tier_waves(tfm.TINY, TINY_KV_TIER), None, 0.5)
    serving = {"cfg": tfm.TINY, "params": params, "requests": requests, "results": results,
               "int8_requests": int8_requests, "int8_results": int8_results,
               "steady_ms": 1.0, "checkpoint": str(tmp_path),
               "kv_tier": {"sizes": TINY_KV_TIER, **tier_line["reference"]}}

    tiny = dataclasses.replace(tfm.TINY, dtype=torch.float32)
    monkeypatch.setattr(cs, "BENCH_LM", tiny)
    monkeypatch.setattr(cs, "TRAIN_BATCH", 2)
    monkeypatch.setattr(cs, "TRAIN_SEQ", 1280)
    monkeypatch.setattr(cs, "LONG_CTX", tiny)
    monkeypatch.setattr(cs, "MOE_CFG", dataclasses.replace(moe.TINY_MOE, dtype=torch.float32))
    monkeypatch.setattr(cs, "PARALLEL", {**cs.PARALLEL, "long_seq": 256,
                                         "ring_shape": (1, 1280, 2, 16), "ring_block": 256,
                                         "moe_batch": 1, "moe_seq": 1280})
    monkeypatch.setattr(cs, "device_ms", lambda fn, reps, **kw: (fn() is None and 0.0, 0.0))
    line = cs.phase_parallel(torch.device("cpu"), "cpu", serving)
    assert not dist.is_initialized()
    assert (line["backend"], line["world"]) == ("gloo", 1)
    n = tiny.n_layers * cs.PARALLEL["steps"]
    flash = {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n,
             "cross_entropy": cs.PARALLEL["steps"]}
    for name in ("mesh", "fsdp"):
        r = line["lm_mesh"][name]
        assert r["launches"] == flash
        assert r["loss_rel_err"] <= cs.PARALLEL_REL and r["update_rel_err"] <= cs.PARALLEL_REL
    fsdp = line["lm_mesh"]["fsdp"]  # the gathered bytes are counted on the CPU too
    layer = sum(x.numel() * 4 for x in cs.pmesh.tree_leaves(
        tfm.init_params(tiny, torch.Generator(), device="meta")["layers"][0]) if x.numel() >= 1024)
    assert fsdp["gathered_bound_gb"] == (tiny.dim * tiny.vocab_size * 4 + layer) / 1e9
    assert 0 < fsdp["gathered_peak_gb"] <= fsdp["gathered_bound_gb"]
    elastic = line["elastic"]
    assert elastic["moments_byte_equal"] and elastic["step"] == cs.PARALLEL["steps"]
    assert elastic["loss_rel_err"] <= cs.PARALLEL_REL
    assert elastic["launches"] == {k: 2 * v // cs.PARALLEL["steps"] for k, v in flash.items()}
    two = line["lm_mesh"]["data2_gloo"]  # two spawned processes, half the rows each
    assert two["loss_rel_err_vs_world1"] <= cs.PARALLEL_REL and len(two["losses"]) == 3
    assert line["long_context"]["seq"] == 256 and len(line["long_context"]["losses"]) == 3
    assert set(line["ring_vs_flash"]["errors"]["ring"]) == {"o", "dq", "dk", "dv"}
    assert line["expert_parallel"]["launches"]["cross_entropy"] == 3
    assert line["expert_parallel"]["moe_ffn_max_abs_err"] <= line["expert_parallel"]["moe_ffn_bound"]
    predicted = {"flash_fwd": 2 * 2 * n, "flash_bwd_dq": 2 * n, "flash_bwd_dkv": 2 * n,
                 "cross_entropy": 2 * cs.PARALLEL["steps"]}
    for kind in ("1f1b", "interleaved"):
        r = line["pipeline"][kind]
        assert r["launches"] == r["predicted_launches"] == predicted
        assert r["loss_rel_err"] <= cs.PARALLEL_REL and r["grad_rel_err"] <= cs.PIPE_GRAD_REL
        assert len(r["losses"]) == 3
    tp = line["tp_engine"]
    for pool in ("bf16", "int8"):
        assert tp[pool]["streams_equal_plain"] and tp[pool]["graph_captures_after_prewarm"] == 0
        assert tp[pool]["launches"] == tfm.TINY.n_layers * tp[pool]["decode_steps"] > 0
        watched = tp[pool]["watched"]  # the analysis phase's tripwire wave
        assert watched["captures"] == watched["graph_captures_delta"] == 0
        assert watched["paged_decode_launches"] == tfm.TINY.n_layers * watched["decode_steps"] > 0
    assert tp["bf16"]["steady"]["decode_steps"] > 0
    tier = tp["kv_tier"]
    assert tier["streams_equal_plain"] and tier["counters_equal_plain"]
    assert tier["export_byte_equal_plain"] and tier["export"]["blocks"] == 4
    assert tier["kv_restore_hits"] == 4 and tier["recompute_tokens_saved"] == 32
    assert tier["graph_captures_after_prewarm"] == 0 and tier["launches"] > 0
    assert tp["bf16"]["built_by"] == "from_checkpoint(mesh=)"
    assert tp["seam"]["params_byte_equal"] and tp["seam"]["step"] == 1
    assert set(line["part_seconds"]) == {"lm_mesh_and_pipeline", "elastic", "data2_gloo",
                                         "long_context", "ring_vs_flash", "expert_parallel",
                                         "tp_engine", "tp_engine_kv_tier"}
    assert pa.LAST_DISPATCH == {"impl": "reference", "tp": True}
    json.dumps(line)


# -- a CPU rehearsal of the analysis phase ---------------------------------------
def test_analysis_phase_rehearsed_on_the_cpu(counting_launches):
    """The analysis phase's control flow and checks at TINY on the CPU: a
    prewarmed engine's watched wave builds nothing and replays the paged
    function ``n_layers`` times a step; SHD302 at ``model = 3`` only over
    TINY's serving spec tree, the bench LM's pipeline and FSDP layouts
    clean; SHD304 clean on the trainer's update and a decode program (on
    meta tensors, TINY's config here), one finding on the seeded cast; the
    gate's static legs at zero outside the baseline."""
    from devspace_tpu_torch.inference import InferenceEngine
    from devspace_tpu_torch.models import transformer as tfm

    params = tfm.init_params(tfm.TINY, torch.Generator().manual_seed(0))
    requests = tiny_serving_requests(tfm.TINY)
    engine = InferenceEngine(params, tfm.TINY, device="cpu", max_slots=8, max_len=128)
    cs.prewarm_engine(engine)
    engine.start()
    try:
        wave = cs.watched_wave(engine, requests, "tiny")
    finally:
        engine.stop()
    assert wave["captures"] == wave["graph_captures_delta"] == 0
    assert wave["paged_decode_launches"] == tfm.TINY.n_layers * wave["decode_steps"] > 0
    line = cs.phase_analysis(params, tfm.TINY, "cpu", {"tiny": wave})
    assert line["phase"] == "analysis" and line["tripwire"] == {"tiny": wave}
    sharding = line["sharding"]
    assert sharding["serving_leaf_count"] == 3 + 9 * tfm.TINY.n_layers
    assert sharding["model"]["3"]["rules"] == ["SHD302"]
    assert all(sharding["model"][str(m)]["findings"] == 0 for m in (1, 2, 4, 8))
    for name, axes in (("1f1b", {"pipe": 4}), ("interleaved", {"pipe": 4}),
                       ("fsdp", {"data": 8})):
        assert sharding[name]["mesh"] == axes and sharding[name]["findings"] == 0
        assert sharding[name]["leaf_count"] > 0
    donation = line["donation"]
    assert donation["update"]["findings"] == donation["decode_program"]["findings"] == []
    assert donation["seeded_cast"]["findings"] == ["SHD304"]
    assert line["self_lint"]["outside_baseline"] == 0 and line["self_lint"]["files"] > 70
    assert isinstance(line["static_gate_s"], float) and line["seconds"] >= line["static_gate_s"]
    json.dumps(line)  # one JSON line
