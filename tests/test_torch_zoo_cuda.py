"""The model zoo's kernels and models on the card (marked ``cuda``; they
skip on a machine without one, and import no JAX).

    python -m pytest -m cuda tests/test_torch_zoo_cuda.py

The loss kernel at the classifiers' logits (f32 ``[256, 1000]``, whose
rows take the kernel's 16-byte vector path, and ``[256, 10]``, whose
40-byte rows mostly take its scalar loop) against its plain version
(float32, the same values summed in other orders: ``rtol=atol=1e-5``);
the flash kernels at the MoE's head width (bf16 causal ``[64, 2048,
128]``: each (row, head) within 1e-2 of the head's largest plain output,
one bf16 rounding apart); ResNet-50 (space-to-depth, full width, float32
with TF32 off) at 8 x 64^2 on the card against the CPU (logits, one SGD
step's loss and the running statistics within 1e-3 of their largest
value: sums in other orders through 53 layers); the MoE's bfloat16
expert layer (the up-projection one product with a float32 result) on
the card against the CPU (outputs: the mean error within 1e-3 of the
mean magnitude and the largest within 2**-8 of the largest output, one
bfloat16 rounding; the gradients within 2**-6 of each one's largest
value, the products' bfloat16 roundings summed in other orders); and
``prefetch_to_device``'s side-stream copies equal to the host's bytes.
"""

import copy
import itertools

import numpy as np
import pytest
import torch

from devspace_tpu_torch.models.resnet import ResNet50
from devspace_tpu_torch.ops import flash_attention as fa
from devspace_tpu_torch.ops import losses as xl
from devspace_tpu_torch.parallel import expert_parallel as tep
from devspace_tpu_torch.training import data as tdata
from devspace_tpu_torch.training import trainer as ttrainer

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("rows, vocab", [(256, 1000), (128, 1000), (256, 10), (7, 10),
                                        (256, 1001)])
def test_loss_kernel_at_classifier_shapes(dev, rows, vocab):
    g = torch.Generator(device=dev).manual_seed(rows + vocab)
    logits = 3 * torch.randn((rows, vocab), generator=g, device=dev)
    labels = torch.randint(0, vocab, (rows,), generator=g, device=dev)
    before = xl.LAUNCHES
    loss, lse = xl.xent_fwd(logits, labels)
    torch.cuda.synchronize()
    assert xl.LAUNCHES == before + 1
    rloss, rlse = xl._xent_fwd_reference(logits, labels)
    torch.testing.assert_close(loss, rloss, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-5)


def test_flash_at_head_width_128(dev):
    g = torch.Generator(device=dev).manual_seed(11)
    q, k, v, do = (torch.randn((64, 2048, 128), generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    o, lse = fa.flash_fwd(q, k, v, True)
    delta = (do.float() * o.float()).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, True)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, True)
    torch.cuda.synchronize()
    assert fa.LAST_DISPATCH["impl"] == "cuda"
    ro, rlse = fa.flash_fwd_reference(q, k, v, True)
    rdq = fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, True)
    rdk, rdv = fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta, True)
    torch.testing.assert_close(lse, rlse, rtol=2e-4, atol=1e-4)
    for got, ref in ((o, ro), (dq, rdq), (dk, rdk), (dv, rdv)):
        diff = (got.float() - ref.float()).abs().flatten(1).amax(-1)
        assert (diff / ref.float().abs().flatten(1).amax(-1)).max().item() <= 1e-2


def test_resnet50_on_the_card_matches_the_cpu(dev):
    cpu = torch.device("cpu")
    base = ResNet50(num_classes=1000, dtype=torch.float32, stem="space_to_depth", device=cpu)
    rng = np.random.default_rng(1)
    batch = {"image": torch.from_numpy(rng.normal(size=(8, 64, 64, 3)).astype(np.float32)),
             "label": torch.from_numpy(rng.integers(0, 1000, size=8))}
    out = {}
    for d in (cpu, dev):
        model = copy.deepcopy(base).to(d)
        with torch.no_grad():
            logits = model(batch["image"].to(d), train=False)
        opt = ttrainer.sgd(0.1)
        step = ttrainer.make_classifier_train_step(model, opt, has_batch_stats=True)
        _, loss = step(ttrainer.init_train_state(model, opt),
                       {k: t.to(d) for k, t in batch.items()})
        out[d.type] = (logits.cpu(), loss.item(), [b.cpu() for b in model.buffers()])
    (lc, sc, bc), (lg, sg, bg) = out["cpu"], out["cuda"]
    assert ((lg - lc).abs().max() / lc.abs().max()).item() <= 1e-3
    assert abs(sg - sc) <= 1e-3 * abs(sc)
    for a, b in zip(bg, bc):
        assert ((a - b).abs().max() / b.abs().max()).item() <= 1e-3


def test_moe_expert_layer_bf16_on_the_card_matches_the_cpu(dev):
    rng = np.random.default_rng(2)
    d, f, e = 256, 384, 8
    params = {"w_gate": torch.from_numpy(rng.normal(size=(d, e)).astype(np.float32) * 0.1),
              "w_up": torch.from_numpy(rng.normal(size=(e, d, 2 * f)).astype(np.float32)
                                       * 0.1).bfloat16(),
              "w_down": torch.from_numpy(rng.normal(size=(e, f, d)).astype(np.float32)
                                         * 0.1).bfloat16()}
    x = torch.from_numpy(rng.normal(size=(512, d)).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.normal(size=(512, d)).astype(np.float32)).bfloat16()
    out = {}
    for where in ("cpu", dev):
        p = {k: t.detach().to(where).requires_grad_() for k, t in params.items()}
        y, aux = tep.moe_ffn_reference(x.to(where), p, k=2, capacity_factor=1.25,
                                       activation=tep.swiglu)
        (y.float() * g.to(where).float()).sum().add(aux).backward()
        out[str(where)] = (y.float().cpu(), {k: t.grad.float().cpu() for k, t in p.items()})
    (yc, gc), (yg, gg) = out["cpu"], out[str(dev)]
    err = (yg - yc).abs()
    assert err.mean() <= 1e-3 * yc.abs().mean() and err.max() <= 2.0 ** -8 * yc.abs().max()
    for name in params:
        assert (gg[name] - gc[name]).abs().max() <= 2.0 ** -6 * gc[name].abs().max(), name


def test_prefetch_to_device_copies_the_hosts_bytes(dev):
    host = list(itertools.islice(tdata.synthetic_imagenet(4, 32, seed=3, device="cpu"), 5))
    got = list(tdata.prefetch_to_device(iter(host), size=2, device=dev))
    torch.cuda.synchronize()
    assert len(got) == 5
    for h, g in zip(host, got):
        assert g["image"].device.type == "cuda"
        assert torch.equal(g["image"].cpu(), h["image"]) and torch.equal(g["label"].cpu(), h["label"])
