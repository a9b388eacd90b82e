"""The fused RMSNorm + activation kernels on the card.

Each test needs a CUDA card and skips without one; this file imports no
JAX, so on the card's machine it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q -m card \\
        tests/test_torch_rmsnorm_card.py

The kernels are held to their plain versions (``K.rmsnorm_act_plain``,
``K.rmsnorm_act_bwd_plain``) at the flagship's stage shapes, one pixel a
row: the train step's (batch 256) and the IWAE chunk's (1,600 rows). The
bars and the bf16 measure are ``chip_smoke.py``'s (``rms_fwd_err``). Then
the paths: a forward and backward through the ResNet launch each kernel
once a norm; ``evaluate_nll`` at the IWAE cell's shapes launches the
forward 13 times a chunk and 13 times a batch; a scorer artifact exported
on the card launches it from its graph.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from apv_tpu_torch.ops import kernels as K

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# (rows, C): the train step's three stages, then the IWAE chunk's
SHAPES = [(256 * 1024, 64), (256 * 256, 128), (256 * 64, 256),
          (1600 * 1024, 64), (1600 * 256, 128), (1600 * 64, 256)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the rmsnorm_act kernels run only there")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,c", SHAPES)
def test_card_kernels_hold_to_the_plain_versions(card, rows, c, dtype):
    """Forward within one bf16 ulp (chip_smoke.rms_fwd_err) in bf16 and
    1e-6 scale-relative in f32, rstd 1e-6; dx and dw scale-relative 1e-2
    in bf16 and 1e-5 in f32; both on the vector kernels; dw (and dx) the
    same bits on a second call."""
    rng = np.random.default_rng(rows + c)
    x, w, dy = chip_smoke.rms_inputs(rng, rows, c, dtype, card)
    K.reset_launches()
    with torch.inference_mode():
        y, rstd = K.rmsnorm_act_cuda(x, w, "silu", want_rstd=True)
        fwd, _ = chip_smoke.rms_fwd_err(K, x, w, "silu", y)
        dx, dw = K.rmsnorm_act_bwd_cuda(dy, x, w, rstd, "silu")
        dx2, dw2 = K.rmsnorm_act_bwd_cuda(dy, x, w, rstd, "silu")
        dxp, dwp = K.rmsnorm_act_bwd_plain(dy, x, w, rstd, "silu")
    torch.cuda.synchronize()
    assert fwd <= chip_smoke.RMS_FWD_TOL[dtype]
    assert chip_smoke.scale_rel(rstd, K.rms_rstd(x)) <= 1e-6
    tol = chip_smoke.RMS_GRAD_TOL[dtype]
    assert chip_smoke.scale_rel(dx, dxp) <= tol
    assert chip_smoke.scale_rel(dw, dwp) <= tol
    assert torch.equal(dw, dw2) and torch.equal(dx, dx2)
    assert K.rmsnorm_act_routes == {"vector": 1, "scalar": 0}
    assert K.rmsnorm_act_bwd_routes == {"vector": 2, "scalar": 0}


def _flagship(card):
    from apv_tpu_torch import build_model, get_preset, make_latent_d
    cfg = get_preset("iwae_eval")
    model = build_model(cfg.model, device=card, seed=0)
    d = make_latent_d(cfg.adversarial, cfg.model.z_dim, device=card, seed=1)
    return cfg, model, d


@pytest.mark.card
def test_card_resnet_launches_each_kernel_once_a_norm(card):
    """A forward of the flagship's encoder and decoder at batch 8 launches
    the forward kernel 13 + 13 times; a backward to the parameters the
    backward kernel 13 + 13 times."""
    cfg, model, _ = _flagship(card)
    x = torch.rand(8, 32, 32, 3, device=card)
    K.reset_launches()
    mean, _ = model.encode(x)
    out = model.decode(mean)
    assert K.launches["rmsnorm_act"] == 26
    torch.autograd.grad(out.float().square().mean(),
                        list(model.parameters()))
    torch.cuda.synchronize()
    assert (K.launches["rmsnorm_act"], K.launches["rmsnorm_act_bwd"]) \
        == (26, 26)


@pytest.mark.card
def test_card_evaluate_nll_launches_13_a_chunk_and_13_a_batch(card):
    """evaluate_nll at the IWAE cell's shapes (k=1000, chunk 25, batch 64)
    over two batches: 13 forward launches a chunk (the decoder) and 13 a
    batch (the encoder), no backward."""
    from apv_tpu_torch import evaluate_nll
    cfg, model, d = _flagship(card)
    k, chunk = cfg.eval.iwae_k, cfg.eval.iwae_chunk
    assert (k, chunk) == (1000, 25)
    images = np.random.default_rng(2).integers(0, 256, (128, 32, 32, 3),
                                               dtype=np.uint8)
    K.reset_launches()
    evaluate_nll(cfg, model, d, images, k=k, chunk=chunk, batch_size=64,
                 seed=0, device=card)
    torch.cuda.synchronize()
    assert K.launches["rmsnorm_act"] == 2 * (13 * (k // chunk) + 13)
    assert K.launches["rmsnorm_act_bwd"] == 0


@pytest.mark.card
def test_card_scorer_artifact_launches_the_kernel(card, tmp_path):
    """A scorer artifact of the flagship exported on the card holds
    apv::rmsnorm_act nodes, and a call launches the kernel 13 + 13
    times."""
    from apv_tpu_torch import serving
    cfg, model, d = _flagship(card)
    path = serving.export_scorer(cfg, model, tmp_path / "scorer.pt2", d=d,
                                 device=card)
    art = serving.load_exported(path)
    x = torch.rand(4, 32, 32, 3, device=card)
    art(x, torch.tensor(0))
    torch.cuda.synchronize()
    K.reset_launches()
    elbo = art(x, torch.tensor(1))
    torch.cuda.synchronize()
    assert K.launches["rmsnorm_act"] == 26
    assert elbo.shape == (4,) and bool(torch.isfinite(elbo).all())
