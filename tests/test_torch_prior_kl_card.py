"""The reparam kernel's learned-prior variant (VDVAE's layers) on the card.

Each test needs a CUDA card and skips without one; this file imports no
JAX, so on the card's machine it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q -m card \\
        tests/test_torch_prior_kl_card.py

At the vdvae cell's shapes (z [128, 16, r, r], q and p [128, 32, r, r]
in channels_last memory) each way against its plain version, at
``chip_smoke.PRIOR_KL_TOL``; through the model's top-down pass, one launch
each way a layer.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from apv_tpu_torch import ops
from apv_tpu_torch.ops import kernels as K

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the reparam kernel's learned-prior "
                    "variant runs only there")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("r", chip_smoke.PRIOR_KL_RES)
def test_card_variant_holds_to_the_plain_version(card, r):
    gen = torch.Generator(device=card).manual_seed(r)
    cl = torch.channels_last
    b, z = chip_smoke.PRIOR_KL_BATCH, chip_smoke.PRIOR_KL_Z
    q = (0.5 * torch.randn(b, 2 * z, r, r, generator=gen, device=card)
         ).contiguous(memory_format=cl).requires_grad_(True)
    p = (0.5 * torch.randn(b, 2 * z, r, r, generator=gen, device=card)
         ).contiguous(memory_format=cl).requires_grad_(True)
    K.reset_launches()
    zk, klk = ops.reparam_prior_kl(q, p, generator=torch.Generator()
                                   .manual_seed(5))
    g = torch.randn_like(zk)
    g_kl = torch.randn_like(klk)
    dq, dp = torch.autograd.grad((zk * g).sum() + (klk * g_kl).sum(), (q, p))
    assert (K.launches["reparam"], K.launches["reparam_bwd"]) == (1, 1)
    seed, offset = K.draw_key(torch.Generator().manual_seed(5))
    zp, klp = K.reparam_prior_plain(q.detach(), p.detach(), seed, offset)
    rq, rp = K.reparam_prior_bwd_plain(g, zk.detach(), q.detach(),
                                       p.detach(), g_kl)
    for got, want in ((zk, zp), (klk, klp), (dq, rq), (dp, rp)):
        assert chip_smoke.scale_rel(got.detach(), want) \
            <= chip_smoke.PRIOR_KL_TOL


@pytest.mark.card
def test_card_topdown_launches_one_each_way_a_layer(card):
    from apv_tpu_torch.models.vdvae import VDVAE, prepare
    m = VDVAE(width=32, zdim=16, enc_blocks="8x1,8d2,4x1,4d4,1x1",
              dec_blocks="1x1,4m1,4x1,8m4,8x1", mixtures=2,
              image_shape=(8, 8, 3)).init_(0).to(
        card, memory_format=torch.channels_last)
    x = torch.randint(0, 256, (4, 8, 8, 3), dtype=torch.uint8, device=card)
    x_in, x_t = prepare(x)
    K.reset_launches()
    d, kls = m(x_in, x_t, generator=torch.Generator().manual_seed(1))
    (d.mean() + torch.stack(kls).sum(0).mean()).backward()
    assert (K.launches["reparam"], K.launches["reparam_bwd"]) == (5, 5)
