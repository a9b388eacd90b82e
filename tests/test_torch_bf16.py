"""The port's bfloat16 builds against flax's bfloat16 builds.

Every number the port takes on the card comes from its bf16 build
(``training/step.py``: ``dtype=torch.bfloat16``), while the other model
tests hold float32 builds to flax. Here both sides compute in bf16, from
the same converted weights and the same injected ε, at ``tiny_config``
sizes: the ResNet VAE (``apv_tpu/models/resnet_vae.py``, bf16 by default)
in the flagship's structure and in the GroupNorm/GELU/nearest variant,
and the conv VAE. Compared: the encoder's moments, the decoder's output
on the same z, and the per-sample ELBO.

The bar, fixed before the first run. bf16 keeps 8 significand bits, so
its unit roundoff is U = 2⁻⁸. Both builds round each bf16 layer's output
(conv, dense, transposed conv, with its norm and activation) to bf16, and
a rounding can land one way on one side and the other way on the other
when the unrounded values differ in their last f32 bits (another
summation order, a bias added before or after the rounding). So each
layer adds at most about U of its output's scale to the difference, and
the layers carry it forward with gain about 1 (the norms rescale). After L
bf16 layers on the path the bar is

    max |port − flax| ≤ L·U·max |flax|          (element-wise)

with L counted from the port's modules below: the encoder's layers for the
moments, the decoder's for its output. The float32 tests hold the same
tensors to 1e-4; L·U is 0.03 or more here. The per-sample ELBO takes that
bar to first order: the decoder output of its own ε-draw moves by up to
(L_enc + L_dec)·U·max|out| per element and the moments by L_enc·U of
their scale, so

    |ΔELBO_b| ≤ Σ_e |∂ELBO_b/∂out_e|·(L_enc + L_dec)·U·max|out|
               + Σ_j (|∂KL_b/∂μ_j|·δμ + |∂KL_b/∂lv_j|·δlv),

the derivatives taken in float32 at flax's values.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_config
from apv_tpu import ops as jops
from apv_tpu.models import build_model as flax_build_model
from apv_tpu.training import losses as jlosses
from apv_tpu_torch import ops
from apv_tpu_torch.convert import params_from_flax
from apv_tpu_torch.models import build_model
from apv_tpu_torch.models.common import Conv, ConvTranspose2x, Dense
from apv_tpu_torch.training import losses as tlosses
from apv_tpu_torch.utils.config import config_from_dict

torch.set_num_threads(1)

U = 2.0 ** -8            # bf16's unit roundoff: 8 significand bits
B = 4

CASES = {
    "resnet_flagship": ("cifar_advprior_resnet", {}),
    "resnet_group_gelu_nearest": ("cifar_advprior_resnet", {
        "model.norm": "group", "model.activation": "gelu",
        "model.upsample": "nearest"}),
    "conv_mnist": ("mnist_vae", {}),
}


def _bf16_layers(module) -> int:
    """L: the bf16 conv, dense and transposed-conv layers in ``module``."""
    return sum(1 for m in module.modules()
               if isinstance(m, (Conv, Dense, ConvTranspose2x))
               and m.dtype == torch.bfloat16)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    preset, extra = CASES[request.param]
    cfg_j = tiny_config(preset, **extra)
    cfg_t = config_from_dict(json.loads(cfg_j.to_json()))
    fmodel = flax_build_model(cfg_j.model)              # bf16 by default
    h, w, c = cfg_j.model.image_shape
    z_dim = cfg_j.model.z_dim
    params = jax.jit(fmodel.init)(jax.random.PRNGKey(0),
                                  np.zeros((1, h, w, c), np.float32),
                                  np.zeros((1, z_dim), np.float32))["params"]
    tmodel = build_model(cfg_t.model, dtype=torch.bfloat16, device="cpu")
    tmodel.load_state_dict(params_from_flax(_np_tree(params)), strict=True)
    rng = np.random.default_rng(5)
    if cfg_j.data.binarize:
        x_t = (rng.random((B, h, w, c)) < 0.3).astype(np.float32)
        x_in = x_t
    else:
        x_t = (rng.integers(0, 256, (B, h, w, c)) / 255.0).astype(np.float32)
        x_in = x_t * 2.0 - 1.0
    return dict(cfg=cfg_j, fmodel=fmodel, params=params, tmodel=tmodel.eval(),
                x_in=x_in, x_t=x_t,
                z=rng.normal(size=(B, z_dim)).astype(np.float32),
                eps=rng.normal(size=(B, z_dim)).astype(np.float32))


def _flax(p, method, *args):
    return p["fmodel"].apply({"params": p["params"]}, *args, method=method)


def _assert_within(got, want, layers, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    bar = layers * U * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= bar, f"{what}: max |Δ| {err:.3g} > L·U·max|want| = {bar:.3g}"


def test_bf16_encoder_moments_match_flax(pair):
    want_m, want_lv = _flax(pair, "encode", pair["x_in"])
    with torch.no_grad():
        got_m, got_lv = pair["tmodel"].encode(torch.from_numpy(pair["x_in"]))
    assert got_m.dtype == got_lv.dtype == torch.float32
    layers = _bf16_layers(pair["tmodel"].encoder)
    _assert_within(got_m, want_m, layers, "mean")
    _assert_within(got_lv, want_lv, layers, "logvar")


def test_bf16_decoder_output_matches_flax(pair):
    want = _flax(pair, "decode", pair["z"])
    with torch.no_grad():
        got = pair["tmodel"].decode(torch.from_numpy(pair["z"]))
    assert got.dtype == torch.float32 and got.shape == want.shape
    _assert_within(got, want, _bf16_layers(pair["tmodel"].decoder),
                   "decoder output")


def test_bf16_per_sample_elbo_matches_flax(pair):
    cfg, lik = pair["cfg"], pair["cfg"].model.likelihood
    x_in, x_t, eps = pair["x_in"], pair["x_t"], pair["eps"]
    # flax: the same injected ε, JAX's plain likelihood and KL
    mean, logvar = _flax(pair, "encode", x_in)
    z = mean + jnp.exp(0.5 * logvar) * eps
    out_j = _flax(pair, "decode", z)
    want = (jlosses.recon_log_likelihood(jnp.asarray(x_t), out_j, lik)
            - jops.kl_standard(mean, logvar))
    model = pair["tmodel"]
    with torch.no_grad():
        m_t, lv_t = model.encode(torch.from_numpy(x_in))
        z_t = ops.reparam_sample(m_t, lv_t, eps=torch.from_numpy(eps))
        got = (tlosses.recon_log_likelihood(torch.from_numpy(x_t),
                                            model.decode(z_t), lik)
               - ops.kl_standard(m_t, lv_t))
    # the first-order bar of the module docstring, in float32 at flax's
    # values
    out = torch.from_numpy(np.array(out_j)).requires_grad_(True)
    recon = tlosses.recon_log_likelihood(torch.from_numpy(x_t), out, lik)
    g_out = torch.stack([torch.autograd.grad(recon[b], out,
                                             retain_graph=True)[0][b]
                         for b in range(B)])
    l_enc = _bf16_layers(model.encoder)
    l_dec = _bf16_layers(model.decoder)
    m = np.asarray(mean, np.float64)
    lv = np.asarray(logvar, np.float64)
    d_m, d_lv = l_enc * U * np.abs(m).max(), l_enc * U * np.abs(lv).max()
    bar = (g_out.abs().reshape(B, -1).sum(1).double().numpy()
           * (l_enc + l_dec) * U * float(np.abs(np.asarray(out_j)).max())
           + (np.abs(m) * d_m + np.abs(np.expm1(lv)) / 2 * d_lv).sum(1))
    err = np.abs(got.double().numpy() - np.asarray(want, np.float64))
    assert np.all(err <= bar), (err, bar)
    assert np.all(np.isfinite(got.numpy()))
